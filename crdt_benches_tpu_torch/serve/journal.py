"""Write-ahead op journal, fleet snapshot barriers and crash recovery (the
JAX package's ``serve/journal.py``).

After a crash, recovery restores the last consistent snapshot set and the
resumed drain replays the journal tail through the normal macro-round
path; the oracle verify confirms the result is the converged state an
uninterrupted run produces.  Three artifacts live under one journal
directory, byte-compatible with the JAX package's (either package reads
a directory the other wrote):

- **op journal** (``journal.log`` and sealed ``wal_<seq>.log`` segments):
  every macro-round the scheduler appends the per-class lane set, one
  ``[doc, start_cursor, end_cursor]`` triple per scheduled document,
  BEFORE the round's dispatch.  A doc's op stream is deterministic host
  data, so a cursor interval IS the op batch.  Records are one line
  each, ``<crc32hex> <compact json>``; a torn tail fails its CRC or its
  JSON and is dropped at read time.  The active file rolls into a
  numbered segment once past ``segment_bytes``, and the GC pass after
  each committed snapshot deletes the segments whose every record is
  older than the oldest retained barrier.  GC is crash-safe: the victim
  list is committed to ``GC_MANIFEST.json`` before any unlink, and a
  torn pass is completed on the next open, compaction or recovery.
- **snapshot barriers** (``snap_<round>/``): staged in ``<dir>.tmp``
  with the manifest written last and committed by one directory rename.
  A **full** barrier holds one CRC'd ``.npz`` per capacity class; a
  **delta** only the rows the pool marked dirty since the previous
  barrier, chained to its base by the base's name and manifest CRC down
  to the full root.  A periodic full barrier re-roots the chain, and
  snapshots are pruned by chain, so a delta's base is never deleted
  from under it.
- **recovery** (:func:`recover_fleet`): the newest snapshot whose whole
  chain verifies, composed root to tip so the latest write to each row
  wins; any damage falls back down the chain, then to an older chain,
  then to a cold start (the streams are deterministic).

:func:`rebuild_doc` rebuilds one document's row at a cursor from a base
state by replaying the stream interval through ``engine/merge_fleet.py``
(K1's per-row form and K4, a slice at a time) on the pool's device.

The journal's counters and durability gauges are registry metrics
(``serve.journal.*``, attached to a drain's registry by
:meth:`OpJournal.bind_metrics`).  Its file operations run inside the fs
sanitizer's protocols (``lint/fs_sanitizer.py``: ``wal`` for appends,
seals and the torn-tail repair, ``gc`` for segment GC, ``snapshot`` for
barriers, staging sweeps and recovery), and :meth:`OpJournal.round_record`
is a publish point of the race sanitizer.  :func:`recover_fleet` settles a
reshard the journal records (``serve/reshard.py recover_torn_reshard``):
committed ones stay retired, a committed manifest without a commit record
rolls forward, a staged one rolls back.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..engine.merge_fleet import merge_rows_macro
from ..lint.fs_sanitizer import durable_protocol, fs_protocol
from ..lint.race_sanitizer import published
from ..obs.metrics import Counter, Gauge
from ..ops.apply2 import PackedState
from ..traces.tensorize import PAD
from ..utils.checkpoint import (
    CorruptCheckpointError,
    fsync_dir,
    fsync_file,
    load_state,
    save_state,
)
from .pool import _fresh_row_np
from .reshard import recover_torn_reshard

SNAP_PREFIX = "snap_"
WAL_PREFIX = "wal_"
WAL_ACTIVE = "journal.log"
GC_MANIFEST = "GC_MANIFEST.json"

#: Roll the active WAL file into a sealed segment past this many bytes.
DEFAULT_SEGMENT_BYTES = 1 << 20

#: A delta chain deeper than this is re-rooted with a full snapshot
#: whatever the caller's cadence (recovery walks the whole chain).
MAX_CHAIN_DEPTH = 64


class ChainError(CorruptCheckpointError):
    """A snapshot chain failed verification: missing base directory,
    base-manifest CRC mismatch, depth overflow or an unreadable link
    manifest.  A :class:`CorruptCheckpointError`, so every fallback that
    degrades on member damage degrades the same way on link damage."""


#: What a recovery candidate may raise before the walk falls back to an
#: older snapshot: a bit-flipped manifest can stay parseable JSON with
#: garbled values, which surfaces as IndexError/KeyError/TypeError deep in
#: the restore.
_RECOVER_ERRORS = (ValueError, KeyError, IndexError, TypeError, OSError)


# ---------------------------------------------------------------------------
# the op journal (append-only, CRC-framed JSON lines, rolled segments)
# ---------------------------------------------------------------------------


class OpJournal:  # graftlint: thread=hot
    """Append-only write-ahead journal, one record per line:
    ``<crc32 of payload, 8 hex chars> <compact json payload>``.  Owned by
    the drain's thread.

    ``fsync=True`` makes every record durable before the append returns;
    the default leaves flushing to the OS (a lost suffix is what recovery
    tolerates).  ``segment_bytes`` bounds the active file: past it, the
    next roll point (:meth:`maybe_roll`, called by every :meth:`compact`,
    i.e. at each snapshot barrier) seals it as ``wal_<seq>.log``.

    Opening an existing directory first completes a torn GC pass, sweeps
    abandoned snapshot staging directories and truncates a torn tail of
    the active file: records appended behind a damaged line would be
    hidden from the next recovery, whose reader stops there."""

    def __init__(self, journal_dir: str, fsync: bool = False,  # graftlint: durable=wal
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        os.makedirs(journal_dir, exist_ok=True)
        self.dir = journal_dir
        self.path = os.path.join(journal_dir, WAL_ACTIVE)
        self.fsync = fsync
        self.segment_bytes = max(0, int(segment_bytes))
        self.torn_gc_completed = finish_torn_gc(journal_dir)
        sweep_staging(journal_dir)
        if os.path.exists(self.path):
            good = _valid_prefix_bytes(self.path)
            if good < os.path.getsize(self.path):
                with fs_protocol("wal"):
                    with open(self.path, "r+b") as f:
                        f.truncate(good)
        self._seq = 1 + max(
            (_segment_seq(s) for s in wal_segments(journal_dir)), default=0)
        with fs_protocol("wal"):
            self._f = open(self.path, "a", encoding="utf-8")
        self._active_bytes = os.path.getsize(self.path)
        self._since_snapshot = 0
        # max round of each SEALED segment (None: a round-less or damaged
        # record, never GC-eligible); sealed segments never change, so it
        # is tracked for segments sealed here and parsed once for others
        self._seg_max: dict[str, int | None] = {}
        self._active_max_r = -1
        self._active_roundless = False
        self._active_records = 0
        if self._active_bytes:
            recs, _n, _clean = _file_records(self.path)
            self._active_records = len(recs)
            for rec in recs:
                r = rec.get("r")
                if isinstance(r, int):
                    self._active_max_r = max(self._active_max_r, r)
                else:
                    self._active_roundless = True
        self._m_records = Counter("serve.journal.records")
        self._m_bytes = Counter("serve.journal.bytes")
        self._m_snap_bytes = Counter("serve.journal.snapshot_bytes")
        self._m_sealed = Counter("serve.journal.segments_sealed")
        self._m_gc_passes = Counter("serve.journal.gc_passes")
        self._m_gc_segments = Counter("serve.journal.gc_segments")
        self._g_segments = Gauge("serve.journal.wal_segments")
        self._g_since = Gauge("serve.journal.bytes_since_snapshot")
        self._g_segments.set(1 + len(wal_segments(journal_dir)))

    def bind_metrics(self, registry) -> None:
        """Attach the journal's counters and durability gauges to a
        drain's ``MetricsRegistry`` (``serve_journal_*`` on ``/metrics``)."""
        for m in (self._m_records, self._m_bytes, self._m_snap_bytes,
                  self._m_sealed, self._m_gc_passes, self._m_gc_segments,
                  self._g_segments, self._g_since):
            registry.attach(m)

    @property
    def records(self) -> int:
        return self._m_records.value

    @property
    def bytes_written(self) -> int:
        return self._m_bytes.value

    @property
    def bytes_total(self) -> int:
        """WAL bytes appended plus committed snapshot bytes (monotonic;
        GC shrinks the footprint on disk, never this)."""
        return self._m_bytes.value + self._m_snap_bytes.value

    @property
    def segments_sealed(self) -> int:
        return self._m_sealed.value

    @property
    def gc_segments(self) -> int:
        return self._m_gc_segments.value

    def on_disk_bytes(self) -> int:
        """Live WAL footprint: sealed segments and the active file."""
        total = 0
        for name in wal_segments(self.dir) + [WAL_ACTIVE]:
            try:
                total += os.path.getsize(os.path.join(self.dir, name))
            except OSError:
                pass
        return total

    def note_snapshot(self, snap_dir: str) -> int:
        """Account a committed barrier's bytes on disk (hard-linked members
        at full size: what a recovery would read) and restart the bytes
        since the last snapshot."""
        total = 0
        for root, _dirs, files in os.walk(snap_dir):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
        self._m_snap_bytes.inc(total)
        self._since_snapshot = 0
        self._g_since.set(0)
        return total

    def append(self, obj: dict) -> None:  # graftlint: durable=wal
        payload = json.dumps(obj, separators=(",", ":"))
        line = f"{zlib.crc32(payload.encode()):08x} {payload}\n"
        with fs_protocol("wal"):
            self._f.write(line)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
        self._m_records.inc()
        self._m_bytes.inc(len(line))
        self._active_bytes += len(line)
        self._since_snapshot += len(line)
        self._g_since.set(self._since_snapshot)
        self._active_records += 1
        r = obj.get("r")
        if isinstance(r, int):
            if r > self._active_max_r:
                self._active_max_r = r
        else:
            self._active_roundless = True

    def maybe_roll(self) -> bool:  # graftlint: durable=wal
        """Seal the active file as the next numbered segment (once past
        ``segment_bytes``) and open a fresh one.  The file is fsynced
        before the rename: a sealed segment is trusted to hold complete
        records only."""
        if not self.segment_bytes or self._active_bytes < self.segment_bytes:
            return False
        with fs_protocol("wal"):
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            name = _segment_name(self._seq)
            os.replace(self.path, os.path.join(self.dir, name))
            fsync_dir(self.dir)
            self._seg_max[name] = (
                None if self._active_roundless or not self._active_records
                else self._active_max_r)
            self._seq += 1
            self._f = open(self.path, "a", encoding="utf-8")
        self._active_bytes = 0
        self._active_max_r = -1
        self._active_roundless = False
        self._active_records = 0
        self._m_sealed.inc()
        self._g_segments.set(1 + len(wal_segments(self.dir)))
        return True

    @published
    def round_record(self, rnd: int,  # graftlint: publish=journal
                     lanes: dict[int, list[list[int]]]) -> None:
        """The write-ahead record of one macro-round: per class, the
        ``[doc, start_cursor, end_cursor]`` of every scheduled lane.  MUST
        be appended before the round's dispatch."""
        self.append({
            "t": "round",
            "r": rnd,
            "lanes": {str(c): spans for c, spans in lanes.items()},
        })

    def event(self, kind: str, **fields) -> None:
        self.append({"t": kind, **fields})

    # ---- segment GC (inside the barrier) ----

    def compact(self, covered_round: int, crash_hook=None) -> dict:  # graftlint: durable=gc
        """Delete the sealed segments whose every record has ``r <
        covered_round``; a segment with a record at or above it, or one
        without a round, survives.  Callers pass :func:`retained_floor`
        (the OLDEST retained snapshot's round): chain fallback may land
        recovery on any retained snapshot, and its redo tail starts there.

        Two-phase delete: the victim list is committed to
        ``GC_MANIFEST.json`` before the first unlink, and a pass torn
        between the two is completed by the next open, compaction or
        recovery (:func:`finish_torn_gc`).  ``crash_hook`` sits in that
        window: when it returns True the pass stops there.  Rolls the
        active file first, so the records below the barrier it seals are
        this pass's own victims."""
        self.maybe_roll()
        torn = self.finish_torn_gc()
        victims: list[str] = []
        freed = 0
        for name in wal_segments(self.dir):
            path = os.path.join(self.dir, name)
            if name not in self._seg_max:  # sealed before this open
                self._seg_max[name] = _segment_max_round(path)
            max_r = self._seg_max[name]
            if max_r is not None and max_r < covered_round:
                victims.append(name)
                try:
                    freed += os.path.getsize(path)
                except OSError:
                    pass
        info = {
            "round": covered_round,
            "checked": len(wal_segments(self.dir)),
            "deleted": 0,
            "freed_bytes": 0,
            "torn_completed": torn,
            "crashed": False,
        }
        if not victims:
            return info
        mpath = os.path.join(self.dir, GC_MANIFEST)
        tmp = mpath + ".tmp"
        with fs_protocol("gc"):
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"round": int(covered_round), "segments": victims},
                          f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())  # the manifest is the commit record
            os.replace(tmp, mpath)  # the GC commit point
            fsync_dir(self.dir)
            if crash_hook is not None and crash_hook():
                # torn: the next open or compaction repairs it
                info["crashed"] = True
                return info
            for name in victims:
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass
                self._seg_max.pop(name, None)
            os.unlink(mpath)
        self._m_gc_passes.inc()
        self._m_gc_segments.inc(len(victims))
        self._g_segments.set(1 + len(wal_segments(self.dir)))
        info["deleted"] = len(victims)
        info["freed_bytes"] = freed
        return info

    def finish_torn_gc(self) -> int:  # graftlint: durable=gc
        """Complete a GC pass torn by a crash (:func:`finish_torn_gc`),
        counted like a clean pass."""
        n = finish_torn_gc(self.dir)
        if n:
            live = set(wal_segments(self.dir))
            for name in list(self._seg_max):
                if name not in live:
                    del self._seg_max[name]
            self._m_gc_passes.inc()
            self._m_gc_segments.inc(n)
            self._g_segments.set(1 + len(live))
        return n

    def status_fields(self) -> dict:
        """The durability view in small scalars (no disk walk)."""
        return {
            "wal_segments": int(self._g_segments.value),
            "bytes_since_snapshot": int(self._g_since.value),
            "segments_sealed": self._m_sealed.value,
            "gc_segments": self._m_gc_segments.value,
        }

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _segment_name(seq: int) -> str:
    return f"{WAL_PREFIX}{seq:08d}.log"


def _segment_seq(name: str) -> int:
    return int(name[len(WAL_PREFIX):-len(".log")])


def wal_segments(journal_dir: str) -> list[str]:
    """Sealed WAL segment file names, oldest first."""
    if not os.path.isdir(journal_dir):
        return []
    return sorted(f for f in os.listdir(journal_dir)
                  if f.startswith(WAL_PREFIX) and f.endswith(".log"))


def finish_torn_gc(journal_dir: str) -> int:  # graftlint: durable=gc
    """Complete a GC pass that crashed between its manifest write and the
    unlinks: delete every listed victim that still exists, then retire
    the manifest.  Idempotent; returns the segments removed now.  A
    half-written ``GC_MANIFEST.json.tmp`` (a crash before the commit) is
    discarded and every segment survives."""
    with fs_protocol("gc"):
        tmp = os.path.join(journal_dir, GC_MANIFEST + ".tmp")
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        mpath = os.path.join(journal_dir, GC_MANIFEST)
        if not os.path.exists(mpath):
            return 0
        try:
            with open(mpath, encoding="utf-8") as f:
                victims = [str(s) for s in json.load(f).get("segments", [])]
        except (OSError, json.JSONDecodeError, AttributeError):
            victims = []  # unreadable manifest: drop it, keep every segment
        removed = 0
        for name in victims:
            path = os.path.join(journal_dir, name)
            if os.path.exists(path):
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
        try:
            os.unlink(mpath)
        except OSError:
            pass
        return removed


def sweep_staging(journal_dir: str) -> list[str]:  # graftlint: durable=snapshot
    """Remove snapshot staging directories (``snap_*.tmp``) abandoned by a
    crash before the commit rename.  They may hold a valid-looking
    manifest; the rename IS the commit, so they never count."""
    if not os.path.isdir(journal_dir):
        return []
    removed = []
    with fs_protocol("snapshot"):
        for d in sorted(os.listdir(journal_dir)):
            if d.startswith(SNAP_PREFIX) and d.endswith(".tmp") and \
                    os.path.isdir(os.path.join(journal_dir, d)):
                shutil.rmtree(os.path.join(journal_dir, d),
                              ignore_errors=True)
                removed.append(d)
    return removed


def _valid_prefix_bytes(path: str) -> int:
    """Byte length of the longest CRC-valid record prefix of a journal
    file (from the first damaged line on, the file is a torn tail)."""
    good = 0
    with open(path, "rb") as f:
        for raw in f:
            try:
                line = raw.decode("utf-8")
                crc_hex, payload = line.rstrip("\n").split(" ", 1)
                if int(crc_hex, 16) != zlib.crc32(payload.encode()):
                    break
                json.loads(payload)
            except (ValueError, UnicodeDecodeError, json.JSONDecodeError):
                break
            good += len(raw)
    return good


def _file_records(path: str) -> tuple[list[dict], int, bool]:
    """CRC-valid records of one journal file: ``(records, total_lines,
    clean)``, ``clean`` False when a damaged line stopped the read."""
    records: list[dict] = []
    if not os.path.exists(path):
        return records, 0, True
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        lines = f.readlines()
    for line in lines:
        try:
            crc_hex, payload = line.rstrip("\n").split(" ", 1)
            if int(crc_hex, 16) != zlib.crc32(payload.encode()):
                raise ValueError("crc mismatch")
            records.append(json.loads(payload))
        except (ValueError, json.JSONDecodeError):
            return records, len(lines), False
    return records, len(lines), True


def _segment_max_round(path: str) -> int | None:
    """The highest round of a sealed segment's records; None when it holds
    no record, a damaged line or a record without a round (never GC'd)."""
    records, _n, clean = _file_records(path)
    if not clean or not records:
        return None
    max_r = -1
    for rec in records:
        r = rec.get("r")
        if not isinstance(r, int):
            return None
        max_r = max(max_r, r)
    return max_r


def read_journal(journal_dir: str) -> tuple[list[dict], int]:
    """All CRC-valid records across the sealed segments and the active
    file, in append order.  Reading stops at the first damaged line: once
    a line is suspect, so is everything after it, later files included.
    Returns ``(records, dropped_lines)``."""
    records: list[dict] = []
    dropped = 0
    files = wal_segments(journal_dir) + [WAL_ACTIVE]
    for i, name in enumerate(files):
        recs, total, clean = _file_records(os.path.join(journal_dir, name))
        records.extend(recs)
        if not clean:
            dropped = total - len(recs)
            for later in files[i + 1:]:
                dropped += _file_records(os.path.join(journal_dir, later))[1]
            break
    return records, dropped


# ---------------------------------------------------------------------------
# snapshot barriers (full and CRC-chained deltas)
# ---------------------------------------------------------------------------


def _manifest_crc(snap_dir: str) -> str | None:
    """CRC32 (8 hex chars) of a snapshot's manifest FILE BYTES: the chain
    link, so a rewritten, damaged or swapped base breaks the chain."""
    try:
        with open(os.path.join(snap_dir, "MANIFEST.json"), "rb") as f:
            return f"{zlib.crc32(f.read()):08x}"
    except OSError:
        return None


@durable_protocol("snapshot")
def write_snapshot(journal_dir: str, pool, streams, rnd: int,  # graftlint: durable=snapshot
                   keep: int = 2, kind: str = "full") -> tuple[str, dict]:
    """One fleet snapshot barrier: per-class bucket state (CRC'd .npz),
    hard links of the live cold spools and the warm entries' shadows, and
    a manifest of cursors and residency, staged in ``<dir>.tmp`` with the
    manifest last and committed by one directory rename.

    ``kind="full"`` persists every used class's whole bucket (a chain
    root).  ``kind="delta"`` persists only the rows the pool marked dirty
    since the previous barrier, chained to the newest committed snapshot;
    a delta with no usable base, or at :data:`MAX_CHAIN_DEPTH`, becomes a
    full snapshot.  Either kind consumes the pool's dirty set.  Snapshots
    are then pruned by chain to the newest ``keep`` (``keep <= 0``: never).
    Returns ``(path, manifest)``, the manifest as committed."""
    if kind not in ("full", "delta"):
        raise ValueError(f"unknown snapshot kind {kind!r}")
    dirty = pool.take_dirty()  # consumed by EVERY barrier kind

    base_name = None
    base_crc = None
    chain_root = None
    depth = 1
    if kind == "delta":
        snaps = list_snapshots(journal_dir)
        base_name = snaps[-1] if snaps else None
        m_base = (_read_manifest(os.path.join(journal_dir, base_name))
                  if base_name else None)
        if m_base is None:
            kind, base_name = "full", None  # no usable base: re-root
        else:
            depth = int(m_base.get("depth", 1)) + 1
            if depth > MAX_CHAIN_DEPTH:
                kind, base_name, depth = "full", None, 1
            else:
                base_crc = _manifest_crc(os.path.join(journal_dir, base_name))
                chain_root = m_base.get("chain", base_name)

    final = os.path.join(journal_dir, f"{SNAP_PREFIX}{rnd:08d}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    def _adopt(src: str, fname: str) -> None:
        # every spool write lands on a new inode (save_state replaces), so
        # a hard link freezes the member; the copy covers a link across
        # devices.  The member is fsynced here, before the commit: spool
        # writes skip the fsync on the drain's path.
        dst = os.path.join(tmp, fname)
        try:
            os.link(src, dst)
        except OSError:
            shutil.copy2(src, dst)
        fsync_file(dst)

    resident: dict[str, list[int]] = {}
    spooled: dict[str, str] = {}
    warm: dict[str, str] = {}
    for doc_id, rec in pool.docs.items():
        if rec.cls is not None:
            resident[str(doc_id)] = [int(rec.cls), int(rec.row)]
        elif rec.spool is not None and os.path.exists(rec.spool):
            fname = f"doc{doc_id}.npz"
            _adopt(rec.spool, fname)
            spooled[str(doc_id)] = fname
    for doc_id in sorted(pool.warm.entries):
        fname = f"doc{doc_id}.npz"
        _adopt(pool.ensure_warm_shadow(doc_id), fname)
        warm[str(doc_id)] = fname

    class_shapes: dict[str, list[int]] = {}
    delta_rows: dict[str, list[int]] = {}
    if kind == "full":
        used_classes = sorted({int(v[0]) for v in resident.values()})
        for cls in used_classes:
            doc, length, nvis = pool.pull_bucket(cls)
            save_state(os.path.join(tmp, f"class_{cls}.npz"),
                       PackedState(doc=doc, length=length, nvis=nvis),
                       compress=False, durable=True)
            class_shapes[str(cls)] = [int(doc.shape[0]), int(doc.shape[1])]
    else:
        for cls in sorted(c for c, rows in dirty.items() if rows):
            rows = [r for r in dirty[cls] if 0 <= r < pool.buckets[cls].R]
            if not rows:
                continue
            doc, length, nvis = pool.pull_bucket(cls)
            rows_a = np.asarray(rows, np.int64)
            # the dirty rows' used prefix (past it every row holds the
            # beyond-length coding 2, which the compose pads back)
            ltrim = max(1, int(length[rows_a].max(initial=0)))
            save_state(os.path.join(tmp, f"delta_{cls}.npz"), PackedState(
                doc=np.ascontiguousarray(doc[rows_a, :ltrim]),
                length=np.asarray(length[rows_a], np.int32),
                nvis=np.asarray(nvis[rows_a], np.int32),
            ), compress=False, durable=True)
            delta_rows[str(cls)] = [int(r) for r in rows]
            class_shapes[str(cls)] = [int(doc.shape[0]), int(doc.shape[1])]
        used_classes = sorted(int(c) for c in delta_rows)

    docs = {str(doc_id): {"c": int(st.cursor),
                          "lim": None if st.limit is None else int(st.limit),
                          "lossy": bool(st.lossy)}
            for doc_id, st in streams.items()}
    name = os.path.basename(final)
    manifest = {
        "round": int(rnd),
        "kind": kind,
        "base": base_name,
        "base_crc": base_crc,
        "chain": chain_root if kind == "delta" else name,
        "depth": depth,
        "classes": used_classes,
        "class_shapes": class_shapes,
        "delta_rows": delta_rows,
        "resident": resident,
        "spooled": spooled,
        "warm": warm,
        "docs": docs,
    }
    mtmp = os.path.join(tmp, "MANIFEST.tmp")
    with open(mtmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, separators=(",", ":"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(mtmp, os.path.join(tmp, "MANIFEST.json"))
    fsync_dir(tmp)
    os.rename(tmp, final)  # the commit point
    fsync_dir(journal_dir)

    _prune_chains(journal_dir, keep)
    return final, manifest


def _prune_chains(journal_dir: str, keep: int) -> None:  # graftlint: durable=snapshot
    """Prune committed snapshots by CHAIN (a full snapshot starts one, a
    delta whose base is the previous member continues it, anything else
    is its own group): all but the newest ``keep`` chains go, so a
    retained delta's base links always survive with it."""
    chains: list[list[str]] = []
    for n in list_snapshots(journal_dir):
        m = _read_manifest(os.path.join(journal_dir, n))
        if (m is not None and m.get("kind", "full") == "delta" and chains
                and m.get("base") == chains[-1][-1]):
            chains[-1].append(n)
        else:
            chains.append([n])
    for chain in (chains[:-keep] if keep > 0 else []):
        for n in chain:
            shutil.rmtree(os.path.join(journal_dir, n), ignore_errors=True)


def retained_floor(journal_dir: str) -> int | None:
    """The OLDEST retained snapshot's round, the WAL GC floor: chain
    fallback may land recovery on any retained snapshot, and a landing at
    round R re-applies the journaled decisions of records with ``r >=
    R``."""
    snaps = list_snapshots(journal_dir)
    return int(snaps[0][len(SNAP_PREFIX):]) if snaps else None


def list_snapshots(journal_dir: str) -> list[str]:
    """Committed snapshot directory names, oldest first (staging
    directories, ``.tmp``, are never candidates)."""
    if not os.path.isdir(journal_dir):
        return []
    return sorted(d for d in os.listdir(journal_dir)
                  if d.startswith(SNAP_PREFIX) and not d.endswith(".tmp")
                  and os.path.isdir(os.path.join(journal_dir, d)))


def _read_manifest(snap_dir: str) -> dict | None:
    try:
        with open(os.path.join(snap_dir, "MANIFEST.json"),
                  encoding="utf-8") as f:
            return json.load(f)
    except (OSError, UnicodeDecodeError, ValueError):
        return None


def chain_members(journal_dir: str, name: str,
                  manifests: dict | None = None) -> list[str]:
    """The snapshot chain ending at ``name``, root first.  Every link is
    verified (the base exists, its manifest parses, its manifest CRC is
    the one the delta recorded); a broken link raises
    :class:`ChainError`."""
    members: list[str] = []
    cur = name
    for _ in range(MAX_CHAIN_DEPTH + 1):
        if manifests is not None and cur in manifests:
            m = manifests[cur]
        else:
            m = _read_manifest(os.path.join(journal_dir, cur))
            if manifests is not None:
                manifests[cur] = m
        if m is None:
            raise ChainError(f"snapshot {cur}: unreadable manifest")
        members.append(cur)
        if m.get("kind", "full") != "delta":
            members.reverse()
            return members
        base = m.get("base")
        if not base:
            raise ChainError(f"delta {cur}: no base link")
        got = _manifest_crc(os.path.join(journal_dir, base))
        if got is None or got != m.get("base_crc"):
            raise ChainError(f"delta {cur}: base {base} manifest CRC "
                             "mismatch (chain link broken)")
        cur = base
    raise ChainError(f"snapshot {name}: chain deeper than {MAX_CHAIN_DEPTH}")


def _compose_class(journal_dir: str, members: list[str], manifests: dict,
                   cls: int) -> tuple | None:
    """One class's ``(doc, length, nvis)`` host arrays as of the chain tip:
    the full root's member (or an empty bucket when the class first
    appears in a delta) with each delta's rows overlaid in chain order.
    None when no member mentions the class; member damage raises
    :class:`CorruptCheckpointError`."""
    key = str(cls)
    state = None
    for name in members:
        m = manifests[name]
        sd = os.path.join(journal_dir, name)
        if m.get("kind", "full") != "delta":
            if int(cls) in [int(c) for c in m.get("classes", [])]:
                st = load_state(os.path.join(sd, f"class_{cls}.npz"))
                state = (np.array(st.doc, np.int32),
                         np.array(st.length, np.int32),
                         np.array(st.nvis, np.int32))
            continue
        rows = m.get("delta_rows", {}).get(key)
        if not rows:
            continue
        if state is None:
            R, C = m["class_shapes"][key]
            state = (np.full((R, C), 2, np.int32), np.zeros(R, np.int32),
                     np.zeros(R, np.int32))
        st = load_state(os.path.join(sd, f"delta_{cls}.npz"))
        doc, length, nvis = state
        d = np.asarray(st.doc, np.int32)
        rows_a = np.asarray(rows, np.int64)
        doc[rows_a, :d.shape[1]] = d
        doc[rows_a, d.shape[1]:] = 2
        length[rows_a] = np.asarray(st.length, np.int32)
        nvis[rows_a] = np.asarray(st.nvis, np.int32)
    return state


def load_chain_states(journal_dir: str, name: str,
                      manifests: dict | None = None
                      ) -> tuple[dict, dict, list[str]]:
    """Materialize snapshot ``name`` by walking its chain: ``(manifest,
    states, members)``, ``states`` the composed host arrays of every class
    the tip's residency needs.  A broken link or damaged member raises."""
    manifests = {} if manifests is None else manifests
    members = chain_members(journal_dir, name, manifests)
    tip = manifests[name]
    states = {}
    for cls in sorted({int(v[0]) for v in tip.get("resident", {}).values()}):
        st = _compose_class(journal_dir, members, manifests, cls)
        if st is None:
            raise ChainError(f"snapshot {name}: class {cls} resident but "
                             "absent from every chain member")
        states[cls] = st
    return tip, states, members


def probe_recovery(journal_dir: str) -> tuple[str | None, int]:  # graftlint: durable=snapshot
    """Dry-run recovery's snapshot selection: ``(first usable snapshot,
    candidates skipped over damage)``; ``(None, n)`` is a cold start."""
    manifests: dict = {}
    fallbacks = 0
    for snap in reversed(list_snapshots(journal_dir)):
        try:
            load_chain_states(journal_dir, snap, manifests)
        except _RECOVER_ERRORS:
            fallbacks += 1
            continue
        return snap, fallbacks
    return None, fallbacks


class SnapshotBases:
    """Cached per-doc base states across the retained snapshots, the
    rebuild path's source: ``base(doc_id)`` walks the snapshots newest
    first and returns the first intact ``(doc_row, length, nvis,
    cursor)``, or None when no snapshot holds the doc (rebuild from
    cursor 0).  A doc resident at a delta resolves through the composed
    chain; damage falls back to the next older snapshot.  Composed class
    states are cached; ``release()`` drops them."""

    def __init__(self, journal_dir: str | None):
        self.dir = journal_dir
        self._class_cache: dict[tuple, object] = {}
        self._manifests: dict[str, dict | None] = {}

    def release(self) -> None:
        """Drop cached states and manifests (a new barrier may have pruned
        old directories)."""
        self._class_cache.clear()
        self._manifests.clear()

    def _manifest(self, snap: str) -> dict | None:
        if snap not in self._manifests:
            self._manifests[snap] = _read_manifest(
                os.path.join(self.dir, snap))
        return self._manifests[snap]

    def _class_state(self, snap: str, cls: int):
        ck = (snap, int(cls))
        if ck not in self._class_cache:
            members = chain_members(self.dir, snap, self._manifests)
            st = _compose_class(self.dir, members, self._manifests, cls)
            if st is None:
                raise ChainError(f"snapshot {snap}: class {cls} absent "
                                 "from chain")
            self._class_cache[ck] = st
        return self._class_cache[ck]

    def base(self, doc_id: int):  # graftlint: durable=snapshot
        if self.dir is None:
            return None
        key = str(doc_id)
        for snap in reversed(list_snapshots(self.dir)):
            m = self._manifest(snap)
            if m is None:
                continue
            try:
                if key in m.get("resident", {}):
                    cls, row = m["resident"][key]
                    doc, length, nvis = self._class_state(snap, cls)
                    return (np.array(doc[row]), int(length[row]),
                            int(nvis[row]), int(m["docs"][key]["c"]))
                if key in m.get("spooled", {}):
                    st = load_state(os.path.join(self.dir, snap,
                                                 m["spooled"][key]))
                    return (np.array(st.doc[0]), int(st.length[0]),
                            int(st.nvis[0]), int(m["docs"][key]["c"]))
            except _RECOVER_ERRORS:
                continue  # damaged member or link: an older snapshot
        return None


# ---------------------------------------------------------------------------
# targeted rebuild: replay a stream interval, a slice at a time
# ---------------------------------------------------------------------------


def _pad_row(row: np.ndarray, C: int) -> np.ndarray:
    """A doc row at capacity ``C``: trimmed rows and smaller-class bases
    padded with the beyond-length coding ``2``."""
    row = np.asarray(row, np.int32)
    if len(row) >= C:
        return row[:C]
    return np.concatenate([row, np.full(C - len(row), 2, np.int32)])


def rebuild_doc(stream, C: int, base, target: int, *, n_init: int,
                batch: int, batch_chars: int, macro_k: int = 1,
                device: str | torch.device = "cuda"
                ) -> tuple[np.ndarray, int, int, int]:
    """Rebuild one document's row at cursor ``target`` by replaying ops
    ``[base_cursor, target)`` over ``base`` (``(doc_row, length, nvis,
    base_cursor)``, or None for a fresh row at cursor 0) on a one-row
    state on ``device``.  Each dispatch stages up to ``macro_k`` slices
    sized by ``stream.slice_end`` (the scheduler's rule) and applies them
    with ``engine/merge_fleet.py merge_rows_macro``: K1's per-row form and
    K4, one launch each a slice on a CUDA device (their plain versions on
    the CPU).  A dispatch's trailing all-PAD slices are trimmed.  Returns
    ``(doc_row[C], length, nvis, dispatches)``, ``dispatches`` the
    macro-round count (the repair's unit of time).  Ops below the base
    cursor are never re-applied: the cursor is the idempotence mark."""
    dev = resolve_device(device)
    if base is None:
        doc_row, length, nvis, c = _fresh_row_np(C, n_init), n_init, n_init, 0
    else:
        doc_row, length, nvis, c = base
        doc_row = _pad_row(doc_row, C)
    c = max(0, min(int(c), target))
    state = PackedState(
        doc=torch.from_numpy(np.ascontiguousarray(doc_row[None], np.int32)
                             ).to(dev),
        length=torch.tensor([length], dtype=torch.int32, device=dev),
        nvis=torch.tensor([nvis], dtype=torch.int32, device=dev),
    )
    K = max(1, macro_k)
    dispatches = 0
    while c < target:
        ops = np.zeros((4, K, 1, batch), np.int32)  # kind, pos, rlen, slot0
        ops[0] = PAD
        ops[3] = -1
        k = 0
        while k < K and c < target:
            e = stream.slice_end(c, batch, batch_chars, target)
            take = e - c
            for i, lane in enumerate((stream.kind, stream.pos, stream.rlen,
                                      stream.slot0)):
                ops[i, k, 0, :take] = lane[c:e]
            c = e
            k += 1
        kind, pos, rlen, slot0 = torch.from_numpy(
            np.ascontiguousarray(ops[:, :k])).to(dev)
        state = merge_rows_macro(state, kind, pos, rlen, slot0)
        dispatches += 1
    return (state.doc[0].cpu().numpy(), int(state.length[0]),
            int(state.nvis[0]), dispatches)


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------


@dataclass
class RecoveryReport:
    """What a :func:`recover_fleet` run found and did."""

    snapshot_round: int = -1  # -1 = cold start (no usable snapshot)
    snapshot_dir: str | None = None
    resume_round: int = 0
    docs_restored: int = 0  # residency and cursor restored from it
    spools_restored: int = 0
    warm_restored: int = 0
    ops_replayed: int = 0  # journal-tail redo span (snap cursor -> WAL tip)
    torn_records: int = 0  # damaged journal tail lines dropped
    quarantined: list[int] = field(default_factory=list)
    shed_ops: int = 0
    records: int = 0
    chain_depth: int = 0  # members composed for the chosen snapshot
    chain_fallbacks: int = 0  # damaged candidates skipped
    gc_segments_completed: int = 0  # torn GC finished by this recovery
    staging_removed: int = 0  # abandoned snap_*.tmp dirs swept
    # the elastic shard map: the shards kept or made retired, the docs
    # evicted off them, and whether a torn reshard was completed
    reshard_retired: list[int] = field(default_factory=list)
    reshard_docs_moved: int = 0
    reshard_completed: bool = False


@durable_protocol("snapshot")
def recover_fleet(pool, streams, journal_dir: str) -> RecoveryReport:  # graftlint: durable=snapshot
    """Restore a crashed fleet into a FRESH pool and stream set (built by
    the same ``prepare_streams`` the original run used): complete a torn
    GC pass, sweep abandoned staging directories, restore the newest
    snapshot whose chain verifies (delta, older delta, full root, older
    chain, cold start), re-apply the journaled quarantine and shed
    decisions of the tail, and leave the cursors at the chosen barrier so
    the resumed drain replays the tail through the normal macro-round
    path, and last settle the reshard state (committed reshards' shards
    retired again, a torn one rolled forward: the docs a snapshot put on
    them are evicted).  The restored buckets land on the pool's device."""
    report = RecoveryReport()
    report.gc_segments_completed = finish_torn_gc(journal_dir)
    report.staging_removed = len(sweep_staging(journal_dir))
    records, dropped = read_journal(journal_dir)
    report.torn_records = dropped
    report.records = len(records)

    manifests: dict = {}
    for snap in reversed(list_snapshots(journal_dir)):
        sd = os.path.join(journal_dir, snap)
        try:
            m, states, members = load_chain_states(journal_dir, snap,
                                                   manifests)
        except _RECOVER_ERRORS:
            report.chain_fallbacks += 1
            continue
        try:
            _restore_snapshot(pool, streams, sd, m, states)
        except _RECOVER_ERRORS:
            _reset_fleet(pool, streams)
            report.chain_fallbacks += 1
            continue
        report.snapshot_dir = sd
        report.snapshot_round = int(m["round"])
        report.docs_restored = len(m["resident"])
        report.spools_restored = len(m["spooled"])
        report.warm_restored = len(m.get("warm", {}))
        report.chain_depth = len(members)
        pool.recount_cold()  # the bulk restore wrote the spools directly
        break

    # ---- journal tail: redo span and re-applied decisions ----
    snap_round = report.snapshot_round
    high: dict[int, int] = {}
    max_r = snap_round
    for rec in records:
        r = int(rec.get("r", -1))
        if rec["t"] == "round":
            max_r = max(max_r, r)
            # a barrier's round is the clock AFTER its last round
            # advanced, so a record with r == the snapshot round was
            # journaled after the barrier: redo it
            if r < snap_round:
                continue  # durable in the snapshot
            for spans in rec["lanes"].values():
                for doc, _start, end in spans:
                    high[int(doc)] = max(high.get(int(doc), 0), int(end))
        elif rec["t"] in ("quarantine", "shed") and r >= snap_round:
            st = streams.get(int(rec["doc"]))
            if st is None:
                continue
            lim = int(rec["at"])
            st.limit = lim if st.limit is None else min(st.limit, lim)
            st.lossy = True
            report.shed_ops += int(rec.get("ops", 0))
            if rec["t"] == "quarantine":
                report.quarantined.append(int(rec["doc"]))
    for doc, hw in high.items():
        st = streams.get(doc)
        if st is None:
            continue
        report.ops_replayed += max(0, min(hw, st.n_total) - st.cursor)

    # ---- the shard map: after the restore, which placed docs by the map
    # of the snapshot's time
    rs = recover_torn_reshard(pool, journal_dir, records)
    report.reshard_retired = rs["retired"]
    report.reshard_docs_moved = rs["moved"]
    report.reshard_completed = rs["completed"]
    report.resume_round = max(0, max_r + 1)
    return report


def _reset_fleet(pool, streams) -> None:
    """Undo a partly applied snapshot restore (damage found mid-restore):
    every doc back to cold, every cursor to 0."""
    for rec in pool.docs.values():
        if rec.cls is not None:
            b = pool.buckets[rec.cls]
            b.rows[rec.row] = None
            b.release_row(rec.row)
        rec.cls = rec.row = None
        rec.spool = None  # a bulk reset: the count is derived below
        rec.length = rec.n_init
        rec.last_sched = -1
        pool.warm.take(rec.doc_id)
    pool.recount_cold()
    for st in streams.values():
        st.cursor = 0
        st.limit = None
        st.lossy = False
        if st.delivered is not None:
            st.delivered = 0


def _restore_snapshot(pool, streams, snap_dir: str, manifest: dict,
                      states: dict) -> None:
    """Apply one materialized snapshot (``states``: the chain-composed
    per-class host arrays) to a fresh pool and streams: each class's rows
    composed on the host and uploaded once.  A damaged spool or warm
    member degrades its doc to a cold restart from cursor 0 (the streams
    are deterministic); other damage raises and the caller falls back."""
    by_class: dict[int, list[tuple[int, int]]] = {}
    for key, (cls, row) in manifest["resident"].items():
        by_class.setdefault(int(cls), []).append((int(key), int(row)))
    for cls, docs in by_class.items():
        b = pool.buckets[cls]
        st_doc, st_len, st_nvis = states[cls]
        doc_w = np.full((b.R, b.C), 2, np.int32)
        len_w = np.zeros(b.R, np.int32)
        nvis_w = np.zeros(b.R, np.int32)
        for doc_id, row in docs:
            doc_w[row] = np.asarray(st_doc[row], np.int32)
            len_w[row] = int(st_len[row])
            nvis_w[row] = int(st_nvis[row])
            b.rows[row] = doc_id
            b.take_row(row)
            rec = pool.docs[doc_id]
            rec.cls, rec.row = cls, row
        pool.upload_bucket(cls, doc_w, len_w, nvis_w)
    damaged: set[int] = set()
    for key, fname in manifest["spooled"].items():
        doc_id = int(key)
        src = os.path.join(snap_dir, fname)
        try:
            load_state(src)  # verify BEFORE adopting
        except CorruptCheckpointError:
            damaged.add(doc_id)
            continue
        dst = pool.spool_path(doc_id)
        shutil.copy2(src, dst)
        # a bulk restore (no residency transition, as in JAX): the
        # caller derives the cold count once the restore is whole
        pool.docs[doc_id].spool = dst
    # warm members go back into the warm tier when the recovering pool
    # has one (shadowed by the copied member, so a later demotion is
    # free); a pool without one takes them as cold spools
    for key, fname in manifest.get("warm", {}).items():
        doc_id = int(key)
        src = os.path.join(snap_dir, fname)
        try:
            st = load_state(src)
        except CorruptCheckpointError:
            damaged.add(doc_id)
            continue
        dst = pool.spool_path(doc_id)
        shutil.copy2(src, dst)
        if pool.warm.budget > 0:
            pool.warm_restore(doc_id, np.asarray(st.doc[0], np.int32),
                              int(st.length[0]), int(st.nvis[0]),
                              shadow=dst)
        else:
            pool.docs[doc_id].spool = dst  # a bulk restore, as above
    for key, d in manifest["docs"].items():
        doc_id = int(key)
        st = streams.get(doc_id)
        if st is None:
            continue
        st.cursor = 0 if doc_id in damaged else int(d["c"])
        st.limit = d["lim"]
        st.lossy = bool(d["lossy"])
        if st.delivered is not None:
            st.delivered = st.cursor
        rec = pool.docs[doc_id]
        rec.length = rec.n_init + st.ins_before(st.cursor)
        rec.last_sched = int(manifest["round"])
