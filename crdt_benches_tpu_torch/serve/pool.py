"""DocPool: N independent documents in a few batched device states (the
JAX package's ``serve/pool.py``: its device surface and three-tier
residency).

Each row of a ``PackedState`` stack is a different document with its own
``length``/``nvis`` lane, slot-id space and op stream.  Documents are
bucketed by **capacity class** (256 / 1024 / ... slots) so a small doc
never pays a wide apply; a doc is admitted into a free row of its class,
**promoted** to a larger class before its slot need outgrows the current
one (the need is host-known, so no device sync), and **evicted** when its
bucket is full.  Residency has two or three tiers:

- ``warm_docs=0`` (the default): device rows and the checkpoint spool
  (``utils/checkpoint.py`` .npz, uncompressed); an evicted doc restores
  from its spool into any free row later;
- ``warm_docs > 0``: device rows (hot), host copies of evicted rows
  (:class:`WarmTier`, warm: an LRU by the round each doc was last
  scheduled) and the compressed spool (cold), which takes the warm tier's
  overflow.  With ``prefetch`` a worker thread (``serve/prefetch.py``)
  reads the cold spools of docs the scheduler will soon admit into the
  warm tier.

Every write to a device row marks it dirty (:meth:`DocPool.take_dirty`):
a delta snapshot barrier (``serve/journal.py``) persists only those rows.

A streamed fleet (``serve/scheduler.py LazyStreams``) registers its docs on
first touch: until then a doc is in **genesis** (no record anywhere,
counted by :attr:`DocPool.genesis_docs`).  A journal-less drain may reclaim
drained docs' records and spool members (:meth:`DocPool.gc_drained_docs`,
two phases behind ``SPOOL_GC_MANIFEST``, a torn pass completed by the next
pool on the directory).

With ``shards=N`` every bucket's rows are split over N logical shards
(row ``r`` on shard ``r // (R / N)``), each live, draining or retired: the
shard map ``serve/reshard.py`` changes while the fleet serves.  With
``mesh`` (``parallel/mesh.py fleet_mesh``) the shards are the mesh's: every
bucket keeps one ``(R / N, C)`` state a shard, on that shard's device
(JAX's ``fleet_sharding``), a macro step launches the kernels once a shard
on its rows in place, and the boundary moves concatenate and split the
shards in row order.

The hot path is :meth:`DocPool.macro_step`: K staged rounds of per-row
range ops for a row tier of one class (:meth:`DocPool.tiers`: the first
``Rt / N`` rows of every shard; the scheduler compacts a macro-round's
documents into it), applied to the tier's row slice by one of two byte-identical
serve kernels (``serve_kernel``).  ``"fused"`` (the default): K1's per-row
form resolves the K rounds and yields each round's starting visible count,
:func:`serve_round_inputs` derives the rounds' operands, and one launch of
K4 applies them in place.  ``"scan"``: the rounds one after another through
``engine/merge_fleet.py merge_rows_body`` (K1's per-row form and K4, each
at K = 1), then the tier's rows written back.  On a CUDA device the kernels
launch (or raise); on the CPU their plain versions run.  Nothing syncs:
callers fence with :meth:`DocPool.block` or a bucket pull.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..engine.merge_fleet import merge_rows_body
from ..lint import lifecycle_sanitizer as lifecycle
from ..lint import range_sanitizer as range_rt
from ..lint.boundary import boundary
from ..lint.fs_sanitizer import fs_protocol
from ..lint.sanitizer import fenced
from ..obs.metrics import Counter, Gauge
from ..ops.apply2 import LANE, PackedState, apply_batch3
from ..ops.packing import NARROW_ID_BOUND, op_lane_dtypes, widen_ops
from ..ops.resolve import resolve_batch_rows
from ..ops.resolve_range import resolve_range_rows
from ..ops.serve_fused import serve_macro_fused, serve_round_inputs
from ..traces.tensorize import PAD
from ..utils.checkpoint import CorruptCheckpointError, load_state, save_state
from ..utils.fsdur import fsync_dir
from .prefetch import Prefetcher

I32 = torch.int32
#: The serve step's kernels: "fused" (K1's per-row form over the K rounds,
#: then one K4 launch) and "scan" (``merge_rows_body`` round by round).
SERVE_KERNELS = ("fused", "scan")

#: The drained-doc spool GC's commit point (:meth:`DocPool.gc_drained_docs`):
#: the manifest names every member about to die, so a pass torn by a crash
#: is completed, never decided again, by the next pool on the directory.
#: Its bytes are the JAX package's, so either package completes the other's.
SPOOL_GC_MANIFEST = "SPOOL_GC_MANIFEST.json"

#: The errors a manifest read absorbs (a damaged manifest unlinks nothing).
_SPOOL_GC_ERRORS = (OSError, ValueError, KeyError, TypeError)


def _fresh_row_np(C: int, n_init: int) -> np.ndarray:
    """A fresh document row: slots 0..n_init-1 visible in order, the rest
    the beyond-length coding ``2``."""
    idx = np.arange(C, dtype=np.int32)
    return np.where(idx < n_init, ((idx + 2) << 1) | 1, 2).astype(np.int32)


def decode_row_np(doc: np.ndarray, length: int, nvis: int,
                  chars: np.ndarray) -> str:
    """The visible content of one packed doc row (host side)."""
    order = (doc[:length] >> 1) - 2
    vis = (doc[:length] & 1).astype(bool)
    slots = order[vis]
    if len(slots) != nvis:
        raise ValueError(f"decode: {len(slots)} visible chars != nvis {nvis}")
    return "".join(chr(int(c)) for c in chars[slots])


@boundary(
    dtypes=("int32", "int32", "int32", "int32"),
    shapes=(None, "R B", "R B", "R B"),
    # the port's donates: written in place (JAX's donate_argnums=(0,))
    donates=(0,),
)
def fleet_step(state: PackedState, kind, pos, slot) -> PackedState:
    """One unit-op batch a resident doc (the pre-macro step, kept as the
    minimal one-round reference): ``kind``/``pos``/``slot`` int32[R, B],
    row r the next B ops of the doc in row r (PAD everywhere for an idle
    row, a no-op end to end).  K5's per-row form resolves each row against
    its own ``nvis``, then :func:`apply_batch3` with (R, B) slots; the
    result is written into ``state``'s tensors, which are returned."""
    resolved = resolve_batch_rows(kind, pos, state.nvis)
    new = apply_batch3(state, resolved, slot)
    for x, y in zip(state, new):
        x.copy_(y)
    return state


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place device updates cannot
    change."""
    return t.cpu().numpy().copy()


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device for what runs under it (a no-op
    on the CPU): the macro step's span events record on the first shard's
    device."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _zero_state(R: int, C: int, device: torch.device) -> PackedState:
    return PackedState(
        doc=torch.full((R, C), 2, dtype=I32, device=device),
        length=torch.zeros(R, dtype=I32, device=device),
        nvis=torch.zeros(R, dtype=I32, device=device),
    )


@dataclass
class DocRecord:  # graftlint: state=doc field=spool states=live,cold edges=live->cold,cold->live
    """Host bookkeeping for one document: its length and capacity evolve
    deterministically with its stream, so the scheduler promotes and
    admits from host state alone."""

    doc_id: int
    n_init: int
    capacity_need: int  # n_init + inserted chars of the whole stream
    chars: np.ndarray  # int32[capacity_need] slot -> codepoint
    length: int = 0  # host mirror of the device length (slots used)
    cls: int | None = None  # resident capacity class (None: not resident)
    row: int | None = None
    spool: str | None = None  # checkpoint path while evicted
    last_sched: int = -1  # round last scheduled, for LRU eviction


class Bucket:
    """One capacity class: a PackedState stack of R rows of C slots whose
    rows are docs.

    Rows are split over ``n_sh`` logical shards: row ``r`` lives on shard
    ``r // Rg``.  Free rows are per-shard min-heaps of local indices
    (lazily invalidated, so the scheduler can claim specific rows), and an
    allocation takes the lowest local row on the emptiest live shard,
    which balances the shards and keeps each one's occupied set packed
    toward its front (what makes tier slicing effective).  The ``live``
    mask is the elastic shard map (``serve/reshard.py``): a draining or
    retired shard keeps its rows but never receives another doc.

    Without ``devices`` the rows are one (R, C) ``state``; with ``devices``
    (a mesh's, one a shard) they are ``parts``, shard s's (Rg, C) state on
    ``devices[s]``, and ``state`` is None."""

    def __init__(self, C: int, R: int, device: torch.device, n_sh: int = 1,
                 devices=None):
        self.C = C
        self.R = R
        self.n_sh = n_sh
        self.Rg = R // n_sh  # rows per shard
        self.state = self.parts = None
        if devices is None:
            self.state = _zero_state(R, C, device)
        else:
            self.parts = [_zero_state(self.Rg, C, d) for d in devices]
        self.rows: list[int | None] = [None] * R  # row -> doc_id
        self._heaps = [list(range(self.Rg)) for _ in range(n_sh)]
        self._free = [set(range(self.Rg)) for _ in range(n_sh)]
        self.live: list[bool] = [True] * n_sh
        self.steps = 0  # rounds applied (a fleet step 1, a macro step K)

    @property
    def free(self) -> list[int]:
        """The free global rows (a read-only view)."""
        return [s * self.Rg + r for s in range(self.n_sh)
                for r in self._free[s]]

    @property
    def n_free(self) -> int:
        return sum(len(f) for f in self._free)

    def free_locals(self, s: int) -> set[int]:
        """Shard ``s``'s free local rows."""
        return self._free[s]

    @property
    def n_free_live(self) -> int:
        """Free rows on live shards: the allocatable supply (``n_free``
        counts physical rows)."""
        return sum(len(f) for s, f in enumerate(self._free) if self.live[s])

    @property
    def live_rows(self) -> int:
        """The live shards' rows."""
        return self.Rg * sum(self.live)

    @property
    def usable_rows(self) -> int:
        """Rows a round may schedule: every live row and the occupied rows
        of draining shards (their residents serve until they migrate)."""
        return self.R - (self.n_free - self.n_free_live)

    def set_live(self, shard: int, flag: bool) -> None:
        self.live[shard] = bool(flag)

    def locate(self, row: int) -> tuple[PackedState, int]:
        """The state holding global ``row`` and the row's index in it."""
        if self.parts is None:
            return self.state, row
        s, r = divmod(row, self.Rg)
        return self.parts[s], r

    def alloc_row(self) -> int:  # graftlint: acquire=rows
        """The lowest local row on the emptiest live shard (ties: the
        lowest shard)."""
        lives = [s for s in range(self.n_sh) if self.live[s]]
        if not lives:
            raise RuntimeError(f"bucket c{self.C}: no live shard")
        s = max(lives, key=lambda i: (len(self._free[i]), -i))
        heap, free = self._heaps[s], self._free[s]
        while heap:
            r = heapq.heappop(heap)
            if r in free:
                free.discard(r)
                lifecycle.acquire("rows", (self.C, s * self.Rg + r))
                return s * self.Rg + r
        raise RuntimeError(f"bucket c{self.C}: no free row")

    def take_row(self, row: int) -> None:  # graftlint: acquire=rows
        """Claim a specific free row (compaction relocations)."""
        s, r = divmod(row, self.Rg)
        if r not in self._free[s]:
            raise RuntimeError(f"bucket c{self.C}: row {row} not free")
        self._free[s].discard(r)  # its heap entry is dropped lazily
        lifecycle.acquire("rows", (self.C, row))

    def release_row(self, row: int) -> None:  # graftlint: release=rows
        s, r = divmod(row, self.Rg)
        self._free[s].add(r)
        heapq.heappush(self._heaps[s], r)
        lifecycle.release("rows", (self.C, row))


@dataclass
class WarmEntry:
    """One warm-tier document: a packed row ready to upload (host numpy,
    trimmed to its used ``length`` prefix; the tail is the constant ``2``
    an install re-pads).  Entries never change once deposited (a doc's
    state evolves only while hot), so a ``shadow`` (an on-disk copy of
    the same bytes) stays valid for the entry's whole warm lifetime and
    makes its demotion to cold free."""

    doc_row: np.ndarray
    length: int
    nvis: int
    origin: str = "evict"  # "evict" | "prefetch" | "recover"
    shadow: str | None = None  # spool file with the same bytes, if any
    last_sched: int = -1  # LRU key: round the doc was last scheduled
    token: int = 0  # heap-entry invalidation tag


class WarmTier:
    """The bounded host tier: doc_id -> :class:`WarmEntry`, evicted least
    recently scheduled first.  The eviction heap is invalidated lazily (a
    doc deposited again gets a new token; stale heap entries are skipped
    on pop), so put, take and pop stay O(log n).  Owned by the hot thread:
    the prefetch thread never touches it."""

    def __init__(self, budget: int):
        self.budget = max(0, int(budget))
        self.entries: dict[int, WarmEntry] = {}
        self._heap: list[tuple[int, int, int]] = []  # (last_sched, doc, token)
        self._tokens = 0

    def __contains__(self, doc_id: int) -> bool:
        return doc_id in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def put(self, doc_id: int, entry: WarmEntry) -> None:
        self._tokens += 1
        entry.token = self._tokens
        self.entries[doc_id] = entry
        heapq.heappush(self._heap, (entry.last_sched, doc_id, entry.token))

    def take(self, doc_id: int) -> WarmEntry | None:
        """Remove and return the doc's entry (its heap entry goes stale)."""
        return self.entries.pop(doc_id, None)

    def pop_lru(self) -> tuple[int, WarmEntry] | None:
        """Remove and return the least recently scheduled entry."""
        while self._heap:
            _, doc_id, token = heapq.heappop(self._heap)
            e = self.entries.get(doc_id)
            if e is not None and e.token == token:
                del self.entries[doc_id]
                return doc_id, e
        return None

    def over_budget(self) -> int:
        return max(0, len(self.entries) - self.budget)


class DocPool:
    """The document fleet: buckets, admit/evict/promote and the macro step.

    ``classes``: ascending capacity classes, each a multiple of 128;
    ``slots``: resident rows per class.  Buckets live on ``device`` (CUDA
    by default; the CPU only when asked).  ``serve_kernel`` names the
    serve step, one of :data:`SERVE_KERNELS`.  ``warm_docs`` bounds the
    warm tier (0: two tiers); with a warm tier, ``prefetch`` starts the
    prefetch thread.  ``mesh`` (``parallel/mesh.py FleetMesh``) shards every
    bucket's rows over the mesh's devices (slots must divide by its size;
    ``shards``, if given, must equal it)."""

    def __init__(
        self,
        classes: tuple[int, ...] = (256, 1024, 4096, 8192, 49152),
        slots: tuple[int, ...] = (2048, 512, 128, 32, 16),
        spool_dir: str | None = None,
        serve_kernel: str = "fused",
        device: str | torch.device = "cuda",
        warm_docs: int = 0,
        prefetch: bool = True,
        shards: int | None = None,
        mesh=None,
    ):
        if serve_kernel not in SERVE_KERNELS:
            raise ValueError(f"unknown serve kernel {serve_kernel!r}")
        if len(classes) != len(slots):
            raise ValueError("classes and slots must have equal length")
        if list(classes) != sorted(set(classes)):
            raise ValueError(f"classes must be ascending/unique: {classes}")
        for c in classes:
            if c % LANE:
                raise ValueError(f"capacity class {c} not a multiple of {LANE}")
        #: logical shards of every bucket's rows (``shards``, or the mesh's
        #: size; 1 without): the elastic shard map ``serve/reshard.py``
        #: changes live
        self.n_sh = 1
        #: the mesh's device of each shard (None without a mesh)
        self.shard_devices = None
        if mesh is not None:
            n_dev = mesh.size
            for r in slots:
                if r % n_dev:
                    raise ValueError(
                        f"bucket slots {r} not divisible by mesh size {n_dev}")
            self.shard_devices = tuple(mesh.devices)
            self.n_sh = n_dev
        if shards is not None:
            if mesh is not None and shards != self.n_sh:
                raise ValueError(
                    f"shards={shards} conflicts with mesh size {self.n_sh}")
            for r in slots:
                if r % shards:
                    raise ValueError(
                        f"bucket slots {r} not divisible by shards={shards}")
            self.n_sh = shards
        #: each shard's lifecycle: live -> draining (no allocation, its
        #: residents still serve) -> retired (empty, closed); a grow revives
        self.shard_state: list[str] = ["live"] * self.n_sh
        self.device = resolve_device(device)
        if mesh is not None:
            if self.device.type != mesh.devices[0].type:
                raise ValueError(f"mesh on {mesh.devices[0].type}, pool "
                                 f"device {self.device}")
            self.device = mesh.devices[0]
        self.serve_kernel = serve_kernel
        self.classes = tuple(classes)
        self.buckets = {
            c: Bucket(c, r, self.device, self.n_sh, self.shard_devices)
            for c, r in zip(classes, slots)
        }
        self.docs: dict[int, DocRecord] = {}
        self._owns_spool = spool_dir is None
        self.spool_dir = spool_dir or tempfile.mkdtemp(prefix="crdt_serve_")
        os.makedirs(self.spool_dir, exist_ok=True)
        # a predecessor's torn drained-doc GC pass is completed before any
        # member could be read again as live state
        self.finish_torn_spool_gc()
        #: staged op-lane dtypes (ops/packing.py), static per pool
        self.op_dtypes = op_lane_dtypes(max(classes))
        # typed counters (obs/metrics.py), attached to a drain's registry
        # by bind_metrics; the int properties below read and write them:
        # evictions, restores (admissions that read a cold spool),
        # promotions, fresh_admits (admissions installed from the initial
        # text), warm_hits (admissions served from the warm tier),
        # warm_evictions (warm-to-cold demotions) and prefetch_hits (warm
        # hits the prefetcher deposited)
        self._counters = {
            name: Counter("serve.pool." + name)
            for name in ("evictions", "restores", "promotions",
                         "fresh_admits")}
        for name in ("warm_hits", "warm_evictions", "prefetch_hits"):
            self._counters[name] = Counter("serve.tier." + name)
        #: the residency gauges, refreshed once a round by the scheduler
        #: (:meth:`update_tier_gauges`)
        self._gauges = {
            name: Gauge("serve.tier." + name)
            for name in ("hot_rows", "warm_docs", "cold_docs",
                         "genesis_docs", "prefetch_inflight")}
        self.warm = WarmTier(warm_docs)
        #: per-doc spool write generation, bumped at every spool_save: a
        #: prefetch read that raced a re-eviction is stale
        self._spool_gens: dict[int, int] = {}
        #: docs whose live copy is a spool; every ``rec.spool`` write goes
        #: through :meth:`_set_spool`, which keeps this count (a recovery's
        #: bulk restore writes them directly and calls :meth:`recount_cold`)
        self._n_cold = 0
        # the doc residency machine's legal graph (JAX's): armed runs
        # enforce it, every run counts its edges (the lifecycle block)
        lifecycle.declare_machine(
            "doc", ("live", "cold"), (("live", "cold"), ("cold", "live")))
        #: when a list on a CUDA pool, each macro step appends its
        #: (name, start, end) CUDA-event pairs: upload, resolve, inputs, k4
        #: (fused); upload, then a "round" span for each round (scan)
        self.spans: list | None = None
        self.prefetcher: Prefetcher | None = None
        if warm_docs > 0 and prefetch:
            self.prefetcher = Prefetcher()
            self.prefetcher.start()
        #: rows whose device content changed since the last snapshot
        #: barrier, per class: a delta snapshot persists exactly these
        #: rows, and the barrier consumes the set (:meth:`take_dirty`)
        self._dirty: dict[int, set[int]] = {c: set() for c in classes}
        #: docs the fleet specifies that have no record yet (streaming
        #: construction's genesis residency; 0 for an eager fleet)
        self._n_genesis = 0

    def bind_metrics(self, registry) -> None:
        """Attach the pool's counters and gauges to a drain's
        ``MetricsRegistry`` (the same objects: the pool keeps counting
        through them)."""
        for m in (*self._counters.values(), *self._gauges.values()):
            registry.attach(m)

    def _counter(name):  # a class-body helper: the int view of a counter
        def get(self) -> int:
            return self._counters[name].value

        def put(self, v: int) -> None:
            self._counters[name].value = int(v)
        return property(get, put)

    evictions = _counter("evictions")
    restores = _counter("restores")
    promotions = _counter("promotions")
    fresh_admits = _counter("fresh_admits")
    warm_hits = _counter("warm_hits")
    warm_evictions = _counter("warm_evictions")
    prefetch_hits = _counter("prefetch_hits")
    del _counter

    # ---- dirty tracking (the delta snapshots' substrate) ----

    def note_rows_dirty(self, cls: int, rows) -> None:
        """Mark rows of ``cls`` as touched since the last barrier."""
        self._dirty[cls].update(int(r) for r in rows)

    def take_dirty(self) -> dict[int, list[int]]:
        """Consume the dirty set: ``{cls: sorted rows}`` for the classes
        with a dirty row, cleared as a unit (every snapshot barrier, full
        or delta, is the reset point)."""
        out = {c: sorted(s) for c, s in self._dirty.items() if s}
        for s in self._dirty.values():
            s.clear()
        return out

    def dirty_rows(self, cls: int) -> set[int]:
        """A copy of the class's dirty rows."""
        return set(self._dirty[cls])

    def _mark_op_rows(self, cls: int, kind: np.ndarray) -> None:
        """Mark the rows a staged (K, Rt, B) op array touches: a row whose
        every lane is PAD is a no-op end to end and stays clean.  A tier's
        row ``r`` is local row ``r % rt`` of shard ``r // rt``."""
        b = self.buckets[cls]
        rt = kind.shape[1] // b.n_sh
        self._dirty[cls].update(
            (int(r) // rt) * b.Rg + int(r) % rt
            for r in np.flatnonzero((kind != PAD).any(axis=(0, 2))))

    # ---- registration / class arithmetic ----

    def set_genesis_population(self, n: int) -> None:
        """Arm genesis residency (streaming construction): ``n`` docs exist
        in the fleet's spec with nothing anywhere, not even a record.  Each
        first :meth:`register` of a doc takes one off."""
        self._n_genesis = max(0, int(n))

    @property
    def genesis_docs(self) -> int:
        """Docs the fleet specifies that were never materialized."""
        return self._n_genesis

    def register(self, doc_id: int, n_init: int, capacity_need: int,
                 chars: np.ndarray) -> DocRecord:
        if capacity_need > self.classes[-1]:
            raise ValueError(
                f"doc {doc_id}: capacity need {capacity_need} exceeds the "
                f"largest class {self.classes[-1]}"
            )
        rec = DocRecord(doc_id=doc_id, n_init=n_init,
                        capacity_need=capacity_need,
                        chars=np.asarray(chars, np.int32), length=n_init)
        if doc_id not in self.docs and self._n_genesis > 0:
            self._n_genesis -= 1
        self.docs[doc_id] = rec
        return rec

    def class_for(self, need: int) -> int:
        for c in self.classes:
            if need <= c:
                return c
        raise ValueError(f"slot need {need} exceeds largest class")

    def residents(self, cls: int) -> list[tuple[int, int]]:
        """(doc_id, row) pairs resident in class ``cls``."""
        return [(d, r) for r, d in enumerate(self.buckets[cls].rows)
                if d is not None]

    def tiers(self, cls: int) -> list[int]:
        """Row-count tiers a macro step may run on, ascending: factor-4
        steps down from the bucket's rows, the smallest at most 4 local
        rows a shard.  A tier of ``Rt`` rows is the first ``Rt / n_sh``
        local rows of every shard."""
        b = self.buckets[cls]
        out, rt = [], b.Rg
        while True:
            out.append(rt * b.n_sh)
            if rt <= 4:
                break
            rt = max(rt // 4, 4)
        return sorted(out)

    def tier_rows(self, cls: int, Rt: int) -> PackedState:
        """The tier's rows of class ``cls`` as one (Rt, C) state: a view of
        the bucket's first ``Rt`` rows on one shard or at the full tier, a
        gathered copy of every shard's first ``Rt / n_sh`` rows
        otherwise (on the first shard's device under a mesh)."""
        b = self.buckets[cls]
        if b.parts is not None:
            rt = Rt // b.n_sh
            return PackedState(*(
                torch.cat([x[:rt].to(self.device) for x in xs])
                for xs in zip(*b.parts)))
        st = b.state
        if b.n_sh == 1 or Rt == b.R:
            return PackedState(st.doc[:Rt], st.length[:Rt], st.nvis[:Rt])
        rt = Rt // b.n_sh
        take = lambda x: x.view(b.n_sh, b.Rg, *x.shape[1:])[:, :rt].reshape(
            Rt, *x.shape[1:])
        return PackedState(take(st.doc), take(st.length), take(st.nvis))

    def _put_tier(self, cls: int, Rt: int, new: PackedState) -> None:
        """Write a gathered tier (:meth:`tier_rows`) back into its rows."""
        b = self.buckets[cls]
        rt = Rt // b.n_sh
        for x, y in zip(b.state, new):
            x.view(b.n_sh, b.Rg, *x.shape[1:])[:, :rt].copy_(
                y.view(b.n_sh, rt, *y.shape[1:]))

    # ---- row movement (host round trips, off the macro step) ----

    @fenced
    def _pull_row(self, rec: DocRecord) -> tuple[np.ndarray, int, int]:  # graftlint: fence
        st, r = self.buckets[rec.cls].locate(rec.row)
        return _host(st.doc[r]), int(st.length[r]), int(st.nvis[r])

    def _free_row(self, rec: DocRecord) -> None:
        b = self.buckets[rec.cls]
        b.rows[rec.row] = None
        b.release_row(rec.row)
        rec.cls = rec.row = None

    def _install(self, rec: DocRecord, cls: int, doc_row: np.ndarray,
                 length: int, nvis: int) -> tuple[int, int]:
        b = self.buckets[cls]
        row = b.alloc_row()
        # graftlint: inrange=row<nrows check=pool.write-row
        range_rt.check_index("pool.write-row", row, len(b.rows),
                             doc=rec.doc_id, cls=cls)
        full = np.full(b.C, 2, np.int32)  # promotion / trimmed-spool pad
        full[:len(doc_row)] = doc_row
        st, r = b.locate(row)
        st.doc[r] = torch.from_numpy(full).to(st.doc.device)
        st.length[r] = length
        st.nvis[r] = nvis
        b.rows[row] = rec.doc_id
        rec.cls, rec.row = cls, row
        self._dirty[cls].add(row)
        return cls, row

    def spool_path(self, doc_id: int) -> str:
        return os.path.join(self.spool_dir, f"doc{doc_id}.npz")

    def _set_spool(self, rec: DocRecord, path: str | None) -> None:  # graftlint: transition=doc:live->cold,cold->live
        """The one place ``rec.spool`` changes: a doc entering or leaving
        the cold tier moves the O(1) :attr:`cold_docs` count."""
        if (rec.spool is None) != (path is None):
            if path is not None:
                self._n_cold += 1
                lifecycle.transition("doc", "live", "cold", key=rec.doc_id)
            else:
                self._n_cold -= 1
                lifecycle.transition("doc", "cold", "live", key=rec.doc_id)
        rec.spool = path

    def recount_cold(self) -> int:
        """Derive the cold count again from the records (and keep it)."""
        self._n_cold = sum(1 for rec in self.docs.values()
                           if rec.spool is not None)
        return self._n_cold

    def spool_gen(self, doc_id: int) -> int:
        """The doc's spool write generation (bumped by every spool_save):
        the staleness tag a prefetch submission carries."""
        return self._spool_gens.get(doc_id, 0)

    def spool_save(self, doc_id: int, doc_row: np.ndarray, length: int,  # graftlint: durable=spool
                   nvis: int, compress: bool = False) -> str:
        """Write one doc's checkpoint (only the used ``length`` prefix;
        the tail is the constant ``2`` an install re-pads).  Uncompressed
        unless ``compress``: the cold tier's writes (warm-to-cold
        demotions, direct evictions with a warm tier) are compressed."""
        path = self.spool_path(doc_id)
        save_state(path, PackedState(
            doc=np.ascontiguousarray(doc_row[None, :length]),
            length=np.asarray([length], np.int32),
            nvis=np.asarray([nvis], np.int32),
        ), compress=compress)
        self._spool_gens[doc_id] = self._spool_gens.get(doc_id, 0) + 1
        return path

    @fenced
    def evict(self, doc_id: int) -> str:  # graftlint: fence=cold
        """Move a resident doc to the spool and free its row (direct pool
        users; the drain moves evictions from its own bucket pull)."""
        rec = self.docs[doc_id]
        if rec.cls is None:
            raise ValueError(f"doc {doc_id} is not resident")
        doc, length, nvis = self._pull_row(rec)
        self._set_spool(rec, self.spool_save(
            doc_id, doc, length, nvis, compress=self.warm.budget > 0))
        self._free_row(rec)
        self.evictions += 1
        return rec.spool

    # ---- drained-doc record eviction (two-phase, manifest-committed) ----

    def gc_drained_docs(self, doc_ids) -> int:  # graftlint: durable=spool
        """Reclaim drained docs: the pool record, the spool member (the
        live claim, or the stale file a restore or warm hit leaves behind)
        and any warm entry and its shadow.  Two phases, as the journal's
        segment GC: the manifest naming every member is committed first
        (temp file, fsync, replace), then the members go, then the
        manifest; :meth:`finish_torn_spool_gc` completes a pass a crash
        tore.  Resident ids (and unknown or repeated ones) are skipped.
        Returns the number of docs reclaimed."""
        victims: list[tuple[int, list[str]]] = []
        seen: set[int] = set()
        for d in doc_ids:
            rec = self.docs.get(d)
            if rec is None or rec.cls is not None or d in seen:
                continue
            seen.add(d)
            paths: list[str] = []
            if rec.spool is not None:
                paths.append(rec.spool)
            elif os.path.exists(self.spool_path(d)):
                paths.append(self.spool_path(d))  # stale leftover
            e = self.warm.take(d)
            if e is not None and e.shadow and e.shadow not in paths:
                paths.append(e.shadow)
            victims.append((d, paths))
        if not victims:
            return 0
        manifest = os.path.join(self.spool_dir, SPOOL_GC_MANIFEST)
        tmp = manifest + ".tmp"
        members = sorted({p for _d, ps in victims for p in ps})
        with fs_protocol("spool"):
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": 1,
                           "members": [os.path.basename(p) for p in members]},
                          f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, manifest)  # the commit point
            fsync_dir(self.spool_dir)
            for p in members:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            os.unlink(manifest)
            fsync_dir(self.spool_dir)
        for d, _paths in victims:
            rec = self.docs.pop(d)
            self._set_spool(rec, None)
            self._spool_gens.pop(d, None)
        return len(victims)

    def finish_torn_spool_gc(self) -> int:
        """Complete a predecessor's torn spool GC pass: a committed
        manifest is finished (the members it names unlinked, then the
        manifest), a staged ``.tmp`` never committed and rolls back.
        Called by the constructor; returns the members removed."""
        manifest = os.path.join(self.spool_dir, SPOOL_GC_MANIFEST)
        tmp = manifest + ".tmp"
        if not (os.path.exists(manifest) or os.path.exists(tmp)):
            return 0
        with fs_protocol("spool"):
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)  # uncommitted: rolls back
                except OSError:
                    pass
            if not os.path.exists(manifest):
                return 0
            try:
                with open(manifest, encoding="utf-8") as f:
                    names = json.load(f)["members"]
            except _SPOOL_GC_ERRORS:
                names = []
            done = 0
            for name in names:
                p = os.path.join(self.spool_dir, os.path.basename(str(name)))
                if os.path.exists(p):
                    try:
                        os.unlink(p)
                        done += 1
                    except OSError:
                        pass
            try:
                os.unlink(manifest)
            except OSError:
                pass
            fsync_dir(self.spool_dir)
        return done

    def admit(self, doc_id: int, need: int) -> tuple[int, int]:
        """Make ``doc_id`` resident in the class covering ``need`` slots:
        promote it from a smaller class, compose its warm entry, restore
        its spool, or install it fresh.  The target bucket must have a
        free row (eviction policy is the scheduler's).  Returns (class,
        row)."""
        rec = self.docs[doc_id]
        cls = self.class_for(max(need, rec.length, 1))
        if rec.cls is not None:
            if rec.cls >= cls:
                return rec.cls, rec.row
            doc, length, nvis = self._pull_row(rec)
            self._free_row(rec)
            self.promotions += 1
            return self._install(rec, cls, doc, length, nvis)
        entry = self.take_warm_hit(doc_id)
        if entry is not None:
            return self._install(rec, cls, entry.doc_row, entry.length,
                                 entry.nvis)
        if rec.spool is not None:
            try:
                st = load_state(rec.spool)
            except CorruptCheckpointError as e:
                raise CorruptCheckpointError(
                    f"doc {doc_id}: eviction spool damaged: {e}"
                ) from e
            self.restores += 1
            out = self._install(rec, cls, st.doc[0], int(st.length[0]),
                                int(st.nvis[0]))
            # cleared only once the doc is resident, so it is never
            # without a copy; the file stays until a re-eviction's
            # atomic save replaces it
            self._set_spool(rec, None)
            return out
        self.fresh_admits += 1
        return self._install(rec, cls, _fresh_row_np(cls, rec.n_init),
                             rec.n_init, rec.n_init)

    # ---- the warm tier (host rows; owned by the hot thread) ----

    def take_warm_hit(self, doc_id: int) -> WarmEntry | None:
        """The warm-hit rule of :meth:`admit` and the scheduler's plan:
        remove the doc's warm entry (a memory compose follows, no disk
        read), count the hit and clear the doc's spool claim (a shadow
        file stays behind, stale, until the next eviction replaces it).
        None when the doc is not warm."""
        entry = self.warm.take(doc_id)
        if entry is None:
            return None
        self.warm_hits += 1
        if entry.origin == "prefetch":
            self.prefetch_hits += 1
        self._set_spool(self.docs[doc_id], None)
        return entry

    def warm_deposit(self, doc_id: int, doc_row: np.ndarray, length: int,
                     nvis: int, origin: str = "evict",
                     last_sched: int = -1) -> int:
        """Deposit an evicted doc into the warm tier (a trimmed host copy,
        no disk write) and keep the budget: the overflow demotes the least
        recently scheduled entries to the compressed spool.  Returns the
        number demoted."""
        rec = self.docs[doc_id]
        self.warm.put(doc_id, WarmEntry(
            doc_row=np.array(doc_row[:length], np.int32),
            length=int(length), nvis=int(nvis), origin=origin,
            last_sched=last_sched if last_sched >= 0 else rec.last_sched,
        ))
        return self._enforce_warm_budget()

    def _enforce_warm_budget(self, extra: int = 0) -> int:
        """Demote the warm tier's overflow and ``extra`` more entries, least
        recently scheduled first, to cold: free for an entry with a shadow,
        one compressed spool write otherwise.  Returns the number
        demoted."""
        demoted = 0
        for _ in range(self.warm.over_budget() + max(0, extra)):
            hit = self.warm.pop_lru()
            if hit is None:
                break
            doc_id, e = hit
            self._set_spool(self.docs[doc_id], e.shadow if e.shadow
                            is not None else self.spool_save(
                                doc_id, e.doc_row, e.length, e.nvis,
                                compress=True))
            self.warm_evictions += 1
            demoted += 1
        return demoted

    def warm_pressure(self, n: int) -> int:
        """Force-demote up to ``n`` warm entries to cold (the
        ``tier_evict_pressure`` fault: warm-tier churn under load).
        Returns the number demoted."""
        return self._enforce_warm_budget(extra=min(n, len(self.warm)))

    def store_prefetched(self, doc_id: int, doc_row: np.ndarray,
                         length: int, nvis: int, round_no: int,
                         gen: int | None = None) -> bool:
        """Adopt one harvested prefetch payload into the warm tier.  A doc
        that is hot, already warm or not cold keeps its state and the
        payload is refused, as is a payload whose spool generation moved.
        The doc's spool becomes the entry's shadow (the same bytes).  The
        entry's LRU key is ``round_no``, the round it was fetched for, so
        it outranks stale entries; the overflow past the budget is demoted
        at the next boundary moves, where disk writes belong."""
        rec = self.docs.get(doc_id)
        if (rec is None or rec.cls is not None or doc_id in self.warm
                or rec.spool is None):
            return False
        if gen is not None and self.spool_gen(doc_id) != gen:
            return False  # the read raced a re-eviction
        shadow = rec.spool
        self._set_spool(rec, None)
        self.warm.put(doc_id, WarmEntry(
            doc_row=doc_row[:length], length=int(length), nvis=int(nvis),
            origin="prefetch", shadow=shadow, last_sched=int(round_no),
        ))
        return True

    def warm_restore(self, doc_id: int, doc_row: np.ndarray, length: int,
                     nvis: int, shadow: str | None) -> None:
        """A recovered doc's warm residency comes back warm, with its
        snapshot copy as the shadow (so its demotion is free)."""
        rec = self.docs[doc_id]
        self._set_spool(rec, None)
        self.warm.put(doc_id, WarmEntry(
            doc_row=np.asarray(doc_row[:length], np.int32),
            length=int(length), nvis=int(nvis), origin="recover",
            shadow=shadow, last_sched=rec.last_sched,
        ))
        self._enforce_warm_budget()

    def ensure_warm_shadow(self, doc_id: int) -> str:
        """The warm entry's on-disk copy (a compressed spool write), which a
        snapshot barrier adopts as it adopts a cold spool.  Written once in
        the entry's warm lifetime: entries never change, so the shadow
        never goes stale."""
        e = self.warm.entries[doc_id]
        if e.shadow is None:
            e.shadow = self.spool_save(doc_id, e.doc_row, e.length, e.nvis,
                                       compress=True)
        return e.shadow

    @property
    def cold_docs(self) -> int:
        """Docs whose only live copy is a cold spool (O(1))."""
        return self._n_cold

    @property
    def hot_rows(self) -> int:
        """Occupied device rows across every class."""
        return sum(b.R - b.n_free for b in self.buckets.values())

    def update_tier_gauges(self) -> None:
        """Refresh the residency gauges (the scheduler, once a round: host
        arithmetic on pre-registered gauges)."""
        g = self._gauges
        g["hot_rows"].set(self.hot_rows)
        g["warm_docs"].set(len(self.warm))
        g["cold_docs"].set(self.cold_docs)
        g["genesis_docs"].set(self._n_genesis)
        g["prefetch_inflight"].set(
            self.prefetcher.inflight if self.prefetcher is not None else 0)

    def tier_status(self) -> dict:
        """The residency in small scalars (``/status.json``)."""
        pf = self.prefetcher
        return {
            "hot_rows": self.hot_rows,
            "hot_budget": sum(b.R for b in self.buckets.values()),
            "warm_docs": len(self.warm),
            "warm_budget": self.warm.budget,
            "cold_docs": self.cold_docs,
            "genesis_docs": self._n_genesis,
            "warm_hits": self.warm_hits,
            "warm_evictions": self.warm_evictions,
            "cold_restores": self.restores,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_inflight": pf.inflight if pf is not None else 0,
            "prefetch_submitted": pf.submitted if pf is not None else 0,
            "prefetch_dropped": pf.dropped if pf is not None else 0,
        }

    # ---- boundary bulk movement (one sync, one upload per class) ----

    @fenced
    def pull_bucket(self, cls: int):  # graftlint: fence
        """Host copies of a whole bucket (doc, length, nvis), the shards
        concatenated in row order under a mesh; waits for any macro step
        in flight."""
        b = self.buckets[cls]
        if b.parts is not None:
            return tuple(np.concatenate([_host(x) for x in xs])
                         for xs in zip(*b.parts))
        st = b.state
        return _host(st.doc), _host(st.length), _host(st.nvis)

    def upload_bucket(self, cls: int, doc: np.ndarray, length: np.ndarray,
                      nvis: np.ndarray, dirty_rows=None) -> None:
        """Replace a bucket's device state from host arrays (the write
        half of a boundary compose).  ``dirty_rows`` scopes the delta
        snapshots' dirty marks to the rows the compose rewrote; None marks
        every row (never wrong)."""
        b = self.buckets[cls]
        if (doc.shape != (b.R, b.C) or length.shape != (b.R,)
                or nvis.shape != (b.R,)):
            raise ValueError(
                f"bucket c{cls} holds ({b.R}, {b.C}) rows; got doc "
                f"{doc.shape}, length {length.shape}, nvis {nvis.shape}")
        if dirty_rows is None:
            dirty_rows = range(b.R)
        else:
            dirty_rows = [int(r) for r in dirty_rows]
            # the scheduler's batched install writes these rows: the row
            # bound of _install, under the same check name
            # graftlint: inrange=row<nrows check=pool.write-row
            range_rt.check_index("pool.write-row", dirty_rows, len(b.rows),
                                 cls=cls)
            if any(not 0 <= r < b.R for r in dirty_rows):
                raise ValueError(
                    f"bucket c{cls}: dirty rows outside [0, {b.R})")
        self._dirty[cls].update(int(r) for r in dirty_rows)
        up = lambda a, dev: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(dev)
        if b.parts is not None:  # each shard's rows to its device
            g = b.Rg
            b.parts = [PackedState(*(up(a[s * g:(s + 1) * g], dev)
                                     for a in (doc, length, nvis)))
                       for s, dev in enumerate(self.shard_devices)]
            return
        b.state = PackedState(up(doc, self.device), up(length, self.device),
                              up(nvis, self.device))

    # ---- the hot paths ----

    def step(self, cls: int, kind: np.ndarray, pos: np.ndarray,
             slot: np.ndarray) -> None:
        """Apply one (R, B) unit-op batch to class ``cls`` through
        :func:`fleet_step` (row r the ops of the doc resident in row r;
        PAD rows are no-ops).  The ops upload without blocking; under a
        mesh each shard's rows step on its device.  Nothing syncs."""
        b = self.buckets[cls]
        self._mark_op_rows(cls, kind[None])
        ops = np.stack([np.asarray(a, np.int32)
                        for a in (kind, pos, slot)])[:, None]  # (3, 1, R, B)
        states = b.parts if b.parts is not None else [b.state]
        devs = self.shard_devices or [self.device]
        for state, lanes, dev in zip(states, self._piece_ops(b, ops), devs):
            with _on(dev):
                fleet_step(state, *(o[0] for o in lanes))
        b.steps += 1

    def _piece_ops(self, b: Bucket, ops: np.ndarray) -> list:
        """The op lanes ``ops`` (L, K, Rt, B) uploaded without blocking, as
        each piece's L (K, Rt / pieces, B) tensors: one piece, on the
        pool's device, without a mesh; under a mesh one piece a shard (JAX's
        P(None, AXIS, None)), each device given its own shards' ops only."""
        if b.parts is None:
            return [torch.from_numpy(ops).to(
                self.device, non_blocking=True).unbind(0)]
        L, K, Rt, B = ops.shape
        n, rt = b.n_sh, Rt // b.n_sh
        host = torch.from_numpy(np.ascontiguousarray(
            ops.reshape(L, K, n, rt, B).transpose(2, 0, 1, 3, 4)))
        pieces = [None] * n
        for d in dict.fromkeys(self.shard_devices):
            mine = [s for s, e in enumerate(self.shard_devices) if e == d]
            up = (host if len(mine) == n else host[mine]).to(
                d, non_blocking=True)
            for s, o in zip(mine, up):
                pieces[s] = o.unbind(0)
        return pieces

    @boundary(
        # the op lanes arrive in the pool's staged dtypes (op_dtypes), so
        # the contract pins the (K, Rt, B) layout only
        dtypes=(),
        shapes=(None, None, "K R B", "K R B", "K R B", "K R B"),
    )
    def macro_step(self, cls: int, kind: np.ndarray, pos: np.ndarray,
                   rlen: np.ndarray, slot0: np.ndarray, nbits: int) -> None:
        """Apply K staged rounds to the tier of ``Rt`` rows of class ``cls``
        (:meth:`tier_rows`): op arrays [K, Rt, B] in the pool's staged lane
        dtypes (:attr:`op_dtypes`), row r of round k the ops of the doc in
        the tier's row r (PAD lanes are no-ops), through
        :attr:`serve_kernel`.  ``nbits``
        (the scheduler's ``bit_length(batch_chars)``, which JAX's kernels
        need for their roll cascade) is unused: the port expands with one
        gather.  Under a mesh the tier splits into its shards' first
        ``Rt / N`` rows, and each phase launches once a shard on its device
        in place (no gather, no write-back).  Nothing syncs."""
        del nbits
        b = self.buckets[cls]
        K, Rt, B = kind.shape
        if not 1 <= Rt <= b.R or Rt % b.n_sh:
            raise ValueError(f"tier {Rt} incompatible with bucket {b.R} "
                             f"over {b.n_sh} shards")
        self._mark_op_rows(cls, kind)
        # the staged lanes' bounds: host numpy, before the dispatch, PAD
        # lanes masked out (their payloads are don't-care).  Disarmed, two
        # counter bumps; armed, the check the kernels cannot make
        # graftlint: inrange=pos<=cap check=pool.macro-pos
        range_rt.check_index("pool.macro-pos", lambda: pos[kind != PAD],
                             b.C + 1, cls=cls)
        # the narrow ladder's ceiling is the uint16 repack's; a wide
        # ladder's ids are bounded by the class capacity
        narrow = self.op_dtypes[3] == np.dtype(np.uint16)
        # graftlint: inrange=slot0<=NARROW_ID_BOUND check=pool.macro-ids
        range_rt.check_narrow("pool.macro-ids", lambda: slot0[kind != PAD],
                              NARROW_ID_BOUND if narrow else b.C - 1,
                              cls=cls)
        # both serve kernels count below a clamped bound (JAX's mask tags)
        range_rt.note_mask("count-le-clamp")
        if self.serve_kernel == "fused":
            range_rt.note_mask("fused-gap-gather")
        spans = self.spans if self.device.type == "cuda" else None
        marks = []

        def mark(name):  # on the first shard's device under a mesh
            if spans is not None:
                with _on(self.device):
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                marks.append((name, ev))

        mark("")
        # (4, K, Rt, B): one piece, the tier's rows, or one a shard
        piece_ops = self._piece_ops(b, np.stack(
            widen_ops(kind, pos, rlen, slot0)))
        mark("upload")
        if b.parts is None:
            subs = [self.tier_rows(cls, Rt)]
        else:  # each shard's first Rt / N rows, in place
            rt = Rt // b.n_sh
            subs = [PackedState(p.doc[:rt], p.length[:rt], p.nvis[:rt])
                    for p in b.parts]
        # every piece launches before anything syncs; the ops launch on
        # their operands' device
        if self.serve_kernel == "fused":
            res = [resolve_range_rows(kd, pd, ld, sd, sub.nvis)
                   for sub, (kd, pd, ld, sd) in zip(subs, piece_ops)]
            mark("resolve")
            inputs = [serve_round_inputs(tokens, dints, sub.length, sub.nvis)
                      for sub, (tokens, dints, _) in zip(subs, res)]
            mark("inputs")
            news = [serve_macro_fused(sub, tokens, dints, inputs=inp,
                                      out=sub.doc)
                    for sub, (tokens, dints, _), inp in zip(subs, res,
                                                            inputs)]
            mark("k4")
        else:
            news = list(subs)
            for k in range(K):
                news = [merge_rows_body(new, kd[k], pd[k], ld[k], sd[k])
                        for new, (kd, pd, ld, sd) in zip(news, piece_ops)]
                mark("round")
            for sub, new in zip(subs, news):
                sub.doc.copy_(new.doc)  # the tier's rows back into the bucket
        for sub, new in zip(subs, news):
            sub.length.copy_(new.length)
            sub.nvis.copy_(new.nvis)
        if b.parts is None and b.n_sh > 1 and Rt < b.R:
            self._put_tier(cls, Rt, subs[0])  # the gathered tier back
        b.steps += K
        if spans is not None:
            spans.extend((name, marks[i][1], ev)
                         for i, (name, ev) in enumerate(marks[1:]))

    @fenced
    def block(self) -> None:  # graftlint: fence
        """Wait for every outstanding macro step (on every shard's device
        under a mesh)."""
        if self.device.type == "cuda":
            for d in dict.fromkeys(self.shard_devices or (self.device,)):
                torch.cuda.synchronize(d)

    # ---- decode / verify (off the hot path) ----

    def decode(self, doc_id: int) -> str:
        """The doc's visible content: resident, warm or spooled."""
        rec = self.docs[doc_id]
        if rec.cls is not None:
            doc, length, nvis = self._pull_row(rec)
        elif doc_id in self.warm:
            e = self.warm.entries[doc_id]
            doc, length, nvis = e.doc_row, e.length, e.nvis
        elif rec.spool is not None:
            st = load_state(rec.spool)
            doc, length, nvis = st.doc[0], int(st.length[0]), int(st.nvis[0])
        else:
            raise ValueError(f"doc {doc_id} was never admitted")
        return decode_row_np(doc, length, nvis, rec.chars)

    def occupancy(self) -> dict[int, float]:
        return {c: 1.0 - b.n_free / b.R for c, b in self.buckets.items()}

    def shard_occupancy(self) -> list[int]:
        """Occupied rows per shard over every class; their sum is the
        fleet's resident-doc count."""
        out = [0] * self.n_sh
        for b in self.buckets.values():
            for s in range(b.n_sh):
                out[s] += b.Rg - len(b.free_locals(s))
        return out

    # ---- the elastic shard map (serve/reshard.py drives these) ----

    @property
    def live_shard_count(self) -> int:
        return sum(1 for s in self.shard_state if s == "live")

    def docs_on_shard(self, shard: int) -> list[tuple[int, int, int]]:
        """``(doc_id, cls, row)`` of every resident of ``shard``, read from
        the bucket row tables (the ground truth, not the records)."""
        out: list[tuple[int, int, int]] = []
        for cls, b in self.buckets.items():
            base = shard * b.Rg
            out.extend((d, cls, base + r)
                       for r, d in enumerate(b.rows[base:base + b.Rg])
                       if d is not None)
        return out

    def drain_shard(self, shard: int) -> None:
        """live -> draining: allocation on the shard stops now, its
        residents serve until the reshard coordinator moves them.
        Idempotent (recovery drains again)."""
        if self.shard_state[shard] == "retired":
            raise ValueError(f"shard {shard} already retired")
        self.shard_state[shard] = "draining"
        for b in self.buckets.values():
            b.set_live(shard, False)

    def retire_shard(self, shard: int) -> None:
        """draining -> retired: the shard must be empty in every class."""
        occupied = len(self.docs_on_shard(shard))
        if occupied:
            raise RuntimeError(
                f"shard {shard}: {occupied} residents, cannot retire")
        self.shard_state[shard] = "retired"

    def revive_shard(self, shard: int) -> None:
        """-> live (a grow): the shard allocates again in every class."""
        self.shard_state[shard] = "live"
        for b in self.buckets.values():
            b.set_live(shard, True)

    def close(self) -> None:
        """Stop the prefetch thread, then delete the spool directory if
        this pool created it (spooled docs become undecodable)."""
        if self.prefetcher is not None:
            self.prefetcher.stop()
        if self._owns_spool and os.path.isdir(self.spool_dir):
            shutil.rmtree(self.spool_dir, ignore_errors=True)
