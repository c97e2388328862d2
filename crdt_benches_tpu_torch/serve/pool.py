"""DocPool: N independent documents in a few batched device states (the
JAX package's ``serve/pool.py``: its device surface and two-tier
residency).

Each row of a ``PackedState`` stack is a different document with its own
``length``/``nvis`` lane, slot-id space and op stream.  Documents are
bucketed by **capacity class** (256 / 1024 / ... slots) so a small doc
never pays a wide apply; a doc is admitted into a free row of its class,
**promoted** to a larger class before its slot need outgrows the current
one (the need is host-known, so no device sync), and **evicted** to the
checkpoint spool (``utils/checkpoint.py`` .npz, uncompressed) when its
bucket is full — a cold doc restores into any free row later.  Residency
is two-tier: device rows and the spool.

The hot path is :meth:`DocPool.macro_step`: K staged rounds of per-row
range ops for the first ``Rt`` rows of one class (a row tier from
:meth:`DocPool.tiers`; the scheduler compacts a macro-round's documents
into it), applied to the tier's row slice by one of two byte-identical
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

import heapq
import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..engine.merge_fleet import merge_rows_body
from ..ops.apply2 import LANE, PackedState
from ..ops.packing import op_lane_dtypes, widen_ops
from ..ops.resolve_range import resolve_range_rows
from ..ops.serve_fused import serve_macro_fused, serve_round_inputs
from ..utils.checkpoint import CorruptCheckpointError, load_state, save_state

I32 = torch.int32
#: The serve step's kernels: "fused" (K1's per-row form over the K rounds,
#: then one K4 launch) and "scan" (``merge_rows_body`` round by round).
SERVE_KERNELS = ("fused", "scan")


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


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place device updates cannot
    change."""
    return t.cpu().numpy().copy()


@dataclass
class DocRecord:
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
    rows are docs.  Free rows sit in a min-heap (lazily invalidated, so the
    scheduler can claim specific rows), so allocation prefers the lowest
    row and keeps the occupied set packed toward the front, which is what
    makes tier slicing effective."""

    def __init__(self, C: int, R: int, device: torch.device):
        self.C = C
        self.R = R
        self.state = PackedState(
            doc=torch.full((R, C), 2, dtype=I32, device=device),
            length=torch.zeros(R, dtype=I32, device=device),
            nvis=torch.zeros(R, dtype=I32, device=device),
        )
        self.rows: list[int | None] = [None] * R  # row -> doc_id
        self._heap = list(range(R))
        self.free: set[int] = set(range(R))

    @property
    def n_free(self) -> int:
        return len(self.free)

    def alloc_row(self) -> int:
        """The lowest free row."""
        while self._heap:
            row = heapq.heappop(self._heap)
            if row in self.free:
                self.free.discard(row)
                return row
        raise RuntimeError(f"bucket c{self.C}: no free row")

    def take_row(self, row: int) -> None:
        """Claim a specific free row (compaction relocations)."""
        if row not in self.free:
            raise RuntimeError(f"bucket c{self.C}: row {row} not free")
        self.free.discard(row)  # its heap entry is dropped lazily

    def release_row(self, row: int) -> None:
        self.free.add(row)
        heapq.heappush(self._heap, row)


class DocPool:
    """The document fleet: buckets, admit/evict/promote and the macro step.

    ``classes``: ascending capacity classes, each a multiple of 128;
    ``slots``: resident rows per class.  Buckets live on ``device`` (CUDA
    by default; the CPU only when asked).  ``serve_kernel`` names the
    serve step, one of :data:`SERVE_KERNELS`."""

    def __init__(
        self,
        classes: tuple[int, ...] = (256, 1024, 4096, 8192, 49152),
        slots: tuple[int, ...] = (2048, 512, 128, 32, 16),
        spool_dir: str | None = None,
        serve_kernel: str = "fused",
        device: str | torch.device = "cuda",
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
        self.device = resolve_device(device)
        self.serve_kernel = serve_kernel
        self.classes = tuple(classes)
        self.buckets = {
            c: Bucket(c, r, self.device) for c, r in zip(classes, slots)
        }
        self.docs: dict[int, DocRecord] = {}
        self._owns_spool = spool_dir is None
        self.spool_dir = spool_dir or tempfile.mkdtemp(prefix="crdt_serve_")
        os.makedirs(self.spool_dir, exist_ok=True)
        #: staged op-lane dtypes (ops/packing.py), static per pool
        self.op_dtypes = op_lane_dtypes(max(classes))
        self.evictions = 0
        self.restores = 0
        self.promotions = 0
        #: when a list on a CUDA pool, each macro step appends its
        #: (name, start, end) CUDA-event pairs: upload, resolve, inputs, k4
        #: (fused); upload, then a "round" span for each round (scan)
        self.spans: list | None = None

    # ---- registration / class arithmetic ----

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
        steps down from the bucket's rows, the smallest at most 4."""
        out, rt = [], self.buckets[cls].R
        while True:
            out.append(rt)
            if rt <= 4:
                break
            rt = max(rt // 4, 4)
        return sorted(out)

    # ---- row movement (host round trips, off the macro step) ----

    def _pull_row(self, rec: DocRecord) -> tuple[np.ndarray, int, int]:
        st = self.buckets[rec.cls].state
        return (_host(st.doc[rec.row]), int(st.length[rec.row]),
                int(st.nvis[rec.row]))

    def _free_row(self, rec: DocRecord) -> None:
        b = self.buckets[rec.cls]
        b.rows[rec.row] = None
        b.release_row(rec.row)
        rec.cls = rec.row = None

    def _install(self, rec: DocRecord, cls: int, doc_row: np.ndarray,
                 length: int, nvis: int) -> tuple[int, int]:
        b = self.buckets[cls]
        row = b.alloc_row()
        full = np.full(b.C, 2, np.int32)  # promotion / trimmed-spool pad
        full[:len(doc_row)] = doc_row
        b.state.doc[row] = torch.from_numpy(full).to(self.device)
        b.state.length[row] = length
        b.state.nvis[row] = nvis
        b.rows[row] = rec.doc_id
        rec.cls, rec.row = cls, row
        return cls, row

    def spool_path(self, doc_id: int) -> str:
        return os.path.join(self.spool_dir, f"doc{doc_id}.npz")

    def spool_save(self, doc_id: int, doc_row: np.ndarray, length: int,
                   nvis: int) -> str:
        """Write one doc's checkpoint (only the used ``length`` prefix;
        the tail is the constant ``2`` an install re-pads), uncompressed."""
        path = self.spool_path(doc_id)
        save_state(path, PackedState(
            doc=np.ascontiguousarray(doc_row[None, :length]),
            length=np.asarray([length], np.int32),
            nvis=np.asarray([nvis], np.int32),
        ), compress=False)
        return path

    def evict(self, doc_id: int) -> str:
        """Move a resident doc to the spool and free its row (direct pool
        users; the drain spools evictions from its own bucket pull)."""
        rec = self.docs[doc_id]
        if rec.cls is None:
            raise ValueError(f"doc {doc_id} is not resident")
        doc, length, nvis = self._pull_row(rec)
        rec.spool = self.spool_save(doc_id, doc, length, nvis)
        self._free_row(rec)
        self.evictions += 1
        return rec.spool

    def admit(self, doc_id: int, need: int) -> tuple[int, int]:
        """Make ``doc_id`` resident in the class covering ``need`` slots:
        promote it from a smaller class, restore its spool, or install it
        fresh.  The target bucket must have a free row (eviction policy is
        the scheduler's).  Returns (class, row)."""
        rec = self.docs[doc_id]
        cls = self.class_for(max(need, rec.length, 1))
        if rec.cls is not None:
            if rec.cls >= cls:
                return rec.cls, rec.row
            doc, length, nvis = self._pull_row(rec)
            self._free_row(rec)
            self.promotions += 1
            return self._install(rec, cls, doc, length, nvis)
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
            rec.spool = None  # the file stays until a re-eviction replaces it
            return out
        return self._install(rec, cls, _fresh_row_np(cls, rec.n_init),
                             rec.n_init, rec.n_init)

    # ---- boundary bulk movement (one sync, one upload per class) ----

    def pull_bucket(self, cls: int):
        """Host copies of a whole bucket (doc, length, nvis); waits for
        any macro step in flight."""
        st = self.buckets[cls].state
        return _host(st.doc), _host(st.length), _host(st.nvis)

    def upload_bucket(self, cls: int, doc: np.ndarray, length: np.ndarray,
                      nvis: np.ndarray) -> None:
        """Replace a bucket's device state from host arrays (the write
        half of a boundary compose)."""
        b = self.buckets[cls]
        if (doc.shape != (b.R, b.C) or length.shape != (b.R,)
                or nvis.shape != (b.R,)):
            raise ValueError(
                f"bucket c{cls} holds ({b.R}, {b.C}) rows; got doc "
                f"{doc.shape}, length {length.shape}, nvis {nvis.shape}")
        up = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(self.device)
        b.state = PackedState(up(doc), up(length), up(nvis))

    # ---- the hot path ----

    def macro_step(self, cls: int, kind: np.ndarray, pos: np.ndarray,
                   rlen: np.ndarray, slot0: np.ndarray, nbits: int) -> None:
        """Apply K staged rounds to the first ``Rt`` rows of class ``cls``:
        op arrays [K, Rt, B] in the pool's staged lane dtypes
        (:attr:`op_dtypes`), row r of round k the ops of the doc in row r
        (PAD lanes are no-ops), through :attr:`serve_kernel`.  ``nbits``
        (the scheduler's ``bit_length(batch_chars)``, which JAX's kernels
        need for their roll cascade) is unused: the port expands with one
        gather.  Nothing syncs."""
        del nbits
        b = self.buckets[cls]
        K, Rt, B = kind.shape
        if not 1 <= Rt <= b.R:
            raise ValueError(f"tier {Rt} incompatible with bucket {b.R}")
        spans = self.spans if self.device.type == "cuda" else None
        marks = []

        def mark(name):
            if spans is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev))

        mark("")
        ops = torch.from_numpy(np.stack(widen_ops(kind, pos, rlen, slot0)))
        kd, pd, ld, sd = ops.to(self.device).unbind(0)
        mark("upload")
        st = b.state
        sub = PackedState(st.doc[:Rt], st.length[:Rt], st.nvis[:Rt])
        if self.serve_kernel == "fused":
            tokens, dints, _ = resolve_range_rows(kd, pd, ld, sd, sub.nvis)
            mark("resolve")
            inputs = serve_round_inputs(tokens, dints, sub.length, sub.nvis)
            mark("inputs")
            new = serve_macro_fused(sub, tokens, dints, inputs=inputs,
                                    out=sub.doc)
            mark("k4")
        else:
            new = sub
            for k in range(K):
                new = merge_rows_body(new, kd[k], pd[k], ld[k], sd[k])
                mark("round")
            sub.doc.copy_(new.doc)  # the tier's rows back into the bucket
        sub.length.copy_(new.length)
        sub.nvis.copy_(new.nvis)
        if spans is not None:
            spans.extend((name, marks[i][1], ev)
                         for i, (name, ev) in enumerate(marks[1:]))

    def block(self) -> None:
        """Wait for every outstanding macro step."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- decode / verify (off the hot path) ----

    def decode(self, doc_id: int) -> str:
        """The doc's visible content, resident or spooled."""
        rec = self.docs[doc_id]
        if rec.cls is not None:
            doc, length, nvis = self._pull_row(rec)
        elif rec.spool is not None:
            st = load_state(rec.spool)
            doc, length, nvis = st.doc[0], int(st.length[0]), int(st.nvis[0])
        else:
            raise ValueError(f"doc {doc_id} was never admitted")
        return decode_row_np(doc, length, nvis, rec.chars)

    def occupancy(self) -> dict[int, float]:
        return {c: 1.0 - b.n_free / b.R for c, b in self.buckets.items()}

    def close(self) -> None:
        """Delete the spool directory if this pool created it (spooled
        docs become undecodable)."""
        if self._owns_spool and os.path.isdir(self.spool_dir):
            shutil.rmtree(self.spool_dir, ignore_errors=True)
