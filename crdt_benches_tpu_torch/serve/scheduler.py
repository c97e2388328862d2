"""Admission and batching scheduler of the document fleet: macro-rounds
(the JAX package's ``serve/scheduler.py``: its core drain, its tiered
residency, its journal and its fault tolerance).

Every macro-round each active capacity class gets one ``(K_eff, Rt, B)``
range-op tensor — K_eff staged rounds of up to B ops for the doc in each
of the first Rt rows, idle lanes PAD — applied by ONE ``pool.macro_step``.
Residency is decided once per K rounds; the host plans and stages round
m+1 while round m runs on the device, and the only syncs are the boundary
bucket pulls when rows move and the final fence.  Streams are run-length
coalesced range ops, and each round's scheduled docs are compacted into
the lowest row tier that holds them.

Policy (deterministic, host only; the same fleet gives JAX's plans: the
same lanes, row placements, evictions, restores and promotions):

- **round robin**: active docs are served in FIFO order and rotate to the
  back once scheduled;
- **class selection**: a doc's slot need after its next K slices is
  host-known, so it is promoted before the round that would overflow it;
- **eviction**: a selected doc whose bucket has no free row evicts a
  resident not selected this round — finished docs first, then the least
  recently scheduled — to the pool's checkpoint spool, or, with a warm
  tier, to the warm tier (whose overflow goes to the compressed spool);
- **arrival**: each doc becomes active at its session's arrival round;
- **streaming construction** (``streams`` a :class:`LazyStreams`): the
  rotation is fed from the spec's arrival order as rounds reach each doc,
  and nothing exists for a doc (no session, stream or pool record: genesis
  residency) until it is first selected or a construct prefetch built its
  stream off the drain; a journal-less drain releases a drained doc's op
  arrays, and ``drained_gc`` reclaims its pool record and spool members in
  batches at the boundary (``DocPool.gc_drained_docs``);
- **prefetch** (warm tier with a prefetcher): after each round's moves
  the cold docs at the front of the rotation are submitted to the
  prefetch thread, and the loaded rows are adopted into the warm tier at
  the start of the next round, before it is planned;
- **write-ahead journal** (``journal``, ``serve/journal.py``): each
  round's lane set is journaled after its plan and before its stage and
  dispatch, and every ``snapshot_every`` rounds a snapshot barrier (a
  full one every ``snapshot_full_every``-th time, a delta of the dirty
  rows between) bounds the redo tail, followed by the WAL's GC pass.
  Crash recovery is ``journal.recover_fleet``; the resumed scheduler
  starts its clock at ``start_round``.

Fault tolerance (``faults``, a ``serve/faults.py`` FaultInjector polled at
fixed points of each round):

- **bounded queues** (``queue_cap > 0``): a doc's pending window is capped
  and delivery past the cap is an explicit decision, **defer** (producer
  backpressure, nothing lost: ``deferred_ops``) or **shed** (the session's
  remaining ops tail-dropped, the doc lossy and left out of verification:
  ``shed_ops``);
- **in-run repair**: a spool that fails its CRC at restore, or a class
  whose device state is lost right after its dispatch, is rebuilt from the
  last snapshot base and the stream (``journal.rebuild_doc``, K1's per-row
  form and K4 on the pool's device); a doc whose rebuild also fails is
  **quarantined** (its remaining ops shed, its row freed);
- **degradation**: after ``degrade_after`` faults inside
  ``degrade_window`` rounds the scheduler plans K = 1 rounds, fenced each,
  for ``degrade_rounds`` rounds, then restores K;
- **idempotent admission**: the cursor is the delivery high-water mark, so
  a duplicated batch is clamped and dropped (``dup_ops_dropped``);
- **logical shards** (a pool built with ``shards=``): a tier is the first
  rows of every shard, installs balance the live shards, and ``reshard``
  (``serve/reshard.py ReshardCoordinator``) is ticked each round after the
  plan and before its WAL record, its migrations joining the round's
  boundary moves; a draining shard's residents still serve (on top of the
  live-row cap) and are never eviction or shed victims.

Telemetry (``obs/``): :class:`ServeStats` keeps its per-round series in the
drain's ``MetricsRegistry`` (fixed-bucket histograms of round latency,
occupancy, queue depth and per-cause doc drain latency), and the pool,
journal and fault counters attach to it; every phase of a round is a span
of the tracer (a shared no-op unless armed) and a segment of the request
tracker (``reqtrace``, the admission-timestamp table unless armed); each
admission opens a request and each drained doc closes it under a cause
tag; ``telemetry`` (``obs/timeseries.py ServeTelemetry``) takes one sample
a round (time-series windows, the status endpoint, the anomaly detectors,
the flight recorder) and the durability and recovery events.

The macro depth of a class's tensor trims exactly to its deepest lane (the
JAX host form's rule): nothing in the port is keyed by K.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from functools import partial

import numpy as np

from ..lint import lifecycle_sanitizer as lifecycle
from ..lint.sanitizer import entries_total, fenced, hot_path
from ..obs.metrics import (
    DEPTH_BUCKETS,
    LATENCY_BUCKETS_S,
    OCCUPANCY_BUCKETS,
    Histogram,
    MetricsRegistry,
)
from ..obs.reqtrace import RequestTracker
from ..obs.trace import span
from ..ops.packing import pack_ops
from ..traces.tensorize import INSERT, PAD, split_insert_runs, tensorize_ranges
from ..utils.checkpoint import CorruptCheckpointError, load_state
from .journal import (
    SnapshotBases,
    _read_manifest,
    list_snapshots,
    probe_recovery,
    rebuild_doc,
    retained_floor,
    write_snapshot,
)
from .pool import DocPool, _fresh_row_np


@dataclass
class DocStream:
    """One doc's pending op queue: coalesced range ops, insert runs split
    to at most ``batch_chars`` chars, in the pool's packed lane dtypes,
    with a cursor.  ``limit`` truncates the stream (a quarantine or shed
    decision) and ``lossy`` marks a doc whose ops were shed, which
    verification leaves out.  Under a bounded queue ``delivered`` is how
    far the producer has pushed ops into the pending window (None: the
    whole stream), ``burst`` the producer's ops a round and
    ``deferred_high`` the highest op index ever refused."""

    doc_id: int
    kind: np.ndarray  # [N] range ops
    pos: np.ndarray
    rlen: np.ndarray
    slot0: np.ndarray
    ins_cum: np.ndarray  # int32[N] inclusive cumulative inserted chars
    unit_cum: np.ndarray  # int32[N] inclusive cumulative unit-op count
    n_patches: int
    arrival: int = 0
    cursor: int = 0
    delivered: int | None = None  # bounded-queue fill point (None: all)
    limit: int | None = None  # stream truncation (shed / quarantine)
    lossy: bool = False
    burst: int | None = None  # producer delivery rate (ops/round)
    deferred_high: int = 0  # highest op index ever backpressured

    @property
    def n_total(self) -> int:
        """Stream length after any truncation."""
        n = len(self.kind)
        return n if self.limit is None else min(self.limit, n)

    @property
    def remaining(self) -> int:
        return self.n_total - self.cursor

    @property
    def n_sched(self) -> int:
        """Ops the scheduler may take: up to the bounded queue's fill
        point (the whole stream when unbounded)."""
        if self.delivered is None:
            return self.n_total
        return min(self.n_total, self.delivered)

    def ins_before(self, i: int) -> int:
        """Inserted chars in ops [0, i)."""
        return int(self.ins_cum[i - 1]) if i > 0 else 0

    def units_before(self, i: int) -> int:
        return int(self.unit_cum[i - 1]) if i > 0 else 0

    def slice_end(self, c: int, batch: int, batch_chars: int,
                  n: int) -> int:
        """End cursor of ONE device slice starting at ``c`` (bounded by
        ``n``): up to ``batch`` ops and ``batch_chars`` inserted chars (ops
        are pre-split, so at least one always fits).  THE slice-budget
        rule: the scheduler's staging (``_sim_takes``) and the recovery
        replayer (``journal.rebuild_doc``) must size slices identically,
        so both call here."""
        hi = min(c + batch, n)
        cap = self.ins_before(c) + batch_chars
        e = c + int(np.searchsorted(self.ins_cum[c:hi], cap, side="right"))
        return max(e, c + 1)

    def clamp_redelivery(self, start: int, end: int) -> int:
        """Admit a (re)delivered batch ``[start, end)``: ops below the
        applied cursor are duplicates (or stale reorders) and are dropped,
        the cursor being the idempotence high-water mark.  Returns the
        dropped-op count; the stream always continues from ``cursor``."""
        return max(0, min(end, self.cursor) - max(0, start))


def _tensorize_trace(trace, batch_chars: int, max_class: int) -> tuple:
    """One trace -> packed coalesced range-op arrays, their cumulative
    insert and unit-op counts, and the range tensorization (for the init
    and capacity metadata)."""
    rt = tensorize_ranges(trace, batch=1, coalesce=True)
    n = rt.n_ops
    kind, pos, rlen, slot0 = split_insert_runs(
        rt.kind[:n], rt.pos[:n], rt.rlen[:n], rt.slot0[:n], batch_chars,
    )
    # slot0 is read only for INSERT ops; the tensorizer's -1 on deletes
    # would fail the unsigned lane's range check
    slot0 = np.where(kind == INSERT, slot0, 0)
    arrays = pack_ops(kind, pos, rlen, slot0, max_class=max_class)
    ins_cum = np.cumsum(
        np.where(arrays[0] == INSERT, arrays[2], 0)).astype(np.int32)
    unit_cum = np.cumsum(arrays[2]).astype(np.int32)
    return arrays, ins_cum, unit_cum, rt


def build_stream_payload(spec, doc_id: int, batch_chars: int,
                         max_class: int) -> dict:
    """One doc's session and tensorized stream as a dict of numpy arrays
    and ints: the construct payload.  Pure: everything derives from the
    frozen ``FleetSpec`` and the scalars, so the prefetch thread can run it
    (``Prefetcher.submit_construct``).  Array keys carry an ``_a`` suffix,
    clear of the payload envelope's ``kind``."""
    s = spec.session(doc_id)
    (kind, pos, rlen, slot0), ins_cum, unit_cum, rt = _tensorize_trace(
        s.trace, batch_chars, max_class)
    return {
        "kind_a": kind, "pos_a": pos, "rlen_a": rlen, "slot0_a": slot0,
        "ins_cum": ins_cum, "unit_cum": unit_cum,
        "n_patches": rt.n_patches, "n_init": len(rt.init_chars),
        "capacity": rt.capacity, "chars": rt.chars,
        "arrival": s.arrival, "burst": s.burst,
    }


def prepare_streams(sessions, pool: DocPool, batch: int = 64,
                    batch_chars: int = 256) -> dict[int, DocStream]:
    """Tensorize every session's trace, register the docs with the pool
    and return the per-doc op queues.  Sessions sharing one trace object
    (a band's template window) share its tensorized arrays.  ``batch`` is
    accepted for the JAX signature; slices are sized by the scheduler."""
    del batch
    streams: dict[int, DocStream] = {}
    cache: dict[int, tuple] = {}  # id(trace) -> (trace, tensorized)
    for s in sessions:
        hit = cache.get(id(s.trace))
        if hit is None or hit[0] is not s.trace:
            hit = cache[id(s.trace)] = (s.trace, _tensorize_trace(
                s.trace, batch_chars, max(pool.classes)))
        (kind, pos, rlen, slot0), ins_cum, unit_cum, rt = hit[1]
        pool.register(s.doc_id, n_init=len(rt.init_chars),
                      capacity_need=rt.capacity, chars=rt.chars)
        streams[s.doc_id] = DocStream(
            doc_id=s.doc_id, kind=kind, pos=pos, rlen=rlen, slot0=slot0,
            ins_cum=ins_cum, unit_cum=unit_cum, n_patches=rt.n_patches,
            arrival=s.arrival, burst=s.burst,
        )
    return streams


#: The arrays of a released stream: a drained doc's DocStream keeps its
#: identity (the victim picker and the fault paths index it) and drops its
#: op arrays for these shared empty ones.
_EMPTY_I32 = np.zeros(0, np.int32)


class LazyStreams:
    """The op queues of a fleet as a mapping over a ``FleetSpec``, each
    stream materialized on first touch: streaming construction.  A doc
    has nothing (no session, trace, stream or pool record: genesis) until
    then, so construction and host memory scale with the active set.

    The scheduler's mapping surface: ``[]`` (materializes), ``get`` (does
    not), ``in``, ``len`` and ``keys`` over the whole fleet; ``values()``
    and ``items()`` over the live (materialized) streams only.  A stream
    is built on the hot thread (:meth:`__getitem__`), or on the prefetch
    thread (:meth:`builder`) and installed by :meth:`adopt`;
    :meth:`release` swaps a drained stream's arrays for shared empty ones.
    A stream walks the lifecycle sanitizer's ``stream`` machine (genesis,
    live, released), and its two materialization edges are fences of the
    sync sanitizer, as in JAX."""

    def __init__(self, spec, pool: DocPool, batch: int = 64,
                 batch_chars: int = 256):
        self.spec = spec
        self.pool = pool
        self.batch = batch
        self.batch_chars = batch_chars
        self.bounded = False  # a bounded queue: delivered = cursor at birth
        self._live: dict[int, DocStream] = {}
        self._tcache: dict = {}  # (band, trace name) -> tensorized
        self.materialized = 0
        self.released = 0
        self.prefetch_built = 0  # streams adopted from the thread
        self.patches_total = 0  # n_patches over the materialized docs
        pool.set_genesis_population(spec.n_docs)
        # the stream machine's legal graph (JAX's): a doc's op queue is
        # built once and released once
        lifecycle.declare_machine(
            "stream", ("genesis", "live", "released"),
            (("genesis", "live"), ("live", "released")))

    # ---- the mapping surface ----

    def __len__(self) -> int:
        return self.spec.n_docs

    def __contains__(self, doc_id) -> bool:
        return 0 <= int(doc_id) < self.spec.n_docs

    def keys(self):
        return range(self.spec.n_docs)

    def values(self):
        """The live streams (materialized, released stubs included)."""
        return self._live.values()

    def items(self):
        return self._live.items()

    def get(self, doc_id, default=None):
        """The live stream, or ``default``; never materializes."""
        if doc_id is None:
            return default
        return self._live.get(int(doc_id), default)

    def __getitem__(self, doc_id: int) -> DocStream:
        st = self._live.get(doc_id)
        if st is None:
            st = self._materialize(self.spec.session(doc_id))
        return st

    # ---- materialization ----

    @fenced
    def _install(self, st: DocStream, n_init: int, capacity: int,
                 chars) -> DocStream:
        lifecycle.transition("stream", "genesis", "live", key=st.doc_id)
        self.pool.register(st.doc_id, n_init=n_init, capacity_need=capacity,
                           chars=chars)
        if self.bounded and st.delivered is None:
            st.delivered = st.cursor
        self._live[st.doc_id] = st
        self.materialized += 1
        self.patches_total += st.n_patches
        return st

    @fenced
    def _materialize(self, s) -> DocStream:
        # a trace band's docs share one lru-cached window, so its
        # tensorization is cached by (band, trace); synth traces are one
        # a doc and transient, so they are never cached (an id(trace) key
        # would be poisoned once a freed trace's id is recycled)
        if s.source == "synth":
            hit = _tensorize_trace(s.trace, self.batch_chars,
                                   max(self.pool.classes))
        else:
            key = (s.band, s.source)
            hit = self._tcache.get(key)
            if hit is None:
                hit = self._tcache[key] = _tensorize_trace(
                    s.trace, self.batch_chars, max(self.pool.classes))
        (kind, pos, rlen, slot0), ins_cum, unit_cum, rt = hit
        return self._install(
            DocStream(doc_id=s.doc_id, kind=kind, pos=pos, rlen=rlen,
                      slot0=slot0, ins_cum=ins_cum, unit_cum=unit_cum,
                      n_patches=rt.n_patches, arrival=s.arrival,
                      burst=s.burst),
            n_init=len(rt.init_chars), capacity=rt.capacity, chars=rt.chars)

    def builder(self, doc_id: int):
        """The construct callable for the prefetch thread: a ``partial``
        over :func:`build_stream_payload` and immutable inputs (never a
        closure over this object)."""
        return partial(build_stream_payload, self.spec, int(doc_id),
                       self.batch_chars, max(self.pool.classes))

    def adopt(self, doc_id: int, payload: dict) -> bool:
        """Install a stream the thread built.  False when superseded: the
        doc materialized on the hot thread while the build ran."""
        if doc_id in self._live:
            return False
        self._install(
            DocStream(doc_id=doc_id, kind=payload["kind_a"],
                      pos=payload["pos_a"], rlen=payload["rlen_a"],
                      slot0=payload["slot0_a"], ins_cum=payload["ins_cum"],
                      unit_cum=payload["unit_cum"],
                      n_patches=payload["n_patches"],
                      arrival=payload["arrival"], burst=payload["burst"]),
            n_init=payload["n_init"], capacity=payload["capacity"],
            chars=payload["chars"])
        self.prefetch_built += 1
        return True

    def release(self, doc_id: int) -> None:
        """Drop a drained doc's op arrays, keeping the stream object.
        Idempotent; a doc never materialized is left alone."""
        st = self._live.get(doc_id)
        if st is None or st.kind is _EMPTY_I32:
            return
        lifecycle.transition("stream", "live", "released", key=doc_id)
        st.kind = st.pos = st.rlen = st.slot0 = _EMPTY_I32
        st.ins_cum = st.unit_cum = _EMPTY_I32
        st.cursor = 0
        st.limit = None
        if st.delivered is not None:
            st.delivered = 0
        self.released += 1

    @property
    def all_done(self) -> bool:
        """Every doc materialized at least once, and every live one
        drained."""
        return (self.materialized >= self.spec.n_docs
                and all(s.remaining == 0 for s in self._live.values()))


#: Host phases of a macro-round, timed by the host clock; a pool with a
#: prefetcher adds "prefetch" (the harvest and the submissions), a
#: journaled drain "wal" (the round record) and "snapshot" (the barriers),
#: a drain with a fault injector "faults" (the injection hooks; repairs
#: count in the phase they run in: spool heals in "moves", device-loss
#: rebuilds and the degraded fence in "dispatch").
PHASES = ("plan", "stage", "moves", "dispatch")

#: Cause tags of the per-doc admission-to-drain latency series: how the
#: doc's stream ended.  A fixed set, pre-registered.
DOC_CAUSE_TAGS = ("ok", "deferred", "shed", "quarantined")


@dataclass
class ServeStats:
    """One drain's counters and telemetry.

    The per-round series live in fixed-bucket histograms of
    :attr:`metrics` (O(buckets) however long the drain), and
    :meth:`note_round` is the one place a round is classified: a compile
    round (never in the port: nothing compiles per shape, so
    ``macro_step`` reports none) or a snapshot-barrier round goes to
    ``lat_skipped``, every other to ``lat_steady``.  ``keep_raw`` (tests)
    also keeps the raw per-round lists."""

    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    keep_raw: bool = False
    raw_round_latencies: list[float] = field(default_factory=list)
    raw_compile_flags: list[bool] = field(default_factory=list)
    raw_barrier_flags: list[bool] = field(default_factory=list)
    rounds: int = 0  # macro-rounds dispatched
    compile_time: float = 0.0  # wall time of compile-flagged rounds
    compile_rounds: int = 0
    barrier_time: float = 0.0  # wall time of snapshot-barrier rounds
    barrier_rounds: int = 0
    slices: int = 0  # device rounds (sum of K_eff per class)
    ops: int = 0  # coalesced range ops applied
    unit_ops: int = 0  # unit-op equivalent (sum of run lengths)
    staged_cells: int = 0  # op slots staged across all macro tensors
    patches: int = 0
    evictions: int = 0
    restores: int = 0
    promotions: int = 0
    admissions: int = 0
    dispatches: int = 0  # macro steps (one per active class and round)
    wall_time: float = 0.0
    phase_seconds: dict[str, float] = field(
        default_factory=lambda: dict.fromkeys(PHASES, 0.0))
    snapshots: int = 0
    snapshots_full: int = 0  # chain-rooting full barriers
    snapshots_delta: int = 0  # dirty-row delta barriers
    snapshot_time: float = 0.0  # seconds in write_snapshot
    # ---- fault tolerance and degradation ----
    shed_ops: int = 0  # ops dropped by an explicit shed decision
    deferred_ops: int = 0  # ops backpressured at the bounded queue cap
    overflow_events: int = 0
    backpressure_rounds: int = 0
    dup_ops_dropped: int = 0  # duplicated or stale redeliveries clamped
    stall_rounds: int = 0
    quarantines: list[dict] = field(default_factory=list)
    recoveries: int = 0  # in-run repairs (spool heal / device loss)
    ops_replayed: int = 0  # ops re-applied by the repairs
    replay_dispatches: int = 0
    mttr_rounds: list[int] = field(default_factory=list)  # per recovery
    degraded_rounds: int = 0  # macro-rounds served at K = 1
    faults_seen: int = 0  # faults the engine observed
    faults_injected: int = 0  # events the injector fired

    def __post_init__(self):
        m = self.metrics
        self.lat_steady = m.histogram("serve.round.latency.steady",
                                      LATENCY_BUCKETS_S)
        self.lat_skipped = m.histogram("serve.round.latency.skipped",
                                       LATENCY_BUCKETS_S)
        self.occupancy = m.histogram("serve.round.occupancy",
                                     OCCUPANCY_BUCKETS)
        self.queue_depth = m.histogram("serve.round.queue_depth",
                                       DEPTH_BUCKETS)
        self.doc_latency = {
            tag: m.histogram("serve.doc.drain_latency." + tag,
                             LATENCY_BUCKETS_S)
            for tag in DOC_CAUSE_TAGS}

    def note_round(self, latency: float, compiled: bool,
                   barrier: bool) -> None:
        """Record one macro-round: THE classification rule (compile and
        barrier rounds are kept out of the steady histogram and accounted
        apart)."""
        self.rounds += 1
        if compiled:
            self.compile_time += latency
            self.compile_rounds += 1
            self.lat_skipped.observe(latency)
        elif barrier:
            self.barrier_time += latency
            self.barrier_rounds += 1
            self.lat_skipped.observe(latency)
        else:
            self.lat_steady.observe(latency)
        if self.keep_raw:
            self.raw_round_latencies.append(latency)
            self.raw_compile_flags.append(compiled)
            self.raw_barrier_flags.append(barrier)

    @property
    def steady_rounds(self) -> int:
        return self.lat_steady.count

    def latency_quantiles(self, ps=(0.5, 0.95, 0.99)) -> dict[str, float]:
        """Steady-round latency quantiles from the histogram (within a
        bucket's ~21%), or of every round when every round was skipped."""
        if self.lat_steady.count:
            return self.lat_steady.quantiles(ps)
        if self.lat_skipped.count:
            return Histogram.merged(self.lat_steady,
                                    self.lat_skipped).quantiles(ps)
        return {f"p{100 * p:g}": 0.0 for p in ps}

    @property
    def coalesce_ratio(self) -> float:
        """Unit ops per staged range op (>= 1)."""
        return self.unit_ops / self.ops if self.ops else 1.0

    @property
    def pad_fraction(self) -> float:
        """PAD share of the staged op slots after row compaction."""
        if not self.staged_cells:
            return 0.0
        return 1.0 - self.ops / self.staged_cells

    def note_doc_drained(self, tag: str, seconds: float) -> None:
        """One doc's stream ended: its admission-to-drain latency under
        its cause tag."""
        self.doc_latency[tag].observe(seconds)


@dataclass
class _Lane:
    stream: DocStream
    takes: list[int]  # range ops consumed per slice (len <= K)
    end: int  # cursor after the macro-round
    row: int = -1


@dataclass
class _Plan:
    base_round: int
    lanes: dict[int, list[_Lane]] = field(default_factory=dict)
    k_eff: dict[int, int] = field(default_factory=dict)
    rt: dict[int, int] = field(default_factory=dict)
    # data movement, planned on the host and executed at the boundary
    pull_classes: set[int] = field(default_factory=set)
    evictions: list[tuple[int, int, int]] = field(default_factory=list)
    # warm-mode victims whose state stays in their old bucket row until
    # the moves: a larger class selecting such a doc this round pulls it
    # from there (see _place), and its eviction is cancelled
    limbo: dict[int, tuple[int, int]] = field(default_factory=dict)
    cancelled_evictions: set[int] = field(default_factory=set)
    # target class -> [(doc_id, row, source)]; source is ("fresh",),
    # ("warm", entry), ("spool", path) or ("pull", src_cls, src_row)
    installs: dict[int, list[tuple[int, int, tuple]]] = field(
        default_factory=dict)
    #: arrived, undrained docs this round could not schedule
    waiting: int = 0


class FleetScheduler:
    def __init__(self, pool: DocPool, streams: dict[int, DocStream],
                 batch: int = 64, macro_k: int = 1, batch_chars: int = 256,
                 queue_cap: int = 0, overflow_policy: str = "defer",
                 faults=None, journal=None, snapshot_every: int = 0,
                 snapshot_keep: int = 2, snapshot_full_every: int = 4,
                 degrade_after: int = 3, degrade_window: int = 8,
                 degrade_rounds: int = 4, start_round: int = 0,
                 telemetry=None, reqtrace=None, slo=None,
                 drained_gc: bool = False, gc_keep=None, reshard=None,
                 profiler=None):
        if overflow_policy not in ("defer", "shed"):
            raise ValueError(f"unknown overflow policy {overflow_policy!r}")
        self.pool = pool
        self.streams = streams
        self.batch = batch
        self.macro_k = max(1, macro_k)
        self.batch_chars = batch_chars
        self.nbits = max(1, int(batch_chars).bit_length())
        self.round = start_round
        self.queue_cap = max(0, queue_cap)
        self.overflow_policy = overflow_policy
        self.faults = faults  # serve/faults.py FaultInjector (or None)
        self.journal = journal  # serve/journal.py OpJournal (or None)
        self.snapshot_every = snapshot_every
        self.snapshot_keep = snapshot_keep
        #: every Nth barrier is a chain-rooting full snapshot, the ones
        #: between deltas (<= 1: every barrier full)
        self.snapshot_full_every = max(0, snapshot_full_every)
        self._barrier_count = 0
        self._pending_gc_ev = None  # crash_compact fired, GC pass torn
        self.degrade_after = degrade_after
        self.degrade_window = degrade_window
        self.degrade_rounds = degrade_rounds
        self._bases = SnapshotBases(journal.dir if journal else None)
        self._fault_rounds: deque[int] = deque()
        self._degrade_left = 0  # K = 1 rounds still to serve
        self._planned_degraded = False  # this round was planned at K = 1
        self._k_round = self.macro_k  # the macro depth frozen per plan
        self._dead_lanes: set[int] = set()  # quarantined mid-round
        self._bp_round = False  # a delivery was refused this round
        self._n_rounds = 0  # macro-rounds advanced by this scheduler
        self._lazy = isinstance(streams, LazyStreams)
        if self._lazy:
            # streaming construction: the rotation is fed from the
            # arrival-sorted order as rounds reach each doc's arrival
            streams.bounded = self.queue_cap > 0
            arr = streams.spec.arrivals.astype(np.int64)
            self._order = np.argsort(arr, kind="stable")
            self._order_arrivals = arr[self._order]
            self._order_ptr = 0
            self._rr: deque[int] = deque()  # arrived ids with pending ops
            self._arrivals_sorted = self._order_arrivals
            # the patch total is known once every doc materialized: run()
            # fills it in at the drain's end
            self.stats = ServeStats(patches=0)
        else:
            # FIFO of doc ids not yet arrived or with pending ops, in
            # arrival order (stable for determinism)
            self._rr = deque(sorted(
                streams, key=lambda d: (streams[d].arrival, d)))
            # the static arrival schedule and the ended set are the O(1)
            # inputs of _select's count of the unscanned tail's waiting
            # docs (arrived and not drained)
            self._arrivals_sorted = np.sort(np.fromiter(
                (st.arrival for st in streams.values()), dtype=np.int64,
                count=len(streams)))
            if self.queue_cap > 0:
                for st in streams.values():
                    if st.delivered is None:
                        st.delivered = st.cursor
            self.stats = ServeStats(
                patches=sum(s.n_patches for s in streams.values()))
        self._ended: set[int] = set()  # docs whose stream ended
        # drained-doc record eviction (two-phase spool GC): journal-less
        # drains only, since recovery reads snapshot members in the spool
        if drained_gc and journal is not None:
            raise ValueError(
                "drained-doc GC requires a journal-less drain "
                "(recovery re-adopts spool members)"
            )
        self.drained_gc = drained_gc
        self._gc_keep = set(gc_keep or ())
        self._gc_queue: list[int] = []
        self.spool_gc_docs = 0  # records and members reclaimed so far
        # predictive prefetch (a pool with a prefetcher): doc ->
        # (submit round, seq) of the reads in flight, so reads whose
        # results never arrive are reaped by seq
        self._prefetch_inflight: dict[int, tuple[int, int]] = {}
        #: the rotation's front scanned for cold docs each round
        self._prefetch_lookahead = max(
            32, sum(b.R for b in pool.buckets.values()))
        self.prefetch_wasted = 0  # harvested but stale or superseded
        self.prefetch_missed = 0  # planned but dropped (prefetch_miss)
        self.limbo_pulls = 0  # same-round victim-to-promotion pulls
        if pool.prefetcher is not None:
            self.stats.phase_seconds["prefetch"] = 0.0
        if journal is not None:
            self.stats.phase_seconds["wal"] = 0.0
            self.stats.phase_seconds["snapshot"] = 0.0
        if faults is not None:
            self.stats.phase_seconds["faults"] = 0.0
        # the round held until the next round (or the drain's end) records
        # it, so run() folds the final fence into the last round's latency
        self._pending_round: tuple[float, bool, bool] | None = None
        # request lifecycle (obs/reqtrace.py): disarmed, the admission-
        # timestamp table; armed, a request context an episode with its
        # phase segments
        self.reqtrace = reqtrace if reqtrace is not None \
            else RequestTracker()
        self.slo = slo  # obs/slo.py SloTracker (or None)
        #: obs/profiler.py DeviceProfiler (or None): its capture window
        #: opens and closes at round boundaries
        self.profiler = profiler
        #: the last round's class for the profiler (None: no work left)
        self._steady: bool | None = None
        # one registry a drain: the pool's, journal's and faults' metrics
        # attach to it, so the report's metrics block holds the whole run
        reg = self.stats.metrics
        pool.bind_metrics(reg)
        if journal is not None:
            journal.bind_metrics(reg)
        if faults is not None:
            faults.bind_metrics(reg)
        if slo is not None:
            slo.bind(reg)  # the burn-rate gauges, pre-registered
        #: the live shard-map change (serve/reshard.py ReshardCoordinator),
        #: ticked once a round between the plan and its WAL record
        self.reshard = reshard
        if reshard is not None:
            reshard.bind_metrics(reg)  # the serve.reshard.* series
        self.reqtrace.bind(self.stats)
        self._m_faults_seen = reg.counter("serve.faults.seen")
        # the durability gauges: the newest barrier's delta-chain depth and
        # the round of the last completed WAL compaction
        self._g_chain_depth = reg.gauge("serve.durability.chain_depth")
        self._g_last_compact = reg.gauge(
            "serve.durability.last_compaction_round")
        # continuous telemetry (obs/timeseries.py ServeTelemetry, or None)
        self.telemetry = telemetry
        self._last_occ = 0.0
        self._last_queue = 0
        self._sh_lanes = [0] * pool.n_sh
        self._sh_ops = [0] * pool.n_sh
        self._sh_units = [0] * pool.n_sh
        if telemetry is not None:
            telemetry.bind(pool, reg, reqtrace=self.reqtrace)

    # ---- degradation (macro-K falls back to K = 1) ----

    @property
    def effective_k(self) -> int:
        """The macro depth of the next planned round: 1 while degraded."""
        return 1 if self._degrade_left > 0 else self.macro_k

    def _note_fault(self) -> None:
        """Track the fault density: ``degrade_after`` faults inside
        ``degrade_window`` rounds trip (or extend) the K = 1 fallback for
        ``degrade_rounds`` dispatched rounds, from the next planned round
        on (journaled as a ``degrade`` event)."""
        self.stats.faults_seen += 1
        self._m_faults_seen.inc()
        self._fault_rounds.append(self.round)
        while (self._fault_rounds
               and self._fault_rounds[0] < self.round - self.degrade_window):
            self._fault_rounds.popleft()
        if (self.macro_k > 1 and self.degrade_after > 0
                and len(self._fault_rounds) >= self.degrade_after
                and self._degrade_left < self.degrade_rounds):
            self._degrade_left = self.degrade_rounds
            if self.journal:
                self.journal.event("degrade", r=self.round,
                                   rounds=self.degrade_rounds)

    # ---- bounded-queue delivery (backpressure is explicit) ----

    def _push_delivery(self, st: DocStream, want: int) -> int:
        """THE bounded-queue admission rule: a producer push is clamped at
        ``queue_cap`` pending ops, each refused op counted once (by the
        ``deferred_high`` mark) in ``deferred_ops``.  The per-round
        delivery and the overflow fault both come here.  Returns the
        deferred excess."""
        lim = st.cursor + self.queue_cap
        excess = max(0, want - lim)
        if excess:
            newly = max(0, want - max(lim, st.deferred_high))
            if newly:
                self.stats.deferred_ops += newly
                st.deferred_high = max(st.deferred_high, want)
            self._bp_round = True
        st.delivered = max(st.delivered, min(want, lim))
        return excess

    def _deliver(self, st: DocStream) -> None:
        """Advance the producer's delivery point into the bounded pending
        window (``burst`` ops a round, or the whole stream)."""
        if st.delivered is None:
            return
        n = st.n_total
        want = n if st.burst is None else min(
            n, max(st.delivered, st.cursor) + st.burst)
        self._push_delivery(st, want)

    # ---- planning (host only; no device syncs) ----

    def _sim_takes(self, st: DocStream) -> tuple[list[int], int]:
        """Per-slice op counts of one doc's next macro-round (at the plan's
        frozen depth, up to the delivered ops) and its end cursor."""
        takes: list[int] = []
        c = st.cursor
        n = st.n_sched
        for _ in range(self._k_round):
            if c >= n:
                break
            e = st.slice_end(c, self.batch, self.batch_chars, n)
            takes.append(e - c)
            c = e
        return takes, c

    def _note_doc_drained(self, st: DocStream, tag: str | None = None
                          ) -> None:
        """One doc's stream ended (drained, shed empty or quarantined):
        close its request under its cause tag (``shed`` for a lossy doc,
        ``deferred`` for one ever backpressured, else ``ok``, unless
        given) and record its admission-to-drain latency.  The close pops
        the request, so each episode is observed once, and a doc admitted
        again opens a fresh one.  A streamed, journal-less drain releases
        its op arrays (nothing replays them); with ``drained_gc`` the doc
        is queued for the next boundary's record eviction
        (:meth:`_flush_drained_gc`)."""
        self._ended.add(st.doc_id)
        if tag is None:
            tag = ("shed" if st.lossy else "deferred" if st.deferred_high > 0
                   else "ok")
        dt = self.reqtrace.close_request(st.doc_id, tag, round_no=self.round)
        if self._lazy and self.journal is None:
            self.streams.release(st.doc_id)
        if self.drained_gc and st.doc_id not in self._gc_keep:
            self._gc_queue.append(st.doc_id)
        if dt is not None:  # None: never admitted, or already closed
            self.stats.note_doc_drained(tag, dt)

    # ---- the elastic shard map's hooks (serve/reshard.py) ----

    def _shard_imbalance(self) -> float:
        """The live shards' occupancy imbalance (peak x live / total): the
        reshard coordinator's rebalance trigger."""
        occ = self.pool.shard_occupancy()
        live = [occ[s] for s in range(self.pool.n_sh)
                if self.pool.shard_state[s] == "live"]
        total = sum(live)
        if not live or total <= 0:
            return 1.0
        return max(live) * len(live) / total

    def _note_reshard_deferred(self, ops: int) -> None:
        """A migrating doc's lane was pulled from the round: its ops defer
        (scheduled again from a live shard), they are never shed."""
        self.stats.deferred_ops += ops

    def _flush_drained_gc(self, force: bool = False) -> None:
        """Reclaim the queued drained docs in batches of 32 (the manifest's
        fsyncs amortized); the flush at the drain's end is forced."""
        if not self.drained_gc or not self._gc_queue:
            return
        if not force and len(self._gc_queue) < 32:
            return
        batch, self._gc_queue = self._gc_queue, []
        self.spool_gc_docs += self.pool.gc_drained_docs(batch)

    def _select(self, plan: _Plan) -> None:
        """Pick this macro-round's lanes {class: [_Lane]}, bounded by each
        bucket's rows, in round-robin order.  Once every class is full no
        remaining doc can schedule: the rest of the rotation stays in place
        and its arrived, undrained docs count as waiting (from the arrival
        schedule and the ended set, without a scan)."""
        pool = self.pool
        scheduled: list[int] = []
        deferred: list[int] = []
        live_need: dict[int, int] = {}  # lanes taking a live row
        open_classes = {c for c in pool.classes
                        if pool.buckets[c].usable_rows > 0}
        popped_live = 0  # arrived, undrained docs this scan handled
        while self._rr:
            if not open_classes:
                arrived = int(np.searchsorted(self._arrivals_sorted,
                                              self.round, side="right"))
                plan.waiting += max(
                    0, arrived - len(self._ended) - popped_live)
                break
            doc_id = self._rr.popleft()
            st = self.streams[doc_id]
            self._deliver(st)
            if st.remaining == 0:
                self._note_doc_drained(st)
                continue  # drained or shed: out of the rotation for good
            if st.arrival > self.round:
                deferred.append(doc_id)
                continue
            popped_live += 1
            if st.n_sched <= st.cursor:
                # the bounded queue is empty under backpressure: next round
                plan.waiting += 1
                deferred.append(doc_id)
                continue
            if self.faults is not None:
                dup = self.faults.dup_event(self.round, doc_id, st.cursor)
                if dup is not None:
                    depth = dup.param or min(st.cursor, self.batch)
                    dropped = st.clamp_redelivery(st.cursor - depth,
                                                  st.cursor)
                    self.stats.dup_ops_dropped += dropped
                    self.stats.faults_injected += 1
                    dup.fire(self.round, doc=doc_id, depth=depth,
                             dropped=dropped)
                    dup.recover()  # clamped, nothing re-applied
                    self._note_fault()
            takes, end = self._sim_takes(st)
            rec = pool.docs[doc_id]
            cls = pool.class_for(
                max(rec.n_init + st.ins_before(end), rec.length, 1))
            b = pool.buckets[cls]
            lanes = plan.lanes.setdefault(cls, [])
            # the lane cap is the live rows, taken by every lane but a
            # resident already serving from a draining shard (it keeps its
            # row until it migrates, on top of the cap)
            on_drain = rec.cls == cls and not b.live[rec.row // b.Rg]
            need = live_need.get(cls, 0)
            if not on_drain and need >= b.live_rows:
                plan.waiting += 1
                deferred.append(doc_id)
                if b.usable_rows <= b.live_rows:
                    open_classes.discard(cls)  # no free rider left: full
                continue
            lanes.append(_Lane(stream=st, takes=takes, end=end))
            if not on_drain:
                need += 1
                live_need[cls] = need
            if need >= b.live_rows and b.usable_rows <= b.live_rows:
                open_classes.discard(cls)
            # the admission edge: one request an episode
            self.reqtrace.open_request(doc_id, self.round, cap_cls=cls)
            scheduled.append(doc_id)
        # scheduled docs go to the back; deferred (and any unscanned tail,
        # already in place) keep their order
        self._rr.extendleft(reversed(deferred))
        self._rr.extend(scheduled)

    def _pick_victim(self, cls: int, selected: set[int],
                     selected_all: set[int]) -> int:
        """Eviction victim in ``cls``: finished docs first, then the least
        recently scheduled doc not selected this round.  Docs selected in
        any class (a resident about to promote out) are spared when
        possible; only this class's own selection must leave a
        candidate."""
        b = self.pool.buckets[cls]
        # a draining shard's residents are the reshard coordinator's to
        # move (evicting one would free no allocatable row)
        candidates = [d for d, row in self.pool.residents(cls)
                      if d not in selected and b.live[row // b.Rg]]
        if not candidates:
            raise RuntimeError(
                f"bucket c{cls}: no eviction candidate "
                "(selected set exceeds bucket rows?)")
        preferred = [d for d in candidates if d not in selected_all]
        return min(preferred or candidates, key=lambda d: (
            self.streams[d].remaining > 0,
            self.pool.docs[d].last_sched,
            d,
        ))

    def _place(self, plan: _Plan) -> None:
        """Residency bookkeeping for every selected lane (evictions,
        promotions, spool restores, fresh admits) and per-class row
        compaction.  Host state only: the data moves at the boundary
        (:meth:`_execute_moves`)."""
        pool = self.pool
        selected_all = {l.stream.doc_id
                        for lanes in plan.lanes.values() for l in lanes}
        for cls in pool.classes:
            lanes = plan.lanes.get(cls)
            if not lanes:
                continue
            b = pool.buckets[cls]
            selected = {l.stream.doc_id for l in lanes}
            pending: list[tuple[int, tuple]] = []  # (lane index, source)
            for i, lane in enumerate(lanes):
                rec = pool.docs[lane.stream.doc_id]
                if rec.cls == cls:
                    lane.row = rec.row
                    continue
                if rec.cls is not None:  # promotion out of a smaller class
                    pending.append((i, ("pull", rec.cls, rec.row)))
                    plan.pull_classes.add(rec.cls)
                    b_old = pool.buckets[rec.cls]
                    b_old.rows[rec.row] = None
                    b_old.release_row(rec.row)
                    rec.cls = rec.row = None
                    pool.promotions += 1
                elif lane.stream.doc_id in plan.limbo:
                    # a smaller class's victim earlier this round: warm
                    # mode moves it at the boundary, so its bytes are
                    # still in the old row (the moves read pre-compose
                    # snapshots): pull it from there, as a promotion
                    src = plan.limbo.pop(lane.stream.doc_id)
                    plan.cancelled_evictions.add(lane.stream.doc_id)
                    pending.append((i, ("pull", *src)))
                    pool.promotions += 1
                    self.limbo_pulls += 1
                elif lane.stream.doc_id in pool.warm:
                    # taken now, so nothing before the moves can demote it
                    pending.append(
                        (i, ("warm", pool.take_warm_hit(lane.stream.doc_id))))
                elif rec.spool is not None:
                    pending.append((i, ("spool", rec.spool)))
                    pool._set_spool(rec, None)
                    pool.restores += 1
                else:
                    pending.append((i, ("fresh",)))
                    pool.fresh_admits += 1
                self.stats.admissions += 1
            # make room: one victim per missing free row; to the spool,
            # or with a warm tier to limbo (deposited at the boundary)
            warm_mode = pool.warm.budget > 0
            while b.n_free_live < len(pending):
                victim = self._pick_victim(cls, selected, selected_all)
                vrec = pool.docs[victim]
                plan.evictions.append((victim, cls, vrec.row))
                plan.pull_classes.add(cls)
                if warm_mode:
                    plan.limbo[victim] = (cls, vrec.row)
                else:
                    pool._set_spool(vrec, pool.spool_path(victim))
                b.rows[vrec.row] = None
                b.release_row(vrec.row)
                vrec.cls = vrec.row = None
                pool.evictions += 1
            # the depth trims to the deepest lane; the row tier is the
            # lowest that holds the residents (relocating high ones into
            # free low rows) and the installs
            k_eff = min(max(len(l.takes) for l in lanes), self._k_round)
            resident = [(lane, divmod(lane.row, b.Rg)) for lane in lanes
                        if lane.row >= 0]
            n_installs = len(pending)
            chosen_rt = b.R
            relocs: list[tuple[_Lane, int]] = []
            install_rows: list[int] = []
            for rt_total in pool.tiers(cls):
                rt = rt_total // b.n_sh
                # a shard that is not live takes no install or relocation
                fb = [sorted(r for r in b.free_locals(s) if r < rt)
                      if b.live[s] else [] for s in range(b.n_sh)]
                high = [[] for _ in range(b.n_sh)]
                for lane, (s, r) in resident:
                    if r >= rt:
                        high[s].append(lane)
                if any(len(high[s]) > len(fb[s]) for s in range(b.n_sh)):
                    continue
                if sum(len(fb[s]) - len(high[s])
                       for s in range(b.n_sh)) < n_installs:
                    continue
                chosen_rt = rt_total
                # high rows to the lowest free rows of their own shard;
                # installs into the rest, balanced over the shards
                spare: list[list[int]] = []
                for s in range(b.n_sh):
                    relocs.extend((lane, s * b.Rg + r)
                                  for lane, r in zip(high[s], fb[s]))
                    spare.append(fb[s][len(high[s]):])
                for _ in range(n_installs):
                    s = max(range(b.n_sh), key=lambda i: (len(spare[i]), -i))
                    install_rows.append(s * b.Rg + spare[s].pop(0))
                break
            plan.k_eff[cls] = k_eff
            plan.rt[cls] = chosen_rt
            if chosen_rt == b.R:
                install_rows = []  # no tier: plain lowest-row allocation
            inst = plan.installs.setdefault(cls, [])
            for j, (i, source) in enumerate(pending):
                lane = lanes[i]
                rec = pool.docs[lane.stream.doc_id]
                if install_rows:
                    row = install_rows[j]
                    b.take_row(row)
                else:
                    row = b.alloc_row()
                b.rows[row] = rec.doc_id
                rec.cls, rec.row = cls, row
                lane.row = row
                inst.append((rec.doc_id, row, source))
                if self.telemetry is not None and source[0] == "pull":
                    # a promotion landing on another shard than its source
                    src_rg = pool.buckets[source[1]].Rg
                    if source[2] // src_rg != row // b.Rg:
                        self.telemetry.shards.note_relocation(row // b.Rg)
            for lane, dst in relocs:
                rec = pool.docs[lane.stream.doc_id]
                src = rec.row
                plan.pull_classes.add(cls)
                inst.append((rec.doc_id, dst, ("pull", cls, src)))
                b.take_row(dst)
                b.rows[dst] = rec.doc_id
                b.rows[src] = None
                b.release_row(src)
                rec.row = dst
                lane.row = dst

    def _plan(self) -> _Plan | None:
        """One macro-round's host plan, or None when drained; the round
        clock jumps over arrival gaps.  The macro depth is frozen per plan
        (``_k_round``): a fault that trips degradation inside the
        selection (a dup event) takes effect from the next plan, never
        under lanes already sized for the old depth."""
        while True:
            self._k_round = self.effective_k
            self._planned_degraded = self._degrade_left > 0
            self._feed_rotation()
            plan = _Plan(base_round=self.round)
            self._select(plan)
            if plan.lanes:
                self._place(plan)
                return plan
            if self._lazy:
                # the docs not arrived are the unfed tail of the order
                if self._order_ptr >= len(self._order):
                    return None
                self.round = int(self._order_arrivals[self._order_ptr])
                continue
            pending = [s.arrival for s in self.streams.values()
                       if s.remaining and s.arrival > self.round]
            if not pending:
                return None
            self.round = min(pending)

    def _feed_rotation(self) -> None:
        """Streaming construction: every doc whose arrival round has come
        joins the rotation (its id only; it materializes when first
        selected, or a construct prefetch builds it)."""
        if not self._lazy:
            return
        n, p = len(self._order), self._order_ptr
        while p < n and self._order_arrivals[p] <= self.round:
            self._rr.append(int(self._order[p]))
            p += 1
        self._order_ptr = p

    # ---- staging (host; overlaps the device's work) ----

    def _stage(self, plan: _Plan) -> dict[int, tuple]:
        """Each class's (K, Rt, B) op tensors in the pool's packed lane
        dtypes (PAD lanes carry slot0 = 0, never read)."""
        tensors: dict[int, tuple] = {}
        B = self.batch
        dt_kind, dt_pos, dt_rlen, dt_slot = self.pool.op_dtypes
        for cls, lanes in plan.lanes.items():
            K, Rt = plan.k_eff[cls], plan.rt[cls]
            b = self.pool.buckets[cls]
            rt = Rt // b.n_sh
            kind = np.full((K, Rt, B), PAD, dt_kind)
            pos = np.zeros((K, Rt, B), dt_pos)
            rlen = np.zeros((K, Rt, B), dt_rlen)
            slot0 = np.zeros((K, Rt, B), dt_slot)
            for lane in lanes:
                st = lane.stream
                s, r = divmod(lane.row, b.Rg)
                r += s * rt  # the lane's row in the tier
                c = st.cursor
                for k, take in enumerate(lane.takes):
                    kind[k, r, :take] = st.kind[c:c + take]
                    pos[k, r, :take] = st.pos[c:c + take]
                    rlen[k, r, :take] = st.rlen[c:c + take]
                    slot0[k, r, :take] = st.slot0[c:c + take]
                    c += take
            tensors[cls] = (kind, pos, rlen, slot0)
        return tensors

    # ---- fault firing and repair (serve/faults.py, serve/journal.py) ----

    def _maybe_stall(self, rnd: int) -> None:
        """The ``stall`` fault: sleep the staging path."""
        hit = self.faults.stall_event(rnd)
        if hit is None:
            return
        ev, secs = hit
        time.sleep(secs)
        ev.fire(rnd, ms=secs * 1e3)
        ev.recover()  # a stall is absorbed, not repaired
        self.stats.stall_rounds += 1
        self.stats.faults_injected += 1
        self._note_fault()

    def _fire_overflow(self) -> None:
        """The ``queue_overflow`` fault: a producer bursts past the bounded
        cap and the scheduler makes the explicit shed or defer decision
        (pending until a doc with a bounded queue has work)."""
        if self.queue_cap <= 0:
            return
        ev = self.faults.overflow_event(self.round)
        if ev is None:
            return
        cands = sorted(d for d, s in self.streams.items()
                       if s.remaining > 0 and s.delivered is not None)
        if self.overflow_policy == "shed" and self.reshard is not None:
            # a doc mid-move defers for a round; it is never the shed victim
            migrating = self.reshard.migrating_docs()
            if migrating:
                cands = [d for d in cands if d not in migrating]
        if not cands:
            return  # stays pending; retried next round
        deep = [d for d in cands
                if self.streams[d].remaining > self.queue_cap]
        doc = self.faults.pick(deep or cands)
        st = self.streams[doc]
        burst = ev.param or self.faults.plan.burst or 4 * self.queue_cap
        lim = st.cursor + self.queue_cap
        want = min(st.n_total, lim + burst)
        self.stats.overflow_events += 1
        self.stats.faults_injected += 1
        self._note_fault()
        shed = 0
        if self.overflow_policy == "shed":
            # tail-drop the session's ops past the cap: an explicit loss,
            # surfaced (the doc becomes lossy) and journaled
            keep = min(st.n_total, lim)
            shed = st.n_total - keep
            if shed:
                st.limit = keep
                st.lossy = True
                self.stats.shed_ops += shed
                if self.journal:
                    self.journal.event("shed", r=self.round, doc=doc,
                                       at=keep, ops=shed)
                if st.remaining == 0:
                    self._note_doc_drained(st)  # the shed ended the stream
        else:
            # defer: the queue refuses the burst, the producer holds it
            ev.detail["deferred"] = self._push_delivery(st, want)
        ev.fire(self.round, doc=doc, burst=burst,
                policy=self.overflow_policy, shed=shed)
        ev.recover()  # the decision is the recovery

    def _fire_tier_pressure(self) -> None:
        """The ``tier_evict_pressure`` fault: warm-tier churn under load,
        the least recently scheduled warm entries demoted to the
        compressed spool (pending until the warm tier holds an entry)."""
        ev = self.faults.tier_pressure_event(self.round)
        if ev is None or not len(self.pool.warm):
            return
        self._tier_pressure_barrier(ev)

    @fenced
    def _tier_pressure_barrier(self, ev) -> None:
        """One forced warm-to-cold churn: compressed spool writes for the
        least recently scheduled warm entries (disk work, a fence as the
        spool-tear injector is)."""
        n = ev.param or max(1, len(self.pool.warm) // 2)
        demoted = self.pool.warm_pressure(n)
        self.stats.faults_injected += 1
        ev.fire(self.round, demoted=demoted)
        ev.recover()  # churn is absorbed, not repaired
        self._note_fault()
        if self.telemetry is not None:
            self.telemetry.note_event("tier", why="evict_pressure",
                                      round=self.round, demoted=demoted)

    def _all_residents(self) -> list[tuple[int, int]]:
        return [(d, row) for cls in self.pool.classes
                for d, row in self.pool.residents(cls)]

    @fenced
    def _fire_spool_fault(self, plan: _Plan) -> None:
        """The ``spool_corrupt``/``spool_truncate`` faults: damage a spool
        on disk, an existing one of a doc with pending ops (its restore,
        and so the detection, is certain) or, with none, one written for
        the purpose by evicting a resident not scheduled this round."""
        ev = self.faults.spool_event(self.round)
        if ev is None:
            return
        pool = self.pool
        cands = sorted(d for d, rec in pool.docs.items()
                       if rec.spool is not None and os.path.exists(rec.spool)
                       and self.streams[d].remaining > 0)
        if not cands:
            scheduled = {l.stream.doc_id
                         for lanes in plan.lanes.values() for l in lanes}
            evictable = sorted(d for d, _row in self._all_residents()
                               if d not in scheduled
                               and self.streams[d].remaining > 0)
            if not evictable:
                return  # stays pending; retried next round
            victim = self.faults.pick(evictable)
            pool.evict(victim)  # a boundary sync, like any eviction
            cands = [victim]
        doc = self.faults.pick(cands)
        detail = self.faults.corrupt_file(pool.docs[doc].spool, ev.kind)
        ev.fire(self.round, doc=doc, **detail)
        self.stats.faults_injected += 1

    def _quarantine(self, doc_id: int, reason: str) -> None:
        """Isolate a doc that cannot be repaired: its remaining ops shed,
        its row freed, the fleet serving on.  The doc becomes lossy and
        the decision is journaled (recovery re-applies it)."""
        st = self.streams[doc_id]
        rec = self.pool.docs[doc_id]
        shed = max(0, st.remaining)
        st.limit = st.cursor
        st.lossy = True
        self.stats.shed_ops += shed
        if rec.cls is not None:
            b = self.pool.buckets[rec.cls]
            b.rows[rec.row] = None
            b.release_row(rec.row)
            rec.cls = rec.row = None
        self.pool._set_spool(rec, None)
        self.pool.warm.take(doc_id)  # a quarantined doc holds no tier
        self._dead_lanes.add(doc_id)
        self._note_doc_drained(st, tag="quarantined")
        self.stats.quarantines.append({"doc": doc_id, "round": self.round,
                                       "reason": reason, "shed_ops": shed})
        if self.journal:
            self.journal.event("quarantine", r=self.round, doc=doc_id,
                               at=st.cursor, ops=shed, reason=reason[:120])

    def _rebuild(self, doc_id: int, cls: int):
        """One doc's row at its applied cursor, rebuilt from its newest
        snapshot base (or from its stream alone) on the pool's device:
        ``(row, length, nvis, dispatches, ops replayed)``.  A poisoned
        rebuild (the ``poison_rebuild`` fault) raises."""
        st = self.streams[doc_id]
        if self.faults is not None and self.faults.poisoned(doc_id):
            raise RuntimeError("rebuild poisoned by fault plan")
        base = self._bases.base(doc_id)
        row_v, L, nv, disp = rebuild_doc(
            st, cls, base, st.cursor, n_init=self.pool.docs[doc_id].n_init,
            batch=self.batch, batch_chars=self.batch_chars,
            macro_k=self.effective_k, device=self.pool.device)
        start = min(base[3], st.cursor) if base is not None else 0
        return row_v, L, nv, disp, st.cursor - start

    @fenced
    def _heal_spool(self, doc_id: int, cls: int, err: str):
        """A spool failed its integrity check at restore: rebuild the
        doc's row at its applied cursor (:meth:`_rebuild`).  Returns
        ``(row, length, nvis)``, or None after quarantining a doc whose
        rebuild failed too."""
        self._note_fault()
        ev = None
        if self.faults is not None:
            for e in self.faults.plan.events:
                if (e.kind in ("spool_corrupt", "spool_truncate")
                        and e.fired and not e.recovered
                        and e.detail.get("doc") == doc_id):
                    ev = e
                    break
        try:
            with span("serve.recover.spool", doc=doc_id):
                row_v, L, nv, disp, ops = self._rebuild(doc_id, cls)
            self.stats.recoveries += 1
            self.stats.ops_replayed += ops
            self.stats.replay_dispatches += disp
            self.stats.mttr_rounds.append(max(1, disp))
            if ev is not None:
                ev.recover()
            if self.journal:
                self.journal.event("heal", r=self.round, doc=doc_id, ops=ops,
                                   why="spool")
            if self.telemetry is not None:
                self.telemetry.note_event("recovery", round=self.round,
                                          doc=doc_id, why="spool", ops=ops)
            return row_v, L, nv
        except Exception as e2:  # the rebuild failed too: isolate the doc
            self._quarantine(
                doc_id, f"spool unreadable ({err}); rebuild failed: {e2}")
            if ev is not None:
                ev.detail["quarantined"] = True
            return None
        finally:
            self._bases.release()  # pin no snapshot arrays after the heal

    @fenced
    def _recover_class(self, cls: int, plan: _Plan, ev) -> None:
        """Device-state loss right after a class's dispatch: the round's
        lanes of the class are dropped unadvanced (the WAL recorded them;
        the docs are scheduled again), every resident row is rebuilt at
        its applied cursor (:meth:`_rebuild`) and the bucket uploaded in
        one compose.  The kernel already enqueued on the old state writes
        tensors the bucket no longer holds."""
        pool = self.pool
        b = pool.buckets[cls]
        plan.lanes.pop(cls, None)  # not applied: cursors stay
        affected = pool.residents(cls)
        doc_w = np.full((b.R, b.C), 2, np.int32)
        len_w = np.zeros(b.R, np.int32)
        nvis_w = np.zeros(b.R, np.int32)
        replayed = disp_total = disp_max = 0
        self._note_fault()
        for doc_id, row in affected:
            try:
                row_v, L, nv, disp, ops = self._rebuild(doc_id, cls)
            except Exception as e:
                self._quarantine(doc_id, f"device loss; rebuild failed: {e}")
                continue
            doc_w[row] = row_v
            len_w[row] = L
            nvis_w[row] = nv
            replayed += ops
            disp_total += disp
            disp_max = max(disp_max, disp)
        pool.upload_bucket(cls, doc_w, len_w, nvis_w)
        self._bases.release()  # the class is done: drop the cached states
        self.stats.recoveries += 1
        self.stats.ops_replayed += replayed
        self.stats.replay_dispatches += disp_total
        self.stats.mttr_rounds.append(max(1, disp_max))
        self.stats.faults_injected += 1
        ev.fire(self.round, cls=cls, docs=len(affected),
                replayed_ops=replayed)
        ev.recover()
        if self.journal:
            self.journal.event("device_loss", r=self.round, cls=cls,
                               docs=len(affected), ops=replayed)
        if self.telemetry is not None:
            self.telemetry.note_event("recovery", round=self.round, cls=cls,
                                      why="device_loss", ops=replayed)

    def finalize_faults(self) -> None:
        """The end-of-drain sweep: a damaged spool whose doc was never
        restored again is healed now (rebuilt, the spool rewritten); a
        torn GC pass still pending is completed; a damaged delta is shown
        recoverable by the chain-fallback probe.  A chaos drain thus never
        ends with an undecodable doc or a fired fault left open."""
        for e in self.faults.plan.events:
            if e.kind == "crash_compact" and e.fired and not e.recovered \
                    and self.journal is not None:
                n = self.journal.finish_torn_gc()
                e.recover(completed="finalize", segments=n)
                if e is self._pending_gc_ev:
                    self._pending_gc_ev = None
            if e.kind == "delta_corrupt" and e.fired and not e.recovered \
                    and self.journal is not None:
                used, fallbacks = probe_recovery(self.journal.dir)
                if used is not None:
                    # the walk fell back below the damaged link, or a later
                    # full barrier re-rooted past it: both the repair
                    e.recover(fallback_to=used, fallbacks=fallbacks)
                if self.telemetry is not None:
                    self.telemetry.note_event("recovery_probe", used=used,
                                              fallbacks=fallbacks)
        for e in self.faults.plan.events:
            if e.kind not in ("spool_corrupt", "spool_truncate"):
                continue
            if not e.fired or e.recovered:
                continue
            doc_id = e.detail.get("doc")
            rec = self.pool.docs.get(doc_id)
            st = self.streams.get(doc_id)
            if rec is None or st is None:
                continue
            if rec.spool is None or not os.path.exists(rec.spool):
                e.recover()  # superseded: the doc is resident again
                continue
            try:
                load_state(rec.spool)
                e.recover()  # the damage missed the live bytes
                continue
            except CorruptCheckpointError as err:
                healed = self._heal_spool(
                    doc_id, self.pool.class_for(max(rec.length, 1)),
                    str(err))
            if healed is None:
                continue  # quarantined (reported apart)
            row_v, L, nv = healed
            self.pool._set_spool(rec, self.pool.spool_save(doc_id, row_v, L,
                                                           nv))
            e.recover()

    # ---- boundary moves (the only syncs of a round) ----

    @fenced
    def _execute_moves(self, plan: _Plan) -> None:
        """The plan's row movement: pull each affected bucket once, move
        the evictions (to the spool, or to the warm tier, whose overflow
        is demoted to the compressed spool here), compose the installs on
        the host from the pre-compose snapshots, upload each touched
        bucket once."""
        pool = self.pool
        snaps = {cls: pool.pull_bucket(cls)
                 for cls in sorted(plan.pull_classes)}
        warm_mode = pool.warm.budget > 0
        demoted = 0
        for doc_id, cls, row in plan.evictions:
            if doc_id in plan.cancelled_evictions:
                continue  # pulled into a larger class this round
            doc, length, nvis = snaps[cls]
            if warm_mode:
                demoted += pool.warm_deposit(
                    doc_id, doc[row], int(length[row]), int(nvis[row]),
                    last_sched=pool.docs[doc_id].last_sched)
            else:
                pool.spool_save(doc_id, doc[row], int(length[row]),
                                int(nvis[row]))
        if warm_mode:
            demoted += pool._enforce_warm_budget()  # the harvest's overflow
        if demoted and self.telemetry is not None:
            self.telemetry.note_event("tier", why="warm_overflow",
                                      round=self.round, demoted=demoted)
        for cls, items in plan.installs.items():
            if not items:
                continue
            doc_s, len_s, nvis_s = (snaps[cls] if cls in snaps
                                    else pool.pull_bucket(cls))
            # writable copies: sources always read the snapshot, so a row
            # can be vacated and refilled in one boundary
            doc_w, len_w, nvis_w = (np.array(doc_s), np.array(len_s),
                                    np.array(nvis_s))
            C = pool.buckets[cls].C
            for doc_id, row, source in items:
                n_init = pool.docs[doc_id].n_init
                if source[0] == "fresh":
                    doc_w[row] = _fresh_row_np(C, n_init)
                    len_w[row] = nvis_w[row] = n_init
                    continue
                if source[0] == "warm":  # a memory compose, no disk read
                    e = source[1]
                    src_doc, L, nv = e.doc_row, e.length, e.nvis
                elif source[0] == "spool":
                    try:
                        st = load_state(source[1])
                    except CorruptCheckpointError as e:
                        # damaged: rebuilt in place (or quarantined, and
                        # the row takes a scratch fresh row its lane,
                        # still staged, leaves unadvanced)
                        healed = self._heal_spool(doc_id, cls, str(e))
                        try:
                            os.unlink(source[1])
                        except OSError:
                            pass
                        if healed is None:
                            doc_w[row] = _fresh_row_np(C, n_init)
                            len_w[row] = nvis_w[row] = n_init
                            continue
                        src_doc, L, nv = healed
                    else:
                        src_doc, L, nv = st.doc[0], int(st.length[0]), int(
                            st.nvis[0])
                else:  # ("pull", src_cls, src_row)
                    _, src_cls, src_row = source
                    sdoc, slen, snvis = snaps[src_cls]
                    src_doc, L, nv = (sdoc[src_row], int(slen[src_row]),
                                      int(snvis[src_row]))
                doc_w[row, :L] = src_doc[:L]
                doc_w[row, L:] = 2
                len_w[row] = L
                nvis_w[row] = nv
            pool.upload_bucket(cls, doc_w, len_w, nvis_w,
                               dirty_rows=[row for _d, row, _s in items])
        # the drained docs' record eviction rides the same boundary
        self._flush_drained_gc()

    # ---- predictive prefetch (never blocks the hot thread) ----

    def _harvest_prefetch(self) -> None:
        """Adopt the completed reads into the warm tier and the built
        streams into the lazy view (start of a round, before its plan).  A
        payload with an error is left to the synchronous path, which reads
        the spool or materializes the stream itself; a stale or superseded
        one is counted and dropped."""
        pf = self.pool.prefetcher
        if pf is None:
            return
        for payload in pf.drain():
            doc_id = payload["doc"]
            self._prefetch_inflight.pop(doc_id, None)
            if payload["error"] is not None:
                continue
            if payload["kind"] == "construct":
                # a stream built off the drain: installed unless the doc
                # materialized on the hot thread while it was built
                if not self.streams.adopt(doc_id, payload):
                    self.prefetch_wasted += 1
                continue
            if not self.pool.store_prefetched(
                    doc_id, payload["row"], payload["length"],
                    payload["nvis"], round_no=self.round,
                    gen=payload["gen"]):
                self.prefetch_wasted += 1

    def _plan_prefetch(self) -> None:
        """Submit the cold docs the next rounds will admit: the front of
        the rotation (after ``_select`` it is the next round's admission
        order), those arriving within the next macro-round, up to the
        lookahead, the warm budget and the worker's queue depth.  A
        streamed fleet also submits construct requests for the genesis
        docs in the fed rotation and, past it, those arriving within the
        horizon."""
        pf = self.pool.prefetcher
        if pf is None:
            return
        pool = self.pool
        horizon = self.round + self._k_round
        # reap reads whose results never arrived (the worker's bounded
        # publish dropped them): they would pin the budget for good
        reap_before = self.round - 32 * self._k_round
        stale = [(d, seq) for d, (r0, seq) in self._prefetch_inflight.items()
                 if r0 < reap_before]
        if stale:
            for d, _ in stale:
                del self._prefetch_inflight[d]
            pf.note_lost([seq for _, seq in stale])
        space = (min(self._prefetch_lookahead, pool.warm.budget, pf.capacity)
                 - len(self._prefetch_inflight))
        # ("spool", doc, path, gen): a cold read; ("construct", doc): a
        # genesis doc's stream built off the drain (streamed fleets only)
        wanted: list[tuple] = []
        scanned = 0
        for doc_id in self._rr:
            scanned += 1
            if scanned > self._prefetch_lookahead or len(wanted) >= space:
                break
            if doc_id in self._prefetch_inflight:
                continue
            rec = pool.docs.get(doc_id)
            if rec is None:
                # a genesis doc already fed (arrived, so within the horizon);
                # in an eager fleet, a drained doc whose record was evicted
                # (JAX's drain raises KeyError here)
                if self._lazy:
                    wanted.append(("construct", doc_id))
                continue
            if (rec.spool is None or rec.cls is not None
                    or doc_id in pool.warm):
                continue
            st = self.streams[doc_id]
            if st.remaining == 0 or st.arrival > horizon:
                continue
            wanted.append(("spool", doc_id, rec.spool,
                           pool.spool_gen(doc_id)))
        if self._lazy:
            # past the fed rotation: genesis docs arriving within the
            # horizon get their streams built before their feed
            p, n = self._order_ptr, len(self._order)
            while (p < n and len(wanted) < space
                   and scanned <= self._prefetch_lookahead):
                if self._order_arrivals[p] > horizon:
                    break
                d = int(self._order[p])
                p += 1
                scanned += 1
                if d in self._prefetch_inflight or d in pool.docs:
                    continue
                wanted.append(("construct", d))
        if wanted and self.faults is not None:
            ev = self.faults.prefetch_miss_event(self.round)
            if ev is not None:
                # the planned reads are dropped: admission takes the
                # synchronous cold path, which must stay exact
                self.prefetch_missed += len(wanted)
                self.stats.faults_injected += 1
                ev.fire(self.round, dropped=len(wanted))
                ev.recover()  # the synchronous fallback is the recovery
                self._note_fault()
                if self.telemetry is not None:
                    self.telemetry.note_event(
                        "tier", why="prefetch_miss", round=self.round,
                        dropped=len(wanted))
                return
        for item in wanted:
            doc_id = item[1]
            if item[0] == "spool":
                seq = pf.submit(doc_id, item[2], item[3])
            else:
                seq = pf.submit_construct(doc_id,
                                          self.streams.builder(doc_id))
            if seq:
                self._prefetch_inflight[doc_id] = (self.round, seq)

    # ---- dispatch and host mirrors ----

    def _dispatch(self, plan: _Plan, tensors: dict[int, tuple]) -> bool:
        """One macro step a class.  Returns whether a dispatch compiled a
        new shape: never in the port (the kernels are built and loaded
        before a drain, and nothing is keyed by shape)."""
        for cls, (kind, pos, rlen, slot0) in tensors.items():
            self.pool.macro_step(cls, kind, pos, rlen, slot0,
                                 nbits=self.nbits)
            self.stats.dispatches += 1
            self.stats.slices += plan.k_eff[cls]
            self.stats.staged_cells += kind.size
            if self.faults is not None:
                ev = self.faults.device_loss_event(self.round, cls)
                if ev is not None:
                    with span("serve.recover.class", cls=cls):
                        self._recover_class(cls, plan, ev)
        return False

    def _advance(self, plan: _Plan) -> None:
        """Host mirrors after dispatch: the staged ops will be applied and
        length and cursor evolve deterministically, so no sync is needed
        to keep scheduling exact.  The lanes of a class that lost its
        device state (popped from the plan) and of docs quarantined this
        round do not advance.  The round's occupancy (lanes used over the
        fleet's rows) and queue depth (``plan.waiting``) are observed, and
        the per-shard tallies kept for the telemetry."""
        lanes_used = 0
        n_sh = self.pool.n_sh
        sh_lanes, sh_ops, sh_units = [0] * n_sh, [0] * n_sh, [0] * n_sh
        for cls, lanes in plan.lanes.items():
            Rg = self.pool.buckets[cls].Rg
            for lane in lanes:
                st = lane.stream
                if st.doc_id in self._dead_lanes:
                    continue
                rec = self.pool.docs[st.doc_id]
                ops_d = lane.end - st.cursor
                units_d = (st.units_before(lane.end)
                           - st.units_before(st.cursor))
                self.stats.ops += ops_d
                self.stats.unit_ops += units_d
                s = lane.row // Rg  # the lane's shard: host arithmetic
                sh_lanes[s] += 1
                sh_ops[s] += ops_d
                sh_units[s] += units_d
                st.cursor = lane.end
                rec.length = rec.n_init + st.ins_before(lane.end)
                rec.last_sched = plan.base_round
                lanes_used += 1
                if st.remaining == 0:
                    self._note_doc_drained(st)
        self._dead_lanes.clear()
        occ = lanes_used / sum(b.R for b in self.pool.buckets.values())
        self.stats.occupancy.observe(occ)
        self.stats.queue_depth.observe(plan.waiting)
        self._last_occ = occ
        self._last_queue = plan.waiting
        self._sh_lanes, self._sh_ops, self._sh_units = (sh_lanes, sh_ops,
                                                        sh_units)
        if self._planned_degraded:
            self.stats.degraded_rounds += 1
            self._degrade_left -= 1
        if self._bp_round:
            self.stats.backpressure_rounds += 1
            self._bp_round = False
        self.pool.update_tier_gauges()
        self.round = plan.base_round + max(plan.k_eff.values())
        self._n_rounds += 1

    # ---- the journal: write-ahead records and snapshot barriers ----

    def _journal_round(self, plan: _Plan) -> None:
        """The round's write-ahead record: per class, in the plan's lane
        order, each lane's ``[doc, start_cursor, end_cursor]``."""
        self.journal.round_record(plan.base_round, {
            cls: [[l.stream.doc_id, int(l.stream.cursor), int(l.end)]
                  for l in lanes]
            for cls, lanes in plan.lanes.items()
        })

    def _maybe_snapshot(self) -> bool:
        """The barrier's cadence (after ``_advance``); True when one ran."""
        if self.journal is None or self.snapshot_every <= 0:
            return False
        if self._n_rounds % self.snapshot_every:
            return False
        with span("serve.snapshot"):
            self._snapshot_barrier()
        return True

    @fenced
    def _snapshot_barrier(self) -> None:
        """Persist a consistent fleet state (a full barrier every
        ``snapshot_full_every``-th time, a dirty-row delta between), then
        run the WAL GC pass the barrier made safe, then journal the
        ``snap`` marker.  The GC floor is the OLDEST retained snapshot's
        round (chain fallback may land there); the marker comes after the
        pass, which rolls the active file first, so it never pins a sealed
        segment at the covered round."""
        t0 = time.perf_counter()
        self._barrier_count += 1
        kind = "full"
        if (self.snapshot_full_every > 1
                and (self._barrier_count - 1) % self.snapshot_full_every):
            kind = "delta"
        d, m = write_snapshot(self.journal.dir, self.pool, self.streams,
                              self.round, keep=self.snapshot_keep, kind=kind)
        self.stats.snapshots += 1
        self.stats.snapshot_time += time.perf_counter() - t0
        kind = m["kind"]  # the committed kind (a delta may have re-rooted)
        depth = int(m["depth"])
        if kind == "full":
            self.stats.snapshots_full += 1
        else:
            self.stats.snapshots_delta += 1
        self._g_chain_depth.set(depth)
        self.journal.note_snapshot(d)
        self._bases.release()  # the barrier may have pruned old dirs
        if self.telemetry is not None:
            self.telemetry.note_event("snapshot", round=self.round,
                                      snap_kind=kind, depth=depth)
        floor = retained_floor(self.journal.dir)
        info = self.journal.compact(self.round if floor is None else floor,
                                    crash_hook=self._gc_crash_hook)
        self.journal.event("snap", r=self.round, dir=os.path.basename(d),
                           snap_kind=kind, depth=depth)
        if not info["crashed"]:
            # a pass killed mid-flight did not complete: the gauge says
            # when a compaction last finished
            self._g_last_compact.set(self.round)
        if info["torn_completed"] and self._pending_gc_ev is not None:
            self._pending_gc_ev.recover(completed_round=self.round,
                                        segments=info["torn_completed"])
            self._pending_gc_ev = None
        if self.telemetry is not None and (
                info["deleted"] or info["torn_completed"] or info["crashed"]):
            self.telemetry.note_event("compaction", **info)
        if self.faults is not None:
            self._fire_delta_corrupt()

    def _gc_crash_hook(self) -> bool:
        """The ``crash_compact`` kill point, polled by the GC pass between
        its manifest commit and the unlinks: True abandons the pass there,
        the torn state the next open, compaction or recovery repairs."""
        if self.faults is None:
            return False
        ev = self.faults.compact_crash_event(self.round)
        if ev is None:
            return False
        ev.fire(self.round, stage="post_manifest_pre_unlink")
        self.stats.faults_injected += 1
        self._note_fault()
        self._pending_gc_ev = ev
        return True

    def _fire_delta_corrupt(self) -> None:
        """The ``delta_corrupt`` fault: flip bytes inside the newest delta
        snapshot's member (after a barrier; pending until a delta
        exists).  Recovery must fall back down the chain, which
        :meth:`finalize_faults`'s probe or the bench's recovery leg
        proves."""
        ev = self.faults.delta_corrupt_event(self.round)
        if ev is None:
            return
        jd = self.journal.dir
        target = None
        for snap in reversed(list_snapshots(jd)):
            m = _read_manifest(os.path.join(jd, snap))
            if m is not None and m.get("kind") == "delta":
                target = snap
                break
        if target is None:
            return  # no delta committed yet: retried next barrier
        sd = os.path.join(jd, target)
        members = sorted(f for f in os.listdir(sd)
                         if f.startswith("delta_") and f.endswith(".npz"))
        path = os.path.join(sd, members[0] if members else "MANIFEST.json")
        detail = self.faults.corrupt_file(path, "delta_corrupt")
        ev.fire(self.round, dir=target, member=os.path.basename(path),
                **detail)
        self.stats.faults_injected += 1
        self._note_fault()

    # ---- continuous telemetry taps (host only; see obs/timeseries.py) ----

    def _cum_counters(self) -> dict:
        """The cumulative counters the time-series recorder delta-encodes
        into windows (``obs/timeseries.py CUM_KEYS``); ``fence_entries``
        is the sync sanitizer's running total of fence crossings."""
        s = self.stats
        return {
            "ops": s.ops,
            "unit_ops": s.unit_ops,
            "shed": s.shed_ops,
            "deferred": s.deferred_ops,
            "quarantines": len(s.quarantines),
            "dup_dropped": s.dup_ops_dropped,
            "evictions": self.pool.evictions,
            "restores": self.pool.restores,
            "promotions": self.pool.promotions,
            "recoveries": s.recoveries,
            "journal_bytes": (self.journal.bytes_total if self.journal
                              else 0),
            "fence_entries": entries_total(),
        }

    def status_fields(self) -> dict:
        """The ``/status.json`` snapshot: where the drain is now, its fault
        and degraded state, and with a warm tier, a journal or an SLO
        their ``residency``, ``durability`` and ``slo`` views.  Plain
        scalars only: the status server serializes it as published."""
        s = self.stats
        out = {
            "phase": "serving",
            "round": self.round,
            "rounds": self._n_rounds,
            "occupancy": self._last_occ,
            "queue_depth": self._last_queue,
            "ops": s.ops,
            "unit_ops": s.unit_ops,
            "patches": s.patches,
            "shed_ops": s.shed_ops,
            "deferred_ops": s.deferred_ops,
            "quarantines": len(s.quarantines),
            "degraded": self._degrade_left > 0,
            "faults_seen": s.faults_seen,
            "faults_injected": s.faults_injected,
            "recoveries": s.recoveries,
            "snapshots": s.snapshots,
            "done": False,
        }
        if self.pool.warm.budget > 0:
            res = self.pool.tier_status()
            res["prefetch_wasted"] = self.prefetch_wasted
            res["prefetch_missed"] = self.prefetch_missed
            out["residency"] = res
        if self.journal is not None:
            d = self.journal.status_fields()
            d["chain_depth"] = int(self._g_chain_depth.value)
            d["last_compaction_round"] = int(self._g_last_compact.value)
            d["snapshots_full"] = s.snapshots_full
            d["snapshots_delta"] = s.snapshots_delta
            out["durability"] = d
        if self.slo is not None:
            out["slo"] = self.slo.status_fields()
        if self.reshard is not None:
            # the live migration view (its gauges are serve.reshard.*)
            out["reshard"] = self.reshard.status_fields()
        return out

    # ---- the drain loop ----

    def run_round(self) -> bool:
        """One macro-round inside the sync sanitizer's hot scope
        (``lint/sanitizer.py hot_path``, a no-op unless armed: armed, a host
        sync outside a declared fence raises at its callsite), with the
        device profiler's window hooks around it (:meth:`_round`).  The
        hooks stay outside the hot scope: stopping a CUDA capture
        synchronizes the device, which is the profiler's wait, not the
        round's."""
        if self.profiler is not None:
            self.profiler.round_begin()
        self._steady = None
        with hot_path(self.pool.device):
            more = self._round()
        if self.profiler is not None and self._steady is not None:
            self.profiler.round_end(steady=self._steady)
        return more

    def _round(self) -> bool:
        """One macro-round (prefetch harvest -> overflow and tier-pressure
        faults -> plan -> the reshard tick -> WAL record -> stage -> stall fault -> boundary
        moves -> prefetch submissions -> spool fault -> one dispatch per
        class, each polled for a device loss -> advance -> the degraded
        fence -> snapshot barrier), each phase a span (``serve.*``) and a
        request segment, then the round's telemetry sample.  Returns False
        when no work remains."""
        rt = self.reqtrace
        rt.round_begin()  # reset the round's segments (no-op disarmed)
        t0 = time.perf_counter()
        ph = self.stats.phase_seconds
        faults = self.faults is not None
        with span("serve.round", round=self.round):
            self._harvest_prefetch()
            th = time.perf_counter()
            timed_prefetch = "prefetch" in ph
            if timed_prefetch:
                ph["prefetch"] += th - t0
            if faults:
                with span("serve.faults.inject"):
                    self._fire_overflow()
                    self._fire_tier_pressure()
                tf = time.perf_counter()
                ph["faults"] += tf - th
                th = tf
            with span("serve.plan"), rt.segment("plan"):
                plan = self._plan()
            t1 = time.perf_counter()
            ph["plan"] += t1 - th
            if plan is None:
                return False
            if self.reshard is not None and self.reshard.state != "done":
                # the placed plan in hand, its WAL record not yet written:
                # the migrations join this round's boundary moves, and the
                # journal sees the round after every move decision
                with span("serve.reshard"):
                    self.reshard.tick(
                        plan.base_round, plan,
                        imbalance=self._shard_imbalance(),
                        note_deferred=self._note_reshard_deferred)
                tr = time.perf_counter()
                ph["plan"] += tr - t1  # the coordinator's planning
                t1 = tr
            if rt.armed:
                # the lane set is final: this round's segments fold into
                # exactly these docs' requests
                rt.note_scheduled(l.stream.doc_id
                                  for lanes in plan.lanes.values()
                                  for l in lanes)
            if self.journal is not None:
                # write-ahead: before the dispatch
                with span("serve.journal.wal"), rt.segment("wal"):
                    self._journal_round(plan)
                tw = time.perf_counter()
                ph["wal"] += tw - t1
                t1 = tw
            with span("serve.stage"), rt.segment("stage"):
                tensors = self._stage(plan)
            t2 = time.perf_counter()
            if faults:
                # its own segment: a stall shows in request traces as the
                # stall, not as queue wait
                with rt.segment("faults"):
                    self._maybe_stall(plan.base_round)
                tf = time.perf_counter()
                ph["faults"] += tf - t2
                t2 = tf
            with span("serve.moves"), rt.segment("moves"):
                self._execute_moves(plan)
            t3 = time.perf_counter()
            self._plan_prefetch()
            tp = time.perf_counter()
            if faults:
                with span("serve.faults.inject"):
                    self._fire_spool_fault(plan)
                tf = time.perf_counter()
                ph["faults"] += tf - tp
                tp = tf
            with span("serve.dispatch"), rt.segment("dispatch"):
                compiled = self._dispatch(plan, tensors)
            if rt.armed:
                # before the cursors advance (each lane's ops still
                # derivable) and before _advance closes requests
                rt.fold_round(plan.base_round, [
                    (l.stream.doc_id, l.end - l.stream.cursor)
                    for lanes in plan.lanes.values() for l in lanes])
            self._advance(plan)
            if self._planned_degraded:
                with span("serve.degraded_fence"):
                    self.pool.block()  # degraded: synchronous K = 1 rounds
            t4 = time.perf_counter()
            barrier = self._maybe_snapshot()
            t5 = time.perf_counter()
            if timed_prefetch:
                ph["prefetch"] += tp - t3
            ph["stage"] += t2 - t1
            ph["moves"] += t3 - t2
            ph["dispatch"] += t4 - tp
            if self.journal is not None:
                ph["snapshot"] += t5 - t4
        if self.telemetry is not None:
            # the round's sample (its latency before the final fence's
            # fold: the time-series wants the live rate)
            self.telemetry.note_round(
                round_no=self.round, seconds=time.perf_counter() - t0,
                compiled=compiled, barrier=barrier,
                occupancy=self._last_occ, queue_depth=self._last_queue,
                cum=self._cum_counters(), shard_lanes=self._sh_lanes,
                shard_ops=self._sh_ops, shard_units=self._sh_units,
                status=self.status_fields())
        # record the previous round and hold this one, so run() can fold
        # the final fence into the last round before it is recorded
        self._flush_round()
        self._pending_round = (time.perf_counter() - t0, compiled, barrier)
        if self.reshard is not None:
            # the rounds served while a move is in flight (the reshard
            # block's mid-reshard latency)
            self.reshard.note_round_latency(time.perf_counter() - t0)
        # the round's class for the profiler's window (run_round)
        self._steady = not compiled and not barrier
        return True

    def _flush_round(self) -> None:
        """Record the held round through ``ServeStats.note_round``."""
        if self._pending_round is not None:
            self.stats.note_round(*self._pending_round)
            self._pending_round = None

    def run(self, max_rounds: int | None = None) -> ServeStats:
        """Drain every queue (or stop after ``max_rounds`` macro-rounds).
        The device drains behind the host planner and is fenced once at
        the end; the fence's wait counts in the last round's latency."""
        t0 = time.perf_counter()
        n = 0
        while self.run_round():
            n += 1
            if max_rounds is not None and n >= max_rounds:
                break
        t1 = time.perf_counter()
        with span("serve.drain_fence"):
            self.pool.block()
        if self._pending_round is not None:
            dt, c, b = self._pending_round
            self._pending_round = (dt + time.perf_counter() - t1, c, b)
        self._flush_round()
        if self.reshard is not None and self.done:
            # before the fault sweep: a crashed coordinator resumes and
            # commits here, closing its reshard_crash event as a recovery.
            # An interrupted drain leaves the manifest to recover_fleet
            with span("serve.reshard.finalize"):
                self.reshard.finalize(self.round)
        self._flush_drained_gc(force=True)
        if self.faults is not None and self.done:
            # only a completed drain sweeps its faults: an interrupted one
            # (a crash round) leaves the repair to the journal's recovery
            with span("serve.finalize_faults"):
                self.finalize_faults()
        self.stats.wall_time += time.perf_counter() - t0
        self.stats.evictions = self.pool.evictions
        self.stats.restores = self.pool.restores
        self.stats.promotions = self.pool.promotions
        if self._lazy:
            # the patch total is known once the docs materialized: at the
            # drain's end the lazy tally is the eager sum
            self.stats.patches = self.streams.patches_total
        return self.stats

    @property
    def done(self) -> bool:
        if self._lazy:
            return self.streams.all_done
        return all(s.remaining == 0 for s in self.streams.values())
