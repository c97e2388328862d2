"""Admission and batching scheduler of the document fleet: macro-rounds
(the JAX package's ``serve/scheduler.py``, its core drain and its tiered
residency).

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

The macro depth of a class's tensor trims exactly to its deepest lane (the
JAX host form's rule): nothing in the port is keyed by K.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..bench.harness import _quantile
from ..ops.packing import pack_ops
from ..traces.tensorize import INSERT, PAD, split_insert_runs, tensorize_ranges
from ..utils.checkpoint import load_state
from .journal import retained_floor, write_snapshot
from .pool import DocPool, _fresh_row_np


@dataclass
class DocStream:
    """One doc's pending op queue: coalesced range ops, insert runs split
    to at most ``batch_chars`` chars, in the pool's packed lane dtypes,
    with a cursor.  ``limit`` truncates the stream (a journaled
    quarantine or shed decision re-applied by recovery) and ``lossy``
    marks a doc whose ops were shed, which verification leaves out."""

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
    limit: int | None = None  # stream truncation (shed / quarantine)
    lossy: bool = False

    @property
    def n_total(self) -> int:
        """Stream length after any truncation."""
        n = len(self.kind)
        return n if self.limit is None else min(self.limit, n)

    @property
    def remaining(self) -> int:
        return self.n_total - self.cursor

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
            arrival=s.arrival,
        )
    return streams


#: Host phases of a macro-round, timed by the host clock; a pool with a
#: prefetcher adds "prefetch" (the harvest and the submissions), a
#: journaled drain "wal" (the round record) and "snapshot" (the barriers).
PHASES = ("plan", "stage", "moves", "dispatch")


@dataclass
class ServeStats:
    """One drain's counters and per-round latencies."""

    rounds: int = 0  # macro-rounds dispatched
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
    round_latencies: list[float] = field(default_factory=list)
    #: per round: a snapshot barrier ran in it (a forced sync)
    barrier_flags: list[bool] = field(default_factory=list)
    phase_seconds: dict[str, float] = field(
        default_factory=lambda: dict.fromkeys(PHASES, 0.0))
    snapshots: int = 0
    snapshots_full: int = 0  # chain-rooting full barriers
    snapshots_delta: int = 0  # dirty-row delta barriers
    snapshot_time: float = 0.0  # seconds in write_snapshot

    def latency_quantiles(self, ps=(0.5, 0.95, 0.99)) -> dict[str, float]:
        """Quantiles of the steady per-macro-round wall latencies: barrier
        rounds are left out (all rounds when every round had one)."""
        s = sorted(lat for lat, b in zip(self.round_latencies,
                                         self.barrier_flags) if not b)
        s = s or sorted(self.round_latencies)
        return {f"p{100 * p:g}": (_quantile(s, p) if s else 0.0) for p in ps}

    @property
    def barrier_time(self) -> float:
        """Wall time of the rounds that ran a snapshot barrier."""
        return sum(lat for lat, b in zip(self.round_latencies,
                                         self.barrier_flags) if b)

    @property
    def barrier_rounds(self) -> int:
        return sum(self.barrier_flags)

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


class FleetScheduler:
    def __init__(self, pool: DocPool, streams: dict[int, DocStream],
                 batch: int = 64, macro_k: int = 1, batch_chars: int = 256,
                 journal=None, snapshot_every: int = 0,
                 snapshot_keep: int = 2, snapshot_full_every: int = 4,
                 start_round: int = 0):
        self.pool = pool
        self.streams = streams
        self.batch = batch
        self.macro_k = max(1, macro_k)
        self.batch_chars = batch_chars
        self.nbits = max(1, int(batch_chars).bit_length())
        self.round = start_round
        self.journal = journal  # serve/journal.py OpJournal (or None)
        self.snapshot_every = snapshot_every
        self.snapshot_keep = snapshot_keep
        #: every Nth barrier is a chain-rooting full snapshot, the ones
        #: between deltas (<= 1: every barrier full)
        self.snapshot_full_every = max(0, snapshot_full_every)
        self._barrier_count = 0
        self._n_rounds = 0  # macro-rounds advanced by this scheduler
        # FIFO of doc ids not yet arrived or with pending ops, in arrival
        # order (stable for determinism)
        self._rr: deque[int] = deque(sorted(
            streams, key=lambda d: (streams[d].arrival, d)))
        self.stats = ServeStats(
            patches=sum(s.n_patches for s in streams.values()))
        # predictive prefetch (a pool with a prefetcher): doc ->
        # (submit round, seq) of the reads in flight, so reads whose
        # results never arrive are reaped by seq
        self._prefetch_inflight: dict[int, tuple[int, int]] = {}
        #: the rotation's front scanned for cold docs each round
        self._prefetch_lookahead = max(
            32, sum(b.R for b in pool.buckets.values()))
        self.prefetch_wasted = 0  # harvested but stale or superseded
        self.prefetch_missed = 0  # dropped by an injected fault (none yet)
        self.limbo_pulls = 0  # same-round victim-to-promotion pulls
        if pool.prefetcher is not None:
            self.stats.phase_seconds["prefetch"] = 0.0
        if journal is not None:
            self.stats.phase_seconds["wal"] = 0.0
            self.stats.phase_seconds["snapshot"] = 0.0

    # ---- planning (host only; no device syncs) ----

    def _sim_takes(self, st: DocStream) -> tuple[list[int], int]:
        """Per-slice op counts of one doc's next macro-round and its end
        cursor."""
        takes: list[int] = []
        c = st.cursor
        n = st.n_total
        for _ in range(self.macro_k):
            if c >= n:
                break
            e = st.slice_end(c, self.batch, self.batch_chars, n)
            takes.append(e - c)
            c = e
        return takes, c

    def _select(self, plan: _Plan) -> None:
        """Pick this macro-round's lanes {class: [_Lane]}, bounded by each
        bucket's rows, in round-robin order.  Once every class is full no
        remaining doc can schedule: the rest of the rotation stays in
        place."""
        pool = self.pool
        scheduled: list[int] = []
        deferred: list[int] = []
        n_lanes: dict[int, int] = {}
        open_classes = {c for c in pool.classes if pool.buckets[c].R > 0}
        while self._rr and open_classes:
            doc_id = self._rr.popleft()
            st = self.streams[doc_id]
            if st.remaining == 0:
                continue  # drained: out of the rotation for good
            if st.arrival > self.round:
                deferred.append(doc_id)
                continue
            takes, end = self._sim_takes(st)
            rec = pool.docs[doc_id]
            cls = pool.class_for(
                max(rec.n_init + st.ins_before(end), rec.length, 1))
            R = pool.buckets[cls].R
            lanes = plan.lanes.setdefault(cls, [])
            n = n_lanes.get(cls, 0)
            if n >= R:
                deferred.append(doc_id)
                open_classes.discard(cls)
                continue
            lanes.append(_Lane(stream=st, takes=takes, end=end))
            n_lanes[cls] = n + 1
            if n + 1 >= R:
                open_classes.discard(cls)
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
        candidates = [d for d, _row in self.pool.residents(cls)
                      if d not in selected]
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
            while b.n_free < len(pending):
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
            k_eff = min(max(len(l.takes) for l in lanes), self.macro_k)
            resident = [lane for lane in lanes if lane.row >= 0]
            n_installs = len(pending)
            chosen_rt = b.R
            relocs: list[tuple[_Lane, int]] = []
            install_rows: list[int] = []
            for rt in pool.tiers(cls):
                fb = sorted(r for r in b.free if r < rt)
                high = [lane for lane in resident if lane.row >= rt]
                if len(high) > len(fb) or len(fb) - len(high) < n_installs:
                    continue
                chosen_rt = rt
                relocs = list(zip(high, fb))
                install_rows = fb[len(high):len(high) + n_installs]
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
        clock jumps over arrival gaps."""
        while True:
            plan = _Plan(base_round=self.round)
            self._select(plan)
            if plan.lanes:
                self._place(plan)
                return plan
            pending = [s.arrival for s in self.streams.values()
                       if s.remaining and s.arrival > self.round]
            if not pending:
                return None
            self.round = min(pending)

    # ---- staging (host; overlaps the device's work) ----

    def _stage(self, plan: _Plan) -> dict[int, tuple]:
        """Each class's (K, Rt, B) op tensors in the pool's packed lane
        dtypes (PAD lanes carry slot0 = 0, never read)."""
        tensors: dict[int, tuple] = {}
        B = self.batch
        dt_kind, dt_pos, dt_rlen, dt_slot = self.pool.op_dtypes
        for cls, lanes in plan.lanes.items():
            K, Rt = plan.k_eff[cls], plan.rt[cls]
            kind = np.full((K, Rt, B), PAD, dt_kind)
            pos = np.zeros((K, Rt, B), dt_pos)
            rlen = np.zeros((K, Rt, B), dt_rlen)
            slot0 = np.zeros((K, Rt, B), dt_slot)
            for lane in lanes:
                st = lane.stream
                r = lane.row
                c = st.cursor
                for k, take in enumerate(lane.takes):
                    kind[k, r, :take] = st.kind[c:c + take]
                    pos[k, r, :take] = st.pos[c:c + take]
                    rlen[k, r, :take] = st.rlen[c:c + take]
                    slot0[k, r, :take] = st.slot0[c:c + take]
                    c += take
            tensors[cls] = (kind, pos, rlen, slot0)
        return tensors

    # ---- boundary moves (the only syncs of a round) ----

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
        for doc_id, cls, row in plan.evictions:
            if doc_id in plan.cancelled_evictions:
                continue  # pulled into a larger class this round
            doc, length, nvis = snaps[cls]
            if warm_mode:
                pool.warm_deposit(doc_id, doc[row], int(length[row]),
                                  int(nvis[row]),
                                  last_sched=pool.docs[doc_id].last_sched)
            else:
                pool.spool_save(doc_id, doc[row], int(length[row]),
                                int(nvis[row]))
        if warm_mode:
            pool._enforce_warm_budget()  # the harvest's overflow too
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
                if source[0] == "fresh":
                    n_init = pool.docs[doc_id].n_init
                    doc_w[row] = _fresh_row_np(C, n_init)
                    len_w[row] = nvis_w[row] = n_init
                    continue
                if source[0] == "warm":  # a memory compose, no disk read
                    e = source[1]
                    src_doc, L, nv = e.doc_row, e.length, e.nvis
                elif source[0] == "spool":
                    st = load_state(source[1])
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

    # ---- predictive prefetch (never blocks the hot thread) ----

    def _harvest_prefetch(self) -> None:
        """Adopt the completed reads into the warm tier (start of a round,
        before its plan).  A payload with an error is left to the
        synchronous admission, which reads the spool itself; a stale or
        superseded one is counted and dropped."""
        pf = self.pool.prefetcher
        if pf is None:
            return
        for payload in pf.drain():
            doc_id = payload["doc"]
            self._prefetch_inflight.pop(doc_id, None)
            if payload["error"] is not None:
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
        lookahead, the warm budget and the worker's queue depth."""
        pf = self.pool.prefetcher
        if pf is None:
            return
        pool = self.pool
        horizon = self.round + self.macro_k
        # reap reads whose results never arrived (the worker's bounded
        # publish dropped them): they would pin the budget for good
        reap_before = self.round - 32 * self.macro_k
        stale = [(d, seq) for d, (r0, seq) in self._prefetch_inflight.items()
                 if r0 < reap_before]
        if stale:
            for d, _ in stale:
                del self._prefetch_inflight[d]
            pf.note_lost([seq for _, seq in stale])
        space = (min(self._prefetch_lookahead, pool.warm.budget, pf.capacity)
                 - len(self._prefetch_inflight))
        wanted: list[tuple[int, str, int]] = []
        for scanned, doc_id in enumerate(self._rr, 1):
            if scanned > self._prefetch_lookahead or len(wanted) >= space:
                break
            if doc_id in self._prefetch_inflight:
                continue
            rec = pool.docs[doc_id]
            if (rec.spool is None or rec.cls is not None
                    or doc_id in pool.warm):
                continue
            st = self.streams[doc_id]
            if st.remaining == 0 or st.arrival > horizon:
                continue
            wanted.append((doc_id, rec.spool, pool.spool_gen(doc_id)))
        for doc_id, path, gen in wanted:
            seq = pf.submit(doc_id, path, gen)
            if seq:
                self._prefetch_inflight[doc_id] = (self.round, seq)

    # ---- dispatch and host mirrors ----

    def _dispatch(self, plan: _Plan, tensors: dict[int, tuple]) -> None:
        for cls, (kind, pos, rlen, slot0) in tensors.items():
            self.pool.macro_step(cls, kind, pos, rlen, slot0,
                                 nbits=self.nbits)
            self.stats.dispatches += 1
            self.stats.slices += plan.k_eff[cls]
            self.stats.staged_cells += kind.size

    def _advance(self, plan: _Plan) -> None:
        """Host mirrors after dispatch: the staged ops will be applied and
        length and cursor evolve deterministically, so no sync is needed
        to keep scheduling exact."""
        for lanes in plan.lanes.values():
            for lane in lanes:
                st = lane.stream
                rec = self.pool.docs[st.doc_id]
                self.stats.ops += lane.end - st.cursor
                self.stats.unit_ops += (st.units_before(lane.end)
                                        - st.units_before(st.cursor))
                st.cursor = lane.end
                rec.length = rec.n_init + st.ins_before(lane.end)
                rec.last_sched = plan.base_round
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
        self._snapshot_barrier()
        return True

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
        if kind == "full":
            self.stats.snapshots_full += 1
        else:
            self.stats.snapshots_delta += 1
        self.journal.note_snapshot(d)
        floor = retained_floor(self.journal.dir)
        self.journal.compact(self.round if floor is None else floor,
                             crash_hook=self._gc_crash_hook)
        self.journal.event("snap", r=self.round, dir=os.path.basename(d),
                           snap_kind=kind, depth=int(m["depth"]))

    def _gc_crash_hook(self) -> bool:
        """The GC pass's kill point between its manifest commit and the
        unlinks (the faults' ``crash_compact``): never fires until the
        fault injector is ported."""
        return False

    # ---- the drain loop ----

    def run_round(self) -> bool:
        """One macro-round (prefetch harvest -> plan -> WAL record ->
        stage -> boundary moves -> prefetch submissions -> one dispatch
        per class -> advance -> snapshot barrier).  Returns False when no
        work remains."""
        t0 = time.perf_counter()
        ph = self.stats.phase_seconds
        self._harvest_prefetch()
        th = time.perf_counter()
        timed_prefetch = "prefetch" in ph
        if timed_prefetch:
            ph["prefetch"] += th - t0
        plan = self._plan()
        t1 = time.perf_counter()
        ph["plan"] += t1 - th
        if plan is None:
            return False
        if self.journal is not None:
            self._journal_round(plan)  # write-ahead: before the dispatch
            tw = time.perf_counter()
            ph["wal"] += tw - t1
            t1 = tw
        tensors = self._stage(plan)
        t2 = time.perf_counter()
        self._execute_moves(plan)
        t3 = time.perf_counter()
        self._plan_prefetch()
        tp = time.perf_counter()
        self._dispatch(plan, tensors)
        self._advance(plan)
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
        self.stats.rounds += 1
        self.stats.round_latencies.append(t5 - t0)
        self.stats.barrier_flags.append(barrier)
        return True

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
        self.pool.block()
        if self.stats.round_latencies:
            self.stats.round_latencies[-1] += time.perf_counter() - t1
        self.stats.wall_time += time.perf_counter() - t0
        self.stats.evictions = self.pool.evictions
        self.stats.restores = self.pool.restores
        self.stats.promotions = self.pool.promotions
        return self.stats

    @property
    def done(self) -> bool:
        return all(s.remaining == 0 for s in self.streams.values())
