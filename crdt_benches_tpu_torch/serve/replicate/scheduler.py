"""The replicated fleet's scheduler: macro-rounds over writer groups.

``ReplicatedScheduler`` is ``serve/scheduler.py FleetScheduler`` with
delivery owned by the broadcast bus.  A replica's stream is the group's
whole op sequence (shared arrays), but the scheduler stages ops only up to
the replica's assembled prefix, so a partitioned or lagging replica waits
while its peers serve and catches up when its backlog flushes.  Peers' ops
reach the device through the same macro dispatch as the replica's own
(K1's per-row form and K4, fused; ``engine/merge_fleet.py`` round by round
with the ``scan`` kernel), so a remote merge adds no sync.

Everything else (capacity classes, promotion, eviction and restore through
the spool, the WAL, barriers, repairs, degradation) applies to replica rows
unchanged: replica rows are pool rows.  On top come the replication counts
(remote merges by class, the divergence gauge, broadcast fan-out through
``obs/shard.py ReplicaMetrics``) and two fault hooks, ``replica_partition``
and ``merge_reorder``.
"""

from __future__ import annotations

import numpy as np

from ...obs.shard import ReplicaMetrics
from ..journal import read_journal, recover_fleet
from ..scheduler import FleetScheduler, _Plan
from .broadcast import REMOTE_LAG, BroadcastBus, replay_journal_broadcasts
from .group import GroupTable, attach_turn_blocks

#: Consecutive rounds the planner may wait on the bus (partition spans,
#: deliveries in flight) with nothing to stage before it calls the backlog
#: stuck.
IDLE_ROUND_LIMIT = 100_000

#: A partition's span in rounds when its fault event gives no ``param``.
DEFAULT_PARTITION_SPAN = 3


class ReplicatedScheduler(FleetScheduler):
    def __init__(self, pool, streams, table: GroupTable, *,
                 turn_ops: int = 64, history_sample: int = 16,
                 seed: int = 0, **kw):
        super().__init__(pool, streams, **kw)
        self.table = table
        self.turn_ops = turn_ops
        attach_turn_blocks(table, streams, turn_ops)
        # the RA checker's sample: a seeded spread over the logical docs
        gids = sorted(g.logical_id for g in table)
        rng = np.random.default_rng(seed + 2)
        n_hist = min(history_sample, len(gids))
        sample = ({int(g) for g in rng.choice(gids, size=n_hist,
                                               replace=False)}
                  if n_hist else set())
        self.replica_metrics = ReplicaMetrics(self.stats.metrics,
                                              pool.classes)
        # a group publishes about what one scheduled replica consumes a
        # macro-round
        self.bus = BroadcastBus(
            table, pub_ops=self.batch * self.macro_k,
            op_nbytes=sum(dt.itemsize for dt in pool.op_dtypes),
            journal=self.journal,
            metrics=self.replica_metrics, history_groups=sample)
        # bus-owned delivery: every replica starts with an empty prefix
        for st in streams.values():
            st.delivered = 0
        self.merged_ops = 0
        self.merged_unit_ops = 0
        self.local_ops = 0
        self._idle_rounds = 0

    # ---- the bus ----

    def _fire_replication_faults(self) -> None:
        """Poll the two replication fault hooks at the bus tick."""
        ev = self.faults.partition_event(self.round)
        if ev is not None:
            targets = self.bus.live_partition_targets()
            if targets:
                gid, w = targets[self.faults.pick(list(range(len(targets))))]
                heal = self.round + (ev.param or DEFAULT_PARTITION_SPAN)
                self.bus.start_partition(gid, w, heal, event=ev)
                ev.fire(self.round, group=gid, writer=w, heal_round=heal)
                self.stats.faults_injected += 1
                self._note_fault()
        ev = self.faults.reorder_event(self.round)
        if ev is not None and self.bus._reorder is None:
            # armed now; it fires at the next tick that delivers remote
            # batches (a permutation needs traffic)
            self.bus.arm_reorder(self.faults.rng, ev)
            self.stats.faults_injected += 1
            self._note_fault()

    def _deliver(self, st) -> None:
        """The replica's schedulable window is its assembled prefix
        (monotone by construction)."""
        got = self.bus.delivered_ops(st.doc_id)
        if st.delivered is None or got > st.delivered:
            st.delivered = got

    def _plan(self) -> _Plan | None:
        """The base planner with the bus tick in its loop: publish and
        deliver for this round, select, and with no lane to stage, move the
        clock over arrival gaps and bus waits."""
        while True:
            self._k_round = self.effective_k
            self._planned_degraded = self._degrade_left > 0
            if self.faults is not None:
                self._fire_replication_faults()
            self.bus.tick(self.round)
            plan = _Plan(base_round=self.round)
            self._select(plan)
            if plan.lanes:
                self._idle_rounds = 0
                self._place(plan)
                return plan
            pending = [s.arrival for s in self.streams.values()
                       if s.remaining and s.arrival > self.round]
            if pending:
                self.round = min(pending)
                continue
            if self.bus.pending_work():
                self._idle_rounds += 1
                if self._idle_rounds > IDLE_ROUND_LIMIT:
                    raise RuntimeError(
                        "replicated scheduler: broadcast backlog never "
                        f"drained after {IDLE_ROUND_LIMIT} idle rounds")
                self.round += 1
                continue
            return None

    def _advance(self, plan: _Plan) -> None:
        """Before the base class moves the cursors: split each staged
        slice into the writer's own ops and its peers' merged ones, counted
        under the class the lane landed in."""
        traced = self.reqtrace.armed
        for cls, lanes in plan.lanes.items():
            for lane in lanes:
                st = lane.stream
                if st.doc_id in self._dead_lanes:
                    continue
                g, w = self.table.group_of(st.doc_id)
                rem_ops = rem_units = 0
                by_writer: dict[int, int] | None = {} if traced else None
                for a, b, ow in g._remote_segments(w, st.cursor, lane.end):
                    rem_ops += b - a
                    rem_units += st.units_before(b) - st.units_before(a)
                    if by_writer is not None:
                        by_writer[ow] = by_writer.get(ow, 0) + (b - a)
                loc = (lane.end - st.cursor) - rem_ops
                if rem_ops:
                    self.replica_metrics.note_merged(cls, rem_ops, rem_units)
                    self.merged_ops += rem_ops
                    self.merged_unit_ops += rem_units
                    if by_writer:
                        # a replica's merged ops belong to their authors
                        self.reqtrace.note_remote(st.doc_id, by_writer)
                if loc:
                    self.replica_metrics.note_local(loc)
                    self.local_ops += loc
        super()._advance(plan)

    def resync_delivery(self) -> None:
        """Derive every replica's delivery point from the bus again (after
        a recovery replayed the journaled broadcasts): the assembled prefix
        must cover the restored cursor.  A cursor past the journaled blocks
        (a torn tail) is covered from the split, which is workload data,
        and a block forced below the published head reaches every replica
        (nothing publishes it again)."""
        for rid, st in self.streams.items():
            g, _w = self.table.group_of(rid)
            if st.cursor > 0 and g.blocks:
                turn = g.blocks[0][1] - g.blocks[0][0]
                need = min(-(-st.cursor // turn), g.n_blocks)
                for seq in range(need):
                    self.bus.force_delivered(g.logical_id, seq)
        self.bus.settle_prefixes()
        for rid, st in self.streams.items():
            st.delivered = self.bus.delivered_ops(rid)

    # ---- reporting ----

    def replication_block(self) -> dict:
        """The report's ``replication`` block."""
        conv = self.bus.convergence_rounds()
        return {
            "version": 1,
            "writers": (self.table.groups[0].writers if len(self.table)
                        else 0),
            "groups": len(self.table),
            "turn_ops": self.turn_ops,
            "remote_lag": REMOTE_LAG,
            "pub_ops": self.bus.pub_ops,
            "merged_ops": self.merged_ops,
            "merged_unit_ops": self.merged_unit_ops,
            "local_ops": self.local_ops,
            "broadcast_blocks": self.bus.blocks_published,
            "broadcast_deliveries": self.bus.blocks_delivered_remote,
            "broadcast_bytes": self.bus.bytes_broadcast,
            "divergence_depth_max": self.bus.divergence_max,
            "partitions_healed": self.bus.partitions_healed,
            "reordered_rounds": self.bus.reordered_rounds,
            "convergence_rounds_max": max(conv) if conv else 0,
            "convergence_rounds_mean": (sum(conv) / len(conv) if conv
                                        else 0.0),
            "history_groups": sorted(self.bus.histories),
        }


def recover_replicated_fleet(pool, streams, table: GroupTable,
                             journal_dir: str, *, journal=None, **sched_kw):
    """Recover a crashed replicated fleet: the pool and cursors from the
    newest intact snapshot and the WAL tail (``journal.recover_fleet``:
    replica rows are pool rows), the bus from the journaled ``bcast``
    records, and a fresh :class:`ReplicatedScheduler` whose drain replays
    the redo tail through the macro path to convergence.  Returns
    ``(scheduler, recovery report, blocks replayed)``."""
    report = recover_fleet(pool, streams, journal_dir)
    records, _ = read_journal(journal_dir)
    sched = ReplicatedScheduler(pool, streams, table, journal=journal,
                                start_round=report.resume_round, **sched_kw)
    replayed = replay_journal_broadcasts(sched.bus, records)
    sched.resync_delivery()
    return sched, report, replayed
