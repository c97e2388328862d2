"""The broadcast bus: op fan-out and sequence-keyed reassembly per group.

Each tick (one scheduler macro-round):

1. **publish**: the next turn blocks of a group's arbitration order are
   published, paced at ``pub_ops`` coalesced ops a group a tick (about
   what one scheduled replica consumes a macro-round, ``K * batch``).  A
   published block is journaled (a ``bcast`` record) before any replica may
   consume it, so a surviving lane record implies its broadcast records
   survived too, which is what lets ``recover_fleet`` and
   :func:`replay_journal_broadcasts` resume to convergence;
2. **deliver**: the author's replica gets its block at once (read your
   writes); the others :data:`REMOTE_LAG` ticks later.  Delivery inserts
   the block into the replica's reassembly buffer, and the replica's
   assembled prefix (what the scheduler may stage) advances over contiguous
   sequences only, so delivery order commutes: permuting a round's remote
   batches (the ``merge_reorder`` fault) changes no replica's stream;
3. **faults**: a partitioned replica (``replica_partition``) buffers its
   remote deliveries in a backlog, flushed in sequence order at the heal.

The bus also records the delivery histories of a sampled set of groups
(the RA-linearizability checker's input) and counts the broadcast fan-out
(packed op-lane bytes delivered to remote replicas) through
``obs/shard.py ReplicaMetrics``.  Host only: no tensor anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...lint.race_sanitizer import published
from .group import GroupTable, ReplicaGroup

#: Ticks between a block's publication and its delivery to the peers.
REMOTE_LAG = 1


@dataclass
class _GroupState:
    """One group's bus state; index ``w`` is writer ``w``'s replica."""

    group: ReplicaGroup
    published: int = 0  # blocks published (a prefix of the sequence)
    last_publish_round: int = -1
    converged_round: int = -1  # every replica fully assembled
    delivered: list[list[bool]] = field(default_factory=list)
    prefix: list[int] = field(default_factory=list)  # contiguous blocks
    # (ready_round, seq, dst_writer): remote deliveries in flight
    pending: list[tuple[int, int, int]] = field(default_factory=list)
    backlog: list[list[int]] = field(default_factory=list)  # per replica

    def __post_init__(self):
        W, n = self.group.writers, self.group.n_blocks
        self.delivered = [[False] * n for _ in range(W)]
        self.prefix = [0] * W
        self.backlog = [[] for _ in range(W)]

    def advance_prefix(self, w: int) -> None:
        d, p = self.delivered[w], self.prefix[w]
        while p < len(d) and d[p]:
            p += 1
        self.prefix[w] = p


class BroadcastBus:
    """Publish and deliver over a :class:`GroupTable` (the module says
    how), owned by the scheduler's thread.  Each block's publication
    crosses :meth:`_cross_block`, a publish point of the race sanitizer
    (``lint/race_sanitizer.py``), as in JAX: it counts the edge and gives
    request traces their bus hop."""

    def __init__(self, table: GroupTable, *, pub_ops: int, op_nbytes: int,
                 journal=None, metrics=None,
                 history_groups: set[int] | None = None):
        self.table = table
        self.pub_ops = max(1, pub_ops)
        self.op_nbytes = op_nbytes
        self.journal = journal
        self.metrics = metrics  # obs/shard.py ReplicaMetrics (or None)
        self._gs = {g.logical_id: _GroupState(g) for g in table}
        # the RA checker's input, for the sampled groups only: each
        # replica's (round, seq) deliveries and each group's publications
        self.history_groups = set(history_groups or ())
        self.histories: dict[int, list[list[tuple[int, int]]]] = {}
        self.publish_log: dict[int, list[tuple[int, int]]] = {}
        for g in table:
            if g.logical_id in self.history_groups:
                self.histories[g.logical_id] = [[] for _ in
                                                range(g.writers)]
                self.publish_log[g.logical_id] = []
        # faults: (gid, writer) -> (heal_round, event or None)
        self._partitions: dict[tuple[int, int], tuple[int, object]] = {}
        self._healed_waiting: list[tuple[int, int, object]] = []
        self._reorder: tuple[object, object] | None = None  # (rng, event)
        # the report's counts
        self.blocks_published = 0
        self.blocks_delivered_remote = 0
        self.bytes_broadcast = 0
        self.divergence_max = 0
        self.partitions_healed = 0
        self.reordered_rounds = 0

    # ---- fault arming (the replicated scheduler calls these) ----

    def start_partition(self, gid: int, writer: int, heal_round: int,
                        event=None) -> None:
        self._partitions[(gid, writer)] = (heal_round, event)

    def partitioned(self, gid: int, writer: int) -> bool:
        return (gid, writer) in self._partitions

    def arm_reorder(self, rng, event=None) -> None:
        """Permute the next delivering tick's remote deliveries across
        writers (each writer's own sequence order kept)."""
        self._reorder = (rng, event)

    def live_partition_targets(self) -> list[tuple[int, int]]:
        """The (gid, writer) pairs a partition can hit observably: the
        group still has blocks the replica has not assembled."""
        out = []
        for gid in sorted(self._gs):
            gs = self._gs[gid]
            if gs.group.writers < 2:
                continue
            for w in range(gs.group.writers):
                if (gs.prefix[w] < gs.group.n_blocks
                        and (gid, w) not in self._partitions):
                    out.append((gid, w))
        return out

    # ---- the tick ----

    def _record(self, gid: int, w: int, rnd: int, seq: int) -> None:
        h = self.histories.get(gid)
        if h is not None:
            h[w].append((rnd, seq))

    def _deliver(self, gs: _GroupState, w: int, seq: int, rnd: int,
                 remote: bool) -> None:
        gid = gs.group.logical_id
        if remote and (gid, w) in self._partitions:
            gs.backlog[w].append(seq)
            return
        if gs.delivered[w][seq]:
            return  # a duplicate: reassembly is idempotent
        gs.delivered[w][seq] = True
        gs.advance_prefix(w)
        self._record(gid, w, rnd, seq)
        if remote:
            lo, hi = gs.group.block_span(seq)
            nbytes = (hi - lo) * self.op_nbytes
            self.blocks_delivered_remote += 1
            self.bytes_broadcast += nbytes
            if self.metrics is not None:
                self.metrics.note_broadcast(nbytes)

    def _heal_due(self, rnd: int) -> None:
        for key in sorted(self._partitions):
            heal_round, event = self._partitions[key]
            if rnd < heal_round:
                continue
            gid, w = key
            gs = self._gs[gid]
            del self._partitions[key]
            for seq in sorted(gs.backlog[w]):
                self._deliver(gs, w, seq, rnd, remote=True)
            gs.backlog[w] = []
            self.partitions_healed += 1
            if event is not None:
                # recovered once the replica's prefix is back at the
                # published head (the backlog flush is the catch-up)
                self._healed_waiting.append((gid, w, event))

    def _deliver_due(self, rnd: int) -> None:
        reordered = False
        for gid in sorted(self._gs):
            gs = self._gs[gid]
            due = [p for p in gs.pending if p[0] <= rnd]
            if not due:
                continue
            gs.pending = [p for p in gs.pending if p[0] > rnd]
            if self._reorder is not None:
                rng, event = self._reorder
                # permute the writers' interleave, each author's blocks
                # kept in its order
                by_pair: dict[tuple[int, int], list] = {}
                for ready, seq, w in due:
                    by_pair.setdefault((w, gs.group.owner(seq)), []).append(
                        (ready, seq, w))
                keys = sorted(by_pair)
                perm = rng.permutation(len(keys))
                due = [item for i in perm
                       for item in sorted(by_pair[keys[int(i)]],
                                          key=lambda p: p[1])]
                reordered = True
                if event is not None and not event.fired:
                    event.fire(rnd, group=gid, batches=len(due))
                    event.recover(commuted=True)
            else:
                due.sort(key=lambda p: p[1])
            for _ready, seq, w in due:
                self._deliver(gs, w, seq, rnd, remote=True)
        if reordered:  # one round: a delivery-order fault, not a mode
            self.reordered_rounds += 1
            self._reorder = None

    @published
    def _cross_block(self, gid: int, seq: int, owner: int) -> None:
        """Block ``seq`` of group ``gid`` leaves writer ``owner``'s log for
        its peers.  The bus is owned by one thread, so nothing is handed
        over here: the point counts the edge (one entry a published
        block) and gives request traces their bus hop."""

    def _publish(self, gs: _GroupState, rnd: int) -> None:
        g = gs.group
        budget = self.pub_ops
        while gs.published < g.n_blocks and budget > 0:
            seq = gs.published
            lo, hi, owner = g.blocks[seq]
            budget -= hi - lo
            gs.published = seq + 1
            gs.last_publish_round = rnd
            self.blocks_published += 1
            self._cross_block(g.logical_id, seq, owner)
            if g.logical_id in self.publish_log:
                self.publish_log[g.logical_id].append((rnd, seq))
            if self.journal is not None:
                self.journal.event("bcast", r=rnd, g=g.logical_id, w=owner,
                                   s=seq, lo=lo, hi=hi)
            # read your writes: the author's replica sees its block when it
            # is published, partition or not (a partition cuts the network)
            self._deliver(gs, owner, seq, rnd, remote=False)
            for w in range(g.writers):
                if w == owner:
                    continue
                gs.pending.append((rnd + REMOTE_LAG, seq, w))

    def tick(self, rnd: int) -> None:
        """One bus round: heal the due partitions, deliver the due remote
        blocks, publish the next paced blocks."""
        self._heal_due(rnd)
        self._deliver_due(rnd)
        for gid in sorted(self._gs):
            gs = self._gs[gid]
            if gs.published < gs.group.n_blocks:
                self._publish(gs, rnd)
            if (gs.converged_round < 0 and gs.group.n_blocks
                    and all(p == gs.group.n_blocks for p in gs.prefix)):
                gs.converged_round = rnd
        still = []
        for gid, w, event in self._healed_waiting:
            if self._gs[gid].prefix[w] >= self._gs[gid].published:
                event.recover(healed_round=rnd)
            else:
                still.append((gid, w, event))
        self._healed_waiting = still
        d = self.divergence_depth()
        self.divergence_max = max(self.divergence_max, d)
        if self.metrics is not None:
            self.metrics.note_divergence(d)

    # ---- recovery (marks outside the live tick) ----

    def force_delivered(self, gid: int, seq: int,
                        writer: int | None = None) -> None:
        """Mark block ``seq`` published and delivered (to ``writer``, or to
        every replica) without the live path's lag, partition and fan-out
        accounting: the recovery primitive of
        :func:`replay_journal_broadcasts` and the scheduler's
        ``resync_delivery``.  A sampled history records it at round ``-1``
        (before the crash), so the RA checker still sees a whole
        arbitration prefix.  Idempotent; :meth:`settle_prefixes` advances
        the prefixes after a batch of marks."""
        gs = self._gs[gid]
        gs.published = max(gs.published, seq + 1)
        targets = range(gs.group.writers) if writer is None else (writer,)
        for w in targets:
            if not gs.delivered[w][seq]:
                gs.delivered[w][seq] = True
                self._record(gid, w, -1, seq)

    def settle_prefixes(self) -> None:
        """Derive every assembled prefix again after forced marks."""
        for gs in self._gs.values():
            for w in range(gs.group.writers):
                gs.advance_prefix(w)

    # ---- queries (the scheduler's) ----

    def delivered_ops(self, replica_id: int) -> int:
        """The replica's assembled prefix in ops: what the scheduler may
        stage up to."""
        g, w = self.table.group_of(replica_id)
        return g.prefix_ops(self._gs[g.logical_id].prefix[w])

    def divergence_depth(self) -> int:
        """The deepest replica lag now, in turn blocks (the published head
        less the assembled prefix, over every replica)."""
        return max((gs.published - p for gs in self._gs.values()
                    for p in gs.prefix), default=0)

    def pending_work(self) -> bool:
        """Whether a later tick can still move ops toward a replica
        (unpublished blocks, deliveries in flight, backlogs, or a prefix
        behind the published head)."""
        for gs in self._gs.values():
            if gs.published < gs.group.n_blocks or gs.pending:
                return True
            if any(gs.backlog) or any(p < gs.published for p in gs.prefix):
                return True
        return False

    def convergence_rounds(self) -> list[int]:
        """For each converged group, the rounds from its last publication
        to full assembly on every replica."""
        return [gs.converged_round - gs.last_publish_round
                for gs in self._gs.values()
                if gs.converged_round >= 0 and gs.last_publish_round >= 0]

    def group_state(self, gid: int) -> _GroupState:
        return self._gs[gid]


def replay_journal_broadcasts(bus: BroadcastBus, records: list[dict]) -> int:
    """Rebuild the bus's delivery state from journaled ``bcast`` records
    (crash recovery): every journaled block is published again and
    delivered to every replica of its group.  Delivering again is safe,
    since the cursor is the idempotence mark (``clamp_redelivery``), and
    the WAL's valid-prefix property puts every restored cursor inside the
    reassembled prefix.  Returns the blocks replayed."""
    n = 0
    for rec in records:
        if rec.get("t") != "bcast":
            continue
        gid = int(rec["g"])
        gs = bus._gs.get(gid)
        if gs is None:
            continue
        seq = int(rec["s"])
        if seq >= gs.group.n_blocks:
            continue
        bus.force_delivered(gid, seq)
        n += 1
    bus.settle_prefixes()
    return n
