"""Writer groups: the replicated fleet's topology.

A logical document served by W writers is a group of W replica documents
(each a pool row with its own class, spool and journal lanes), plus the
split of the doc's op stream into round-robin turn blocks
(``serve/workload.py split_turns``).  Block ``j`` is authored by writer
``j % W``; ascending block sequence is the group's arbitration order, and it
concatenates back to the original stream, so the oracle's replay of the
logical doc is the state every replica must reach byte for byte.

Replica ids are dense: logical doc ``d``'s replica for writer ``w`` is
``d * W + w``.  Replicas share the logical session's trace
(``workload.replicate_sessions``), so ``prepare_streams`` tensorizes each
stream once; what differs per replica is cursor and delivery bookkeeping,
which the broadcast bus owns.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..workload import Session, replicate_sessions, split_turns


@dataclass
class ReplicaGroup:
    """One logical document's writer group."""

    logical_id: int
    writers: int
    replica_ids: tuple[int, ...]  # replica_ids[w]: writer w's pool doc
    blocks: list[tuple[int, int, int]] = field(default_factory=list)
    n_ops: int = 0  # coalesced range ops of the logical stream

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def owner(self, seq: int) -> int:
        return self.blocks[seq][2]

    def block_span(self, seq: int) -> tuple[int, int]:
        lo, hi, _w = self.blocks[seq]
        return lo, hi

    def prefix_ops(self, n_blocks: int) -> int:
        """Ops covered by the first ``n_blocks`` blocks (the assembled
        delivery prefix in ops)."""
        if n_blocks <= 0:
            return 0
        return self.blocks[min(n_blocks, len(self.blocks)) - 1][1]

    def _remote_segments(self, writer: int, lo: int, hi: int):
        """The ``(a, b, owner)`` pieces of ``[lo, hi)`` authored by writers
        other than ``writer``, in stream order: the one walk every remote
        share below derives from (blocks are ``turn_ops`` wide but the
        last)."""
        if hi <= lo or not self.blocks:
            return
        turn = self.blocks[0][1] - self.blocks[0][0]
        seq = min(lo // turn, len(self.blocks) - 1)
        while seq < len(self.blocks):
            blo, bhi, w = self.blocks[seq]
            if blo >= hi:
                break
            a, b = max(lo, blo), min(hi, bhi)
            if b > a and w != writer:
                yield a, b, w
            seq += 1

    def remote_intervals(self, writer: int, lo: int,
                         hi: int) -> list[tuple[int, int]]:
        """The pieces of ``[lo, hi)`` other writers authored (the merged
        share of a staged slice), adjacent pieces joined."""
        out: list[tuple[int, int]] = []
        for a, b, _w in self._remote_segments(writer, lo, hi):
            if out and out[-1][1] == a:
                out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    def split_local_remote(self, writer: int, lo: int,
                           hi: int) -> tuple[int, int]:
        """(local, remote) op counts of ``[lo, hi)`` for ``writer``."""
        if hi <= lo:
            return 0, 0
        rem = sum(b - a for a, b in self.remote_intervals(writer, lo, hi))
        return (hi - lo) - rem, rem


class GroupTable:
    """The groups and the replica -> (group, writer) map, built once with
    the fleet."""

    def __init__(self, groups: list[ReplicaGroup]):
        self.groups = groups
        self.by_replica: dict[int, tuple[ReplicaGroup, int]] = {}
        for g in groups:
            for w, rid in enumerate(g.replica_ids):
                self.by_replica[rid] = (g, w)

    def __iter__(self):
        return iter(self.groups)

    def __len__(self) -> int:
        return len(self.groups)

    def group_of(self, replica_id: int) -> tuple[ReplicaGroup, int]:
        return self.by_replica[replica_id]


def build_writer_groups(sessions: list[Session], writers: int
                        ) -> tuple[list[Session], GroupTable]:
    """The replica sessions and the group table of logical ``sessions``.
    Blocks come later (:func:`attach_turn_blocks`): the split needs the
    coalesced op count, which exists once ``prepare_streams`` ran."""
    replica_sessions = replicate_sessions(sessions, writers)
    groups = [ReplicaGroup(logical_id=s.doc_id, writers=writers,
                           replica_ids=tuple(s.doc_id * writers + w
                                             for w in range(writers)))
              for s in sessions]
    return replica_sessions, GroupTable(groups)


def attach_turn_blocks(table: GroupTable, streams, turn_ops: int) -> None:
    """Every group's turn split from its streams' lengths (equal within a
    group: the replicas share the trace).  Deterministic, so a recovery
    builds the same split from the workload."""
    for g in table.groups:
        st = streams[g.replica_ids[0]]
        g.n_ops = st.n_total
        g.blocks = split_turns(g.n_ops, g.writers, turn_ops)
