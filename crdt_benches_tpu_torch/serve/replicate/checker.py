"""The replicated fleet's verification: convergence and replication-aware
linearizability.

**Convergence** (:func:`check_convergence`): after the drain every replica
of every logical document decodes byte-identical to the oracle's
sequential replay of the logical stream, and so to each other.

**RA-linearizability** (:func:`check_ra_linearizability`, after
"Replication-Aware Linearizability", arXiv 1903.06560): the bus arbitrates
by block sequence and replicas apply assembled prefixes, so the axioms
become checks on the recorded delivery histories
(``BroadcastBus.histories``, sampled groups):

- **A1 session order**: each replica sees any one writer's blocks in
  ascending sequence;
- **A2 exactly once**: no block is delivered twice to a replica;
- **A3 read your writes**: a writer's block reaches its own replica in
  the round it was published;
- **A4 eventual visibility**: every replica's delivered set is the whole
  sequence;
- **A5 arbitration-consistent apply**: the delivered set reassembles into
  the arbitration order with no gap.

Each violated axiom is one finding, and the bench exits non-zero on any.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...oracle.text_oracle import replay_trace
from .broadcast import BroadcastBus
from .group import GroupTable


@dataclass
class ConvergenceReport:
    """What the verification found."""

    groups_checked: int = 0
    replicas_checked: int = 0
    byte_mismatches: list[dict] = field(default_factory=list)
    ra_groups_checked: int = 0
    ra_violations: list[dict] = field(default_factory=list)
    lossy_groups: list[int] = field(default_factory=list)

    @property
    def converged(self) -> bool:
        return not self.byte_mismatches and self.replicas_checked > 0

    @property
    def ra_ok(self) -> bool:
        return not self.ra_violations

    def to_dict(self) -> dict:
        return {
            "groups_checked": self.groups_checked,
            "replicas_checked": self.replicas_checked,
            "converged": self.converged,
            "byte_mismatches": self.byte_mismatches[:16],
            "ra_groups_checked": self.ra_groups_checked,
            "ra_ok": self.ra_ok,
            "ra_violations": self.ra_violations[:16],
            "lossy_groups": self.lossy_groups[:16],
        }


def check_convergence(pool, table: GroupTable, sessions, streams,
                      report: ConvergenceReport | None = None
                      ) -> ConvergenceReport:
    """Decode every replica of every logical doc and compare it byte for
    byte with the oracle's replay of the logical stream.  A group with a
    lossy replica (an explicit shed or quarantine) is left out and listed
    in ``lossy_groups``."""
    rep = report or ConvergenceReport()
    session_of = {s.doc_id: s for s in sessions}
    for g in table:
        if any(streams[rid].lossy for rid in g.replica_ids):
            rep.lossy_groups.append(g.logical_id)
            continue
        want = replay_trace(session_of[g.logical_id].trace)
        rep.groups_checked += 1
        for w, rid in enumerate(g.replica_ids):
            rep.replicas_checked += 1
            got = pool.decode(rid)
            if got != want:
                rep.byte_mismatches.append({
                    "group": g.logical_id, "writer": w, "replica": rid,
                    "got_len": len(got), "want_len": len(want),
                })
    return rep


def _axiom_violations(gid: int, group,
                      histories: list[list[tuple[int, int]]],
                      publish_log: list[tuple[int, int]]) -> list[dict]:
    """A1-A5 on one group's recorded histories (host data only, so a test
    can feed it doctored histories)."""
    out: list[dict] = []
    n_blocks = group.n_blocks
    publish_round = {seq: rnd for rnd, seq in publish_log}
    for w, hist in enumerate(histories):
        seqs = [seq for _rnd, seq in hist]
        if len(seqs) != len(set(seqs)):  # A2
            dup = sorted(s for s in set(seqs) if seqs.count(s) > 1)[0]
            out.append({"axiom": "A2-exactly-once", "group": gid,
                        "writer": w,
                        "detail": f"block {dup} delivered more than once"})
        last_by_author: dict[int, int] = {}  # A1, per author
        for seq in seqs:
            a = group.owner(seq)
            prev = last_by_author.get(a)
            if prev is not None and seq < prev:
                out.append({
                    "axiom": "A1-session-order", "group": gid, "writer": w,
                    "detail": (f"writer {a}'s block {seq} delivered after "
                               f"its block {prev}")})
                break
            last_by_author[a] = seq
        # A3, where the publish log was recorded
        own_delivery = {seq: rnd for rnd, seq in hist
                        if group.owner(seq) == w}
        for seq, prnd in publish_round.items():
            if group.owner(seq) != w:
                continue
            drnd = own_delivery.get(seq)
            if drnd is None or drnd > prnd:
                out.append({
                    "axiom": "A3-read-your-writes", "group": gid,
                    "writer": w,
                    "detail": (
                        f"own block {seq} published round {prnd} but "
                        f"locally delivered "
                        f"{'never' if drnd is None else f'round {drnd}'}")})
                break
        if set(seqs) != set(range(n_blocks)):  # A4
            missing = sorted(set(range(n_blocks)) - set(seqs))
            out.append({"axiom": "A4-eventual-visibility", "group": gid,
                        "writer": w,
                        "detail": f"{len(missing)} blocks never delivered "
                                  f"(first: {missing[:4]})"})
        # A5: the delivered set must reassemble into the gap-free
        # arbitration prefix (checked on its own, so a doctored assembly
        # shows even where A4 did not look)
        applied = sorted(set(seqs))
        if applied != list(range(len(applied))):
            out.append({"axiom": "A5-arbitration-prefix", "group": gid,
                        "writer": w,
                        "detail": "delivered set does not reassemble into "
                                  "a gap-free arbitration prefix"})
    return out


def check_ra_linearizability(bus: BroadcastBus, table: GroupTable,
                             report: ConvergenceReport | None = None
                             ) -> ConvergenceReport:
    """A1-A5 over every group whose histories the bus recorded."""
    rep = report or ConvergenceReport()
    by_id = {g.logical_id: g for g in table}
    for gid in sorted(bus.histories):
        rep.ra_groups_checked += 1
        rep.ra_violations.extend(_axiom_violations(
            gid, by_id[gid], bus.histories[gid],
            bus.publish_log.get(gid, [])))
    return rep
