"""Multi-writer replication over the document fleet (the JAX package's
``serve/replicate/``).

Every served document becomes a writer group of W replicas, each a pool row
with its own writer's share of the stream; peers' ops reach a replica
through the same macro dispatch as its own (K1's per-row form and K4).

- :mod:`.group`: the groups, the turn-block authorship split
  (``serve/workload.py split_turns``) and the dense replica ids;
- :mod:`.broadcast`: the broadcast bus (paced publish, lagged remote
  delivery, sequence-keyed reassembly, partitions and their heal, journaled
  ``bcast`` records, sampled delivery histories);
- :mod:`.scheduler`: ``ReplicatedScheduler``, the fleet scheduler with
  bus-owned delivery, and ``recover_replicated_fleet``;
- :mod:`.checker`: every replica against the oracle and the
  RA-linearizability axioms (arXiv 1903.06560) on the sampled histories;
- :mod:`.bench`: the ``serve/repl/<mix>/<fleet>x<writers>`` family.
"""

from .broadcast import BroadcastBus, replay_journal_broadcasts
from .checker import (
    ConvergenceReport,
    check_convergence,
    check_ra_linearizability,
)
from .group import (
    GroupTable,
    ReplicaGroup,
    attach_turn_blocks,
    build_writer_groups,
)
from .scheduler import ReplicatedScheduler, recover_replicated_fleet

__all__ = [
    "BroadcastBus",
    "ConvergenceReport",
    "GroupTable",
    "ReplicaGroup",
    "ReplicatedScheduler",
    "attach_turn_blocks",
    "build_writer_groups",
    "check_convergence",
    "check_ra_linearizability",
    "recover_replicated_fleet",
    "replay_journal_broadcasts",
]
