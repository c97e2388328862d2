"""Mesh-aware per-shard serve metrics (+ per-replica merge series; the JAX
package's ``obs/shard.py``).

Every fleet number the registry carried before this module was a
*fleet-wide* aggregate: under ``--serve-mesh`` the run could be pinned
to one hot device while seven idled and no artifact field would say so.
:class:`ShardMetrics` splits the load signals by mesh shard:

- ``serve.shard.ops{shard="s"}`` / ``serve.shard.unit_ops{...}`` — range
  ops / unit-op equivalents applied to documents resident on shard
  ``s`` (host-known: a lane's shard is ``row // Rg``, no device sync);
- ``serve.shard.lanes{...}`` — scheduled lane-rounds per shard (the
  occupancy numerator, summed over rounds);
- ``serve.shard.occupancy{...}`` — resident-row fraction of the shard's
  row budget, gauged per round;
- ``serve.shard.relocations{...}`` — cross-shard row moves (promotions
  or compaction pulls whose source lived on a different shard);
- ``serve.shard.imbalance`` — max/mean of per-round scheduled lanes
  across shards: 1.0 = perfectly balanced, R = everything on one shard;
- ``serve.shard.mem_bytes_in_use{...}`` — the device allocator's bytes
  in use, from ``parallel/mesh.py device_memory_stats`` (a CUDA device
  answers; the CPU reports nothing and the gauges simply stay unset).

**Sum parity is the contract** (tested): for every time-series window,
the per-shard ops/lanes sums equal the fleet totals the pre-mesh
artifact already reported — shard residency is a partition, never a
second accounting.

Label convention: series names carry their label set Prometheus-style
(``base{shard="0"}``) directly in the registry key; the ``/metrics``
renderer (:mod:`obs.status`) parses it back into real labels.  All
series are pre-registered here, at bind time — the per-round path only
touches held references (no registry get-or-create in hot scopes).
"""

from __future__ import annotations

from .metrics import MetricsRegistry

#: The ``torch.cuda.memory_stats`` key the memory gauge reads.
MEM_KEY = "allocated_bytes.all.current"


def labeled(base: str, shard: int) -> str:
    """Registry key for a shard-labeled series."""
    return f'{base}{{shard="{shard}"}}'


class ShardMetrics:
    """Per-shard load/residency series over one drain's registry."""

    def __init__(self, pool, registry: MetricsRegistry):
        self.pool = pool
        self.n_sh = pool.n_sh
        rng = range(self.n_sh)
        self._ops = [
            registry.counter(labeled("serve.shard.ops", s)) for s in rng
        ]
        self._units = [
            registry.counter(labeled("serve.shard.unit_ops", s))
            for s in rng
        ]
        self._lanes = [
            registry.counter(labeled("serve.shard.lanes", s)) for s in rng
        ]
        self._reloc = [
            registry.counter(labeled("serve.shard.relocations", s))
            for s in rng
        ]
        self._occ = [
            registry.gauge(labeled("serve.shard.occupancy", s))
            for s in rng
        ]
        self._mem = [
            registry.gauge(labeled("serve.shard.mem_bytes_in_use", s))
            for s in rng
        ]
        self.imbalance = registry.gauge("serve.shard.imbalance")
        self._rows_per_shard = [
            sum(b.Rg for b in pool.buckets.values()) for _ in rng
        ]

    # ---- hot path (pre-registered references only) ----

    def note_round(self, shard_lanes, shard_ops, shard_units) -> None:
        """Fold one macro-round's per-shard tallies into the series and
        gauge the imbalance (max/mean of scheduled lanes; 1.0 when no
        lane ran — an idle round is balanced, not degenerate)."""
        total = 0
        peak = 0
        occupied = self.pool.shard_occupancy()
        for s in range(self.n_sh):
            lanes = shard_lanes[s]
            total += lanes
            if lanes > peak:
                peak = lanes
            if shard_ops[s]:
                self._ops[s].inc(shard_ops[s])
                self._units[s].inc(shard_units[s])
            if lanes:
                self._lanes[s].inc(lanes)
            self._occ[s].set(occupied[s] / self._rows_per_shard[s])
        self.imbalance.set(
            peak * self.n_sh / total if total else 1.0
        )

    def note_relocation(self, dst_shard: int) -> None:
        """One row moved onto ``dst_shard`` from a different shard."""
        self._reloc[dst_shard].inc()

    # ---- window cadence (still host-only; allocator stats are a
    # local device query, not a sync) ----

    def sample_memory(self) -> None:
        from ..parallel.mesh import device_memory_stats

        # ``torch.cuda.memory_stats`` has no ``bytes_in_use`` key (JAX's
        # ``Device.memory_stats()`` name); the allocator's live bytes are
        # ``allocated_bytes.all.current``
        for s, ms in enumerate(device_memory_stats(
                self.n_sh, device=self.pool.device)):
            if ms is not None and MEM_KEY in ms:
                self._mem[s].set(float(ms[MEM_KEY]))


def class_labeled(base: str, cls: int) -> str:
    """Registry key for a capacity-class-labeled series."""
    return f'{base}{{doc_class="{cls}"}}'


class ReplicaMetrics:
    """Replication-fleet series over one drain's registry
    (serve/replicate/): the remote-merge load split by the capacity
    class it landed in, plus the bus-level health signals.

    - ``serve.replica.merged_ops{doc_class="c"}`` /
      ``serve.replica.merged_unit_ops{...}`` — remote (broadcast) range
      ops / unit-op equivalents merged into replica rows of class
      ``c``; **sum parity is the contract** (tested, the same
      discipline as the per-shard series): the per-class counters
      partition the drain's total merged-op count — remote-merge
      attribution is a partition of the merge work, never a second
      accounting;
    - ``serve.replica.local_ops`` — the upstream half (a writer's own
      ops applied to its own replica), so local + merged partition the
      fleet's total applied ops;
    - ``serve.replica.divergence_depth`` — gauge: the deepest
      per-replica broadcast lag this round, in turn blocks (published
      head minus the replica's assembled prefix);
    - ``serve.replica.broadcast_bytes`` / ``broadcast_blocks`` — packed
      op-lane bytes / turn blocks actually delivered to REMOTE replicas
      (the fan-out cost of the writer group; local self-delivery is
      free and not counted).

    All series are pre-registered here, at bind time — the per-round
    path only touches held references."""

    def __init__(self, registry: MetricsRegistry, classes):
        self._merged = {
            c: registry.counter(class_labeled(
                "serve.replica.merged_ops", c
            ))
            for c in classes
        }
        self._merged_units = {
            c: registry.counter(class_labeled(
                "serve.replica.merged_unit_ops", c
            ))
            for c in classes
        }
        self.local_ops = registry.counter("serve.replica.local_ops")
        self.divergence = registry.gauge("serve.replica.divergence_depth")
        self.broadcast_bytes = registry.counter(
            "serve.replica.broadcast_bytes"
        )
        self.broadcast_blocks = registry.counter(
            "serve.replica.broadcast_blocks"
        )

    # ---- hot path (pre-registered references only) ----

    def note_merged(self, cls: int, ops: int, unit_ops: int) -> None:
        """Remote ops merged into a class-``cls`` replica row."""
        self._merged[cls].inc(ops)
        self._merged_units[cls].inc(unit_ops)

    def note_local(self, ops: int) -> None:
        self.local_ops.inc(ops)

    def note_divergence(self, depth_blocks: int) -> None:
        self.divergence.set(float(depth_blocks))

    def note_broadcast(self, nbytes: int, blocks: int = 1) -> None:
        self.broadcast_bytes.inc(nbytes)
        self.broadcast_blocks.inc(blocks)

    def merged_total(self) -> tuple[int, int]:
        """(ops, unit_ops) summed over every class label — the parity
        side the tests compare against the scheduler's totals."""
        return (
            sum(c.value for c in self._merged.values()),
            sum(c.value for c in self._merged_units.values()),
        )
