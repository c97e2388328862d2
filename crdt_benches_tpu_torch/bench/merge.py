"""The concurrent-merge cells (the JAX package's ``bench/runner.py``
``_merge_sim``, ``_delivered_log`` and ``run_merge``).

Configurations:

- ``traces``: two agents editing concurrently from an empty base, one
  replaying rustcode and the other seph-blog1 (BASELINE.md config 4);
- ``synthetic``: 16 agents of random edits totalling ~``merge_ops`` ops
  from a short shared base (config 5's interleaving workload);
- ``adversarial``: ``synthetic`` with ``merge_ops // 16`` unique ops, each
  delivered ~16 times, shuffled (the duplicated/reordered-delivery fault
  model, config 5); ``merge_ops`` counts delivered ops.

Engines (the JAX runner's columns): ``unit`` (``jax``: the packed unit-op
merge, ``engine/merge.py merge_oplogs_packed``), ``range`` (``jax-range``:
the run merge at batch 512, epoch 8, ``engine/merge_range.py``) and
``flat`` (``jax-flat``: ``engine/downstream_flat.py make_flat_merge``).
Generation and wire translation are untimed; the timed region is the merge
into fresh replicas and every replica's digest with the convergence check.
An element is one delivered op.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.downstream import down_packed_init
from ..engine.downstream_flat import make_flat_merge
from ..engine.merge import MergeSimulation, OpLog, merge_oplogs_packed
from ..engine.merge_range import RunMergeSimulation
from ..ops.apply2 import MAX_COMBO_CAPACITY
from ..traces.loader import TestData, TestTxn, load_testing_data
from ..traces.synth import random_patches
from ..traces.tensorize import tensorize
from ..utils.digest import doc_digest_packed

CONFIGS = ("traces", "synthetic", "adversarial")
ENGINES = ("unit", "range", "flat")

#: The run merge's pinned schedule (the JAX runner's ``_range_merge_sim``).
RANGE_BATCH, RANGE_EPOCH = 512, 8


def merge_sim(config: str, merge_ops: int = 1_000_000, batch: int = 256,
              device: str | torch.device = "cuda") -> MergeSimulation:
    """The cell's agents and op logs (untimed, like the reference's update
    generation)."""
    if config == "traces":
        streams = [tensorize(load_testing_data(n), batch=batch)
                   for n in ("rustcode", "seph-blog1")]
        return MergeSimulation(streams, base="", batch=batch, device=device)
    if config not in CONFIGS:
        raise ValueError(f"unknown merge config {config!r}")
    n_agents = 16
    rng = np.random.default_rng(1234)
    base = "the quick brown fox jumps over the lazy dog " * 4
    unique_ops = merge_ops // 16 if config == "adversarial" else merge_ops
    streams = []
    for _ in range(n_agents):
        patches, _ = random_patches(rng, unique_ops // n_agents, len(base))
        streams.append(tensorize(TestData(base, "", [TestTxn("", patches)]),
                                 batch=batch))
    return MergeSimulation(streams, base=base, batch=batch, device=device)


def delivered_log(sim: MergeSimulation, config: str, merge_ops: int) -> OpLog:
    """The wire-delivered op stream: the plain union, or (adversarial) about
    ``merge_ops`` shuffled ops in which every unique op arrives ~16 times."""
    if config != "adversarial":
        return sim.log
    reps = max(1, merge_ops // max(len(sim.log), 1))
    log = OpLog.concat([sim.log] * reps)
    perm = np.random.default_rng(99).permutation(len(log))
    return OpLog(*(getattr(log, f)[perm]
                   for f in ("lamport", "agent", "kind", "elem", "origin",
                             "ch")))


class MergeCell:
    """One merge cell on ``sim``: the untimed set-up here, the timed region
    in :meth:`run`."""

    def __init__(self, sim: MergeSimulation, config: str, engine: str,
                 n_replicas: int = 64, epoch: int = 32,
                 merge_ops: int = 1_000_000):
        if engine not in ENGINES:
            raise ValueError(f"unknown merge engine {engine!r}")
        self.sim = sim
        self.engine = engine
        self.n_replicas = n_replicas
        self.delivered = delivered_log(sim, config, merge_ops)
        self.elements = len(self.delivered)
        if engine == "unit":
            # the packed fill overflow would corrupt every replica alike,
            # which the convergence check cannot see
            if sim.capacity >= MAX_COMBO_CAPACITY:
                raise ValueError(
                    f"merge/{config}: capacity {sim.capacity} >= 2^28 "
                    "exceeds the packed fill range (int32 combo)")
            plain = config != "adversarial"
            self.epoch, segments = sim.packed_schedule(
                None if plain else self.delivered, epoch)
            log = sim._padded(self.delivered,
                              multiple=sim.batch * self.epoch)
            wire = sim.device_log(log)

            def merge():
                return merge_oplogs_packed(
                    down_packed_init(n_replicas, sim.capacity, sim.n_base,
                                     device=sim.device),
                    *wire, batch=sim.batch, epoch=self.epoch,
                    max_unique=len(sim.log), segments=segments,
                )
        elif engine == "range":
            if config == "adversarial":
                raise ValueError(
                    "merge/adversarial: the run merge refuses duplicated "
                    "delivery (it integrates the agents' own logs); use "
                    "the unit or flat engine")
            rm = RunMergeSimulation(sim, batch=RANGE_BATCH,
                                    epoch=RANGE_EPOCH)
            if not rm.fast_ok:
                raise ValueError(f"merge/{config}: the run-atomic "
                                 "precondition does not hold")
            self.runs = rm
            merge = lambda: rm.merge(n_replicas=n_replicas)
        else:
            merge = make_flat_merge(sim, self.delivered,
                                    n_replicas=n_replicas)
        self._merge = merge

    def run(self):
        """The timed region: the merge into fresh replicas, then every
        replica's digest; raises when the replicas diverged.  Returns the
        merged state."""
        st = self._merge()
        d = doc_digest_packed(st.doc, st.length, self.sim.chars)
        if not bool((d.amin(dim=0) == d.amax(dim=0)).all()):
            raise RuntimeError("replicas diverged")
        return st

    def check(self, state) -> tuple[bool, str]:
        """(replica 0 byte-identical to the native treap's merge of the
        delivered log, that document)."""
        from ..engine.merge import native_merge_content

        want = native_merge_content(self.sim, self.delivered)
        return self.sim.decode(state, 0) == want, want
