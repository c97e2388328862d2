"""One step of the headline hot path on tiny shapes (the port's twin of
``entry()`` in the repository's ``__graft_entry__.py``): a compile-and-run
check of the range replay's kernels.

    from crdt_benches_tpu_torch.entry import entry
    step, args = entry()          # device="cuda" by default
    doc, cv_intile, vis_tile, length, nvis = step(*args)

The step is one op batch of the range replay: K1's shared form, then the
fused range apply (``apply_range_batch4``: K2 or K3 by the dispatch), at 4
replicas, capacity 1024, on the first batch of the seed-0 synthetic trace
of 24 ops (batch 8).

:func:`dryrun_multichip` is the twin of ``dryrun_multichip`` there: the
sharded replay, the v1, packed and run merges and the sharded downstream
over ``n`` ranks of a replica mesh (``parallel/mesh.py``), on tiny shapes
from the same seeds.

    from crdt_benches_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4, device="cpu")   # 4 processes over gloo
    dryrun_multichip(1)                 # one GPU over NCCL
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .engine.merge import MergeSimulation
from .engine.merge_range import RunMergeSimulation
from .ops.apply2 import PackedState4, init_state4
from .ops.apply_range_fused import apply_range_batch4
from .ops.resolve_range import resolve_range
from .parallel import mesh as pm
from .parallel.launch import run_ranks
from .traces.synth import synth_streams, synth_trace
from .traces.tensorize import tensorize, tensorize_ranges
from .utils.digest import doc_digest_packed

#: replicas and capacity of the step (nt = 8 tiles of 128)
R = 4
CAPACITY = 1024


def step(doc, cv_intile, vis_tile, length, nvis, kind, pos, rlen, slot0):
    """One range batch (kind/pos/rlen/slot0 int32[B]) applied to every
    replica of the state; returns the new (doc, cv_intile, vis_tile,
    length, nvis)."""
    st = PackedState4(doc, cv_intile, vis_tile, length, nvis)
    tokens, dints, _ = resolve_range(kind, pos, rlen, slot0, st.nvis)
    st = apply_range_batch4(st, tokens, dints)
    return st.doc, st.cv_intile, st.vis_tile, st.length, st.nvis


def entry(device: str | torch.device = "cuda"):
    """``(step, example_args)`` on ``device``: the fresh state's five
    fields, then the first range batch's four op arrays."""
    dev = resolve_device(device)
    trace = synth_trace(seed=0, n_ops=24, p_insert=0.7)
    kind_b, pos_b, rlen_b, slot0_b = tensorize_ranges(trace,
                                                      batch=8).batched()
    st = init_state4(R, CAPACITY, 0, device=dev)
    ops = tuple(torch.as_tensor(a[0], dtype=torch.int32, device=dev)
                for a in (kind_b, pos_b, rlen_b, slot0_b))
    return step, (st.doc, st.cv_intile, st.vis_tile, st.length,
                  st.nvis) + ops


def _tiny_problem(batch: int = 8, n_batches: int = 2):
    """The dry run's replay input: seed-0 synthetic unit ops, tensorized."""
    trace = synth_trace(seed=0, n_ops=batch * n_batches // 2, p_insert=0.7)
    return tensorize(trace, batch=batch)


def _pad_to(a: np.ndarray, mult: int, fill: int) -> np.ndarray:
    padn = (-len(a)) % mult
    return np.concatenate([a, np.full(padn, fill, np.int32)]) if padn else a


def dryrun_rank(mesh: pm.ReplicaMesh) -> dict:
    """One rank of the dry run: the five parts on this rank's shard, each
    ``(state, digests, converged)``, and ``down_ref`` (the single-device
    run downstream's digest).  Every rank builds the inputs from the seeds
    and takes its shard."""
    dev, world = mesh.device, mesh.world
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    out = {}

    # part 1: 2 replicas a rank replay the tiny problem
    tt = _tiny_problem()
    kind_b, pos_b, _, slot_b = tt.batched()
    capacity = 128
    chars = np.zeros(capacity, np.int32)
    ins = tt.slot >= 0
    chars[tt.slot[ins]] = tt.ch[ins]
    state = pm.make_sharded_state(mesh, 2 * world, capacity, 0)
    out["replay"] = pm.sharded_replay_and_digest(mesh)(
        state, i32(kind_b), i32(pos_b), i32(slot_b), i32(chars))

    # part 2: one divergent agent a rank, logs exchanged, the v1 merge
    base = "shared base"
    streams = [tensorize(t, batch=8)
               for t in synth_streams(seed=1, n_agents=world, n_ops=6,
                                      base=base, p_insert=0.7)]
    simm = MergeSimulation(streams, base=base, batch=8, device=dev)
    logs = simm.stacked_logs()
    fields = ("lamport", "agent", "kind", "elem", "origin", "ch")
    local = [pm.shard_rows(mesh, logs[f]) for f in fields]
    out["merge"] = pm.sharded_merge_and_converge(
        mesh, simm.capacity, simm.n_base, batch=8)(*local, simm.chars)

    # part 3: the same exchange on the packed path
    n_local = logs["kind"].shape[1]
    ep = 2 if (world * n_local) % (8 * 2) == 0 else 1
    out["packed"] = pm.sharded_merge_packed(
        mesh, simm.capacity, simm.n_base, batch=8, epoch=ep)(
        *local, simm.chars)

    # part 4: the run wire sharded over the ranks, the run merge
    rm = RunMergeSimulation(simm, batch=4, epoch=1)
    if not rm.fast_ok:
        raise AssertionError("dry run: the run merge's precondition fails")
    unit = 4 * world  # a multiple of batch x epoch and of the world size
    wire = (_pad_to(rm.lamport, unit, 0), _pad_to(rm.agent, unit, 0),
            _pad_to(rm.slot0, unit, -1), _pad_to(rm.rlen, unit, 0),
            _pad_to(rm.origin, unit, -2), _pad_to(rm.dlo, world, -1),
            _pad_to(rm.dhi, world, -2))
    out["runs"] = pm.sharded_merge_runs(
        mesh, simm.capacity, simm.n_base, batch=4, epoch=1)(
        *(pm.shard_rows(mesh, a) for a in wire), simm.chars)

    # part 5: one writer's run wire replicated, 2 subscribers a rank
    dt = synth_trace(seed=3, n_ops=24, p_insert=0.75)
    dsim = MergeSimulation([tensorize(dt, batch=8)], base=dt.start_content,
                           batch=8, device=dev)
    drm = RunMergeSimulation(dsim, batch=4, epoch=2)
    dels = drm._dev_del or (i32([-1]), i32([-2]))
    out["down"] = pm.sharded_downstream_runs(
        mesh, dsim.capacity, dsim.n_base, batch=4, epoch=drm.epoch_eff,
        r_per_shard=2)(*drm._dev, *dels, dsim.chars)
    ref = drm.merge(n_replicas=1)  # the single-device engine
    out["down_ref"] = doc_digest_packed(ref.doc, ref.length, dsim.chars)[0]
    return out


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda"):
    """The five sharded parts on ``n_devices`` ranks with tiny shapes, with
    the JAX dry run's asserts over all ranks' digests.  Returns and prints
    the three digests (replay, merge, downstream)."""
    ranks = run_ranks(dryrun_rank, n_devices, device=device)
    cat = lambda part: np.concatenate([r[part][1] for r in ranks])
    digests, md, ref_digest = cat("replay"), cat("merge"), ranks[0]["down_ref"]
    R = 2 * n_devices
    for ok, what in (
        (digests.shape == (R, 3), f"replay digests {digests.shape}"),
        (all(bool(r[p][2]) for r in ranks
             for p in ("replay", "merge", "packed", "runs", "down")),
         "every part's replicas must converge"),
        ((digests == digests[0]).all(), "identical replicas must agree"),
        ((md == md[0]).all(), "merged divergent replicas must agree"),
        ((cat("packed") == md[0]).all(),
         "packed and v1 sharded merges must agree"),
        ((cat("runs") == md[0]).all(),
         "run-granular and unit merges must agree"),
        ((cat("down") == ref_digest).all(),
         "sharded downstream must match the single-device engine"),
    ):
        if not ok:
            raise AssertionError(f"dryrun_multichip({n_devices}): {what}")
    print(
        f"dryrun_multichip OK: {n_devices} devices, {R} replicas replayed "
        f"(digest={digests[0].tolist()}), {n_devices} divergent agents "
        f"merged+converged on all three merge paths (v1, packed, "
        f"run-granular; digest={md[0].tolist()}), and the sharded "
        f"single-writer downstream apply ({2 * n_devices} subscriber "
        f"replicas over the mesh) matched the single-device engine "
        f"(digest={ref_digest.tolist()})"
    )
    return digests[0].tolist(), md[0].tolist(), ref_digest.tolist()
