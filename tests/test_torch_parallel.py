"""The port's replica mesh (``parallel/mesh.py`` over ``torch.distributed``)
against the JAX package's ``shard_map`` mesh: the five parts of the dry run
(the sharded replay, the v1, packed and run merges, the sharded
downstream) on n ranks over gloo (world size 1 in this process, 2 and 4
spawned) against the same JAX functions on the first n devices of the
8-device virtual CPU mesh, rank by rank: every state field, every digest
and the converged flag, exactly.  Then a tampered replica that both sides
must report as not converged, and the launcher's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from crdt_benches_tpu.engine.merge import MergeSimulation as JaxMergeSim
from crdt_benches_tpu.engine.merge_range import RunMergeSimulation as JaxRunSim
from crdt_benches_tpu.parallel import mesh as jm
from crdt_benches_tpu.traces.synth import synth_streams as jax_synth_streams
from crdt_benches_tpu.traces.synth import synth_trace as jax_synth_trace
from crdt_benches_tpu.traces.tensorize import tensorize as jax_tensorize
from crdt_benches_tpu.utils.digest import doc_digest_packed as jax_digest
from crdt_benches_tpu_torch.entry import dryrun_multichip, dryrun_rank
from crdt_benches_tpu_torch.parallel import mesh as pm
from crdt_benches_tpu_torch.parallel.launch import run_ranks

WORLDS = (1, 2, 4)
PARTS = ("replay", "merge", "packed", "runs", "down")
FIELDS = ("lamport", "agent", "kind", "elem", "origin", "ch")


def _host(out):
    """(state fields as numpy, digests, converged) of a JAX step."""
    st, d, c = out
    return ({f: np.asarray(getattr(st, f)) for f in st._fields},
            np.asarray(d), bool(np.asarray(c)))


def _jax_parts(n: int) -> dict:
    """The five parts of ``__graft_entry__.dryrun_multichip(n)``, their
    global outputs."""
    out = {}
    mesh = jm.replica_mesh(n)
    tt = graft._tiny_problem()
    kind_b, pos_b, _, slot_b = tt.batched()
    capacity = 128
    chars = np.zeros(capacity, np.int32)
    ins = tt.slot >= 0
    chars[tt.slot[ins]] = tt.ch[ins]
    step, _ = jm.sharded_replay_and_digest(mesh)
    out["replay"] = _host(step(
        jm.make_sharded_state(mesh, 2 * n, capacity, 0), jnp.asarray(kind_b),
        jnp.asarray(pos_b), jnp.asarray(slot_b), jnp.asarray(chars)))

    base = "shared base"
    streams = [jax_tensorize(t, batch=8)
               for t in jax_synth_streams(seed=1, n_agents=n, n_ops=6,
                                          base=base, p_insert=0.7)]
    simm = JaxMergeSim(streams, base=base, batch=8)
    logs = simm.stacked_logs()
    args = [jnp.asarray(logs[f]) for f in FIELDS]
    out["merge"] = _host(jm.sharded_merge_and_converge(
        mesh, simm.capacity, simm.n_base, batch=8)(*args, simm.chars))
    n_local = logs["kind"].shape[1]
    ep = 2 if (n * n_local) % (8 * 2) == 0 else 1
    out["packed"] = _host(jm.sharded_merge_packed(
        mesh, simm.capacity, simm.n_base, batch=8, epoch=ep)(
        *args, simm.chars))

    rm = JaxRunSim(simm, batch=4, epoch=1)

    def pad_to(a, mult, fill):
        padn = (-len(a)) % mult
        return np.concatenate([a, np.full(padn, fill, np.int32)]) if padn \
            else a

    unit = 4 * n
    wire = (pad_to(rm.lamport, unit, 0), pad_to(rm.agent, unit, 0),
            pad_to(rm.slot0, unit, -1), pad_to(rm.rlen, unit, 0),
            pad_to(rm.origin, unit, -2), pad_to(rm.dlo, n, -1),
            pad_to(rm.dhi, n, -2))
    out["runs"] = _host(jm.sharded_merge_runs(
        mesh, simm.capacity, simm.n_base, batch=4, epoch=1,
        nbits=max(rm.nbits, 1))(*map(jnp.asarray, wire), simm.chars))

    dt = jax_synth_trace(seed=3, n_ops=24, p_insert=0.75)
    dsim = JaxMergeSim([jax_tensorize(dt, batch=8)], base=dt.start_content,
                       batch=8)
    drm = JaxRunSim(dsim, batch=4, epoch=2)
    dels = drm._dev_del if drm._dev_del is not None else (
        jnp.full(1, -1, jnp.int32), jnp.full(1, -2, jnp.int32))
    out["down"] = _host(jm.sharded_downstream_runs(
        mesh, dsim.capacity, dsim.n_base, batch=4, epoch=drm.epoch_eff,
        nbits=drm.nbits, r_per_shard=2)(*drm._dev, *dels, dsim.chars))
    ref = drm.merge(n_replicas=1)
    out["down_ref"] = np.asarray(jax.vmap(jax_digest, in_axes=(0, 0, None))(
        ref.doc, ref.length, dsim.chars))[0]
    return out


@pytest.fixture(scope="module")
def both():
    """{n: (the port's per-rank results, JAX's parts)}, built on first
    use."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = (run_ranks(dryrun_rank, n, device="cpu", timeout=240),
                        _jax_parts(n))
        return cache[n]

    return get


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("part", PARTS)
def test_dryrun_part_equals_jax_per_rank(both, part, n):
    ranks, want = both(n)
    assert len(ranks) == n
    wst, wd, wc = want[part]
    r_loc = wd.shape[0] // n
    for rank, res in enumerate(ranks):
        st, d, c = res[part]
        rows = slice(rank * r_loc, (rank + 1) * r_loc)
        assert st._fields == tuple(wst), part
        for f in st._fields:
            np.testing.assert_array_equal(getattr(st, f), wst[f][rows],
                                          err_msg=f"{part} rank {rank} {f}")
        np.testing.assert_array_equal(d, wd[rows])
        assert bool(c) is wc is True
    if part == "down":
        for res in ranks:
            np.testing.assert_array_equal(res["down_ref"], want["down_ref"])


@pytest.mark.parametrize("n", WORLDS)
def test_dryrun_multichip_digests_equal_jax(both, n, capsys):
    _, want = both(n)
    got = dryrun_multichip(n, device="cpu")
    assert got == (want["replay"][1][0].tolist(),
                   want["merge"][1][0].tolist(), want["down_ref"].tolist())
    assert f"dryrun_multichip OK: {n} devices" in capsys.readouterr().out


@pytest.mark.parametrize("n", (1, 2))
def test_tampered_replica_is_not_converged_on_both_sides(both, n):
    """One visibility bit of replica 0 cleared after the replay, then an
    all-PAD step (``tests/test_parallel.py``'s divergence case): neither
    mesh may report convergence, and each rank's digests equal JAX's."""
    tt = graft._tiny_problem()
    capacity = 128
    chars = np.zeros(capacity, np.int32)
    ins = tt.slot >= 0
    chars[tt.slot[ins]] = tt.ch[ins]
    state, _, _ = both(n)[1]["replay"]
    live = int(tt.slot[ins][0])
    state = dict(state)
    state["visible"] = state["visible"].copy()
    state["visible"][0, live] = False
    state["nvis"] = state["nvis"].copy()
    state["nvis"][0] -= 1
    pad = np.zeros((1, tt.batch), np.int32)

    mesh = jm.replica_mesh(n)
    step, _ = jm.sharded_replay_and_digest(mesh)
    jstate = jm.DocState(**{f: jnp.asarray(v) for f, v in state.items()})
    _, jd, jc = step(jstate, jnp.asarray(pad), jnp.asarray(pad),
                     jnp.asarray(pad - 1), jnp.asarray(chars))
    assert not bool(np.asarray(jc))

    ranks = run_ranks(pm.sharded_call, n, pm.sharded_replay_and_digest, (),
                      (pm.DocState(**state),), (pad, pad, pad - 1, chars),
                      device="cpu", timeout=240)
    r_loc = np.asarray(jd).shape[0] // n
    for rank, (_, d, c) in enumerate(ranks):
        assert bool(c) is False
        np.testing.assert_array_equal(
            d, np.asarray(jd)[rank * r_loc:(rank + 1) * r_loc])


def test_make_sharded_state_refuses_indivisible_replicas():
    mesh = pm.ReplicaMesh(rank=0, world=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        pm.make_sharded_state(mesh, 3, 128)
    assert pm.make_sharded_state(mesh, 4, 128).order.shape == (2, 128)
    with pytest.raises(ValueError, match="not divisible"):
        jm.make_sharded_state(jm.replica_mesh(2), 3, 128)


def _backend(mesh):
    return torch.distributed.get_backend()


def test_launcher_runs_in_process_and_refuses_what_would_fall_back():
    assert run_ranks(_backend, 1, device="cpu") == ["gloo"]
    assert not torch.distributed.is_initialized()  # destroyed afterwards
    with pytest.raises(RuntimeError, match="visible GPUs|CUDA"):
        run_ranks(_backend, 2, device="cuda")
    with pytest.raises(RuntimeError, match="no process group"):
        pm.replica_mesh("cpu")
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            pm.replica_mesh("cuda")  # no fallback to gloo or the CPU
        with pytest.raises(RuntimeError, match="already exists"):
            run_ranks(_backend, 1, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    assert pm.device_memory_stats(2, device="cpu") == [None, None]


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed"):
        run_ranks(pm.make_sharded_state, 2, 3, 128, device="cpu",
                  timeout=120)
