"""The port's run-granular merge (``engine/merge_range.py``) on the CPU,
held against the JAX package with exact equality: the ``RunLog``s at every
granularity, the run precondition, each batch's fragments, the
``DownPacked`` state after every epoch and at the end, the delete fold,
and the one-shot schedule; every decoded document equals the oracle, and
the unit, run and flat merges agree with each other."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.engine import downstream as jds
from crdt_benches_tpu.engine import downstream_range as jdr
from crdt_benches_tpu.engine import merge as jm
from crdt_benches_tpu.engine import merge_range as jmr
from crdt_benches_tpu.ops import idpos as jidpos
from crdt_benches_tpu.oracle import replay_trace
from crdt_benches_tpu.traces import loader as jloader
from crdt_benches_tpu.traces.synth import random_patches as jrandom_patches
from crdt_benches_tpu.traces.synth import synth_trace as jsynth_trace
from crdt_benches_tpu.traces.tensorize import tensorize as jtensorize
from crdt_benches_tpu_torch.engine import downstream as pds
from crdt_benches_tpu_torch.engine import downstream_flat as pdf
from crdt_benches_tpu_torch.engine import downstream_range as pdr
from crdt_benches_tpu_torch.engine import merge as pm
from crdt_benches_tpu_torch.engine import merge_range as pmr
from crdt_benches_tpu_torch.ops import idpos as pidpos
from crdt_benches_tpu_torch.traces import loader as ploader
from crdt_benches_tpu_torch.traces.synth import random_patches
from crdt_benches_tpu_torch.traces.synth import synth_trace as psynth_trace
from crdt_benches_tpu_torch.traces.tensorize import tensorize
from crdt_benches_tpu_torch.utils.convert import runlog_from_jax

RUN_FIELDS = ("lamport", "agent", "slot0", "rlen", "origin", "dlo", "dhi")
STATE = ("doc", "snap", "length", "nvis")
JAX = types.SimpleNamespace(loader=jloader, patches=jrandom_patches,
                            tensorize=jtensorize, m=jm)
PORT = types.SimpleNamespace(loader=ploader, patches=random_patches,
                             tensorize=tensorize, m=pm)


def _sim(side, seed, n_agents, n_ops, base, batch=32):
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(n_agents):
        patches, _ = side.patches(rng, n_ops, len(base))
        streams.append(side.tensorize(side.loader.TestData(
            base, "", [side.loader.TestTxn("", patches)]), batch=batch))
    kw = {"device": "cpu"} if side is PORT else {}
    return side.m.MergeSimulation(streams, base=base, batch=batch, **kw)


@pytest.fixture(scope="module")
def pair():
    """Three agents from a shared base, both packages."""
    args = (4, 3, 300, "shared base text ")
    return _sim(JAX, *args), _sim(PORT, *args)


def _want(js):
    base = "".join(chr(c) for c in np.asarray(js.chars)[: js.n_base])
    return jm.merge_oracle(js.log, base, np.asarray(js.chars))


def _eq_state(got, want, msg):
    for f in STATE:
        np.testing.assert_array_equal(
            np.asarray(got[f]) if isinstance(got, dict)
            else getattr(got, f).numpy(),
            np.asarray(want[f]) if isinstance(want, dict)
            else np.asarray(getattr(want, f)), err_msg=f"{msg}: {f}")


@pytest.mark.parametrize("granularity", ["coalesced", "patch", "unit"])
def test_runs_from_oplog_matches_jax(pair, granularity):
    js, ps = pair
    rng = np.random.default_rng(2)
    for jl, pl in zip(js.agent_logs, ps.agent_logs):
        starts = {"coalesced": None,
                  "patch": rng.random(len(pl)) < 0.3,
                  "unit": np.ones(len(pl), bool)}[granularity]
        got = pmr.runs_from_oplog(pl, starts)
        want = runlog_from_jax(jmr.runs_from_oplog(jl, starts))
        for f in RUN_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        assert got.n_unit_ops == want.n_unit_ops
        if granularity == "unit":
            assert (got.rlen == 1).all()


def test_check_no_skip_matches_jax(pair):
    js, ps = pair
    runs = [pmr.runs_from_oplog(lg) for lg in ps.agent_logs]
    assert pmr.check_no_skip(runs) is jmr.check_no_skip(
        [jmr.runs_from_oplog(lg) for lg in js.agent_logs]) is True
    # a head that ties its anchor's chain child on lamport with a smaller
    # agent id violates the precondition
    a = pmr.RunLog(*(np.asarray(x, np.int32) for x in (
        [10], [5], [0], [3], [-1], [], [])), n_unit_ops=3)
    b = pmr.RunLog(*(np.asarray(x, np.int32) for x in (
        [11], [2], [3], [1], [0], [], [])), n_unit_ops=1)
    assert pmr.check_no_skip([a, b]) is False
    assert jmr.check_no_skip([a, b]) is False
    assert pmr.check_no_skip([pmr.RunLog(*(np.zeros(0, np.int32),) * 7,
                                         n_unit_ops=0)])


def _walk(rm, R, port):
    """merge_runlogs walked epoch by epoch on one side: every batch's
    fragments and every epoch's state."""
    B, K = rm.batch, rm.epoch_eff
    if port:
        t = torch.as_tensor
        st = pds.down_packed_init(R, rm.sim.capacity, rm.sim.n_base,
                                  device="cpu")
        frag, apply5, rebuild = (pmr._run_batch_fragments,
                                 pdr._apply_range_update_batch5,
                                 pidpos.snap_rebuild)
        kw = {}
    else:
        t = jnp.asarray
        st = jds.down_packed_init(R, rm.sim.capacity, rm.sim.n_base)
        frag, apply5, rebuild = (jmr._run_batch_fragments,
                                 jdr._apply_range_update_batch5,
                                 jidpos.snap_rebuild)
        kw = {"nbits": 18}
    key = np.where(rm.rlen > 0, rm.lamport * 64 + rm.agent,
                   2**31 - 1).astype(np.int32)
    doc, snap, length, nvis = st
    frags, states = [], []
    NB = len(key) // B
    for e0 in range(0, NB, K):
        levels = []
        for k in range(e0, e0 + K):
            sl = slice(k * B, (k + 1) * B)
            f = frag(t(key[sl]), t(rm.slot0[sl]), t(rm.rlen[sl]),
                     t(rm.origin[sl]))
            frags.append([np.asarray(x) for x in f])
            neg1 = t(np.full(2 * B, -1, np.int32))
            doc, length, nvis, lv = apply5(
                doc, length, nvis, snap, levels, *f,
                t(np.ones(2 * B, np.int32)), neg1, neg1, **kw)
            levels.append(lv)
        snap = rebuild(doc)
        states.append({f: np.asarray(x) for f, x in
                       zip(STATE, (doc, snap, length, nvis))})
    return frags, states


@pytest.mark.parametrize("batch,epoch", [(16, 3), (32, 2)])
def test_run_merge_matches_jax_batch_by_batch(pair, batch, epoch):
    js, ps = pair
    jrm = jmr.RunMergeSimulation(js, batch=batch, epoch=epoch)
    prm = pmr.RunMergeSimulation(ps, batch=batch, epoch=epoch)
    assert prm.fast_ok and jrm.fast_ok
    for f in ("lamport", "agent", "slot0", "rlen", "origin", "dlo", "dhi"):
        np.testing.assert_array_equal(getattr(prm, f), getattr(jrm, f))
    assert (prm.n_runs, prm.n_unit_ops, prm.epoch_eff) == (
        jrm.n_runs, jrm.n_unit_ops, jrm.epoch_eff)
    pf, pst = _walk(prm, 2, True)
    jf, jst = _walk(prm, 2, False)
    assert len(pst) >= 2
    for b, (p, j) in enumerate(zip(pf, jf)):
        for x, y, n in zip(p, j, ("anchor", "rank", "slot0", "rlen")):
            np.testing.assert_array_equal(x, y, err_msg=f"batch {b} {n}")
    for e, (p, j) in enumerate(zip(pst, jst)):
        _eq_state(p, j, f"epoch {e}")
    # the whole merge: that walk, then the delete fold
    st = pmr.merge_runlogs(
        pds.down_packed_init(2, ps.capacity, ps.n_base, device="cpu"),
        *prm._dev, batch=batch, epoch=prm.epoch_eff)
    _eq_state(st, pst[-1], "merge_runlogs")
    folded = pmr.delete_fold(st, *prm._dev_del)
    jfold = jmr.delete_fold(
        jds.DownPacked(*(jnp.asarray(pst[-1][f]) for f in STATE)),
        jnp.asarray(jrm.dlo), jnp.asarray(jrm.dhi))
    _eq_state(folded, jfold, "delete_fold")
    want = _want(js)
    got = prm.merge(n_replicas=2)
    _eq_state(got, jrm.merge(n_replicas=2), "merge")
    assert [prm.decode(got, r) for r in range(2)] == [want] * 2


def test_flat_schedule_equals_batched_and_the_unit_merge(pair):
    js, ps = pair
    prm = pmr.RunMergeSimulation(ps, batch=16, epoch=4)
    flat = prm.merge_flat(n_replicas=2)
    _eq_state(flat, jmr.RunMergeSimulation(js, batch=16, epoch=4)
              .merge_flat(n_replicas=2), "merge_flat")
    batched = prm.merge(n_replicas=2)
    np.testing.assert_array_equal(flat.doc.numpy(), batched.doc.numpy())
    np.testing.assert_array_equal(flat.nvis.numpy(), batched.nvis.numpy())
    unit = ps.merge_packed(n_replicas=2, epoch=2)
    onepass = pdf.make_flat_merge(ps, ps.log, n_replicas=2)()
    want = _want(js)
    for st in (flat, batched, unit, onepass):
        assert [prm.decode(st, r) for r in range(2)] == [want] * 2


def test_run_merge_refuses_a_violated_precondition(pair):
    _, ps = pair
    prm = pmr.RunMergeSimulation(ps, batch=16)
    prm.fast_ok = False
    for fn in (prm.merge, prm.merge_flat):
        with pytest.raises(ValueError, match="precondition"):
            fn()


def _traces(seed, n_ops=400, base="run downstream "):
    jt = jsynth_trace(seed=seed, n_ops=n_ops, base=base)
    jt = dataclasses.replace(jt, end_content=replay_trace(jt))
    pt = psynth_trace(seed=seed, n_ops=n_ops, base=base)
    return jt, dataclasses.replace(pt, end_content=jt.end_content)


@pytest.mark.parametrize("granularity,schedule", [
    ("coalesced", "flat"), ("coalesced", "batched"), ("patch", "flat"),
    ("patch", "batched"), ("unit", "flat"), ("unit", "batched"),
])
def test_run_downstream_backend_matches_jax(granularity, schedule,
                                            monkeypatch):
    jt, pt = _traces(8 + len(granularity))
    bk = pmr.TorchRunDownstreamBackend(n_replicas=2, batch=32, epoch=3,
                                       granularity=granularity,
                                       schedule=schedule, device="cpu")
    kind = {"coalesced": "runs", "patch": "patch", "unit": "unitwire"}
    assert bk.NAME == "torch-cpu-r2-" + kind[granularity] + (
        "-flat" if schedule == "flat" else "")
    bk.prepare(pt)
    assert bk.replay_once() == len(pt.end_content)
    assert bk.final_content() == pt.end_content
    monkeypatch.setenv("CRDT_DOWN_SCHEDULE", schedule)
    jbk = jmr.JaxRunDownstreamBackend(n_replicas=2, batch=32, epoch=3,
                                      granularity=granularity)
    jbk.prepare(jt)
    _eq_state(bk._merge(), jbk._merge(), f"{granularity}/{schedule}")


def test_run_downstream_backend_rejects_unknown_options():
    with pytest.raises(ValueError, match="granularity"):
        pmr.TorchRunDownstreamBackend(granularity="chars", device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        pmr.TorchRunDownstreamBackend(schedule="eager", device="cpu")
    with pytest.raises(RuntimeError, match="prepare"):
        pmr.TorchRunDownstreamBackend(device="cpu").engine


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["range", "runs", "patch", "unitwire"])
def test_sveltecomponent_run_downstream_byte_identical(engine):
    """The whole sveltecomponent trace through each run-granular column
    (the flat schedule for the run merges) at two replicas."""
    trace = ploader.load_testing_data("sveltecomponent")
    if engine == "range":
        bk = pdr.TorchRangeDownstreamBackend(n_replicas=2, device="cpu")
    else:
        bk = pmr.TorchRunDownstreamBackend(
            n_replicas=2, device="cpu",
            granularity={"runs": "coalesced", "patch": "patch",
                         "unitwire": "unit"}[engine])
    bk.prepare(trace)
    assert bk.replay_once() == len(trace.end_content)
    assert bk.final_content() == trace.end_content
