"""The port's one-shot flatten (``engine/downstream_flat.py``) on the CPU,
held against the JAX package with exact equality: the segment fill,
``flatten_runs`` on run wires, ``flatten_unit_log`` and the flat merge
cell on plain and on duplicated, shuffled delivery; every decoded document
equals the oracle and the native treap's merge."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.engine import downstream_flat as jdf
from crdt_benches_tpu.engine import merge as jm
from crdt_benches_tpu.traces import loader as jloader
from crdt_benches_tpu.traces.synth import random_patches as jrandom_patches
from crdt_benches_tpu.traces.tensorize import tensorize as jtensorize
from crdt_benches_tpu_torch.backends.native import native_available
from crdt_benches_tpu_torch.engine import downstream_flat as pdf
from crdt_benches_tpu_torch.engine import merge as pm
from crdt_benches_tpu_torch.engine import merge_range as pmr
from crdt_benches_tpu_torch.traces import loader as ploader
from crdt_benches_tpu_torch.traces.synth import random_patches
from crdt_benches_tpu_torch.traces.tensorize import tensorize

FIELDS = ("lamport", "agent", "kind", "elem", "origin", "ch")
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


#: (seed, agents, ops each, base)
CASES = {"three": (12, 3, 250, "flat base "), "empty-base": (13, 2, 300, "")}


@pytest.fixture(scope="module")
def sims():
    return {c: (_sim(JAX, *a), _sim(PORT, *a)) for c, a in CASES.items()}


def _want(js):
    base = "".join(chr(c) for c in np.asarray(js.chars)[: js.n_base])
    return jm.merge_oracle(js.log, base, np.asarray(js.chars))


def _eq_state(got, want, msg):
    for f in STATE:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{msg}: {f}")


def _delivered(log, seed, reps):
    cat = pm.OpLog.concat([log] * reps)
    perm = np.random.default_rng(seed).permutation(len(cat))
    return pm.OpLog(*(getattr(cat, f)[perm] for f in FIELDS))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rightmost_fill_matches_jax(seed):
    rng = np.random.default_rng(seed)
    marks = np.where(rng.random(300) < 0.1, rng.integers(0, 50, 300),
                     -1).astype(np.int32)
    marks[0] = -1 if seed else 7  # no valid mark before the first one
    np.testing.assert_array_equal(
        pdf._rightmost_fill(torch.as_tensor(marks)).numpy(),
        np.asarray(jdf._rightmost_fill(jnp.asarray(marks))))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("granularity", ["coalesced", "unit"])
def test_flatten_runs_matches_jax(sims, case, granularity):
    js, ps = sims[case]
    starts = None if granularity == "coalesced" else [
        np.ones(len(lg), bool) for lg in ps.agent_logs]
    prm = pmr.RunMergeSimulation(ps, batch=16, patch_starts=starts)
    key = np.where(prm.rlen > 0, prm.lamport * 64 + prm.agent,
                   2**31 - 1).astype(np.int32)
    kw = dict(n_base=ps.n_base, capacity=ps.capacity,
              n_elems=ps.n_base + int(prm.rlen.sum()), n_replicas=3)
    wire = (key, prm.slot0, prm.rlen, prm.origin)
    got = pdf.flatten_runs(*(torch.as_tensor(a) for a in wire), **kw)
    want = jdf.flatten_runs(*(jnp.asarray(a) for a in wire), **kw)
    _eq_state(got, want, "flatten_runs")
    assert got.snap.is_contiguous() and got.snap.stride(0) == ps.capacity
    assert prm.decode(pmr.delete_fold(got, *prm._dev_del), 2) == _want(js)


@pytest.mark.parametrize("case,reps", [("three", 1), ("three", 4),
                                       ("empty-base", 3)])
def test_flat_merge_matches_jax_on_delivered_logs(sims, case, reps):
    js, ps = sims[case]
    log = ps.log if reps == 1 else _delivered(ps.log, 20 + reps, reps)
    jlog = jm.OpLog(*(getattr(log, f) for f in FIELDS))
    n_uni = int((ps.log.kind == 1).sum())
    kw = dict(n_base=ps.n_base, capacity=ps.capacity,
              n_elems=ps.n_base + n_uni, max_unique=n_uni, n_replicas=2)
    cols = ("lamport", "agent", "kind", "elem", "origin")
    got = pdf.flatten_unit_log(
        *(torch.as_tensor(getattr(log, f)) for f in cols), **kw)
    want = jdf.flatten_unit_log(
        *(jnp.asarray(getattr(log, f)) for f in cols), **kw)
    _eq_state(got, want, "flatten_unit_log")
    st = pdf.make_flat_merge(ps, log, n_replicas=2)()
    _eq_state(st, jdf.make_flat_merge(js, jlog, n_replicas=2)(),
              "make_flat_merge")
    doc = _want(js)
    assert [ps.decode(st, r) for r in range(2)] == [doc] * 2
    if native_available():
        assert pm.native_merge_content(ps, log) == doc


def test_flat_merge_equals_the_unit_merge_under_duplicates(sims):
    js, ps = sims["three"]
    log = _delivered(ps.log, 31, 3)
    flat = pdf.make_flat_merge(ps, log, n_replicas=2)()
    unit = ps.merge_packed(log, n_replicas=2, epoch=2, max_unique=len(ps.log))
    np.testing.assert_array_equal(ps.decode(flat, 1), ps.decode(unit, 1))
    np.testing.assert_array_equal(flat.nvis.numpy(), unit.nvis.numpy())


def test_flat_merge_guards_the_packed_key(sims):
    _, ps = sims["three"]
    big = pm.OpLog(*(getattr(ps.log, f).copy() for f in FIELDS))
    big.lamport[0] = (2**31 - 1) // 64
    with pytest.raises(ValueError, match="too large"):
        pdf.make_flat_merge(ps, big)
    with pytest.raises(ValueError, match="node ids"):
        pdf.flatten_runs(*(torch.zeros(4, dtype=torch.int32),) * 4,
                         n_base=0, capacity=2**31 - 4)
