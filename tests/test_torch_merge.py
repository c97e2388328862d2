"""The port's concurrent merge (``engine/merge.py``) on the CPU, held
against the JAX package with exact equality: the agents' op logs, the
causal-order arrangement (sorted segments, and sort + dedup under
duplicated and shuffled delivery), each batch's chain structure, the
packed ``DownPacked`` state after every epoch and at the end, the v1
``DownState``; every decoded document equals ``merge_oracle`` and the
native treap's merge."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.engine import downstream as jds
from crdt_benches_tpu.engine import merge as jm
from crdt_benches_tpu.ops import idpos as jidpos
from crdt_benches_tpu.traces import loader as jloader
from crdt_benches_tpu.traces import synth as jsynth
from crdt_benches_tpu.traces.tensorize import tensorize as jtensorize
from crdt_benches_tpu_torch.backends.native import native_available
from crdt_benches_tpu_torch.engine import downstream as pds
from crdt_benches_tpu_torch.engine import merge as pm
from crdt_benches_tpu_torch.engine.replay import decode_to_str
from crdt_benches_tpu_torch.ops import expand
from crdt_benches_tpu_torch.ops import idpos as pidpos
from crdt_benches_tpu_torch.ops.apply import init_state
from crdt_benches_tpu_torch.traces import loader as ploader
from crdt_benches_tpu_torch.traces import synth as psynth
from crdt_benches_tpu_torch.traces.tensorize import tensorize as ptensorize
from crdt_benches_tpu_torch.utils.convert import (
    down_packed_from_jax,
    down_packed_to_numpy,
    down_state_from_jax,
    oplog_from_jax,
)

FIELDS = ("lamport", "agent", "kind", "elem", "origin", "ch")
JAX = types.SimpleNamespace(loader=jloader, synth=jsynth,
                            tensorize=jtensorize, m=jm)
PORT = types.SimpleNamespace(loader=ploader, synth=psynth,
                             tensorize=ptensorize, m=pm)

#: (seed, agents, ops each, base, batch)
CASES = {
    "three": (3, 3, 200, "shared base text ", 32),
    "empty-base": (7, 2, 300, "", 16),
    "four": (11, 4, 150, "x", 32),
}


def _sim(side, case):
    seed, n_agents, n_ops, base, batch = CASES[case]
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(n_agents):
        patches, _ = side.synth.random_patches(rng, n_ops, len(base))
        streams.append(side.tensorize(side.loader.TestData(
            base, "", [side.loader.TestTxn("", patches)]), batch=batch))
    kw = {"device": "cpu"} if side is PORT else {}
    return side.m.MergeSimulation(streams, base=base, batch=batch, **kw)


@pytest.fixture(scope="module")
def sims():
    return {c: (_sim(JAX, c), _sim(PORT, c)) for c in CASES}


def _delivered(log, seed=5, reps=3, cls=pm.OpLog):
    """Every op delivered ``reps`` times, shuffled."""
    cat = pm.OpLog.concat([log] * reps)
    perm = np.random.default_rng(seed).permutation(len(cat))
    return cls(*(getattr(cat, f)[perm] for f in FIELDS))


def _eq(port, jax_arrays, msg):
    for f, a in jax_arrays.items():
        np.testing.assert_array_equal(port[f], np.asarray(a),
                                      err_msg=f"{msg}: {f}")


def js_base(js):
    return "".join(chr(c) for c in np.asarray(js.chars)[: js.n_base])


def _want(js):
    return jm.merge_oracle(js.log, js_base(js), np.asarray(js.chars))


@pytest.mark.parametrize("case", list(CASES))
def test_oplogs_match_jax(sims, case):
    js, ps = sims[case]
    for jl, pl in zip(js.agent_logs + [js.log], ps.agent_logs + [ps.log]):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(pl, f), getattr(jl, f),
                                          err_msg=f)
        # the carrier gives the same log
        conv = oplog_from_jax(jl)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(conv, f), getattr(pl, f))
    assert ps.capacity == js.capacity and ps.n_base == js.n_base
    np.testing.assert_array_equal(ps.chars.numpy(), np.asarray(js.chars))
    for f, a in js.stacked_logs().items():
        np.testing.assert_array_equal(ps.stacked_logs()[f], a, err_msg=f)


def test_agent_oplog_needs_the_shared_base():
    tt = ptensorize(psynth.synth_trace(seed=0, n_ops=20, base="ab"), 16)
    with pytest.raises(ValueError, match="same base"):
        pm.agent_oplog(tt, 1, 3, 3, device="cpu")


@pytest.mark.parametrize("dup", [False, True])
def test_sort_dedup_matches_jax(sims, dup):
    js, ps = sims["three"]
    log = _delivered(ps.log) if dup else ps.log
    log = ps._padded(log)
    got = pm._sort_dedup(*(torch.as_tensor(getattr(log, f)) for f in FIELDS))
    want = jm._sort_dedup(*(jnp.asarray(getattr(log, f)) for f in FIELDS))
    for g, w, f in zip(got, want, FIELDS):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    n_live = int((got[2] != 0).sum())
    assert n_live == len(ps.log) - int((ps.log.kind == 0).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_rank_sorted_segments_matches_jax(sims, case):
    js, ps = sims[case]
    epoch, segments = ps.packed_schedule(None, 2)
    log = ps._padded(ps.log, multiple=ps.batch * epoch)
    got = pm._rank_sorted_segments(
        *(torch.as_tensor(getattr(log, f)) for f in FIELDS), segments)
    want = jm._rank_sorted_segments(
        *(jnp.asarray(getattr(log, f)) for f in FIELDS), segments)
    for g, w, f in zip(got, want, FIELDS):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


def _walk_packed(sim, log, epoch, max_unique, segments, R, port):
    """The packed merge walked epoch by epoch on one side: the arrangement,
    then per batch the chain structure and the v5 apply; returns (every
    batch's chain structure, every epoch's state as numpy arrays)."""
    B = sim.batch
    if port:
        t = lambda a: torch.as_tensor(a)
        m, apply5, rebuild = pm, pds._apply_update_batch5, pidpos.snap_rebuild
        st = pds.down_packed_init(R, sim.capacity, sim.n_base, device="cpu")
        kw = {}
    else:
        t = jnp.asarray
        m, apply5, rebuild = jm, jds._apply_update_batch5, jidpos.snap_rebuild
        st = jds.down_packed_init(R, sim.capacity, sim.n_base)
        kw = {"nbits": max(1, B.bit_length())}
    arrs = [t(getattr(log, f)) for f in FIELDS]
    if segments is not None:
        _, _, kind, elem, origin, _ = m._rank_sorted_segments(*arrs,
                                                              segments)
    else:
        _, _, kind, elem, origin, _ = m._sort_dedup(*arrs)
    kind, elem, origin = (np.asarray(x) for x in (kind, elem, origin))
    if max_unique is not None:
        keep = -(-max_unique // (B * epoch)) * (B * epoch)
        perm = np.argsort((kind == 0).astype(np.int8), kind="stable")[:keep]
        kind, elem, origin = kind[perm], elem[perm], origin[perm]
    doc, snap, length, nvis = st
    chains, states = [], []
    nb = len(kind) // B
    for e0 in range(0, nb, epoch):
        levels = []
        for k in range(e0, e0 + epoch):
            sl = slice(k * B, (k + 1) * B)
            cs = m._chain_structure(t(kind[sl]), t(elem[sl]), t(origin[sl]))
            chains.append([np.asarray(x) for x in cs])
            doc, length, nvis, lv = apply5(doc, length, nvis, snap, levels,
                                           *cs, **kw)
            levels.append(lv)
        snap = rebuild(doc)
        states.append({f: np.asarray(x) for f, x in
                       zip(("doc", "snap", "length", "nvis"),
                           (doc, snap, length, nvis))})
    return chains, states


@pytest.mark.parametrize("case,dup", [("three", False), ("empty-base", False),
                                      ("three", True), ("four", True)])
def test_packed_merge_matches_jax_batch_by_batch(sims, case, dup):
    js, ps = sims[case]
    R = 2
    if dup:
        log = _delivered(ps.log)
        epoch, segments = ps.packed_schedule(log, 2)
        max_unique = len(ps.log)
    else:
        log, max_unique = None, None
        epoch, segments = ps.packed_schedule(None, 2)
    padded = ps._padded(log if dup else ps.log, multiple=ps.batch * epoch)
    pc, pst = _walk_packed(ps, padded, epoch, max_unique, segments, R, True)
    jc, jst = _walk_packed(js, padded, epoch, max_unique, segments, R, False)
    assert len(pc) == len(jc) and len(pst) == len(jst) >= 2
    for b, (p, j) in enumerate(zip(pc, jc)):
        for x, y, name in zip(p, j, ("ins", "anchor", "rank", "dslot")):
            np.testing.assert_array_equal(x, y, err_msg=f"batch {b} {name}")
    for e, (p, j) in enumerate(zip(pst, jst)):
        _eq(p, j, f"epoch {e}")
    # the whole merge is that walk
    got = ps.merge_packed(log, n_replicas=R, epoch=2, max_unique=max_unique)
    _eq(down_packed_to_numpy(got), pst[-1], "merge_packed")
    want = _want(js)
    assert [ps.decode(got, r) for r in range(R)] == [want] * R
    jl = None if log is None else jm.OpLog(*(getattr(log, f)
                                             for f in FIELDS))
    jgot = js.merge_packed(jl, n_replicas=R, epoch=2, max_unique=max_unique)
    _eq(down_packed_to_numpy(got), {f: getattr(jgot, f) for f in
                                    ("doc", "snap", "length", "nvis")},
        "jax merge_packed")
    # the carrier round trip
    back = down_packed_from_jax(down_packed_to_numpy(got), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, got))


def test_packed_merge_runs_k7_plain_once_a_batch(sims):
    js, ps = sims["three"]
    before = expand.apply_fused_blocked_plain.calls
    st = ps.merge_packed(n_replicas=1, epoch=2)
    epoch, _ = ps.packed_schedule(None, 2)
    n_batches = len(ps._padded(ps.log, ps.batch * epoch)) // ps.batch
    assert expand.apply_fused_blocked_plain.calls - before == n_batches
    assert ps.decode(st) == _want(js)


@pytest.mark.parametrize("case,dup", [("three", False), ("four", True)])
def test_v1_merge_matches_jax(sims, case, dup):
    js, ps = sims[case]
    log = _delivered(ps.log, seed=8) if dup else None
    got = ps.merge(log)
    jlog = None if log is None else jm.OpLog(*(getattr(log, f)
                                               for f in FIELDS))
    want = js.merge(jlog)
    jarr = {f: np.asarray(getattr(want, f))[None] for f in want._fields}
    _eq({f: getattr(got, f).numpy() for f in got._fields}, jarr, "v1")
    assert ps.decode(got) == js.decode(want) == _want(js)
    # the JAX one-replica state carries over with R = 1
    conv = down_state_from_jax({f: np.asarray(getattr(want, f))
                                for f in want._fields}, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(conv, got))


def test_decode_to_str_matches_jax():
    from crdt_benches_tpu.engine.replay import decode_to_str as jdecode
    from crdt_benches_tpu.ops.apply import init_state as jinit

    chars = np.arange(97, 97 + 256, dtype=np.int32)
    jst = jinit(256, 40)
    pst = init_state(1, 256, 40, device="cpu")
    assert decode_to_str(pst, torch.as_tensor(chars)) == jdecode(
        jst, jnp.asarray(chars)) == "".join(map(chr, chars[:40]))


@pytest.mark.parametrize("case", list(CASES))
def test_native_ops_and_content_match(sims, case):
    js, ps = sims[case]
    for a, b in zip(pm.to_native_ops(ps), jm.to_native_ops(js)):
        np.testing.assert_array_equal(a, b)
    log = _delivered(ps.log, seed=9)
    jlog = jm.OpLog(*(getattr(log, f) for f in FIELDS))
    for a, b in zip(pm.to_native_ops(ps, log), jm.to_native_ops(js, jlog)):
        np.testing.assert_array_equal(a, b)
    want = _want(js)
    assert pm.merge_oracle(ps.log, js_base(js), ps.chars.numpy()) == want
    if native_available():
        assert pm.native_merge_content(ps) == want
        assert pm.native_merge_content(ps, log) == want


def test_merge_simulation_guards():
    tt = ptensorize(psynth.synth_trace(seed=1, n_ops=10, base="a"), 16)
    with pytest.raises(ValueError, match="MAX_AGENTS"):
        pm.MergeSimulation([tt] * 63, base="a", batch=16, device="cpu")
    with pytest.raises(ValueError, match="share the base"):
        pm.MergeSimulation([tt], base="ab", batch=16, device="cpu")
