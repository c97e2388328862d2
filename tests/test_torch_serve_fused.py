"""The port's serve macro path (K1's per-row form, the round inputs, the
per-round apply and K4's plain version) against the JAX package's
``ops/serve_fused.py``, exact integer equality (tolerance 0), on per-row
op streams made with numpy from a seed.  JAX's Pallas serve kernel runs
under the interpreter, as its own tests run it.

JAX's K4 expands each round with an ``nbits`` roll cascade that is exact
only while 2^nbits exceeds a round's inserted chars per row, so the JAX
calls get NBITS = 8 (a round here inserts at most 12 x 5 = 60 chars)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops import serve_fused as SF
from crdt_benches_tpu.ops.apply2 import PackedState as JaxPackedState
from crdt_benches_tpu.ops.apply_range import apply_range_batch
from crdt_benches_tpu.ops.resolve_range_scan import resolve_ranges_rows
from crdt_benches_tpu.traces.tensorize import DELETE, INSERT, PAD
from crdt_benches_tpu_torch.ops import serve_fused as PF
from crdt_benches_tpu_torch.ops.resolve import FREE
from crdt_benches_tpu_torch.ops.resolve_range import (
    resolve_range_rows,
    resolve_range_rows_plain,
)
from crdt_benches_tpu_torch.utils.convert import (
    rounds_from_jax,
    state3_from_jax,
    state3_to_numpy,
)

NBITS = 8
# jitted once per shape: eager scans compile on every call
_resolve_rows = jax.jit(resolve_ranges_rows)
_resolve_grow = jax.jit(SF.resolve_round_rows_grow)
_apply_batch = jax.jit(functools.partial(apply_range_batch, nbits=NBITS))
_apply_xla = jax.jit(functools.partial(SF.serve_apply_round_xla,
                                       nbits=NBITS))


def _gen_ops(rng, K, R, B, nvis0, pad_rows=()):
    """Valid random per-row op streams (inserts and deletes in range) with
    PAD tails, int32 (K, R, B); rows in ``pad_rows`` are all PAD in every
    round and round 1 of row 0 is all PAD."""
    kind = np.full((K, R, B), PAD, np.int32)
    pos = np.zeros((K, R, B), np.int32)
    rlen = np.zeros((K, R, B), np.int32)
    slot0 = np.zeros((K, R, B), np.int32)
    slot_next = nvis0.astype(np.int64).copy()
    total = nvis0.astype(np.int64).copy()
    for r in range(R):
        for k in range(K):
            if r in pad_rows or (r, k) == (0, 1):
                continue
            for b in range(int(rng.integers(1, B + 1))):
                if total[r] > 2 and rng.random() < 0.4:
                    kk = DELETE
                    p = int(rng.integers(0, total[r]))
                    L = int(rng.integers(1, min(6, total[r] - p) + 1))
                else:
                    kk = INSERT
                    p = int(rng.integers(0, total[r] + 1))
                    L = int(rng.integers(1, 6))
                kind[k, r, b], pos[k, r, b], rlen[k, r, b] = kk, p, L
                if kk == INSERT:
                    slot0[k, r, b] = slot_next[r]
                    slot_next[r] += L
                    total[r] += L
                else:
                    total[r] -= L
    return kind, pos, rlen, slot0


def _fresh(nvis0, C):
    R = len(nvis0)
    doc = np.full((R, C), 2, np.int32)
    for r in range(R):
        idx = np.arange(nvis0[r])
        doc[r, :nvis0[r]] = ((idx + 2) << 1) | 1
    return {"doc": doc, "length": nvis0.copy(), "nvis": nvis0.copy()}


def _jax_state(arrays):
    return JaxPackedState(*(jnp.asarray(arrays[f])
                            for f in ("doc", "length", "nvis")))


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.fixture(scope="module", params=[(4, 6, 12, 256), (3, 5, 24, 1024)],
                ids=["K4-R6-B12-C256", "K3-R5-B24-C1024"])
def case(request):
    K, R, B, C = request.param
    rng = np.random.default_rng(7)
    nvis0 = rng.integers(3, 24, R).astype(np.int32)
    ops = _gen_ops(rng, K, R, B, nvis0, pad_rows=(R - 1,))
    # the JAX reference: per round, the scan resolve then apply_range_batch
    state = _jax_state(_fresh(nvis0, C))
    starts, rounds, states = [], [], [state]
    for k in range(K):
        starts.append(_np(state.nvis))
        tok, di, _ = _resolve_rows(*(o[k] for o in ops), state.nvis)
        rounds.append((tok, di))
        state = _apply_batch(state, tok, di)
        states.append(state)
    assert int(_np(state.length).max()) <= C  # the case fits its capacity
    tokens = tuple(np.stack([_np(r[0][i]) for r in rounds]) for i in range(4))
    dints = tuple(np.stack([_np(r[1][i]) for r in rounds]) for i in range(3))
    return dict(K=K, R=R, B=B, C=C, nvis0=nvis0, ops=ops,
                starts=np.stack(starts), tokens=tokens, dints=dints,
                states=states)


def _port_resolve(case):
    return resolve_range_rows(*(_t(o) for o in case["ops"]),
                              _t(case["nvis0"]))


def test_rows_resolve_equals_jax_scan_and_round_starts(case):
    (toks, dints, starts) = _port_resolve(case)
    W = 2 * case["B"] + 2
    for got, want in zip(toks, case["tokens"]):
        assert got.shape[2] >= W and got.shape[2] % 128 == 0
        np.testing.assert_array_equal(got[:, :, :W].numpy(), want)
    # the tail past 2B + 2 is FREE with zero length (inert downstream)
    assert (toks[0][:, :, W:] == FREE).all()
    for t in toks[1:]:
        assert (t[:, :, W:] == 0).all()
    for got, want in zip(dints, case["dints"]):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(starts.numpy(), case["starts"])
    ops = case["ops"]
    np.testing.assert_array_equal(
        starts.numpy(), _np(SF.round_starts(*ops[:3], case["nvis0"])))


def test_rows_resolve_equals_growing_resolve(case):
    toks, dints, starts = _port_resolve(case)
    W = 2 * case["B"] + 2
    for k in range(case["K"]):
        t_ref, d_ref = _resolve_grow(
            *(o[k] for o in case["ops"]), case["starts"][k])
        for got, want in zip(toks, t_ref):
            np.testing.assert_array_equal(got[k, :, :W].numpy(), _np(want))
        for got, want in zip(dints, d_ref):
            np.testing.assert_array_equal(got[k].numpy(), _np(want))


def test_all_pad_rows_resolve_to_trivial_tokens(case):
    toks, dints, starts = _port_resolve(case)
    W = 2 * case["B"] + 2
    # the last row is all PAD in every round, row 0 in round 1
    for k, r in [(k, case["R"] - 1) for k in range(case["K"])] + [(1, 0)]:
        assert (case["ops"][0][k, r] == PAD).all()
        t_ref, d_ref = SF.trivial_round_tokens(
            jnp.asarray(starts[k].numpy()), case["B"])
        for got, want in zip(toks, t_ref):
            np.testing.assert_array_equal(got[k, r, :W].numpy(),
                                          _np(want)[r])
        for got, want in zip(dints, d_ref):
            np.testing.assert_array_equal(got[k, r].numpy(), _np(want)[r])


def test_rows_resolve_validates_operands(case):
    kind, pos, rlen, slot0 = (_t(o) for o in case["ops"])
    v0 = _t(case["nvis0"])
    with pytest.raises(ValueError, match="int32"):
        resolve_range_rows(kind, pos, rlen, slot0.long(), v0)
    with pytest.raises(ValueError, match="K, R, B"):
        resolve_range_rows(kind[0], pos[0], rlen[0], slot0[0], v0)
    calls = resolve_range_rows_plain.calls
    resolve_range_rows(kind, pos, rlen, slot0, v0)  # a CPU tensor: plain
    assert resolve_range_rows_plain.calls == calls + 1


def test_round_starts_and_total_delta_equal_jax(case):
    kind, pos, rlen, _ = case["ops"]
    got = PF.round_starts(_t(kind), _t(pos), _t(rlen), _t(case["nvis0"]))
    np.testing.assert_array_equal(
        got.numpy(), _np(SF.round_starts(kind, pos, rlen, case["nvis0"])))
    v0 = _t(case["nvis0"])
    for k in range(case["K"]):
        v0 = PF.round_total_delta(_t(kind[k]), _t(pos[k]), _t(rlen[k]), v0)
        want = SF.round_total_delta(kind[k], pos[k], rlen[k],
                                    jnp.asarray(case["starts"][k]))
        np.testing.assert_array_equal(v0.numpy(), _np(want))


def test_serve_round_inputs_equal_jax(case):
    tokens, dints = rounds_from_jax(case["tokens"], case["dints"], "cpu")
    n0 = case["nvis0"]
    got = PF.serve_round_inputs(tokens, dints, _t(n0), _t(n0))
    want = SF.serve_round_inputs(
        tuple(map(jnp.asarray, case["tokens"])),
        tuple(map(jnp.asarray, case["dints"])),
        jnp.asarray(n0), jnp.asarray(n0))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_apply_round_plain_equals_xla_apply_and_apply_range_batch(case):
    arrays = _fresh(case["nvis0"], case["C"])
    state = state3_from_jax(arrays, "cpu")
    jstate = _jax_state(arrays)
    for k in range(case["K"]):
        tok = tuple(t[k] for t in case["tokens"])
        di = tuple(d[k] for d in case["dints"])
        ptok, pdi = rounds_from_jax([t[None] for t in tok],
                                    [d[None] for d in di], "cpu")
        state = PF.serve_apply_round_plain(
            state, tuple(t[0] for t in ptok), tuple(d[0] for d in pdi))
        jtok = tuple(map(jnp.asarray, tok))
        jdi = tuple(map(jnp.asarray, di))
        want_xla = _apply_xla(jstate, jtok, jdi)
        want_arb = _apply_batch(jstate, jtok, jdi)
        got = state3_to_numpy(state)
        for f in ("doc", "length", "nvis"):
            np.testing.assert_array_equal(got[f], _np(getattr(want_xla, f)))
            np.testing.assert_array_equal(got[f], _np(getattr(want_arb, f)))
        jstate = want_xla


def test_macro_plain_equals_jax_rounds_and_interpreted_kernel(case):
    arrays = _fresh(case["nvis0"], case["C"])
    tokens, dints = rounds_from_jax(case["tokens"], case["dints"], "cpu")
    calls = PF.serve_macro_plain.calls
    got = state3_to_numpy(PF.serve_macro_plain(
        state3_from_jax(arrays, "cpu"), tokens, dints))
    assert PF.serve_macro_plain.calls == calls + 1
    jtok = tuple(map(jnp.asarray, case["tokens"]))
    jdi = tuple(map(jnp.asarray, case["dints"]))
    want_xla = SF.serve_macro_rounds_xla(_jax_state(arrays), jtok, jdi,
                                         NBITS)
    want_k4 = SF.serve_macro_fused(_jax_state(arrays), jtok, jdi,
                                   nbits=NBITS, replica_tile=3,
                                   interpret=True)
    want_ref = case["states"][-1]
    for f in ("doc", "length", "nvis"):
        for want in (want_xla, want_k4, want_ref):
            np.testing.assert_array_equal(got[f], _np(getattr(want, f)))


def test_macro_fused_on_cpu_runs_the_plain_version_in_place(case):
    arrays = _fresh(case["nvis0"], case["C"])
    tokens, dints = rounds_from_jax(case["tokens"], case["dints"], "cpu")
    state = state3_from_jax(arrays, "cpu")
    doc = state.doc
    launches = PF.serve_macro_fused.launches
    new = PF.serve_macro_fused(state, tokens, dints, out=doc)
    assert PF.serve_macro_fused.launches == launches  # no kernel on the CPU
    assert new.doc is doc
    want = case["states"][-1]
    np.testing.assert_array_equal(doc.numpy(), _np(want.doc))
    np.testing.assert_array_equal(new.length.numpy(), _np(want.length))
    np.testing.assert_array_equal(new.nvis.numpy(), _np(want.nvis))


def test_macro_fused_validates_operands(case):
    arrays = _fresh(case["nvis0"], case["C"])
    tokens, dints = rounds_from_jax(case["tokens"], case["dints"], "cpu")
    state = state3_from_jax(arrays, "cpu")
    with pytest.raises(ValueError, match="int32"):
        PF.serve_macro_fused(state, tokens[:3] + (tokens[3].long(),), dints)
    with pytest.raises(ValueError, match="out"):
        PF.serve_macro_fused(state, tokens, dints, out=state.doc[:1])
    with pytest.raises(ValueError, match="at least one round"):
        PF.serve_macro_fused(state, tuple(t[:0] for t in tokens),
                             tuple(d[:0] for d in dints))
    with pytest.raises(ValueError, match="shapes"):
        rounds_from_jax(case["tokens"], tuple(d[:1] for d in case["dints"]),
                        "cpu")
