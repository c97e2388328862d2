"""The fleet's batched downstream merge (``engine/merge_fleet.py``) against
the JAX package's: one round and K rounds of per-row range ops on a 6-row
fleet batch (each row a different document; short streams end in all-PAD
rounds, the last batch of each in PAD lanes) equal JAX's
``merge_rows_round``/``merge_rows_macro`` in every field, and a single
writer's stream replayed through ``merge_rows_macro`` over a fresh row
decodes to the oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.engine import merge_fleet as jax_fleet
from crdt_benches_tpu.ops.apply2 import PackedState as JaxPackedState
from crdt_benches_tpu_torch.engine.merge_fleet import (
    merge_rows_body,
    merge_rows_macro,
    merge_rows_round,
)
from crdt_benches_tpu_torch.ops.apply2 import PackedState
from crdt_benches_tpu_torch.oracle.text_oracle import replay_trace
from crdt_benches_tpu_torch.serve.pool import _fresh_row_np, decode_row_np
from crdt_benches_tpu_torch.serve.workload import trace_prefix
from crdt_benches_tpu_torch.traces.synth import synth_trace
from crdt_benches_tpu_torch.traces.tensorize import PAD, tensorize_ranges

C = 256
B = 8
NBITS = C.bit_length()  # 2^NBITS above any round's inserted chars
FIELDS = ("doc", "length", "nvis")


def _fleet(seed: int = 0):
    """Six documents' range batches stacked into rounds (K, 6, B) — row r
    is document r, rounds past its stream all PAD — and their fresh rows."""
    rng = np.random.default_rng(seed)
    traces, rts = [], []
    for r in range(6):
        base = "".join(chr(97 + x) for x in rng.integers(0, 26, 3 * r))
        tr = synth_trace(seed=seed * 10 + r, n_ops=int(rng.integers(8, 90)),
                         base=base, p_insert=0.7)
        traces.append(tr)
        rts.append(tensorize_ranges(tr, batch=B))
    K = max(rt.n_batches for rt in rts)
    ops = np.zeros((4, K, 6, B), np.int32)
    ops[3] = -1
    for r, rt in enumerate(rts):
        for i, a in enumerate(rt.batched()):
            ops[i, :rt.n_batches, r] = a
    doc = np.stack([_fresh_row_np(C, len(rt.init_chars)) for rt in rts])
    n0 = np.asarray([len(rt.init_chars) for rt in rts], np.int32)
    return traces, rts, ops, (doc, n0, n0.copy())


def _port(state_np, device="cpu"):
    return PackedState(*(torch.as_tensor(a, device=device)
                         for a in state_np))


def _jax(state_np):
    return JaxPackedState(*(jnp.asarray(a) for a in state_np))


def _equal(got: PackedState, want, what: str):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what}: {f}")


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_rows_round_equals_jax_every_round(seed):
    _, _, ops, state_np = _fleet(seed)
    assert (ops[0] == PAD).all(axis=2).any()  # all-PAD rows in a round
    assert ((ops[0] == PAD).any(axis=2) & ~(ops[0] == PAD).all(axis=2)).any()
    st = _port(state_np)
    jst = _jax(state_np)
    for k in range(ops.shape[1]):
        a = [torch.as_tensor(ops[i, k]) for i in range(4)]
        st = merge_rows_round(st, *a)
        jst = jax_fleet.merge_rows_round(
            jst, *(jnp.asarray(ops[i, k]) for i in range(4)), nbits=NBITS)
        _equal(st, jst, f"round {k}")


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_rows_macro_equals_jax_and_the_rounds(seed):
    traces, rts, ops, state_np = _fleet(seed)
    got = merge_rows_macro(_port(state_np),
                           *(torch.as_tensor(ops[i]) for i in range(4)))
    want = jax_fleet.merge_rows_macro(
        _jax(state_np), *(jnp.asarray(ops[i]) for i in range(4)),
        nbits=NBITS)
    _equal(got, want, "macro")
    st = _port(state_np)
    for k in range(ops.shape[1]):
        st = merge_rows_body(st, *(torch.as_tensor(ops[i, k])
                                   for i in range(4)))
    _equal(st, got, "round by round")
    for r, (tr, rt) in enumerate(zip(traces, rts)):
        doc = got.doc[r].numpy()
        assert decode_row_np(doc, int(got.length[r]), int(got.nvis[r]),
                             rt.chars) == replay_trace(tr), r


@pytest.mark.parametrize("name,budget", [("automerge-paper", 400),
                                         ("sveltecomponent", 700)])
def test_single_writer_stream_over_a_fresh_row_decodes_to_the_oracle(
        name, budget):
    tr = trace_prefix(name, budget)
    rt = tensorize_ranges(tr, batch=16)
    cap = -(-rt.capacity // 128) * 128
    n0 = np.asarray([len(rt.init_chars)], np.int32)
    st = PackedState(torch.as_tensor(_fresh_row_np(cap, int(n0[0]))[None]),
                     torch.as_tensor(n0), torch.as_tensor(n0.copy()))
    ops = [torch.as_tensor(np.ascontiguousarray(a[:, None]))
           for a in rt.batched()]
    got = merge_rows_macro(st, *ops)
    assert decode_row_np(got.doc[0].numpy(), int(got.length[0]),
                         int(got.nvis[0]), rt.chars) == replay_trace(tr)


def test_operands_are_checked():
    _, _, ops, state_np = _fleet(0)
    a = [torch.as_tensor(ops[i, 0]) for i in range(4)]
    with pytest.raises(ValueError, match="int32"):
        merge_rows_round(_port(state_np), a[0].long(), *a[1:])
    with pytest.raises(ValueError, match="R = 6"):
        merge_rows_round(_port(state_np), *(x[:5] for x in a))
    with pytest.raises(ValueError, match="K R B"):
        merge_rows_macro(_port(state_np), *a)
    with pytest.raises(ValueError, match="contiguous"):
        merge_rows_round(_port(state_np), a[0].t().contiguous().t(), *a[1:])
