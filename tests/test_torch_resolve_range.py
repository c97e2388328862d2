"""The port's range resolver (K1, plain PyTorch version on the CPU) held
against the JAX reference resolvers: exact equality of all eight outputs
(tolerance 0 — every value is an integer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops.resolve_range_pallas import resolve_range_pallas
from crdt_benches_tpu.ops.resolve_range_scan import resolve_ranges_shared
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu.traces.tensorize import DELETE, INSERT, tensorize_ranges
from crdt_benches_tpu_torch.ops.resolve import FREE
from crdt_benches_tpu_torch.ops.resolve_range import (
    effective_token_list_size,
    resolve_range,
    resolve_range_plain,
)


def _v0_per_batch(rt):
    """Visible length before each batch (valid traces never clamp)."""
    kind_b, _, rlen_b, _ = rt.batched()
    delta = (np.where(kind_b == INSERT, rlen_b, 0).sum(1)
             - np.where(kind_b == DELETE, rlen_b, 0).sum(1))
    return len(rt.init_chars) + np.concatenate([[0], np.cumsum(delta)[:-1]])


def _port(kind, pos, rlen, slot0, v0, cap=None):
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    tokens, dints, nused = resolve_range(
        t(kind), t(pos), t(rlen), t(slot0), t(v0), token_cap=cap
    )
    return [x.numpy() for x in (*tokens, *dints, nused)]


def _jax(out):
    tokens, dints, nused = out
    return [np.asarray(x) for x in (*tokens, *dints, nused)]


@pytest.mark.parametrize("batch,cap", [(32, None), (256, None), (256, 100)])
@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_plain_matches_pallas_interpret(seed, coalesce, batch, cap):
    """Every batch of a synthetic trace, three replicas whose visible
    lengths differ (the true one, a longer and a shorter document, so
    positions and delete lengths also get clipped).  cap=100 shrinks the
    token list to 128 < demand: placements past T are dropped and nused
    still counts the true demand, on both sides."""
    trace = synth_trace(seed=seed, n_ops=260, base="resolver parity test ")
    rt = tensorize_ranges(trace, batch=batch, coalesce=coalesce)
    overflowed = False
    for (kind, pos, rlen, slot0), v in zip(
        zip(*rt.batched()), _v0_per_batch(rt)
    ):
        v0 = np.asarray([v, v + 5, max(v - 3, 0)], np.int32)
        want = _jax(resolve_range_pallas(
            jnp.asarray(kind), jnp.asarray(pos), jnp.asarray(rlen),
            jnp.asarray(slot0), jnp.asarray(v0), interpret=True,
            token_cap=cap,
        ))
        got = _port(kind, pos, rlen, slot0, v0, cap)
        assert got[0].shape == (3, effective_token_list_size(batch, cap))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        overflowed |= bool((got[-1] > got[0].shape[1]).any())
    if cap is not None:
        assert overflowed  # the capped case really exercises the drop


def test_plain_matches_scan_resolver_on_sveltecomponent(svelte_trace):
    """One full-width batch (B = 1536) against the reference's scan
    resolver, whose token list is the unrounded 2B+2: the port's extra
    tail tokens must be FREE and empty."""
    rt = tensorize_ranges(svelte_trace, batch=1536, coalesce=True)
    i = 2
    kind, pos, rlen, slot0 = (a[i] for a in rt.batched())
    v0 = np.asarray([_v0_per_batch(rt)[i]] * 2, np.int32)
    want = _jax(jax.jit(resolve_ranges_shared)(
        jnp.asarray(kind), jnp.asarray(pos), jnp.asarray(rlen),
        jnp.asarray(slot0), jnp.asarray(v0),
    ))
    got = _port(kind, pos, rlen, slot0, v0)
    T = want[0].shape[1]
    assert T == 2 * 1536 + 2 and got[0].shape[1] == 3200
    assert FREE == 0  # FREE tails are (FREE, 0, 0, 0)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g[:, :T], w)
        assert (g[:, T:] == 0).all()
    for g, w in zip(got[4:7], want[4:7]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[7].reshape(-1), want[7].reshape(-1))


def test_resolver_wrapper_checks_inputs():
    z = torch.zeros(4, dtype=torch.int32)
    v0 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        resolve_range(z.long(), z, z, z, v0)
    with pytest.raises(ValueError, match="int32"):
        resolve_range(z, z, z[:3], z, v0)
    before = resolve_range_plain.calls
    resolve_range(z, z, z, z, v0)  # CPU tensors take the plain version
    assert resolve_range_plain.calls == before + 1
