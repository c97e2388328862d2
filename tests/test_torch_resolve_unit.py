"""The port's unit-op resolver (K5, plain PyTorch version on the CPU) held
against the JAX package's two resolvers with exact equality (tolerance
0: every output is an integer or a flag): the ``lax.scan`` resolver,
vmapped over replicas, with origins; and the Pallas kernel in interpret
mode without them (its ``origin`` is then -1 or -2 only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops.resolve import resolve_batch as jax_resolve
from crdt_benches_tpu.ops.resolve_pallas import resolve_batch_pallas
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu.traces.tensorize import DELETE, INSERT, PAD, tensorize
from crdt_benches_tpu_torch.ops.resolve import (
    TDEAD,
    ResolvedBatch,
    resolve_batch,
    resolve_batch_plain,
    token_list_size,
)

_scan = jax.jit(jax.vmap(jax_resolve, in_axes=(None, None, 0)))
#: per-replica offsets from the true pre-batch length: replicas disagree
#: on v0, so positions clip differently per replica
_OFFSETS = np.array([0, 3, -5, -10**6], np.int64)


def _batches(seed: int, B: int):
    """(kind, pos, v0 int32[4]) for every batch of a synth trace, v0 the
    true visible length before the batch plus per-replica offsets."""
    trace = synth_trace(seed=seed, n_ops=6 * B, base="resolver parity ")
    tt = tensorize(trace, batch=B)
    kind_b, pos_b, _, _ = tt.batched()
    step = np.where(kind_b == INSERT, 1, np.where(kind_b == DELETE, -1, 0))
    before = len(tt.init_chars) + np.cumsum(step.sum(1)) - step.sum(1)
    for k, p, v in zip(kind_b, pos_b, before):
        yield k, p, np.maximum(v + _OFFSETS, 0).astype(np.int32)


def _port(kind, pos, v0, emit_origin):
    t = torch.as_tensor
    return resolve_batch(t(kind), t(pos), t(v0), emit_origin=emit_origin)


def _assert_equal(got: ResolvedBatch, want, where: str):
    for f in ResolvedBatch._fields:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.dtype == (np.bool_ if f == "ins_alive" else np.int32), f
        np.testing.assert_array_equal(g, w, err_msg=f"{where} field {f}")


@pytest.mark.parametrize("seed,B", [(0, 32), (1, 32), (2, 64), (3, 64)])
def test_plain_matches_scan_resolver_with_origins(seed, B):
    for i, (k, p, v0) in enumerate(_batches(seed, B)):
        want = _scan(jnp.asarray(k), jnp.asarray(p), jnp.asarray(v0))
        _assert_equal(_port(k, p, v0, True), want, f"batch {i}")


@pytest.mark.parametrize("seed,B", [(0, 32), (4, 32), (5, 64), (6, 64)])
def test_plain_matches_pallas_resolver_without_origins(seed, B):
    for i, (k, p, v0) in enumerate(_batches(seed, B)):
        want = resolve_batch_pallas(
            jnp.asarray(k), jnp.asarray(p), jnp.asarray(v0),
            interpret=True, emit_origin=False,
        )
        got = _port(k, p, v0, False)
        assert set(np.unique(got.origin.numpy())) <= {-1, -2}
        _assert_equal(got, want, f"batch {i}")


def test_same_batch_deletes_and_at_end_inserts():
    """Inserts at the end (onto the first FREE token), deletes of inserts
    of the same batch (TDEAD tokens of length zero), a delete past the end
    (a no-op) and PAD ops, on a 3-char document and an empty one."""
    ops = [
        (INSERT, 3), (INSERT, 0), (DELETE, 0), (INSERT, 4), (DELETE, 1),
        (INSERT, 1), (DELETE, 9), (PAD, 0), (INSERT, 5), (DELETE, 4),
        (INSERT, 0), (DELETE, 0), (DELETE, 0), (INSERT, 2),
    ]
    ops += [(PAD, 0)] * (16 - len(ops))
    kind = np.array([o[0] for o in ops], np.int32)
    pos = np.array([o[1] for o in ops], np.int32)
    v0 = np.array([3, 0], np.int32)
    got = _port(kind, pos, v0, True)
    _assert_equal(
        got, _scan(jnp.asarray(kind), jnp.asarray(pos), jnp.asarray(v0)),
        "scan",
    )
    want = resolve_batch_pallas(
        jnp.asarray(kind), jnp.asarray(pos), jnp.asarray(v0),
        interpret=True, emit_origin=False,
    )
    _assert_equal(_port(kind, pos, v0, False), want, "pallas")
    # op 2 deletes op 1's char: op 1 is dead, op 2 names it
    assert got.del_batch[0, 2] == 1 and not got.ins_alive[0, 1]
    assert got.ins_alive[0, 0] and got.del_rank[0, 2] == -1
    # the delete past the end touches nothing
    assert got.del_rank[:, 6].tolist() == [-1, -1]
    assert got.del_batch[:, 6].tolist() == [-1, -1]
    assert TDEAD == 3 and token_list_size(16) == 128


def test_wrapper_runs_plain_on_cpu_and_checks_operands():
    k = torch.tensor([INSERT, DELETE], dtype=torch.int32)
    p = torch.tensor([0, 0], dtype=torch.int32)
    v0 = torch.tensor([2, 5, 0], dtype=torch.int32)
    calls, launches = resolve_batch_plain.calls, resolve_batch.launches
    out = resolve_batch(k, p, v0)
    assert resolve_batch_plain.calls == calls + 1
    assert resolve_batch.launches == launches
    assert all(t.shape == (3, 2) for t in out)
    with pytest.raises(ValueError, match="int32"):
        resolve_batch(k.long(), p, v0)
    with pytest.raises(ValueError, match="v0"):
        resolve_batch(k, p, v0[:, None])
