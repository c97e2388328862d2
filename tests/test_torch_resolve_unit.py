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
    FREE,
    TDEAD,
    TINS,
    ResolvedBatch,
    resolve_batch,
    resolve_batch_plain,
    resolve_tokens_plain,
    token_list_size,
    unit_smem_bytes,
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


#: v0 per replica for the worst-case batches: an empty document, one that
#: the batch's deletes run past, and two longer than the batch
_WORST_V0 = np.array([0, 7, 300, 1000], np.int32)


def _worst_case(name: str):
    """(kind, pos, v0 int32[4]) of a worst-case batch at the unit path's
    width B = 256: every op moves the whole live list (inserts at 0), grows
    a run of zero-length tokens at the head and runs past the end (deletes
    at 0), lands on the FREE sentinel every other op (alternating ends), or
    a sveltecomponent batch (v0 its true length before the batch, and
    offsets from it as in :func:`_batches`)."""
    B = 256
    if name == "trace":
        from crdt_benches_tpu.traces import load_testing_data

        tt = tensorize(load_testing_data("sveltecomponent"), batch=B)
        kind_b, pos_b, _, _ = tt.batched()
        step = np.where(kind_b == INSERT, 1, np.where(kind_b == DELETE, -1, 0))
        before = len(tt.init_chars) + step[:40].sum()
        v0 = np.maximum(before + _OFFSETS, 0).astype(np.int32)
        return kind_b[40].astype(np.int32), pos_b[40].astype(np.int32), v0
    kind = np.full(B, DELETE if name == "del_at_0" else INSERT, np.int32)
    pos = np.zeros(B, np.int32)
    if name == "alternate":
        pos[1::2] = 10**6  # clamps to the end
    return kind, pos, _WORST_V0


_WORST = ("ins_at_0", "del_at_0", "alternate", "trace")


@pytest.mark.parametrize("name", _WORST)
def test_worst_case_batches_match_scan_resolver(name):
    kind, pos, v0 = _worst_case(name)
    want = _scan(jnp.asarray(kind), jnp.asarray(pos), jnp.asarray(v0))
    _assert_equal(_port(kind, pos, v0, True), want, name)
    got = _port(kind, pos, v0, False)
    np.testing.assert_array_equal(
        got.origin.numpy(), np.where(kind == INSERT, -1, -2)[None].repeat(4, 0)
    )


def _walks():
    """(label, kind, pos, v0) for the token-list invariants: synth batches
    at two widths and the worst cases."""
    for seed, B in ((0, 32), (5, 64)):
        for i, (k, p, v0) in enumerate(_batches(seed, B)):
            yield f"synth {seed} batch {i}", k, p, v0
    for name in _WORST:
        yield name, *_worst_case(name)


@pytest.mark.parametrize("emit_origin", [False, True])
def test_each_insert_owns_one_token_and_dead_iff_killed(emit_origin):
    for label, kind, pos, v0 in _walks():
        t = torch.as_tensor
        w = resolve_tokens_plain(t(kind), t(pos), t(v0),
                                 emit_origin=emit_origin)
        res = _port(kind, pos, v0, emit_origin)
        ttype = (w.tta & 3).numpy()
        ta = (w.tta >> 2).numpy()
        instok = (ttype == TINS) | (ttype == TDEAD)
        for r in range(len(v0)):
            owners = np.bincount(ta[r][instok[r]], minlength=len(kind))
            np.testing.assert_array_equal(
                owners, (kind == INSERT).astype(np.int64), err_msg=label)
            dead = np.zeros(len(kind), bool)
            dead[ta[r][ttype[r] == TDEAD]] = True
            np.testing.assert_array_equal(
                dead, (kind == INSERT) & ~res.ins_alive[r].numpy(),
                err_msg=label)


def test_live_list_bound_and_free_sentinel():
    for label, kind, pos, v0 in _walks():
        t = torch.as_tensor
        B = len(kind)
        w = resolve_tokens_plain(t(kind), t(pos), t(v0))
        res = _port(kind, pos, v0, True)
        ttype = (w.tta & 3).numpy()
        cum = w.cum.numpy()
        killed = ((res.del_rank >= 0) | (res.del_batch >= 0)).sum(1).numpy()
        total = v0 + (kind == INSERT).sum() - killed
        for r in range(len(v0)):
            n = int((ttype[r] != FREE).sum())
            assert n <= 2 * B + 1, label
            # the live tokens come first; the sentinel and all past it are
            # FREE with cum at the visible total
            assert (ttype[r, :n] != FREE).all(), label
            assert (ttype[r, n:] == FREE).all() and (w.tta[r, n:] == 0).all()
            assert (cum[r, n - 1:] == total[r]).all(), label
            # every op's token lies in [0, nused]; PAD ops have none
            nu, tt = w.nused[r].numpy(), w.t[r].numpy()
            assert (np.diff(nu) >= 0).all() and nu[0] == 1, label
            acts = (kind == INSERT) | (kind == DELETE)
            assert ((tt >= 0) & (tt <= nu))[acts].all(), label
            assert (tt[~acts] == -1).all(), label


def test_kernel_shared_memory_range():
    """The wrapper's range check follows the kernel's layout: 4 warps, each
    with two lists of T + 1 ints, and kind/pos staged once per block."""
    assert unit_smem_bytes(256) == (4 * 2 * 641 + 512) * 4 == 22560
    assert unit_smem_bytes(1) == (4 * 2 * 129 + 2) * 4
    # the largest batch that fits Hopper's 227 KB of shared memory per block
    fits = [B for B in range(1, 4096) if unit_smem_bytes(B) <= 232448]
    assert fits == list(range(1, 3200))
