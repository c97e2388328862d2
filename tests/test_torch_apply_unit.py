"""The port's unit-op applies on the CPU — the fused apply K6, the
expansions K8 and K9 (plain PyTorch versions), the rank queries and
``apply_batch2``/``3``/``4`` — held against the JAX package with exact
equality (tolerance 0: every value is an integer; ``cv_intile``, bf16 in
JAX and int16 in the port, is compared by value).  JAX's roll-cascade
expansions are exact only while 2^nbits exceeds the largest shift, so
they are given ``nbits`` with 2^nbits above the largest shift."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops import apply2 as japply2
from crdt_benches_tpu.ops.apply_range_fused import (
    apply_fused2 as jax_apply_fused2,
)
from crdt_benches_tpu.ops.expand_pallas import (
    apply_fused_xla,
)
from crdt_benches_tpu.ops.expand_pallas import (
    expand_fill_zero as jax_expand_fill_zero,
)
from crdt_benches_tpu.ops.expand_pallas import (
    expand_packed as jax_expand_packed,
)
from crdt_benches_tpu.ops.resolve import resolve_batch as jax_resolve
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu.traces.tensorize import tensorize
from crdt_benches_tpu_torch.ops import apply2
from crdt_benches_tpu_torch.ops.apply_range_fused import (
    apply_fused2,
    apply_fused2_plain,
)
from crdt_benches_tpu_torch.ops.expand import (
    expand_fill_zero,
    expand_fill_zero_plain,
    expand_packed,
    expand_packed_plain,
)
from crdt_benches_tpu_torch.utils import convert


def _nbits(ind) -> int:
    """Smallest nbits with 2^nbits above every row's destination count."""
    return int(ind.sum(1).max()).bit_length()


def _operands(seed: int, R: int = 2, C: int = 1024, holes: int = 40):
    """Consistent fused-apply operands as numpy: doc_predel, combo (fill
    << 1 | 1 at distinct destinations), new_len, and the destination
    indicator."""
    rng = np.random.default_rng(seed)
    doc = rng.integers(0, 1 << 20, size=(R, C)).astype(np.int32)
    ind = np.zeros((R, C), np.int32)
    for r in range(R):
        ind[r, rng.choice(C, size=holes, replace=False)] = 1
    fill = rng.integers(0, 1 << 22, size=(R, C)).astype(np.int32)
    combo = np.where(ind != 0, (fill << 1) | 1, 0).astype(np.int32)
    new_len = rng.integers(C // 2, C + 1, size=R).astype(np.int32)
    return doc, combo, new_len, ind


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("emit_cv", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_fused2_plain_matches_jax_kernel_and_xla(seed, emit_cv):
    doc, combo, new_len, ind = _operands(seed)
    R, C = doc.shape
    # consistent cnt_base: exclusive cross-tile prefix of combo & 1
    tc = ind.reshape(R, C // 128, 128).sum(2)
    cnt_base = (np.cumsum(tc, 1) - tc).astype(np.int32)
    j = [jnp.asarray(a) for a in (doc, combo, cnt_base, new_len)]
    nb = _nbits(ind)
    kern = jax_apply_fused2(*j, nbits=nb, interpret=True, emit_cv=emit_cv)
    xla = apply_fused_xla(*j, nbits=nb)
    got = apply_fused2_plain(*_t(doc, combo, new_len), emit_cv=emit_cv)
    if not emit_cv:
        np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
        np.testing.assert_array_equal(got.numpy(), np.asarray(xla[0]))
        return
    assert got[1].dtype == torch.int16
    for want in (kern, xla):
        for g, w, name in zip(got, want, ("doc", "cv_intile", "vis_tile")):
            np.testing.assert_array_equal(
                g.numpy().astype(np.int32),
                np.asarray(w.astype(jnp.int32)), err_msg=name,
            )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expansions_plain_match_jax_kernels_and_expand(seed):
    doc, _, _, ind = _operands(seed, C=768, holes=60)
    rng = np.random.default_rng(seed + 10)
    vis = rng.integers(0, 2, size=doc.shape).astype(np.int32)
    cnt = np.cumsum(ind, 1).astype(np.int32)
    cntind = (cnt << 1) | ind
    hole = ind != 0
    nb = _nbits(ind)
    (ref,) = japply2._expand([jnp.asarray(doc)], jnp.asarray(cnt), nb)
    ref = np.where(hole, 0, np.asarray(ref))
    kern = jax_expand_packed(jnp.asarray(doc), jnp.asarray(cntind),
                             nbits=nb, interpret=True)
    got = expand_packed_plain(*_t(doc, cntind)).numpy()
    np.testing.assert_array_equal(got, np.asarray(kern))
    np.testing.assert_array_equal(got, ref)

    ko, kv = jax_expand_fill_zero(
        *(jnp.asarray(a) for a in (doc, vis, cnt, ind)), nbits=nb,
        interpret=True,
    )
    go, gv = expand_fill_zero_plain(*_t(doc, vis, cnt, ind))
    np.testing.assert_array_equal(go.numpy(), np.asarray(ko))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(kv))
    np.testing.assert_array_equal(go.numpy(), ref)
    # the port's own gather
    (pe,) = apply2._expand(_t(doc), torch.as_tensor(cnt))
    np.testing.assert_array_equal(np.where(hole, 0, pe.numpy()), ref)


def test_wrappers_run_plain_on_cpu_and_check_operands():
    doc, combo, new_len, ind = _operands(5, C=256, holes=9)
    cnt = np.cumsum(ind, 1).astype(np.int32)
    before = (apply_fused2_plain.calls, expand_packed_plain.calls,
              expand_fill_zero_plain.calls, apply_fused2.launches,
              expand_packed.launches, expand_fill_zero.launches)
    apply_fused2(*_t(doc, combo, new_len))
    expand_packed(*_t(doc, (cnt << 1) | ind))
    expand_fill_zero(*_t(doc, doc, cnt, ind))
    after = (apply_fused2_plain.calls, expand_packed_plain.calls,
             expand_fill_zero_plain.calls, apply_fused2.launches,
             expand_packed.launches, expand_fill_zero.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 0, 0, 0]
    with pytest.raises(ValueError, match="int32"):
        expand_packed(*_t(doc, cnt.astype(np.int64)))
    with pytest.raises(ValueError, match="multiple of 128"):
        apply_fused2(*_t(doc[:, :200], combo[:, :200], new_len))
    with pytest.raises(ValueError, match="new_len"):
        apply_fused2(*_t(doc, combo, new_len[:1]))


@pytest.mark.parametrize("C", [1024, 128 * 300])
def test_count_le_tiled_matches_jax(C):
    """Single-level (nt <= 256) and two-level (nt > 256) JAX paths; queries
    below, inside, at and past each row's total."""
    rng = np.random.default_rng(C)
    R = 3
    vis = (rng.random((R, C)) < 0.6).astype(np.int32)
    cum = np.cumsum(vis, 1).astype(np.int32)
    tot = cum[:, -1:]
    q = np.concatenate([
        rng.integers(0, tot.max(), size=(R, 40)), tot - 1, tot, tot + 5,
        np.zeros((R, 1)), np.full((R, 1), -1),
    ], 1).astype(np.int32)
    want = np.asarray(japply2.count_le_tiled(jnp.asarray(cum), jnp.asarray(q)))
    got = apply2.count_le_tiled(*_t(cum, q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, 41:43].numpy(), np.full((R, 2), C))
    np.testing.assert_array_equal(
        apply2.rank_to_phys2(*_t(cum, q)).numpy(), want
    )


_jax_scan = jax.jit(jax.vmap(jax_resolve, in_axes=(None, None, 0)))
_JAX_APPLY = {
    "v2": jax.jit(japply2.apply_batch2),
    "v3": jax.jit(japply2.apply_batch3),
    "v4": jax.jit(japply2.apply_batch4),
}
_JAX_INIT = {"v2": japply2.init_state2, "v3": japply2.init_state3,
             "v4": japply2.init_state4}
_PORT = {
    "v2": (apply2.apply_batch2, convert.state2_from_jax,
           convert.state2_to_numpy),
    "v3": (apply2.apply_batch3, convert.state3_from_jax,
           convert.state3_to_numpy),
    "v4": (apply2.apply_batch4, convert.state4_from_jax,
           convert.state4_to_numpy),
}


def _np_state(st) -> dict[str, np.ndarray]:
    return {
        f: np.asarray(getattr(st, f).astype(jnp.int32)) for f in st._fields
    }


@pytest.mark.parametrize("engine", ["v2", "v3", "v4"])
@pytest.mark.parametrize("B,n_ops", [(32, 150), (1100, 2300)])
def test_apply_batches_match_jax_from_the_same_state(engine, B, n_ops):
    """Each batch starts both sides from the JAX state and the JAX
    ResolvedBatch, carried across by utils/convert.py.  B = 1100 takes the
    JAX apply's double-argsort destination path, B = 32 its compare
    path; the port has one path for both."""
    trace = synth_trace(seed=B, n_ops=n_ops, base="apply parity start ")
    tt = tensorize(trace, batch=B)
    R = 2
    C = -(-tt.capacity // 128) * 128 + 128
    port_apply, from_jax, to_numpy = _PORT[engine]
    jst = _JAX_INIT[engine](R, C, len(tt.init_chars))
    for i, (k, p, _, s) in enumerate(zip(*tt.batched())):
        res = _jax_scan(jnp.asarray(k), jnp.asarray(p), jst.nvis)
        pres = convert.resolved_from_jax(
            {f: np.asarray(getattr(res, f)) for f in res._fields},
            device="cpu",
        )
        pst = from_jax(_np_state(jst), device="cpu")
        got = to_numpy(port_apply(pst, pres, torch.as_tensor(s)))
        jst = _JAX_APPLY[engine](jst, res, jnp.asarray(s))
        for f, w in _np_state(jst).items():
            np.testing.assert_array_equal(
                got[f].astype(np.int32), w, err_msg=f"batch {i} {f}"
            )
