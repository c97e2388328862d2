"""The port's fused range apply (K2/K3, plain PyTorch version on the CPU),
its producer and its rank queries, held against the JAX reference with
exact equality (tolerance 0: every value is an integer; ``cv_intile`` —
bf16 in JAX, int16 in the port — is compared by value)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.engine.replay_range import replay_ranges as jax_replay
from crdt_benches_tpu.ops.apply2 import count_le_two_level as jax_count_le
from crdt_benches_tpu.ops.apply2 import init_state4 as jax_init_state4
from crdt_benches_tpu.ops.apply_range_fused import (
    apply_range_batch4 as jax_apply4,
)
from crdt_benches_tpu.ops.apply_range_fused import (
    range_fused,
    range_fused_blocked,
    range_fused_xla,
)
from crdt_benches_tpu.ops.resolve_range_scan import resolve_ranges_shared
from crdt_benches_tpu.traces.synth import synth_trace
from crdt_benches_tpu_torch.engine.replay import _grow_state4
from crdt_benches_tpu_torch.ops.apply2 import (
    _excl_cumsum_small,
    count_le_two_level,
    init_state4,
)
from crdt_benches_tpu_torch.ops.apply_range_fused import (
    _del_stop_shift,
    apply_range_batch4,
    range_apply,
    range_apply_operands,
    range_apply_plain,
)
from crdt_benches_tpu_torch.ops.resolve_range import resolve_range
from crdt_benches_tpu_torch.traces.tensorize import tensorize_ranges
from crdt_benches_tpu_torch.utils.convert import (
    state4_from_jax,
    state4_to_numpy,
)

R = 2


def _trace(seed):
    return tensorize_ranges(
        synth_trace(seed=seed, n_ops=420, base="fused apply parity "),
        batch=32,
    )


def _port_walk(rt, capacity):
    """Yield (state, tokens, dints) before each batch of a port replay on
    the CPU at ``capacity``."""
    st = init_state4(R, capacity, len(rt.init_chars), device="cpu")
    t = lambda a: torch.as_tensor(a)
    for kind, pos, rlen, slot0 in zip(*rt.batched()):
        tokens, dints, _ = resolve_range(
            t(kind), t(pos), t(rlen), t(slot0), st.nvis
        )
        yield st, tokens, dints
        st = apply_range_batch4(st, tokens, dints)


def _assert_apply_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            np.asarray(g).astype(np.int64),
            np.asarray(w).astype(np.float32).astype(np.int64),
        )


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_plain_matches_range_fused(seed):
    """Every batch of a synthetic replay: the producer's real operands
    through the port's plain version, JAX's fused kernel (interpret mode)
    and JAX's XLA twin."""
    rt = _trace(seed)
    nbits = max(1, rt.max_batch_ins.bit_length())
    for st, tokens, dints in _port_walk(rt, 1024):
        delpk, ind_d, dd, new_len, _, dsh = range_apply_operands(
            st, tokens, dints
        )
        ops = (st.doc, delpk, ind_d, dd, new_len)
        got = range_apply_plain(*ops, dsh)
        jops = [jnp.asarray(x.numpy()) for x in ops]
        _assert_apply_equal(got, range_fused_xla(*jops, nbits=nbits, dsh=dsh))
        _assert_apply_equal(got, range_fused(
            *jops, nbits=nbits, dsh=dsh, interpret=True
        ))


def _random_operands(seed, C=4096, L=3000):
    """Operands with the producer's invariants — disjoint delete
    intervals (some sharing a boundary cell), disjoint increasing insert
    runs, consistent slot deltas — denser than a synthetic replay's."""
    rng = np.random.default_rng(seed)
    doc = np.full((R, C), 2, np.int32)
    delpk = np.zeros((R, C), np.int32)
    ind_d = np.zeros((R, C), np.int32)
    dd = np.zeros((R, C), np.int32)
    new_len = np.full(R, L, np.int32)
    for r in range(R):
        vis = rng.random(L) < 0.8
        doc[r, :L] = ((np.arange(L) + 2) << 1) | vis.astype(np.int32)
        cuts = np.sort(rng.choice(L, 12, replace=False))
        for i in range(0, 12, 2):
            delpk[r, cuts[i]] += 1
            delpk[r, cuts[i + 1] + 1] += 1 << 14
        total, prev = 0, 0
        for d0 in np.sort(rng.choice(np.arange(40, L - 40, 29), 9,
                                     replace=False)):
            ln = int(rng.integers(1, 12))
            dest = d0 + total
            ind_d[r, dest] += 1
            ind_d[r, dest + ln] -= 1
            delta = (3200 + total) - dest
            dd[r, dest] = delta - prev
            prev = delta
            total += ln
        new_len[r] = L + total
    return doc, delpk, ind_d, dd, new_len


@pytest.mark.parametrize("source", ["replay", "random"])
def test_plain_matches_range_fused_blocked(source):
    """The long-document contract (JAX's halo-blocked kernel, block of 8
    tiles) at a capacity spanning four blocks."""
    if source == "replay":
        rt = _trace(1)
        nbits = max(1, rt.max_batch_ins.bit_length())
        walk = list(_port_walk(rt, 1024))
        st, tokens, dints = walk[len(walk) // 2]
        st = _grow_state4(st, 4096)
        delpk, ind_d, dd, new_len, _, dsh = range_apply_operands(
            st, tokens, dints
        )
        ops = [x.numpy() for x in (st.doc, delpk, ind_d, dd, new_len)]
    else:
        # nbits bounds the reference cascade's shift: 2^8 > 9 runs x 11 chars
        ops, nbits, dsh = list(_random_operands(5)), 8, 14
    got = range_apply_plain(*[torch.as_tensor(x) for x in ops], dsh)
    want = range_fused_blocked(
        *[jnp.asarray(x) for x in ops], nbits=nbits, dsh=dsh,
        block_tiles=8, interpret=True,
    )
    assert ops[0].shape[1] == 4096
    _assert_apply_equal(got, want)
    _assert_apply_equal(
        got, range_fused_xla(*[jnp.asarray(x) for x in ops], nbits=nbits,
                             dsh=dsh)
    )


def _jax_state_after(rt, n_batches, capacity):
    kind_b, pos_b, rlen_b, slot0_b = (jnp.asarray(a) for a in rt.batched())
    st = jax_init_state4(R, capacity, len(rt.init_chars))
    if n_batches:
        st, _ = jax_replay(
            st, kind_b[:n_batches], pos_b[:n_batches], rlen_b[:n_batches],
            slot0_b[:n_batches], nbits=max(1, rt.max_batch_ins.bit_length()),
            pack=1, interpret=True, engine="v4",
        )
    return st, (kind_b, pos_b, rlen_b, slot0_b)


def _np_state(st):
    return {
        "doc": np.asarray(st.doc),
        "cv_intile": np.asarray(st.cv_intile.astype(jnp.int32)),
        "vis_tile": np.asarray(st.vis_tile),
        "length": np.asarray(st.length),
        "nvis": np.asarray(st.nvis),
    }


@pytest.mark.parametrize("seed,at", [(0, 2), (3, 5), (1, 9)])
def test_apply_range_batch4_matches_jax(seed, at):
    """The port's producer + fused apply against JAX's apply_range_batch4
    from the SAME state (carried across by state4_from_jax) and the same
    resolved tokens, field by field."""
    rt = _trace(seed)
    jst, (kb, pb, lb, sb) = _jax_state_after(rt, at, 2048)
    tokens, dints, _ = resolve_ranges_shared(
        kb[at], pb[at], lb[at], sb[at], jst.nvis
    )
    want = jax_apply4(
        jst, tokens, dints, nbits=max(1, rt.max_batch_ins.bit_length()),
        interpret=True,
    )
    pst = state4_from_jax(_np_state(jst), device="cpu")
    t = lambda x: torch.as_tensor(np.array(x))
    got = apply_range_batch4(
        pst, tuple(t(x) for x in tokens), tuple(t(x) for x in dints)
    )
    got_np, want_np = state4_to_numpy(got), _np_state(want)
    for f in ("doc", "cv_intile", "vis_tile", "length", "nvis"):
        np.testing.assert_array_equal(got_np[f], want_np[f], err_msg=f)


def test_count_le_two_level_matches_jax():
    """Rank -> physical position on a mid-replay state, for every rank
    from 0 to past the visible total (queries at and past the total map to
    the capacity C)."""
    rt = _trace(3)
    jst, _ = _jax_state_after(rt, 6, 2048)
    pst = state4_from_jax(_np_state(jst), device="cpu")
    total = int(np.asarray(jst.nvis).max())
    q = np.tile(np.arange(total + 4, dtype=np.int32), (R, 1))
    tile_base = _excl_cumsum_small(pst.vis_tile)
    got = count_le_two_level(
        pst.cv_intile, tile_base, tile_base + pst.vis_tile,
        torch.as_tensor(q),
    ).numpy()
    jb = np.asarray(_excl_cumsum_small(pst.vis_tile))
    want = np.asarray(jax_count_le(
        jst.cv_intile, jnp.asarray(jb), jnp.asarray(jb) + jst.vis_tile,
        jnp.asarray(q),
    ))
    np.testing.assert_array_equal(got, want)
    assert (got[:, -4:] == 2048).all()


def test_del_stop_shift_matches_reference_packing():
    from crdt_benches_tpu.ops.apply_range_fused import (
        _del_stop_shift as jax_dsh,
    )

    for B in (1, 32, 1024, 1025, 1536, 4095):
        assert _del_stop_shift(B) == jax_dsh(B)


def test_range_apply_wrapper_checks_inputs():
    doc = torch.full((2, 256), 2, dtype=torch.int32)
    z = torch.zeros_like(doc)
    nl = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        range_apply(doc[:, :200], z[:, :200], z[:, :200], z[:, :200], nl, 14)
    with pytest.raises(ValueError, match="int32"):
        range_apply(doc, z.long(), z, z, nl, 14)
    with pytest.raises(ValueError, match="contiguous"):
        range_apply(doc, z.t().contiguous().t(), z, z, nl, 14)
    out, cv, vt = range_apply(doc, z, z, z, nl, 14)
    assert out.dtype == torch.int32 and cv.dtype == torch.int16
    assert vt.shape == (2, 2) and (out == 2).all() and (vt == 0).all()
