"""K7, the blocked no-cv fused apply (``ops/expand.py``
``apply_fused_blocked``), on the CPU: its plain version against the JAX
package's Pallas kernel in interpret mode and its XLA twin
``apply_fused_nocv_xla`` with exact equality — clusters of inserts at a
block boundary, an odd tile count (nt = 131), block_tiles 8 and 16 — and
the dispatch, the cnt_base helper and K6 without cv on the same operands.
Hand-made inputs give the JAX side an ``nbits`` whose 2^nbits exceeds the
batch's largest shift (its roll cascade is exact only then); the port's
gather takes none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.ops.apply2 import spread_fill_combo as jax_spread_combo
from crdt_benches_tpu.ops.expand_pallas import (
    apply_fused_blocked as jax_blocked,
)
from crdt_benches_tpu.ops.expand_pallas import apply_fused_nocv_xla
from crdt_benches_tpu_torch.ops import expand
from crdt_benches_tpu_torch.ops.apply2 import (
    insert_tile_base,
    spread_fill_combo,
)
from crdt_benches_tpu_torch.ops.apply_range_fused import apply_fused2

LANE = 128


def _with_base(rng, doc, combo, R, C):
    nt = C // LANE
    ind = (combo & 1).reshape(R, nt, LANE).sum(axis=2)
    cnt_base = np.zeros((R, nt), np.int32)
    cnt_base[:, 1:] = np.cumsum(ind, axis=1)[:, :-1]
    new_len = rng.integers(C // 2, C, R).astype(np.int32)
    return doc, combo, cnt_base, new_len


def _random(rng, R, C, n_ins):
    doc = rng.integers(2, 2000, (R, C)).astype(np.int32)
    combo = np.zeros((R, C), np.int32)
    for r in range(R):
        dest = rng.choice(C - 1, size=n_ins, replace=False)
        combo[r, dest] = (rng.integers(1, 1 << 22, n_ins).astype(np.int32)
                          << 1) | 1
    return _with_base(rng, doc, combo, R, C)


def _boundary_cluster(rng, R, C, d0, n):
    """n consecutive insert destinations from d0 (across a block edge)."""
    doc = rng.integers(2, 999, (R, C)).astype(np.int32)
    combo = np.zeros((R, C), np.int32)
    combo[:, d0:d0 + n] = (rng.integers(1, 1 << 20, (R, n)).astype(np.int32)
                           << 1) | 1
    return _with_base(rng, doc, combo, R, C)


def _check(ops, nbits, block_tiles):
    jops = [jnp.asarray(a) for a in ops]
    want = np.asarray(apply_fused_nocv_xla(*jops, nbits=nbits))
    np.testing.assert_array_equal(
        np.asarray(jax_blocked(*jops, nbits=nbits, block_tiles=block_tiles,
                               interpret=True)), want)
    pops = [torch.as_tensor(a) for a in ops]
    before = expand.apply_fused_blocked_plain.calls
    got = expand.apply_fused_blocked(*pops)
    assert expand.apply_fused_blocked_plain.calls == before + 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        expand.apply_fused_blocked(*pops).numpy(), want)
    # K6 without cv recomputes the tile base from combo: equal on
    # consistent operands
    np.testing.assert_array_equal(
        apply_fused2(pops[0], pops[1], pops[3], emit_cv=False).numpy(), want)


@pytest.mark.parametrize("block_tiles", [8, 16])
@pytest.mark.parametrize("seed", [0, 2])
def test_blocked_matches_jax(seed, block_tiles):
    rng = np.random.default_rng(seed)
    # R = 2, C = 4096 (nt = 32, several blocks); 60 inserts, max shift 60
    _check(_random(rng, 2, 4096, 60), nbits=6, block_tiles=block_tiles)


def test_blocked_cluster_at_a_block_boundary():
    rng = np.random.default_rng(7)
    # 100 consecutive destinations just before block 1 (block_tiles 8)
    ops = _boundary_cluster(rng, 1, 4096, 8 * LANE - 60, 100)
    ops[3][:] = 4096
    _check(ops, nbits=7, block_tiles=8)


def test_blocked_odd_tile_count():
    rng = np.random.default_rng(17)
    _check(_random(rng, 1, 131 * LANE, 40), nbits=6, block_tiles=16)


def test_cnt_base_and_combo_match_jax_spread():
    rng = np.random.default_rng(3)
    R, B, C = 3, 40, 1024
    dest = np.stack([np.sort(rng.choice(C, B, replace=False))
                     for _ in range(R)]).astype(np.int32)
    dest[:, -5:] = C + 7  # out of range: dropped
    fill = np.where(dest < C, rng.integers(1, 1 << 20, (R, B)), 0).astype(
        np.int32)
    jcombo, jbase = jax_spread_combo(jnp.asarray(dest), jnp.asarray(fill), C)
    d, f = torch.as_tensor(dest), torch.as_tensor(fill)
    np.testing.assert_array_equal(spread_fill_combo(d, f, C).numpy(),
                                  np.asarray(jcombo))
    np.testing.assert_array_equal(insert_tile_base(d, C).numpy(),
                                  np.asarray(jbase))


def test_blocked_rejects_bad_operands():
    doc = torch.zeros((2, 256), dtype=torch.int32)
    base = torch.zeros((2, 2), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cnt_base"):
        expand.apply_fused_blocked(doc, doc, base[:, :1].contiguous(), n)
    with pytest.raises(ValueError, match="multiple of 128"):
        expand.apply_fused_blocked(doc[:, :200].contiguous(),
                                   doc[:, :200].contiguous(), base, n)
    with pytest.raises(ValueError, match="new_len"):
        expand.apply_fused_blocked(doc, doc, base, n.long())
