"""The port's document digests (``utils/digest.py``) on the CPU, held
against the JAX package's with exact equality: on random slot-indexed and
packed states, on sums that wrap int32, and across row chunks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crdt_benches_tpu.utils import digest as jd
from crdt_benches_tpu_torch.utils import digest as pd


def _state(seed, R, C, p_vis=0.8, max_ch=0x10FFFF):
    rng = np.random.default_rng(seed)
    order = np.stack([rng.permutation(C).astype(np.int32)
                      for _ in range(R)])
    visible = rng.random((R, C)) < p_vis
    length = rng.integers(0, C + 1, R).astype(np.int32)
    length[0] = C
    chars = rng.integers(0, max_ch, C).astype(np.int32)
    return order, visible, length, chars


def _jax_digest(order, visible, length, chars):
    return np.asarray(jax.vmap(jd.doc_digest, in_axes=(0, 0, 0, None))(
        jnp.asarray(order), jnp.asarray(visible), jnp.asarray(length),
        jnp.asarray(chars)))


def _jax_digest_packed(doc, length, chars):
    return np.asarray(jax.vmap(jd.doc_digest_packed, in_axes=(0, 0, None))(
        jnp.asarray(doc), jnp.asarray(length), jnp.asarray(chars)))


@pytest.mark.parametrize("seed,R,C", [(0, 3, 256), (1, 2, 1000),
                                      (2, 4, 3000)])
def test_digest_matches_jax(seed, R, C):
    order, visible, length, chars = _state(seed, R, C, max_ch=128)
    got = pd.doc_digest(*(torch.as_tensor(a) for a in (order, visible,
                                                       length, chars)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_digest(order, visible, length, chars))


@pytest.mark.parametrize("seed,R,C", [(3, 3, 512), (4, 2, 2000)])
def test_digest_packed_matches_jax_and_the_slot_form(seed, R, C):
    """The packed doc in document order: slot order[r, i] at position i
    with the slot's visibility bit; the same value as the slot form."""
    order, visible, length, chars = _state(seed, R, C)
    vis_at = np.take_along_axis(visible, order, axis=1).astype(np.int32)
    doc = ((order + 2) << 1) | vis_at
    got = pd.doc_digest_packed(torch.as_tensor(doc), torch.as_tensor(length),
                               torch.as_tensor(chars)).numpy()
    np.testing.assert_array_equal(got, _jax_digest_packed(doc, length, chars))
    np.testing.assert_array_equal(
        got, pd.doc_digest(*(torch.as_tensor(a) for a in (order, visible,
                                                          length, chars))))


def test_digest_wraps_int32_like_jax():
    """Ranks past 46,341 and codepoints near 2^20: rank x rank and
    rank x (ch x MIX + 1) overflow int32, and so do the sums."""
    order, visible, length, chars = _state(5, 2, 70_000, p_vis=0.95)
    rank = np.cumsum(visible[0][order[0]])
    assert int(rank[-1]) ** 2 > 2**31
    got = pd.doc_digest(*(torch.as_tensor(a) for a in (order, visible,
                                                       length, chars)))
    want = _jax_digest(order, visible, length, chars)
    np.testing.assert_array_equal(got.numpy(), want)
    # the exact sums leave int32: the digest is their wrapped value
    r64 = rank.astype(np.int64)
    vis = visible[0][order[0]]
    ch = chars[order[0]].astype(np.int64)
    mixed = (ch * -1640531527 + 1 + 2**31) % 2**32 - 2**31
    exact = int((r64 * mixed)[vis].sum())
    assert not -2**31 <= exact < 2**31
    assert (exact + 2**31) % 2**32 - 2**31 == int(want[0, 0])


def test_digest_row_chunks_give_the_same_value(monkeypatch):
    order, visible, length, chars = _state(6, 5, 700)
    args = [torch.as_tensor(a) for a in (order, visible, length, chars)]
    whole = pd.doc_digest(*args)
    vis_at = np.take_along_axis(visible, order, axis=1).astype(np.int32)
    doc = torch.as_tensor(((order + 2) << 1) | vis_at)
    whole_packed = pd.doc_digest_packed(doc, args[2], args[3])
    monkeypatch.setattr(pd, "_rows", lambda C: 2)
    assert torch.equal(pd.doc_digest(*args), whole)
    assert torch.equal(pd.doc_digest_packed(doc, args[2], args[3]),
                       whole_packed)
