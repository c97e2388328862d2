"""Packed doc-order replay state and its glue (the state half of the JAX
package's ``ops/apply2.py``).

``doc = ((slot + 2) << 1) | vis`` carries the slot id (-1 for unused) and
the visibility bit of each document-order position in one int32.
``PackedState4`` adds the maintained visibility prefix structure that the
rank queries read: ``cv_intile`` (inclusive vis cumsum within each
128-position tile, held as int16 — values are at most 128) and
``vis_tile`` (each tile's total).  The fused range apply re-emits both
for the post-batch document every batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

LANE = 128
I32 = torch.int32


class PackedState(NamedTuple):
    doc: torch.Tensor  # int32[R, C]
    length: torch.Tensor  # int32[R]
    nvis: torch.Tensor  # int32[R]


class PackedState4(NamedTuple):
    doc: torch.Tensor  # int32[R, C] packed ((slot+2)<<1)|vis
    cv_intile: torch.Tensor  # int16[R, C]
    vis_tile: torch.Tensor  # int32[R, C // LANE]
    length: torch.Tensor  # int32[R]
    nvis: torch.Tensor  # int32[R]


def pack_doc(order, vis):
    return ((order + 2) << 1) | vis


def unpack_doc(doc):
    return (doc >> 1) - 2, doc & 1


def tile_cumsum(vis: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum of int32[R, C] within each 128-position
    tile (C a multiple of 128), shape int32[R, C // 128, 128]."""
    R, C = vis.shape
    return torch.cumsum(vis.view(R, C // LANE, LANE), dim=2, dtype=I32)


def init_state4(
    n_replicas: int, capacity: int, n_init: int = 0,
    device: str | torch.device = "cuda",
) -> PackedState4:
    """Fresh state: slots 0..n_init-1 visible in order, the rest unused.
    Every replica gets its own copy of the arrays."""
    dev = resolve_device(device)
    if capacity % LANE:
        raise ValueError(f"capacity {capacity} is not a multiple of {LANE}")
    idx = torch.arange(capacity, dtype=I32, device=dev)
    live = idx < n_init
    doc = pack_doc(torch.where(live, idx, -1), live.to(I32))
    cv = tile_cumsum(doc[None] & 1)[0]
    R = n_replicas
    return PackedState4(
        doc=doc.expand(R, capacity).contiguous(),
        cv_intile=cv.reshape(capacity).to(torch.int16)
        .expand(R, capacity).contiguous(),
        vis_tile=cv[:, LANE - 1].expand(R, capacity // LANE).contiguous(),
        length=torch.full((R,), n_init, dtype=I32, device=dev),
        nvis=torch.full((R,), n_init, dtype=I32, device=dev),
    )


def _excl_cumsum_small(x):
    """Exclusive int32 cumsum along axis 1 of a small (R, n) array."""
    return torch.cumsum(x, dim=1, dtype=I32) - x


def count_le_two_level(cv_intile, tile_base, tmax_abs, q):
    """#{i : cumvis_abs[r, i] <= q[r, b]} from the maintained two-level
    structure: cv_intile int16[R, C] (within-tile inclusive cumsum),
    tile_base int32[R, nt] (exclusive cross-tile prefix), tmax_abs
    int32[R, nt] (tile_base + tile total, nondecreasing), q int32[R, Q].
    Returns int32[R, Q]; a query at or past the total gives C.

    The crossing tile is a ``searchsorted`` over the tile maxima; within
    it a 7-step binary search over the tile's 128 nondecreasing values.
    Seven steps suffice: the crossing tile's maximum exceeds q, so at most
    127 of its positions count."""
    R, C = cv_intile.shape
    nt = C // LANE
    nfull = torch.searchsorted(tmax_abs, q.contiguous(), right=True)
    tq = nfull.clamp(max=nt - 1)
    base = tile_base.gather(1, tq)
    start = tq * LANE
    within = torch.zeros_like(tq)
    for s in (64, 32, 16, 8, 4, 2, 1):
        v = cv_intile.gather(1, start + within + (s - 1)).to(I32) + base
        within = within + torch.where(v <= q, s, 0)
    return torch.where(nfull >= nt, C, nfull * LANE + within).to(I32)


def decode_state3(state: PackedState, chars: torch.Tensor, replica: int = 0):
    """One replica's visible document as (codepoints int32[nvis], nvis).
    Off the hot path."""
    order, vis = unpack_doc(state.doc[replica])
    C = order.shape[0]
    valid = torch.arange(C, device=order.device) < state.length[replica]
    keep = (vis > 0) & valid
    codes = chars[order[keep].clamp(0, chars.shape[0] - 1).long()]
    return codes, int(keep.sum())
