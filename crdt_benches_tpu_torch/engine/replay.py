"""Capacity staging shared by the replay engines."""

from __future__ import annotations

import torch

from ..ops.apply2 import LANE, PackedState4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _stage_capacity(need: int, lane: int = 128) -> int:
    """Smallest staged capacity >= need from a sqrt(2)-spaced grid
    (lane * {8, 12, 16, 24, 32, ...}) — wasted capacity stays ~20% on
    average while the document grows."""
    s = 8 * lane
    while s < need:
        s2 = s + s // 2
        if s2 >= need:
            return s2
        s *= 2
    return s


def _grow_state4(state: PackedState4, new_cap: int) -> PackedState4:
    """Pad a PackedState4's capacity axis to new_cap (doc pads with
    pack_doc(-1, 0) == 2, the prefix structures with zeros)."""
    R, C = state.doc.shape
    if new_cap <= C:
        return state
    pad = new_cap - C
    doc = state.doc
    return PackedState4(
        doc=torch.cat([doc, doc.new_full((R, pad), 2)], dim=1),
        cv_intile=torch.cat(
            [state.cv_intile, state.cv_intile.new_zeros((R, pad))], dim=1
        ),
        vis_tile=torch.cat(
            [state.vis_tile, state.vis_tile.new_zeros((R, pad // LANE))],
            dim=1,
        ),
        length=state.length,
        nvis=state.nvis,
    )
