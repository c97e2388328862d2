"""Patch-level array layout (one record per trace patch) for the native
C++ baseline, which replays patches in the reference's granularity."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .loader import TestData


@dataclass
class PatchArrays:
    pos: np.ndarray  # int32[n]
    del_count: np.ndarray  # int32[n]
    ins_off: np.ndarray  # int32[n+1]  insert text of patch i = flat[off[i]:off[i+1]]
    ins_flat: np.ndarray  # int32[total_ins_chars] codepoints
    init: np.ndarray  # int32[len(start_content)]
    n_patches: int
    end_len: int


def patch_arrays(trace: TestData, patches=None) -> PatchArrays:
    """``patches``: optional replacement (pos, del, ins) stream, e.g. the
    RLE-coalesced stream the range engine replays."""
    pos, dels, lens, flat = [], [], [0], []
    for p, d, ins in (
        patches if patches is not None else trace.iter_patches()
    ):
        pos.append(p)
        dels.append(d)
        lens.append(lens[-1] + len(ins))
        flat.extend(ord(c) for c in ins)
    return PatchArrays(
        pos=np.asarray(pos, np.int32),
        del_count=np.asarray(dels, np.int32),
        ins_off=np.asarray(lens, np.int32),
        ins_flat=np.asarray(flat, np.int32),
        init=np.asarray([ord(c) for c in trace.start_content], np.int32),
        n_patches=len(pos),
        end_len=len(trace.end_content),
    )
