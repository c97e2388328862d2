"""The v3 range apply on a ``PackedState`` (the JAX package's
``ops/apply_range.py``) and the token-axis helpers that it and the fused v4
producer use.

Deletes arrive as per-op PRE-BATCH RANK intervals [lo, hi]: visible
chars with ranks in the interval are exactly the delete's targets (ranks
inside it that are not covered were tombstoned earlier in the same batch
and are already invisible), so the apply clears the whole physical
interval.
"""

from __future__ import annotations

import torch

from ..lint.boundary import boundary
from .resolve import RUN, TINS

_BIG = 1 << 30
I32 = torch.int32


def extract_range_tokens(ttype, ta, tch, tlen, v0):
    """Per-token placement info from the final token list (all int32[R, T]):
    live mask (surviving insert runs), gap rank ``gvis`` (rank of the
    first surviving pre-batch char to the token's right, v0 = document
    tail), and ``cumlen`` (exclusive prefix sum of live lengths = chars
    inserted before this token, since token order is document order)."""
    R, T = ttype.shape
    live = (ttype == TINS) & (tlen > 0)
    run_start = torch.where((ttype == RUN) & (tlen > 0), ta, _BIG)
    suff = torch.cummin(run_start.flip(1), dim=1).values.flip(1)
    nxt = torch.cat(
        [suff[:, 1:], torch.full_like(suff[:, :1], _BIG)], dim=1
    )
    gvis = torch.where(nxt >= _BIG, v0[:, None], nxt)
    llen = torch.where(live, tlen, 0)
    cumlen = torch.cumsum(llen, dim=1, dtype=I32) - llen
    return live, gvis, cumlen


def _prev_value(x, mask):
    """Per row: at each masked position, the previous masked position's
    value (0 if none); 0 at unmasked positions."""
    R, T = x.shape
    idx = torch.arange(T, device=x.device).expand(R, T)
    last = torch.where(mask, idx, -1).cummax(dim=1).values
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
    val = x.gather(1, prev.clamp(min=0))
    return torch.where(mask & (prev >= 0), val, 0)


@boundary(dtypes=("int32", "int32", "int32"))
def apply_range_batch(state, tokens, dints):
    """One batch's range apply on a ``PackedState`` (engine v3): tokens
    (ttype, ta, tch, tlen) int32[R, T] and dints (dlo, dhi, dcount)
    int32[R, B] from the batch's resolve against ``state.nvis``.  This is
    one round of the serving fleet's macro apply: on a CUDA tensor it
    launches K4 at K = 1 (``serve_macro_fused``, which counts the launch);
    on a CPU tensor it runs the plain round, ``serve_apply_round_plain``.
    Returns the new state."""
    from .serve_fused import serve_macro_fused  # serve_fused imports this

    def one(xs):
        return tuple(x.unsqueeze(0).contiguous() for x in xs)

    return serve_macro_fused(state, one(tokens), one(dints))
