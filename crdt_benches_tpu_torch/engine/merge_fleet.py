"""Batched downstream merge for the document fleet: remote-apply rows (the
JAX package's ``engine/merge_fleet.py``).

One round of per-row RANGE ops — each row a different document, resolved
against its own running visible count, then applied to the packed row
states — is the fleet's downstream-merge primitive and the body of the
``scan`` serve kernel (``serve/pool.py DocPool(serve_kernel="scan")``),
whose ``fused`` twin resolves all K rounds first and applies them in one
launch.  The two are byte-identical.

- :func:`merge_rows_body`: one round over R rows, K1's per-row form at
  K = 1 (``ops/resolve_range.py resolve_range_rows``), then the v3 range
  apply (``ops/apply_range.py apply_range_batch``: K4 at K = 1).  On a
  CUDA tensor both kernels launch (or raise); on the CPU their plain
  versions run.
- :func:`merge_rows_round` / :func:`merge_rows_macro`: the checked entry
  points, one round (R, B) or K rounds (K, R, B) in turn.

JAX resolves with ``resolve_ranges_rows`` (a ``lax.scan``, 2B + 2 tokens);
K1's list is wider (T = round_up(2B + 2, 128)), its extra tokens FREE with
zero length, which the apply ignores.  JAX's ``nbits`` sized the roll
cascade of its apply; the port's apply expands with one gather and takes
none.  ``kind == PAD`` lanes are no-ops end to end.
"""

from __future__ import annotations

import torch

from ..ops.apply2 import PackedState
from ..ops.apply_range import apply_range_batch
from ..ops.resolve_range import resolve_range_rows

I32 = torch.int32


def merge_rows_body(state: PackedState, kind, pos, rlen, slot0
                    ) -> PackedState:
    """One round's merge for R rows: kind/pos/rlen/slot0 int32[R, B] (row r
    the next batch of the document in row r), resolved against
    ``state.nvis`` and applied.  Returns the new state."""
    tokens, dints, _ = resolve_range_rows(
        *(x.unsqueeze(0) for x in (kind, pos, rlen, slot0)), state.nvis)
    return apply_range_batch(state, tuple(t[0] for t in tokens),
                             tuple(d[0] for d in dints))


def _check_operands(state: PackedState, ops, rank: int) -> None:
    """int32 op arrays of one shape (..., R, B) (``rank`` axes) on the
    state's device, R its rows."""
    doc = state.doc
    if doc.dim() != 2 or doc.dtype != I32:
        raise ValueError(f"state.doc: want int32[R, C], got "
                         f"{doc.dtype}{list(doc.shape)}")
    R = doc.shape[0]
    shape = tuple(ops[0].shape)
    want = "K R B" if rank == 3 else "R B"
    if len(shape) != rank or shape[-2] != R:
        raise ValueError(f"kind: want int32[{want}] with R = {R}, got "
                         f"{list(shape)}")
    for name, t in zip(("kind", "pos", "rlen", "slot0"), ops):
        if t.dtype != I32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want int32{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != doc.device:
            raise ValueError(f"{name} on {t.device}, state on {doc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def merge_rows_round(state: PackedState, kind, pos, rlen, slot0
                     ) -> PackedState:
    """Integrate one (R, B) broadcast batch into R replica rows."""
    _check_operands(state, (kind, pos, rlen, slot0), 2)
    return merge_rows_body(state, kind, pos, rlen, slot0)


def merge_rows_macro(state: PackedState, kind, pos, rlen, slot0
                     ) -> PackedState:
    """K rounds (K, R, B) of :func:`merge_rows_round`, one after another:
    an assembled broadcast stream replayed over a fresh replica row gives
    the oracle's document."""
    _check_operands(state, (kind, pos, rlen, slot0), 3)
    for k in range(kind.shape[0]):
        state = merge_rows_body(state, kind[k], pos[k], rlen[k], slot0[k])
    return state
