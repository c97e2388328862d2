"""Order-sensitive document digests for convergence checks (the JAX
package's ``utils/digest.py``): a cheap on-device fingerprint of each
replica's visible document (chars in order) that replicas compare without
materializing content.

Replicas are digested in chunks of rows, so the int64 temporaries stay
small at a thousand replicas of a long document.  Not cryptographic: two
weighted sums in int32 (rank-weighted and
char-mixed) and the visible length.  The arithmetic is int32 that wraps,
as in JAX: torch's ``sum`` and ``cumsum`` of int32 return int64, so every
product is wrapped to int32 before it is summed in int64, and each sum is
wrapped once more, which gives JAX's value bit for bit when
rank x char overflows.  Byte-identical guarantees come from decoding.
"""

from __future__ import annotations

import torch

_MIX = -1640531527  # 2654435761 as int32 (Knuth multiplicative)
I64 = torch.int64


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 that two's-complement wrapping gives, as int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _rows(C: int) -> int:
    """Rows a chunk: the int64 temporaries stay near 2^26 elements each."""
    return max(1, (1 << 26) // max(C, 1))


def _digest(vis: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """int32[R, 3] from the visibility int64[R, C] (0/1) and the char at
    each position int64[R, C] (0 where not visible)."""
    rank = torch.cumsum(vis, dim=1)  # rank + 1 at visible entries
    h1 = _wrap32(rank * _wrap32(ch * _MIX + 1)) * vis
    h2 = (_wrap32(rank * rank) ^ (ch * 31 + rank)) * vis
    return torch.stack(
        [_wrap32(h1.sum(dim=1)), _wrap32(h2.sum(dim=1)), rank[:, -1]], dim=1
    ).to(torch.int32)


def doc_digest(order: torch.Tensor, visible: torch.Tensor,
               length: torch.Tensor, chars: torch.Tensor) -> torch.Tensor:
    """Digest of each replica's visible document in order, from the
    slot-indexed state (order int32[R, C], visible bool[R, C] by slot,
    length int32[R]) and the slot -> codepoint table.  Returns int32[R, 3]:
    (rank-weighted char sum, mixed rolling component, visible length)."""
    C = order.shape[1]
    idx = torch.arange(C, device=order.device)
    out = []
    for r0 in range(0, order.shape[0], _rows(C)):
        rows = slice(r0, r0 + _rows(C))
        valid = idx < length[rows, None]
        slot_at = torch.where(valid, order[rows], 0).long()
        vis = valid & visible[rows].gather(1, slot_at)
        ch = torch.where(vis, chars[slot_at], 0)
        out.append(_digest(vis.to(I64), ch.to(I64)))
    return torch.cat(out)


def doc_digest_packed(doc: torch.Tensor, length: torch.Tensor,
                      chars: torch.Tensor) -> torch.Tensor:
    """:func:`doc_digest` over the packed doc-order state (``PackedState``
    layout: ((slot + 2) << 1) | vis, tombstones in line), int32[R, C].  The
    same value as :func:`doc_digest` on the equivalent order/visible
    arrays."""
    C = doc.shape[1]
    idx = torch.arange(C, device=doc.device)
    out = []
    for r0 in range(0, doc.shape[0], _rows(C)):
        rows = slice(r0, r0 + _rows(C))
        slot = ((doc[rows] >> 1) - 2).clamp(0, chars.shape[0] - 1).long()
        vis = (idx < length[rows, None]) & ((doc[rows] & 1) > 0)
        ch = torch.where(vis, chars[slot], 0)
        out.append(_digest(vis.to(I64), ch.to(I64)))
    return torch.cat(out)
