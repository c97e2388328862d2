"""Epoch-structured element-id -> physical-position resolution (the JAX
package's ``ops/idpos.py``).

The id-based integration paths (the v5 downstream apply) must answer,
inside the timed region: where is element ``s`` in my document right now?
The structure:

- ``snap`` int32[R, C]: slot -> physical position, exact as of the last
  epoch boundary, rebuilt by one scatter every ``epoch`` batches;
- per batch inside the epoch, a :class:`Level`: the batch's insert runs
  in ``sub = dest0 - (chars of runs placed before)`` form (the count_le
  array that maps a pre-batch position to its post-batch shift) plus the
  (slot0, dest0, rlen) runs for same-epoch id matches.

A query gathers the stale position from ``snap`` and walks the epoch's
levels oldest to newest: add the level's shift, then override with the
exact destination if the id was inserted at that level.  Positions are
physical (tombstones included), so deletes never move anything.

The JAX package does both level steps as (R, B, B) compares.  Here each
level carries its runs sorted twice — by ``sub`` with the inclusive
prefix of ``rlen`` (the shift is a weighted count_le: one
``searchsorted``), and by ``slot0`` (the override: one ``searchsorted``
for the last run starting at or before the id) — so no (R, B, B) tensor
is built.  The override search assumes what every caller guarantees: the
live runs of a level occupy disjoint slot ranges (each slot is inserted
once) and have ``rlen >= 1``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: Sentinel for invalid level rows (sorts after every real position/slot).
BIG = 2**30
I32 = torch.int32


class Level(NamedTuple):
    """One batch's contribution to the epoch position map in run form:
    each live entry is a block of ``rlen`` consecutive slots
    (slot0 .. slot0 + rlen - 1) inserted at post-batch positions
    dest0 .. dest0 + rlen - 1.  The first four fields are the JAX
    ``Level``'s; the rest are the search forms :func:`query` reads."""

    sub: torch.Tensor  # int32[R, B] (BIG for invalid rows)
    rlen: torch.Tensor  # int32[R, B] run length (0 for invalid rows)
    slot0: torch.Tensor  # int32[R, B] first slot id (BIG for invalid rows)
    dest0: torch.Tensor  # int32[R, B] post-batch position of slot0
    sub_sorted: torch.Tensor  # int32[R, B] sub, ascending
    rlen_cum: torch.Tensor  # int32[R, B] inclusive prefix of rlen, sub order
    slot_sorted: torch.Tensor  # int32[R, B] slot0, ascending
    slot_rlen: torch.Tensor  # int32[R, B] rlen in slot0 order
    slot_dest0: torch.Tensor  # int32[R, B] dest0 in slot0 order


def snap_rebuild(doc: torch.Tensor) -> torch.Tensor:
    """slot -> physical position from the packed doc int32[R, C] (one
    scatter; epoch boundaries only).  Unused slots stay 0."""
    R, C = doc.shape
    slot = (doc >> 1) - 2
    tgt = torch.where((slot >= 0) & (slot < C), slot, C).long()
    idx = torch.arange(C, dtype=I32, device=doc.device).expand(R, C)
    out = torch.zeros((R, C + 1), dtype=I32, device=doc.device)
    return out.scatter_(1, tgt, idx)[:, :C].contiguous()


def snap_init(
    n_replicas: int, capacity: int, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """Epoch snapshot of a fresh document (slots 0..n_init-1 in order; the
    identity covers every present slot).  Every replica gets its own copy."""
    idx = torch.arange(capacity, dtype=I32, device=torch.device(device))
    return idx.expand(n_replicas, capacity).contiguous()


def _sorted_prefix(keys, weights):
    """keys int32[R, B] sorted ascending, and the inclusive prefix of
    ``weights`` in that order."""
    ks, perm = torch.sort(keys, dim=1, stable=True)
    return ks, torch.cumsum(weights.gather(1, perm), dim=1, dtype=I32)


def _prefix_at(ks, cum, q, right: bool):
    """sum of the weights whose key is < q (``right``: <=), from a
    :func:`_sorted_prefix` pair, for int32[R, Q] queries."""
    n = torch.searchsorted(ks, q.contiguous(), right=right)
    # n == 0 reads column 0, which the where below masks
    got = cum.gather(1, (n - 1).clamp(min=0))  # graftlint: disable=G026
    return torch.where(n > 0, got, 0).to(I32)


def make_level_runs(dest0, rlen, slot0, live) -> Level:
    """Build a level from a batch's insert runs (int32[R, B] each, ``live``
    bool): ``sub[i] = dest0[i] - P[i]`` with P[i] the chars of live runs
    whose dest0 is strictly smaller."""
    L = torch.where(live, rlen, 0).to(I32)
    d = torch.where(live, dest0, BIG).to(I32)
    before = _prefix_at(*_sorted_prefix(d, L), d, right=False)
    sub = torch.where(live, d - before, BIG).to(I32)
    s0 = torch.where(live, slot0, BIG).to(I32)
    slot_sorted, perm = torch.sort(s0, dim=1, stable=True)
    dest0 = dest0.to(I32)
    return Level(
        sub, L, s0, dest0, *_sorted_prefix(sub, L),
        slot_sorted=slot_sorted,
        slot_rlen=L.gather(1, perm),
        slot_dest0=dest0.gather(1, perm),
    )


def make_level(dest, is_ins, slot) -> Level:
    """Unit-op level: each insert is a length-1 run."""
    return make_level_runs(dest, torch.ones_like(dest), slot, is_ins)


def query(snap: torch.Tensor, levels: list[Level], ids: torch.Tensor):
    """Current physical positions of ``ids`` int32[R, Q] (rows with ids < 0
    return garbage, as in the JAX package — callers mask them).  Each level,
    oldest first: shift by the chars its runs placed at or before the
    position, then, if the id was inserted at that level, take its
    position in the level's frame."""
    C = snap.shape[1]
    ids = ids.to(I32).contiguous()
    # an id past the snapshot reads garbage, as in the JAX package; the
    # levels below overwrite every id they inserted and callers mask the rest
    p = snap.gather(1, ids.clamp(0, C - 1).long())  # graftlint: disable=G026
    for lv in levels:
        p = p + _prefix_at(lv.sub_sorted, lv.rlen_cum, p, right=True)
        n = torch.searchsorted(lv.slot_sorted, ids, right=True)
        k = (n - 1).clamp(min=0)
        # k = n - 1 clamped: n == 0 is masked by `found` below
        off = ids - lv.slot_sorted.gather(1, k)  # graftlint: disable=G026
        found = (n > 0) & (off < lv.slot_rlen.gather(1, k))  # graftlint: disable=G026 (n == 0 masked here)
        p = torch.where(found, lv.slot_dest0.gather(1, k) + off, p)  # graftlint: disable=G026 (masked by found)
    return p.to(I32)
