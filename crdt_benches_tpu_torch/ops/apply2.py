"""Doc-order replay states and the unit-op batch applies (the JAX
package's ``ops/apply2.py``).

``ReplayState`` holds the document order (slot ids, tombstones included,
-1 unused) and the visibility bit of each document-order position as two
int32 arrays.  ``PackedState`` carries both in one int32,
``doc = ((slot + 2) << 1) | vis``.  ``PackedState4`` adds the maintained
visibility prefix structure that the rank queries read: ``cv_intile``
(inclusive vis cumsum within each 128-position tile, held as int16 —
values are at most 128) and ``vis_tile`` (each tile's total).  The fused
applies (K2 for range ops, K6 for unit ops) re-emit both for the
post-batch document every batch.

A unit batch apply (``apply_batch2``/``3``/``4``, one per state) turns
the resolver's per-op ranks into document positions (rank -> position is
a ``searchsorted`` over the visibility prefix), orders each insert's
destination by (gap, tie-break), clears deleted visibility bits, shifts
the old entries right past the insert destinations (the expansion
y[d] = x[d - cnt[d]], cnt the inclusive prefix of destinations: K9, K8 or
inside K6), fills the destinations and stamps everything past the new
length unused.  The TPU's one-hot MXU spreads become int32
``scatter_add_`` (:func:`_scatter_rows`).

Each ``apply_batchN`` is ``batchN_finish(kernel(*ops), *rest)`` with
``ops, rest = batchN_operands(state, resolved, slots)``, so the kernel
and its plain version can be called on one producer's operands.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..lint.boundary import boundary
from ..device import resolve_device
from .expand import expand_fill_zero, expand_packed
from .resolve import ResolvedBatch

LANE = 128
I32 = torch.int32


class ReplayState(NamedTuple):
    order: torch.Tensor  # int32[R, C] slot ids in doc order (incl. tombstones)
    vis: torch.Tensor  # int32[R, C] 0/1 visibility by doc-order position
    length: torch.Tensor  # int32[R] used entries of order
    nvis: torch.Tensor  # int32[R] visible char count


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


def init_state2(
    n_replicas: int, capacity: int, n_init: int = 0,
    device: str | torch.device = "cuda",
) -> ReplayState:
    """Fresh state: slots 0..n_init-1 visible in order, the rest unused.
    Every replica gets its own copy of the arrays."""
    dev = resolve_device(device)
    idx = torch.arange(capacity, dtype=I32, device=dev)
    live = idx < n_init
    R = n_replicas
    return ReplayState(
        order=torch.where(live, idx, -1).expand(R, capacity).contiguous(),
        vis=live.to(I32).expand(R, capacity).contiguous(),
        length=torch.full((R,), n_init, dtype=I32, device=dev),
        nvis=torch.full((R,), n_init, dtype=I32, device=dev),
    )


def init_state3(
    n_replicas: int, capacity: int, n_init: int = 0,
    device: str | torch.device = "cuda",
) -> PackedState:
    s2 = init_state2(n_replicas, capacity, n_init, device)
    return PackedState(
        doc=pack_doc(s2.order, s2.vis), length=s2.length, nvis=s2.nvis
    )


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
    base = tile_base.gather(1, tq)  # graftlint: mask=count-le-clamp
    start = tq * LANE
    within = torch.zeros_like(tq)
    for s in (64, 32, 16, 8, 4, 2, 1):
        # in range: start + within + s - 1 < (tq + 1) * LANE <= C
        v = cv_intile.gather(1, start + within + (s - 1)).to(I32) + base  # graftlint: disable=G026
        within = within + torch.where(v <= q, s, 0)
    return torch.where(nfull >= nt, C, nfull * LANE + within).to(I32)  # graftlint: mask=count-le-clamp


def count_le_tiled(sorted_rc: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """#{i : sorted_rc[r, i] <= q[r, b]} for a row-wise nondecreasing
    int32[R, C] and int32[R, Q] queries -> int32[R, Q] (C for a query at
    or past the row's last value)."""
    return torch.searchsorted(
        sorted_rc, q.contiguous(), right=True, out_int32=True
    )


def rank_to_phys2(cumvis: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Doc-order position of the visible char with rank[r, b] (0-based),
    given the inclusive visibility cumsum int32[R, C]."""
    return count_le_tiled(cumvis, rank)


def _expand(arrays, r):
    """y[d] = x[d - r[d]] for each int32[R, C] array x (r the inclusive
    prefix of insert destinations, so d - r[d] < 0 only at a destination;
    those positions get x[0], and callers overwrite them)."""
    C = r.shape[1]
    col = torch.arange(C, device=r.device, dtype=torch.int64)
    src = (col - r).clamp(min=0).long()
    # d - r[d] < 0 only at a destination, which every caller overwrites
    return [x.gather(1, src) for x in arrays]  # graftlint: disable=G026


def _scatter_rows(arr, idx, val):
    """Add val[r, b] (an int or an int tensor) into arr[r, idx[r, b]] IN
    PLACE and return arr; indices outside [0, C) are dropped."""
    C = arr.shape[1]
    ok = (idx >= 0) & (idx < C)
    if isinstance(val, int):
        val = torch.full_like(idx, val)
    return arr.scatter_add_(
        1, torch.where(ok, idx, 0).long(), torch.where(ok, val, 0).to(arr.dtype)
    )


def _zeros_like_rows(idx, C: int):
    return torch.zeros((idx.shape[0], C), dtype=I32, device=idx.device)


#: Capacity bound of the combo operand of the fused unit apply K6:
#: combo = (fill << 1) | 1, with fill = ((slot + 2) << 1) | vis, must fit
#: int32 (the packed doc and the resolver's tta = ta*4 + ttype need only
#: 2^29).
MAX_COMBO_CAPACITY = 1 << 28


def spread_fill_combo(dest, fill, C: int):
    """Dense combo int32[R, C] = (fill << 1) | 1 at each insert destination
    dest[r, b] (out-of-range destinations dropped), 0 elsewhere: the
    insert operand of the fused unit apply K6.  ``fill`` must be 0 where
    ``dest`` is out of range."""
    if C >= MAX_COMBO_CAPACITY:
        raise ValueError(
            f"capacity {C} >= 2^28: combo = (fill << 1) | ind no longer"
            " fits int32"
        )
    return _scatter_rows(_zeros_like_rows(dest, C), dest, (fill << 1) | 1)


def insert_tile_base(dest, C: int):
    """int32[R, C // 128]: for each 128-position tile, the insert
    destinations dest[r, b] in the tiles before it (out-of-range ones
    dropped) — the ``cnt_base`` that JAX's ``spread_fill_combo`` returns
    beside the combo, counted from the B destinations."""
    R = dest.shape[0]
    nt = C // LANE
    ok = (dest >= 0) & (dest < C)
    count = torch.zeros((R, nt + 1), dtype=I32, device=dest.device)
    count.scatter_add_(1, torch.where(ok, dest // LANE, nt).long(),
                       ok.to(I32))
    return _excl_cumsum_small(count[:, :nt])


def _insert_dest(g_phys, is_ins, seq, drop: int):
    """Each insert's destination: its gap position plus its rank among the
    batch's inserts ordered by (gap position, tie-break).  One int64 sort
    key for every batch size; the JAX package's B <= 1024 compare path and
    its B > 1024 double argsort give the same ranks."""
    R, B = g_phys.shape
    key = torch.where(
        is_ins, g_phys.long() * (B + 1) + seq, torch.iinfo(torch.int64).max
    )
    perm = torch.argsort(key, dim=1, stable=True)
    ar = torch.arange(B, device=g_phys.device, dtype=torch.int64).expand(R, B)
    rank = torch.empty_like(perm).scatter_(1, perm, ar)
    return torch.where(is_ins, g_phys + rank.to(I32), drop)


def _gap_positions(resolved: ResolvedBatch, phys_of, length, nvis, drop):
    """(has_del, delete positions, is_ins, insert destinations) of a
    resolved batch; ``phys_of(q)`` maps visible ranks int32[R, 2B] (delete
    ranks, then insert gaps) to document positions."""
    B = resolved.del_rank.shape[1]
    has_del = resolved.del_rank >= 0
    gv = resolved.ins_gvis
    is_ins = gv >= 0
    both = phys_of(torch.cat(
        [torch.where(has_del, resolved.del_rank, 0),
         torch.where(is_ins, gv, 0)], dim=1
    ))
    dphys = torch.where(has_del, both[:, :B], drop)
    g_phys = torch.where(gv >= nvis[:, None], length[:, None], both[:, B:])
    g_phys = torch.where(is_ins, g_phys, drop)
    dest = _insert_dest(g_phys, is_ins, resolved.ins_seq, drop)
    return has_del, dphys, is_ins, dest


def _new_counts(state, has_del, is_ins, alive):
    n_ins = is_ins.sum(dim=1, dtype=I32)
    n_live = (is_ins & alive).sum(dim=1, dtype=I32)
    n_del = has_del.sum(dim=1, dtype=I32)
    return state.length + n_ins, state.nvis - n_del + n_live


def _visible_cumsum(vis, length):
    C = vis.shape[1]
    valid = torch.arange(C, device=vis.device, dtype=torch.int64) < length[:, None]
    return torch.cumsum(vis * valid, dim=1, dtype=I32)


def _beyond(length, C: int):
    return torch.arange(C, device=length.device, dtype=torch.int64) >= length[:, None]


def batch2_operands(state: ReplayState, resolved: ResolvedBatch, slots):
    """The v2 producer: K9's operands (order, vis after the deletes, cnt,
    ind), and what :func:`batch2_finish` needs after it."""
    R, C = state.order.shape
    drop = C + 7
    cumvis = _visible_cumsum(state.vis, state.length)
    has_del, dphys, is_ins, dest = _gap_positions(
        resolved, lambda q: rank_to_phys2(cumvis, q),
        state.length, state.nvis, drop,
    )
    # deletes hit distinct visible chars: add(-1) clears a 1-bit
    vis = _scatter_rows(state.vis.clone(), dphys, -1)
    ind = _scatter_rows(_zeros_like_rows(dest, C), dest, 1)
    cnt = torch.cumsum(ind, dim=1, dtype=I32)
    length, nvis = _new_counts(state, has_del, is_ins, resolved.ins_alive)
    rest = (dest, slots[None, :].expand(R, -1), resolved.ins_alive.to(I32),
            length, nvis)
    return (state.order, vis, cnt, ind), rest


def batch2_finish(expanded, dest, slots, alive, length, nvis) -> ReplayState:
    """Fill K9's zeroed holes and stamp everything past the new length."""
    order = _scatter_rows(expanded[0], dest, slots)
    vis = _scatter_rows(expanded[1], dest, alive)
    beyond = _beyond(length, order.shape[1])
    return ReplayState(
        order=torch.where(beyond, -1, order),
        vis=torch.where(beyond, 0, vis),
        length=length,
        nvis=nvis,
    )


def apply_batch2(
    state: ReplayState, resolved: ResolvedBatch, slots: torch.Tensor
) -> ReplayState:
    """Apply one resolved batch (leaves (R, B)) to the two-array state;
    ``slots`` int32[B] are the inserts' preassigned slot ids, shared by
    every replica.  The expansion is K9 (:func:`expand_fill_zero`)."""
    ops, rest = batch2_operands(state, resolved, slots)
    return batch2_finish(expand_fill_zero(*ops), *rest)


def batch3_operands(state: PackedState, resolved: ResolvedBatch, slots):
    """The v3 producer: K8's operands (doc after the deletes,
    cntind = cnt << 1 | ind), and what :func:`batch3_finish` needs.
    ``slots`` is int32[B] (one op stream for every row) or int32[R, B]
    (a stream a row: the fleet step)."""
    R, C = state.doc.shape
    drop = C + 7
    cumvis = _visible_cumsum(state.doc & 1, state.length)
    has_del, dphys, is_ins, dest = _gap_positions(
        resolved, lambda q: rank_to_phys2(cumvis, q),
        state.length, state.nvis, drop,
    )
    doc = _scatter_rows(state.doc.clone(), dphys, -1)
    ind = _scatter_rows(_zeros_like_rows(dest, C), dest, 1)
    cntind = (torch.cumsum(ind, dim=1, dtype=I32) << 1) | ind
    rows = slots if slots.dim() == 2 else slots[None, :]
    fill = torch.where(
        is_ins, pack_doc(rows, resolved.ins_alive.to(I32)), 0
    )
    length, nvis = _new_counts(state, has_del, is_ins, resolved.ins_alive)
    return (doc, cntind), (dest, fill, length, nvis)


def batch3_finish(expanded, dest, fill, length, nvis) -> PackedState:
    """Fill K8's zeroed holes and stamp everything past the new length."""
    doc = _scatter_rows(expanded, dest, fill)
    return PackedState(
        doc=torch.where(_beyond(length, doc.shape[1]), 2, doc),
        length=length, nvis=nvis,
    )


@boundary(dtypes=("int32", None, "int32"))
def apply_batch3(
    state: PackedState, resolved: ResolvedBatch, slots: torch.Tensor
) -> PackedState:
    """apply_batch2 on the packed one-array state; the expansion is K8
    (:func:`expand_packed`) over cntind = cnt << 1 | ind.  ``slots`` may
    be int32[B] (shared by every row) or int32[R, B] (a stream a row, as
    the fleet step passes them)."""
    ops, rest = batch3_operands(state, resolved, slots)
    return batch3_finish(expand_packed(*ops), *rest)


def batch4_operands(state: PackedState4, resolved: ResolvedBatch, slots):
    """The v4 producer: K6's operands (doc after the deletes, combo, the
    new length), and what :func:`batch4_finish` needs."""
    R, C = state.doc.shape
    drop = C + 7
    tile_base = _excl_cumsum_small(state.vis_tile)
    tmax_abs = tile_base + state.vis_tile
    has_del, dphys, is_ins, dest = _gap_positions(
        resolved,
        lambda q: count_le_two_level(state.cv_intile, tile_base, tmax_abs, q),
        state.length, state.nvis, drop,
    )
    doc_predel = _scatter_rows(state.doc.clone(), dphys, -1)
    fill = torch.where(
        is_ins, pack_doc(slots[None, :], resolved.ins_alive.to(I32)), 0
    )
    combo = spread_fill_combo(dest, fill, C)
    length, nvis = _new_counts(state, has_del, is_ins, resolved.ins_alive)
    return (doc_predel, combo, length), (length, nvis)


def batch4_finish(fused, length, nvis) -> PackedState4:
    doc, cv, vt = fused
    return PackedState4(
        doc=doc, cv_intile=cv, vis_tile=vt, length=length, nvis=nvis
    )


def apply_batch4(
    state: PackedState4, resolved: ResolvedBatch, slots: torch.Tensor
) -> PackedState4:
    """apply_batch3 on the maintained-cv state: rank queries read the
    two-level structure (no per-batch capacity cumsum), and expansion,
    fill, beyond-length stamp and the next batch's cv_intile/vis_tile run
    in one kernel, K6 (``apply_range_fused.apply_fused2``)."""
    from .apply_range_fused import apply_fused2

    ops, rest = batch4_operands(state, resolved, slots)
    return batch4_finish(apply_fused2(*ops), *rest)


def decode_state2(state: ReplayState, chars: torch.Tensor, replica: int = 0):
    """One replica's visible document as (codepoints int32[nvis], nvis).
    Off the hot path."""
    order = state.order[replica]
    C = order.shape[0]
    valid = torch.arange(C, device=order.device, dtype=torch.int64) < state.length[replica]
    keep = (state.vis[replica] > 0) & valid
    codes = chars[order[keep].clamp(0, chars.shape[0] - 1).long()]
    return codes, int(keep.sum())


def decode_state3(state: PackedState, chars: torch.Tensor, replica: int = 0):
    one = slice(replica, replica + 1)
    order, vis = unpack_doc(state.doc[one])
    return decode_state2(
        ReplayState(order=order, vis=vis, length=state.length[one],
                    nvis=state.nvis[one]),
        chars,
    )


def decode_state4(state: PackedState4, chars: torch.Tensor, replica: int = 0):
    return decode_state3(
        PackedState(doc=state.doc, length=state.length, nvis=state.nvis),
        chars, replica,
    )
