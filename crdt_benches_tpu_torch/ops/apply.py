"""The slot-indexed (v1) unit-op apply (the JAX package's ``ops/apply.py``),
with the replica axis written out: every field carries a leading R.

Per batch, from a resolved batch in pre-batch rank space:

1. gather visibility in document order and prefix-sum it (rank ->
   physical position is a ``searchsorted`` over that prefix);
2. tombstone deleted slots and set the new slots' visibility (scatters);
3. merge the batch's new slots into the document-order permutation with a
   counting merge: ``new_index_old[i] = i + #inserts at gaps <= i`` and
   ``new_index_ins[j] = gap_j + #inserts before j`` — two disjoint
   scatters, no sort.

The physical buffer holds every slot ever allocated (tombstones included)
in document order; ``visible`` and ``origin`` are indexed by slot id.  No
kernel of its own: the engine's kernel is the resolver K5
(``ops/resolve.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .resolve import ORIGIN_BATCH, ResolvedBatch

I32 = torch.int32


class DocState(NamedTuple):
    order: torch.Tensor  # int32[R, C] slot ids in doc order (incl. tombstones)
    visible: torch.Tensor  # bool[R, C] by slot id
    origin: torch.Tensor  # int32[R, C] by slot id: left-origin slot, -1 head
    length: torch.Tensor  # int32[R] used entries of order
    nvis: torch.Tensor  # int32[R] visible char count


def init_state(
    n_replicas: int, capacity: int, n_init: int = 0,
    device: str | torch.device = "cuda",
) -> DocState:
    """Fresh document: slots 0..n_init-1 hold the start content.  Every
    replica gets its own copy of the arrays."""
    dev = resolve_device(device)
    idx = torch.arange(capacity, dtype=I32, device=dev)
    live = idx < n_init
    R = n_replicas
    rows = lambda x: x.expand(R, capacity).contiguous()
    return DocState(
        order=rows(torch.where(live, idx, -1)),
        visible=rows(live),
        origin=rows(torch.where(live, idx - 1, -1)),
        length=torch.full((R,), n_init, dtype=I32, device=dev),
        nvis=torch.full((R,), n_init, dtype=I32, device=dev),
    )


def set_rows(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """A copy of arr (R, C) with arr[r, idx[r, b]] = val[r, b] (val a
    scalar or an (R, B) tensor); indices outside [0, C) are dropped, as
    JAX's ``.at[].set(mode="drop")``.  Indices must be distinct per row."""
    R, C = arr.shape
    ok = (idx >= 0) & (idx < C)
    ext = torch.cat([arr, arr[:, :1]], dim=1)
    if not isinstance(val, torch.Tensor):
        val = torch.full(idx.shape, val, dtype=arr.dtype, device=arr.device)
    ext.scatter_(1, torch.where(ok, idx, C).long(), val.to(arr.dtype))
    return ext[:, :C].contiguous()


def take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[r, idx[r, b]] with idx clamped into [0, C) (JAX's gather)."""
    return arr.gather(1, idx.clamp(0, arr.shape[1] - 1).long())


def doc_order_visibility(order, visible, length):
    """(slot_at, vis, cumvis): the slot at each doc-order position (0 past
    the length), whether it is a visible char, and the inclusive int32
    prefix of vis."""
    C = order.shape[1]
    valid = torch.arange(C, device=order.device) < length[:, None]
    slot_at = torch.where(valid, order, 0)
    vis = valid & take_rows(visible, slot_at)
    return slot_at, vis, torch.cumsum(vis, dim=1, dtype=I32)


def rank_to_phys(cumvis: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Doc-order position of the visible char with rank[r, b]."""
    return torch.searchsorted(
        cumvis, (rank + 1).contiguous(), out_int32=True
    )


def apply_batch(state: DocState, resolved: ResolvedBatch, slots):
    """Apply one resolved batch (leaves (R, B)); ``slots`` int32[B] are the
    inserts' preassigned slot ids, shared by every replica."""
    return apply_batch_collect(state, resolved, slots)[0]


def apply_batch_collect(state: DocState, resolved: ResolvedBatch, slots):
    """Like :func:`apply_batch`, and also returns ``dslot`` int32[R, B]:
    the slot each DELETE tombstones (-1 for non-deletes), covering both
    pre-batch targets and same-batch inserts."""
    R, C = state.order.shape
    B = slots.shape[0]
    dev = state.order.device
    slots_b = slots[None, :].expand(R, B)
    _, _, cumvis = doc_order_visibility(
        state.order, state.visible, state.length
    )

    # deletes of pre-batch chars: rank -> position -> slot
    dr = resolved.del_rank
    has_del = dr >= 0
    dslot = take_rows(state.order,
                      rank_to_phys(cumvis, torch.where(has_del, dr, 0)))
    visible = set_rows(state.visible, torch.where(has_del, dslot, C), False)

    # batch inserts: visibility (dead on arrival stays False)
    is_ins = resolved.ins_gvis >= 0
    ins_idx = torch.where(is_ins, slots_b, C)
    visible = set_rows(visible, ins_idx, resolved.ins_alive)

    # origin codes -> slot ids, scattered by slot
    oc = resolved.origin
    from_rank = take_rows(
        state.order, rank_to_phys(cumvis, oc.clamp(0, ORIGIN_BATCH - 1))
    )
    from_batch = slots[(oc - ORIGIN_BATCH).clamp(0, B - 1).long()]
    origin_slot = torch.where(
        oc < 0, -1, torch.where(oc >= ORIGIN_BATCH, from_batch, from_rank)
    )
    origin = set_rows(state.origin, ins_idx,
                      torch.where(is_ins, origin_slot, -1))

    # gap rank -> physical gap (index in pre-batch doc order)
    gv = resolved.ins_gvis
    g_phys = torch.where(
        gv >= state.nvis[:, None], state.length[:, None],
        rank_to_phys(cumvis, torch.where(is_ins, gv, 0)),
    )

    # counting merge of the new slots into the order permutation
    bump = torch.zeros((R, C + 2), dtype=I32, device=dev)
    bump.scatter_add_(1, torch.where(is_ins, g_phys, C + 1).long(),
                      torch.ones((R, B), dtype=I32, device=dev))
    csum = torch.cumsum(bump[:, :C + 1], dim=1, dtype=I32)
    idx = torch.arange(C, dtype=I32, device=dev)
    new_idx_old = idx + csum[:, :C]
    n_before = torch.where(g_phys > 0, take_rows(csum, g_phys - 1), 0)
    new_idx_ins = g_phys + n_before + resolved.ins_seq

    valid = idx < state.length[:, None]
    order = set_rows(
        torch.full_like(state.order, -1),
        torch.where(valid, new_idx_old, C),
        torch.where(valid, state.order, -1),
    )
    order = set_rows(order, torch.where(is_ins, new_idx_ins, C), slots_b)

    n_ins = is_ins.sum(dim=1, dtype=I32)
    n_live = (is_ins & resolved.ins_alive).sum(dim=1, dtype=I32)
    n_del = has_del.sum(dim=1, dtype=I32)
    new_state = DocState(
        order=order, visible=visible, origin=origin,
        length=state.length + n_ins, nvis=state.nvis - n_del + n_live,
    )
    db = resolved.del_batch
    out_dslot = torch.where(
        has_del, dslot,
        torch.where(db >= 0, slots[db.clamp(0, B - 1).long()], -1),
    )
    return new_state, out_dslot.to(I32)


def decode_state(state, chars: torch.Tensor, replica: int = 0):
    """One replica's visible document as (codepoints int32[nvis], nvis),
    from any state with order/visible/length fields (DocState, the
    downstream DownState).  Off the hot path."""
    one = slice(replica, replica + 1)
    slot_at, vis, _ = doc_order_visibility(
        state.order[one], state.visible[one], state.length[one]
    )
    codes = chars[slot_at[vis].long()]
    return codes, int(vis.sum())
