"""Downstream path: remote-update generation and the timed batched apply
(the JAX package's ``engine/downstream.py``; the reference's
``Downstream`` capability, src/rope.rs:185-225, bench src/main.rs:50-81).

- :func:`generate_updates` (untimed, as the reference's
  ``upstream_updates``): replay the trace once on the device
  (``replay_batches_collect``, the v1 apply with K5) and extract, per
  batch of B unit ops, each insert's slot id, its anchor (the nearest
  preceding element from an earlier batch, which the receiver has already
  integrated), its rank among same-anchor inserts, and each delete's
  target slot.  Updates are integer tensors.
- The timed apply integrates them into replicas that start from the start
  content.  Three engines:

  - ``v5`` (default): the id-based wire form, every anchor and delete
    target resolved to its current position inside the timed region
    through the epoch structure of ``ops/idpos.py``; the packed doc is
    rewritten by the no-cv fused apply (``ops/expand.py``
    ``apply_fused_blocked``, K7, at every width: it beat K6 without cv
    at 64 and at 1024 replicas on the card);
  - ``v3``: the positional form (``ins_gap``/``del_pos``, resolved at
    encode time) on the packed doc, expansion K8;
  - ``v1``: the id-based form on the slot-indexed ``DownState`` with
    capacity-sized scatters.

Every replica runs its own query, producer and apply; the wire rows
(B,) are shared by all replicas, as the JAX engine broadcasts them.  The
JAX engine's padding of the batch count to a multiple of ``epoch`` only
made its scan uniform: here the last epoch is shorter instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..lint.boundary import boundary
from ..device import resolve_device
from ..ops.apply import decode_state, init_state, set_rows, take_rows
from ..ops.apply2 import (
    MAX_COMBO_CAPACITY,
    PackedState,
    _scatter_rows,
    _zeros_like_rows,
    decode_state3,
    init_state3,
    insert_tile_base,
    pack_doc,
    spread_fill_combo,
)
from ..ops.expand import apply_fused_blocked, expand_packed
from ..ops.idpos import make_level, query, snap_init, snap_rebuild
from ..traces.loader import TestData
from ..traces.tensorize import INSERT, TensorizedTrace, tensorize
from .replay import _round_up, replay_batches_collect, slot_char_table

I32 = torch.int32
ENGINES = ("v5", "v3", "v1")


class DownState(NamedTuple):
    """Slot-indexed downstream replica state (v1): DocState without the
    origins, which were consumed at encode time."""

    order: torch.Tensor  # int32[R, C] slot ids in doc order (incl. tombstones)
    visible: torch.Tensor  # bool[R, C] by slot id
    length: torch.Tensor  # int32[R]
    nvis: torch.Tensor  # int32[R]


class DownPacked(NamedTuple):
    """Packed downstream state (v5): the packed doc plus the epoch
    position snapshot (``ops/idpos.py``)."""

    doc: torch.Tensor  # int32[R, C] packed ((slot+2)<<1)|vis
    snap: torch.Tensor  # int32[R, C] slot -> position at the epoch boundary
    length: torch.Tensor  # int32[R]
    nvis: torch.Tensor  # int32[R]


@dataclass
class DownstreamUpdates:
    """One trace's pre-generated updates as batched tensors (numpy).

    Row b is one update covering B unit ops: ``ins_slot`` inserted
    element ids (-1 = not an insert), ``anchor`` the already-integrated
    element each insert follows (-1 = document head), ``rank`` the order
    among same-anchor inserts, ``dslot`` deleted element ids (-1 = not a
    delete).  The positional form (v3): ``ins_gap`` the physical position
    the insert lands after in the pre-batch doc (0 = head), ``del_pos`` the
    physical position of the delete target in the post-batch doc."""

    ins_slot: np.ndarray  # int32[n_batches, B]
    anchor: np.ndarray  # int32[n_batches, B]
    rank: np.ndarray  # int32[n_batches, B]
    dslot: np.ndarray  # int32[n_batches, B]
    capacity: int
    n_init: int
    chars: np.ndarray  # int32[capacity] slot -> codepoint
    end_content: str
    n_patches: int
    ins_gap: np.ndarray | None = None  # int32[n_batches, B]
    del_pos: np.ndarray | None = None  # int32[n_batches, B]

    def nbytes(self, engine: str = "v5") -> int:
        """Wire size of the update tensors ``engine`` ships: v5/v1 the
        anchor/rank form, v3 ins_slot/rank plus the positional form."""
        if engine == "v3":
            arrays = [self.ins_slot, self.rank]
            arrays += [a for a in (self.ins_gap, self.del_pos)
                       if a is not None]
        else:
            arrays = [self.ins_slot, self.anchor, self.rank, self.dslot]
        return sum(a.nbytes for a in arrays)


def _prev_smaller(vals: np.ndarray) -> np.ndarray:
    """For each i: the largest j < i with vals[j] < vals[i], else -1
    (previous-smaller-value monotonic stack, amortized O(n))."""
    out = np.empty(len(vals), np.int64)
    stack: list[int] = []
    v = vals.tolist()
    for i, x in enumerate(v):
        while stack and v[stack[-1]] >= x:
            stack.pop()
        out[i] = stack[-1] if stack else -1
        stack.append(i)
    return out


def generate_updates(
    tt: TensorizedTrace, lane: int = 128, positional: bool = True,
    device: str | torch.device = "cuda",
) -> DownstreamUpdates:
    """Untimed update generation: one upstream replay on ``device`` (one
    replica) and the anchor/rank extraction on the host.  ``positional``
    adds the v3 form (an O(n_batches x doc length) host pass)."""
    dev = resolve_device(device)
    capacity = _round_up(max(tt.capacity, 1), lane)
    n_init = len(tt.init_chars)
    kind_b, pos_b, _, slot_b = tt.batched()
    n_batches, B = kind_b.shape
    as_t = lambda a: torch.as_tensor(a, dtype=I32, device=dev)
    state, dslot_b = replay_batches_collect(
        init_state(1, capacity, n_init, device=dev),
        as_t(kind_b), as_t(pos_b), as_t(slot_b),
    )
    length = int(state.length[0])
    order = state.order[0, :length].cpu().numpy()  # final order, tombstones
    dslot_b = dslot_b[:, 0].cpu().numpy()

    # batch index of every slot: -1 for the start content
    batch_of_slot = np.full(capacity, -1, np.int32)
    is_ins = tt.kind == INSERT
    op_of_ins = np.nonzero(is_ins)[0]
    batch_of_slot[tt.slot[is_ins]] = (op_of_ins // B).astype(np.int32)

    pos_of_slot = np.full(capacity, -1, np.int64)
    pos_of_slot[order] = np.arange(length)
    arrb = batch_of_slot[order]  # batch index at each final doc position

    # anchor of the element at position q: the nearest p < q with a smaller
    # batch index (integrated in an earlier batch, or the start content)
    a_pos_all = _prev_smaller(arrb)

    ins_slot = np.full((n_batches, B), -1, np.int32)
    anchor = np.full((n_batches, B), -1, np.int32)
    rank = np.zeros((n_batches, B), np.int32)

    slots = tt.slot[is_ins]
    q = pos_of_slot[slots]
    a_pos = a_pos_all[q]
    a_slot = np.where(a_pos >= 0, order[np.clip(a_pos, 0, None)], -1)
    # rank among the inserts of one batch sharing an anchor, in doc order
    b_of_ins = (op_of_ins // B).astype(np.int64)
    sort = np.lexsort((q, a_pos, b_of_ins))
    key_b, key_a = b_of_ins[sort], a_pos[sort]
    grp_start = np.concatenate(
        [[True], (key_b[1:] != key_b[:-1]) | (key_a[1:] != key_a[:-1])]
    )
    idx = np.arange(len(sort))
    r_sorted = idx - np.maximum.accumulate(np.where(grp_start, idx, 0))
    r = np.empty_like(r_sorted)
    r[sort] = r_sorted

    row, col = np.divmod(op_of_ins, B)
    ins_slot[row, col] = slots
    anchor[row, col] = a_slot
    rank[row, col] = r.astype(np.int32)

    # positional form: the position of final-order index q once batches
    # < b are integrated is #{p < q : arrb[p] < b}
    ins_gap = del_pos = None
    if positional:
        ins_gap = np.zeros((n_batches, B), np.int32)
        del_pos = np.full((n_batches, B), -1, np.int32)
        qd_all = np.where(
            dslot_b >= 0, pos_of_slot[np.clip(dslot_b, 0, None)], 0
        )
        for b in range(n_batches):
            ex_lt = np.concatenate([[0], np.cumsum(arrb < b)[:-1]])
            ex_le = np.concatenate([[0], np.cumsum(arrb <= b)[:-1]])
            sel = row == b
            ap = a_pos[sel]
            ins_gap[b, col[sel]] = np.where(
                ap >= 0, ex_lt[np.clip(ap, 0, None)] + 1, 0
            ).astype(np.int32)
            hd = dslot_b[b] >= 0
            del_pos[b, hd] = ex_le[qd_all[b, hd]].astype(np.int32)

    return DownstreamUpdates(
        ins_slot=ins_slot, anchor=anchor, rank=rank, dslot=dslot_b,
        capacity=capacity, n_init=n_init,
        chars=slot_char_table(tt, capacity), end_content=tt.end_content,
        n_patches=tt.n_patches, ins_gap=ins_gap, del_pos=del_pos,
    )


# ---- v1: the slot-indexed state ------------------------------------------


def init_down_state(
    n_replicas: int, capacity: int, n_init: int,
    device: str | torch.device = "cuda",
) -> DownState:
    st = init_state(n_replicas, capacity, n_init, device)
    return DownState(order=st.order, visible=st.visible, length=st.length,
                     nvis=st.nvis)


def apply_update_batch(state: DownState, ins, anchor, rank, dslot):
    """Integrate one update batch (wire rows int32[B]) into every replica:
    slot -> position scatter, counting merge of the new elements into the
    order permutation, visibility scatters."""
    R, C = state.order.shape
    B = ins.shape[0]
    dev = state.order.device
    bc = lambda x: x[None, :].expand(R, B)
    idx = torch.arange(C, dtype=I32, device=dev)
    valid = idx < state.length[:, None]
    is_ins = bc(ins >= 0)

    phys = set_rows(torch.zeros_like(state.order),
                    torch.where(valid, state.order, C), idx.expand(R, C))
    a_phys = torch.where(bc(anchor) >= 0, take_rows(phys, bc(anchor)), -1)
    gap = torch.where(is_ins, a_phys + 1, C + 1)

    bump = torch.zeros((R, C + 2), dtype=I32, device=dev)
    bump.scatter_add_(1, gap.long(), torch.ones((R, B), dtype=I32, device=dev))
    csum = torch.cumsum(bump[:, :C + 1], dim=1, dtype=I32)
    new_idx_old = idx + csum[:, :C]
    n_before = torch.where(gap > 0, take_rows(csum, gap - 1), 0)
    new_idx_ins = gap + n_before + bc(rank)

    order = set_rows(torch.full_like(state.order, -1),
                     torch.where(valid, new_idx_old, C),
                     torch.where(valid, state.order, -1))
    order = set_rows(order, torch.where(is_ins, new_idx_ins, C), bc(ins))
    # new inserts visible, then this batch's deletes tombstone (covers an
    # insert deleted in its own batch)
    visible = set_rows(state.visible, torch.where(is_ins, bc(ins), C), True)
    visible = set_rows(visible, torch.where(bc(dslot) >= 0, bc(dslot), C),
                       False)
    length = state.length + (ins >= 0).sum(dtype=I32)
    valid2 = idx < length[:, None]
    nvis = (valid2 & take_rows(visible, torch.where(valid2, order, 0))).sum(
        dim=1, dtype=I32)
    return DownState(order=order, visible=visible, length=length, nvis=nvis)


def apply_updates(state: DownState, ins_b, anchor_b, rank_b, dslot_b):
    """Every update batch (int32[N, B] each) into ``state``, in order."""
    for i in range(ins_b.shape[0]):
        state = apply_update_batch(state, ins_b[i], anchor_b[i], rank_b[i],
                                   dslot_b[i])
    return state


# ---- v3: the positional form on the packed doc ----------------------------


def _n_smaller(gap):
    """#{j : gap[r, j] < gap[r, i]} for int32[R, B], by one sort and one
    ``searchsorted`` (the JAX package builds an (R, B, B) compare)."""
    gs = torch.sort(gap, dim=1).values
    return torch.searchsorted(gs, gap.contiguous(), out_int32=True)


def apply_update_batch3(state: PackedState, ins, gap, rank, del_pos):
    """Integrate one positional update batch (int32[R, B] rows) into the
    packed state: counting merge, expansion K8 (``expand_packed``), fills
    into its zeroed holes, deletes cleared at post-batch positions."""
    R, C = state.doc.shape
    drop = C + 7
    is_ins = ins >= 0
    gap = torch.where(is_ins, gap, drop)
    dest = torch.where(is_ins, gap + _n_smaller(gap) + rank, drop)
    ind = _scatter_rows(_zeros_like_rows(dest, C), dest, 1)
    cntind = (torch.cumsum(ind, dim=1, dtype=I32) << 1) | ind
    doc = expand_packed(state.doc, cntind)
    doc = _scatter_rows(doc, dest, torch.where(is_ins, pack_doc(ins, 1), 0))
    # deletes at post-batch positions (each target currently visible)
    has_del = del_pos >= 0
    doc = _scatter_rows(doc, torch.where(has_del, del_pos, drop), -1)
    n_ins = is_ins.sum(dim=1, dtype=I32)
    n_del = has_del.sum(dim=1, dtype=I32)
    length = state.length + n_ins
    beyond = torch.arange(C, device=doc.device) >= length[:, None]
    return PackedState(doc=torch.where(beyond, 2, doc), length=length,
                       nvis=state.nvis + n_ins - n_del)


def apply_updates3(state: PackedState, ins_b, gap_b, rank_b, dpos_b):
    """Every positional update batch (int32[N, B] each) into ``state``."""
    R = state.doc.shape[0]
    bc = lambda x: x[None, :].expand(R, x.shape[0])
    for i in range(ins_b.shape[0]):
        state = apply_update_batch3(state, bc(ins_b[i]), bc(gap_b[i]),
                                    bc(rank_b[i]), bc(dpos_b[i]))
    return state


# ---- v5: id resolution inside the timed apply -----------------------------


def decode_packed(state, chars: torch.Tensor, replica: int = 0) -> str:
    """One replica's visible document as a string, from a packed state
    (``DownPacked``, ``PackedState``)."""
    codes, _ = decode_state3(
        PackedState(doc=state.doc, length=state.length, nvis=state.nvis),
        chars, replica,
    )
    return "".join(map(chr, codes.cpu().tolist()))


def down_packed_init(
    n_replicas: int, capacity: int, n_init: int,
    device: str | torch.device = "cuda",
) -> DownPacked:
    """Fresh replica-batched DownPacked (the start content in order)."""
    s3 = init_state3(n_replicas, capacity, n_init, device)
    return DownPacked(doc=s3.doc, snap=snap_init(n_replicas, capacity,
                                                 s3.doc.device),
                      length=s3.length, nvis=s3.nvis)


def resolve_targets5(snap, levels, anchor, dslot):
    """Current positions int32[R, B] of each insert's anchor and each
    delete's target (wire rows int32[B]) in every replica: one
    ``idpos.query`` over both (rows with an id < 0 are garbage)."""
    R = snap.shape[0]
    return query(snap, levels, torch.cat([anchor, dslot])[None, :].expand(
        R, 2 * anchor.shape[0])).tensor_split(2, dim=1)


def batch5_operands(doc, length, nvis, targets, ins, anchor, rank, dslot):
    """The v5 producer: from the positions of the anchors and delete
    targets (:func:`resolve_targets5`), the no-cv fused apply's operands
    (doc after the deletes, combo, cnt_base, the new length) and the new
    nvis and this batch's level."""
    R, C = doc.shape
    B = ins.shape[0]
    drop = C + 7
    a_phys, d_q = targets
    bc = lambda x: x[None, :].expand(R, B)
    is_ins = ins >= 0
    has_del = dslot >= 0
    gap = torch.where(bc(is_ins),
                      torch.where(bc(anchor) >= 0, a_phys + 1, 0), drop)

    # an insert deleted in its own batch integrates dead (shared rows)
    kill = ((dslot[:, None] == ins[None, :]) & has_del[:, None]
            & is_ins[None, :])  # [d, i]: delete row d targets insert row i
    alive = is_ins & ~kill.any(dim=0)
    del_prev = has_del & ~kill.any(dim=1)  # targets an older element

    # deletes of older elements: clear a visible bit once per position
    dphys = torch.where(bc(del_prev), d_q, drop)
    ok = (dphys >= 0) & (dphys < C)
    ds = torch.sort(torch.where(ok, dphys, C), dim=1).values
    first = torch.ones_like(ds, dtype=torch.bool)
    first[:, 1:] = ds[:, 1:] != ds[:, :-1]
    dsc = ds.clamp(max=C - 1).long()
    sub = doc.gather(1, dsc) & 1 & (first & (ds < C)).to(I32)
    doc_predel = doc.clone().scatter_add_(1, dsc, -sub)

    dest = torch.where(bc(is_ins), gap + _n_smaller(gap) + bc(rank), drop)
    fill = torch.where(is_ins, pack_doc(ins, alive.to(I32)), 0)
    combo = spread_fill_combo(dest, bc(fill), C)
    cnt_base = insert_tile_base(dest, C)
    length2 = length + is_ins.sum(dtype=I32)
    nvis2 = nvis + alive.sum(dtype=I32) - sub.sum(dim=1, dtype=I32)
    level = make_level(dest, bc(is_ins), bc(ins))
    return (doc_predel, combo, cnt_base, length2), (nvis2, level)


def _apply_update_batch5(doc, length, nvis, snap, levels, ins, anchor, rank,
                         dslot):
    """Integrate one anchor/rank update batch with the id -> position
    resolution inside the timed region.  Returns (doc, length, nvis,
    level)."""
    targets = resolve_targets5(snap, levels, anchor, dslot)
    ops, (nvis2, level) = batch5_operands(doc, length, nvis, targets, ins,
                                          anchor, rank, dslot)
    return apply_fused_blocked(*ops), ops[3], nvis2, level


@boundary(
    dtypes=(None, "int32", "int32", "int32", "int32"),
    shapes=(None, "N B", "N B", "N B", "N B"),
    donates=(0,),
)
def apply_updates5(state: DownPacked, ins_b, anchor_b, rank_b, dslot_b,
                   epoch: int = 32) -> DownPacked:
    """Every anchor/rank update batch (int32[N, B] each) into the packed
    state; the snapshot is rebuilt (one scatter) after every ``epoch``
    batches and after the last, the batches between resolved through the
    epoch's levels."""
    doc, snap, length, nvis = state
    N = ins_b.shape[0]
    for e0 in range(0, N, epoch):
        levels: list = []
        for i in range(e0, min(e0 + epoch, N)):
            doc, length, nvis, lv = _apply_update_batch5(
                doc, length, nvis, snap, levels, ins_b[i], anchor_b[i],
                rank_b[i], dslot_b[i],
            )
            levels.append(lv)
        snap = snap_rebuild(doc)
    return DownPacked(doc, snap, length, nvis)


class DownstreamEngine:
    """The downstream engine: untimed generation, timed repeated apply, R
    replicas wide on ``device``.  ``engine``: ``"v5"`` (default; id-based,
    anchors resolved inside the timed apply, like the reference's timed
    integration), ``"v3"`` (positional form, resolved at encode time) or
    ``"v1"`` (id-based, slot-indexed state)."""

    def __init__(self, tt: TensorizedTrace, n_replicas: int = 1,
                 engine: str = "v5", epoch: int = 32,
                 device: str | torch.device = "cuda"):
        if engine not in ENGINES:
            raise ValueError(f"unknown downstream engine {engine!r}")
        if epoch < 1:
            raise ValueError(f"epoch {epoch} < 1")
        self.device = resolve_device(device)
        self.engine = engine
        self.n_replicas = n_replicas
        self.upd = generate_updates(tt, positional=engine == "v3",
                                    device=self.device)
        # the port's one capacity bound: the fused apply's int32 combo
        if self.upd.capacity >= MAX_COMBO_CAPACITY:
            raise ValueError(
                f"capacity {self.upd.capacity} >= 2^28: the fused apply's "
                "combo operand would overflow int32"
            )
        self.n_batches = self.upd.ins_slot.shape[0]
        self.epoch = min(epoch, max(1, self.n_batches))
        as_t = lambda a: torch.as_tensor(a, dtype=I32, device=self.device)
        self.ins_b = as_t(self.upd.ins_slot)
        self.anchor_b = as_t(self.upd.anchor)
        self.rank_b = as_t(self.upd.rank)
        self.dslot_b = as_t(self.upd.dslot)
        if self.upd.ins_gap is not None:
            self.gap_b = as_t(self.upd.ins_gap)
            self.dpos_b = as_t(self.upd.del_pos)
        self.chars = as_t(self.upd.chars)

    def init_state(self):
        """The engine's fresh replica-batched state."""
        init = {"v5": down_packed_init, "v3": init_state3,
                "v1": init_down_state}[self.engine]
        return init(self.n_replicas, self.upd.capacity, self.upd.n_init,
                    device=self.device)

    def run(self):
        """Apply every update to fresh replicas (their init is part of the
        timed region); returns the final state on the device."""
        st = self.init_state()
        if self.engine == "v5":
            return apply_updates5(st, self.ins_b, self.anchor_b, self.rank_b,
                                  self.dslot_b, epoch=self.epoch)
        if self.engine == "v3":
            return apply_updates3(st, self.ins_b, self.gap_b, self.rank_b,
                                  self.dpos_b)
        return apply_updates(st, self.ins_b, self.anchor_b, self.rank_b,
                             self.dslot_b)

    def decode(self, state, replica: int = 0) -> str:
        """A replica's visible document as a string."""
        if isinstance(state, DownState):
            codes, _ = decode_state(state, self.chars, replica)
            return "".join(map(chr, codes.cpu().tolist()))
        return decode_packed(state, self.chars, replica)


class TorchDownstreamBackend:
    """Downstream bench backend.  Timed region of :meth:`replay_once`:
    fresh replicas + the full update apply + the final length fetch, which
    waits for the device — the reference's timed closure (clone + apply
    loop + length assert, src/main.rs:62-69).  Generation is untimed, in
    :meth:`prepare`."""

    def __init__(self, n_replicas: int = 1, batch: int = 256,
                 engine: str = "v5", epoch: int = 32,
                 device: str | torch.device = "cuda"):
        if engine not in ENGINES:
            raise ValueError(f"unknown downstream engine {engine!r}")
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.batch = batch
        self.engine_name = engine
        self.epoch = epoch
        self._eng: DownstreamEngine | None = None
        self._end_len = 0

    @property
    def NAME(self) -> str:
        tag = f"-r{self.n_replicas}" if self.n_replicas > 1 else ""
        # the positional engine's timed region excludes the anchor ->
        # position resolution, so it is labelled apart
        etag = "-pos" if self.engine_name == "v3" else ""
        return f"torch-{self.device.type}{tag}{etag}"

    @property
    def engine(self) -> DownstreamEngine:
        if self._eng is None:
            raise RuntimeError("call prepare(trace) first")
        return self._eng

    def prepare(self, trace: TestData) -> None:
        self._eng = DownstreamEngine(
            tensorize(trace, batch=self.batch), n_replicas=self.n_replicas,
            engine=self.engine_name, epoch=self.epoch, device=self.device,
        )
        self._end_len = len(trace.end_content)

    def replay_once(self) -> int:
        state = self.engine.run()
        lengths = state.nvis.cpu()  # device -> host: waits for the kernels
        if not bool((lengths == self._end_len).all()):
            raise RuntimeError(
                f"length mismatch: {lengths.tolist()[:8]} != {self._end_len}"
            )
        return int(lengths[0])

    def final_content(self) -> str:
        return self.engine.decode(self.engine.run())
