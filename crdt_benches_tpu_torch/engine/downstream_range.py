"""Range-layout downstream: run-granular update generation and the timed
apply (the JAX package's ``engine/downstream_range.py``, the ``range``
downstream column).

The unit-op downstream (``engine/downstream.py``) explodes block edits into
per-char ops, so its timed apply does work per character.  This module
keeps updates at the reference's own granularity (diamond-types encodes
sequential-insert runs, src/rope.rs:214): one wire op per contiguous insert
run or delete interval.

Wire form (generated untimed, like the reference's ``upstream_updates``):

- insert run: (anchor, rank, slot0, rlen, alive): the run's ``rlen``
  consecutive slots integrate directly after ``anchor`` (an element the
  receiver already has; -1 = document head), ordered among same-anchor
  runs by ``rank``; ``alive = 0`` runs arrive tombstoned (every char is
  deleted later in the same batch);
- delete interval: (dfirst, dlast), the element ids of the first and last
  earlier-batch targets; at apply time every visible element in the
  physical interval [pos(dfirst), pos(dlast)] is a target.

The timed apply resolves anchor, dfirst and dlast to current positions
inside the timed region (the epoch structure of ``ops/idpos.py``), then
integrates each batch with interval spreads, two capacity cumsums, the
arithmetic run fill and the no-cv fused apply K7 (``ops/expand.py
apply_fused_blocked``).  JAX spreads its run deltas in 3 x 7-bit chunks by
one-hot matmuls, which bounds its capacity below 2^20; here each spread is
one int32 ``scatter_add_``, and the port's bound is the fused apply's
int32 combo (capacity < 2^28).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..lint.boundary import boundary
from ..device import resolve_device
from ..ops.apply2 import (
    LANE,
    MAX_COMBO_CAPACITY,
    _excl_cumsum_small,
    _scatter_rows,
    _zeros_like_rows,
)
from ..ops.expand import apply_fused_blocked
from ..ops.idpos import make_level_runs, query, snap_rebuild
from ..traces.loader import TestData
from ..traces.tensorize import tensorize
from .downstream import (
    DownPacked,
    _prev_smaller,
    decode_packed,
    down_packed_init,
)
from .replay import _round_up, slot_char_table

I32 = torch.int32

_WIRE = ("anchor", "rank", "slot0", "rlen", "alive", "dfirst", "dlast")


@dataclass
class RangeUpdates:
    """One trace's range-granular updates as batched arrays (rows = wire
    batches, width = the most wire ops in a batch; -1/0 padding)."""

    anchor: np.ndarray  # int32[nb, W] insert-run anchor (-1 head, -2 pad)
    rank: np.ndarray  # int32[nb, W]
    slot0: np.ndarray  # int32[nb, W] first slot (-1 = not an insert)
    rlen: np.ndarray  # int32[nb, W]
    alive: np.ndarray  # int32[nb, W] 0/1
    dfirst: np.ndarray  # int32[nb, W] delete-interval first id (-1 = none)
    dlast: np.ndarray  # int32[nb, W]
    capacity: int
    n_init: int
    chars: np.ndarray
    end_content: str
    n_patches: int

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in _WIRE)


def generate_range_updates(
    trace: TestData, batch_ops: int = 256, lane: int = 128
) -> RangeUpdates:
    """Untimed generation on the host: the native treap's replay dump (the
    final order and every delete's target), then run extraction.

    Wire batches are ``batch_ops`` consecutive original range ops (one per
    patch component); anchors always reference elements of earlier wire
    batches (or the start content), ranks order same-anchor runs, and runs
    are split wherever a same-batch delete kills part of them or a
    same-batch op inserted inside them."""
    from ..backends.native import lib
    from ..traces.patches import patch_arrays

    tt = tensorize(trace, batch=512)
    capacity = _round_up(max(tt.capacity, 1), lane)
    n_init = len(tt.init_chars)

    # the native treap splices each local insert directly after its origin,
    # so its final order is the exact order the receiver's
    # anchor-directly-after rule reproduces (delete intervals rely on it)
    pa = patch_arrays(trace)
    n_del_total = int(pa.del_count.sum())
    order_buf = np.zeros(capacity, np.int32)
    vis_buf = np.zeros(capacity, np.uint8)
    dtgt_buf = np.zeros(max(n_del_total, 1), np.int32)
    length = int(lib().crdt_replay_dump(
        pa.init, len(pa.init), pa.pos, pa.del_count, pa.ins_off,
        pa.ins_flat, pa.n_patches, order_buf, capacity, vis_buf, dtgt_buf,
        len(dtgt_buf),
    ))
    if length <= 0:
        raise RuntimeError("native replay dump failed (buffer too small?)")
    order = order_buf[:length]

    # delete-target slots per unit delete op, in unit-op order (the native
    # log records deletes patch-interleaved like the unit explosion)
    dslot_unit = np.full(tt.n_ops, -1, np.int32)
    u = t = 0
    for _pos, dcount, ins in trace.iter_patches():
        if dcount:
            dslot_unit[u:u + dcount] = dtgt_buf[t:t + dcount]
            u += dcount
            t += dcount
        u += len(ins)

    # range ops (one per patch component), in unit-op order
    r_kind: list[int] = []  # INSERT=1 / DELETE=2
    r_a: list[int] = []  # unit-op start index
    r_len: list[int] = []
    u = 0
    for _pos, dcount, ins in trace.iter_patches():
        if dcount:
            r_kind.append(2)
            r_a.append(u)
            r_len.append(dcount)
            u += dcount
        if ins:
            r_kind.append(1)
            r_a.append(u)
            r_len.append(len(ins))
            u += len(ins)
    n_rops = len(r_kind)
    r_kind_a = np.asarray(r_kind, np.int32)
    r_a_a = np.asarray(r_a, np.int64)
    r_len_a = np.asarray(r_len, np.int64)
    rbatch = np.arange(n_rops, dtype=np.int64) // batch_ops
    nb = int(rbatch[-1]) + 1 if n_rops else 1

    # wire-batch index of every slot (insert unit ops) / -1 for the start
    batch_of_slot = np.full(capacity, -1, np.int64)
    for i in np.nonzero(r_kind_a == 1)[0]:
        s0 = tt.slot[r_a_a[i]]
        batch_of_slot[s0:s0 + r_len_a[i]] = rbatch[i]

    pos_of_slot = np.full(capacity, -1, np.int64)
    pos_of_slot[order] = np.arange(length)
    a_pos_all = _prev_smaller(batch_of_slot[order])

    # killed[slot]: deleted by a delete op in the same wire batch
    del_batch = np.full(capacity, -1, np.int64)
    for i in np.nonzero(r_kind_a == 2)[0]:
        del_batch[dslot_unit[r_a_a[i]:r_a_a[i] + r_len_a[i]]] = rbatch[i]
    killed = (del_batch >= 0) & (del_batch == batch_of_slot)

    # per-batch sorted final positions of the batch's slots: runs split
    # wherever a same-batch later op inserted inside them
    pos_by_batch = {b: np.sort(pos_of_slot[np.nonzero(batch_of_slot == b)[0]])
                    for b in range(nb)}

    rows: list[list[tuple]] = [[] for _ in range(nb)]
    for i in range(n_rops):
        b = int(rbatch[i])
        if r_kind_a[i] == 2:
            tgt = dslot_unit[r_a_a[i]:r_a_a[i] + r_len_a[i]]
            prev = tgt[~killed[tgt]]  # earlier-batch targets, doc order
            if len(prev):
                rows[b].append(("D", int(prev[0]), int(prev[-1]), len(prev)))
        else:
            s0 = int(tt.slot[r_a_a[i]])
            L = int(r_len_a[i])
            k = killed[s0:s0 + L]
            idx_pb = np.searchsorted(pos_by_batch[b], pos_of_slot[s0:s0 + L])
            cut = (np.diff(k.astype(np.int8)) != 0) | (np.diff(idx_pb) > 1)
            cuts = np.nonzero(cut)[0] + 1
            for a0, a1 in zip(np.concatenate([[0], cuts]),
                              np.concatenate([cuts, [L]])):
                rows[b].append(("I", s0 + int(a0), int(a1 - a0),
                                0 if k[a0] else 1))

    # anchors and ranks of every insert segment, from the final order
    seg_batch, seg_slot0 = [], []
    for b, ops in enumerate(rows):
        for op in ops:
            if op[0] == "I":
                seg_batch.append(b)
                seg_slot0.append(op[1])
    if seg_slot0:
        q0 = pos_of_slot[np.asarray(seg_slot0, np.int64)]
        a_pos = a_pos_all[q0]
        a_slot = np.where(a_pos >= 0, order[np.clip(a_pos, 0, None)], -1)
        sb = np.asarray(seg_batch, np.int64)
        srt = np.lexsort((q0, a_pos, sb))
        kb, ka = sb[srt], a_pos[srt]
        grp = np.concatenate([[True], (kb[1:] != kb[:-1])
                              | (ka[1:] != ka[:-1])])
        idx = np.arange(len(srt))
        r_sorted = idx - np.maximum.accumulate(np.where(grp, idx, 0))
        rank = np.empty_like(r_sorted)
        rank[srt] = r_sorted
    else:
        a_slot = rank = np.zeros(0, np.int64)

    W = max(1, max((len(ops) for ops in rows), default=1))
    anchor = np.full((nb, W), -2, np.int32)
    rank_a = np.zeros((nb, W), np.int32)
    slot0_a = np.full((nb, W), -1, np.int32)
    rlen_a = np.zeros((nb, W), np.int32)
    alive_a = np.zeros((nb, W), np.int32)
    dfirst = np.full((nb, W), -1, np.int32)
    dlast = np.full((nb, W), -1, np.int32)
    si = 0
    for b, ops in enumerate(rows):
        for j, op in enumerate(ops):
            if op[0] == "I":
                anchor[b, j] = a_slot[si]
                rank_a[b, j] = rank[si]
                slot0_a[b, j], rlen_a[b, j], alive_a[b, j] = op[1:]
                si += 1
            else:
                dfirst[b, j], dlast[b, j] = op[1], op[2]

    return RangeUpdates(
        anchor=anchor, rank=rank_a, slot0=slot0_a, rlen=rlen_a,
        alive=alive_a, dfirst=dfirst, dlast=dlast, capacity=capacity,
        n_init=n_init, chars=slot_char_table(tt, capacity),
        end_content=tt.end_content, n_patches=tt.n_patches,
    )


def _spread(idx, val, C: int):
    """Dense int32[R, C] with val[r, w] added at idx[r, w] (out-of-range
    indices dropped): the one-hot MXU spread of the JAX package as one
    int32 scatter-add."""
    return _scatter_rows(_zeros_like_rows(idx, C), idx, val)


def _chars_before(gap, rank, L):
    """For each run w of each row: the chars L of the runs ordered before
    it by (gap, rank), lexicographically.  JAX builds an (R, W, W) compare;
    here one sort of the int64 keys and a ``searchsorted`` into the
    inclusive prefix of L (exact: a sum of the keys strictly below)."""
    key = (gap.long() << 32) + (rank.long() + (1 << 31))
    ks, perm = torch.sort(key, dim=1)
    cum = torch.cumsum(L.gather(1, perm), dim=1, dtype=I32)
    n = torch.searchsorted(ks, key, right=False)
    return torch.where(n > 0, cum.gather(1, (n - 1).clamp(min=0)), 0)


def _apply_range_update_batch5(doc, length, nvis, snap, levels, anchor, rank,
                               slot0, rlen, alive, dfirst, dlast):
    """Integrate one range wire batch (wire rows int32[W], shared by every
    replica) with the id -> position resolution inside the timed region.
    Returns (doc, length, nvis, level)."""
    R, C = doc.shape
    W = anchor.shape[0]
    drop = C + 7
    col = torch.arange(C, dtype=I32, device=doc.device)
    is_ins = slot0 >= 0
    has_del = dfirst >= 0
    bc = lambda x: x[None, :].expand(R, W)
    ones = torch.ones((R, W), dtype=I32, device=doc.device)

    # anchors and delete-interval ends in one query
    allq = query(snap, levels,
                 torch.cat([anchor, dfirst, dlast])[None, :].expand(R, 3 * W))
    a_phys, lo_phys, hi_phys = allq.tensor_split(3, dim=1)
    gap = torch.where(bc(is_ins), torch.where(bc(anchor) >= 0, a_phys + 1, 0),
                      drop)

    # deletes: clear the visible bits over [lo, hi]
    lo = torch.where(bc(has_del), lo_phys, drop)
    hi1 = torch.where(bc(has_del), hi_phys + 1, drop - 6)
    in_del = torch.cumsum(_spread(lo, ones, C) - _spread(hi1, ones, C),
                          dim=1, dtype=I32) > 0
    sub = (doc & 1) * in_del.to(I32)
    doc_predel = doc - sub
    n_del_eff = sub.sum(dim=1, dtype=I32)

    # run destinations: the gap plus the chars of the runs ordered before
    L = torch.where(is_ins, rlen, 0)
    dest0 = torch.where(bc(is_ins), gap + _chars_before(gap, bc(rank), bc(L)),
                        drop)
    dstop = torch.where(bc(is_ins), dest0 + bc(rlen), drop - 7)

    # insert indicator and the expansion's per-tile count base
    ind = (torch.cumsum(_spread(dest0, ones, C) - _spread(dstop, ones, C),
                        dim=1, dtype=I32) > 0).to(I32)
    cnt_base = _excl_cumsum_small(
        ind.view(R, C // LANE, LANE).sum(dim=2, dtype=I32))

    # arithmetic fill: slot(d) = d + delta(run), painted as the cumsum of
    # the differences at run starts (runs in dest order)
    ordk = torch.where(bc(is_ins), dest0, drop)
    perm = torch.sort(ordk, dim=1, stable=True).indices
    d_sorted = dest0.gather(1, perm)
    s_sorted = bc(slot0).gather(1, perm)
    v_sorted = bc(alive).gather(1, perm)
    live_sorted = bc(is_ins).gather(1, perm)
    delta = torch.where(live_sorted, s_sorted - d_sorted, 0)
    prev = lambda x: torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    pl = prev(live_sorted)
    ddelta = torch.where(live_sorted, delta - torch.where(pl, prev(delta), 0),
                         0)
    dvis = torch.where(live_sorted,
                       v_sorted - torch.where(pl, prev(v_sorted), 0), 0)
    dpos = torch.where(live_sorted, d_sorted, drop)
    delta_cum = torch.cumsum(_spread(dpos, ddelta, C), dim=1, dtype=I32)
    vis_run = torch.cumsum(_spread(dpos, dvis, C), dim=1, dtype=I32)
    fill_slot = col + delta_cum
    combo = torch.where(ind > 0, ((((fill_slot + 2) << 1) | vis_run) << 1) | 1,
                        0)

    n_ins = torch.where(is_ins, rlen, 0).sum(dtype=I32)
    n_live = torch.where(is_ins, rlen * alive, 0).sum(dtype=I32)
    length2 = length + n_ins
    doc2 = apply_fused_blocked(doc_predel, combo, cnt_base, length2)
    level = make_level_runs(dest0, bc(rlen), bc(slot0), bc(is_ins))
    return doc2, length2, nvis + n_live - n_del_eff, level


@boundary(
    dtypes=(None, "int32", "int32", "int32", "int32", None, "int32",
            "int32"),
    shapes=(None, "N B", "N B", "N B", "N B", "N B", "N B", "N B"),
    donates=(0,),
)
def apply_range_updates5(state: DownPacked, anchor_b, rank_b, slot0_b,
                         rlen_b, alive_b, dfirst_b, dlast_b,
                         epoch: int = 32) -> DownPacked:
    """Every range wire batch (int32[N, W] each) into the packed state; the
    snapshot is rebuilt after every ``epoch`` batches and after the last,
    as in ``engine/downstream.py apply_updates5`` (the JAX engine pads the
    batch count to a multiple of ``epoch`` with no-op rows; here the last
    epoch is shorter)."""
    doc, snap, length, nvis = state
    N = anchor_b.shape[0]
    wire = (anchor_b, rank_b, slot0_b, rlen_b, alive_b, dfirst_b, dlast_b)
    for e0 in range(0, N, epoch):
        levels: list = []
        for i in range(e0, min(e0 + epoch, N)):
            doc, length, nvis, lv = _apply_range_update_batch5(
                doc, length, nvis, snap, levels, *(w[i] for w in wire))
            levels.append(lv)
        snap = snap_rebuild(doc)
    return DownPacked(doc, snap, length, nvis)


class RangeDownstreamEngine:
    """Untimed range-update generation, timed apply, R replicas wide on
    ``device``."""

    def __init__(self, trace: TestData, n_replicas: int = 1,
                 batch_ops: int = 256, epoch: int = 32,
                 device: str | torch.device = "cuda"):
        if epoch < 1:
            raise ValueError(f"epoch {epoch} < 1")
        self.device = resolve_device(device)
        self.upd = generate_range_updates(trace, batch_ops=batch_ops)
        if self.upd.capacity >= MAX_COMBO_CAPACITY:
            raise ValueError(
                f"capacity {self.upd.capacity} >= 2^28: the fused apply's "
                "combo operand would overflow int32"
            )
        self.n_replicas = n_replicas
        self.n_batches = self.upd.anchor.shape[0]
        self.epoch = min(epoch, max(1, self.n_batches))
        as_t = lambda a: torch.as_tensor(a, dtype=I32, device=self.device)
        self.wire = tuple(as_t(getattr(self.upd, f)) for f in _WIRE)
        self.chars = as_t(self.upd.chars)

    def init_state(self) -> DownPacked:
        return down_packed_init(self.n_replicas, self.upd.capacity,
                                self.upd.n_init, device=self.device)

    def run(self) -> DownPacked:
        """Fresh replicas (part of the timed region) and every batch."""
        return apply_range_updates5(self.init_state(), *self.wire,
                                    epoch=self.epoch)

    def decode(self, state: DownPacked, replica: int = 0) -> str:
        return decode_packed(state, self.chars, replica)


class TorchRangeDownstreamBackend:
    """Downstream bench backend on range-granular updates (the ``range``
    column): timed region = fresh replicas + the full apply + the length
    fetch, which waits for the device (the reference's src/main.rs:62-69;
    element = patch)."""

    def __init__(self, n_replicas: int = 1, batch_ops: int = 2048,
                 epoch: int = 32, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.batch_ops = batch_ops
        self.epoch = epoch
        self._eng: RangeDownstreamEngine | None = None
        self._end_len = 0

    @property
    def NAME(self) -> str:
        tag = f"-r{self.n_replicas}" if self.n_replicas > 1 else ""
        return f"torch-{self.device.type}{tag}-range"

    @property
    def engine(self) -> RangeDownstreamEngine:
        if self._eng is None:
            raise RuntimeError("call prepare(trace) first")
        return self._eng

    def prepare(self, trace: TestData) -> None:
        self._eng = RangeDownstreamEngine(
            trace, n_replicas=self.n_replicas, batch_ops=self.batch_ops,
            epoch=self.epoch, device=self.device,
        )
        self._end_len = len(trace.end_content)

    def replay_once(self) -> int:
        lengths = self.engine.run().nvis.cpu()  # waits for the kernels
        if not bool((lengths == self._end_len).all()):
            raise RuntimeError(
                f"length mismatch: {lengths.tolist()[:8]} != {self._end_len}"
            )
        return int(lengths[0])

    def final_content(self) -> str:
        return self.engine.decode(self.engine.run())
