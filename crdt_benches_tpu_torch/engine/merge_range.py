"""Run-granular concurrent merge: integrate whole insert runs per step
(the JAX package's ``engine/merge_range.py``; the ``range`` merge cell and
the ``runs``, ``patch`` and ``unitwire`` downstream columns).

The unit-op merge (``engine/merge.py``) integrates the delivered union one
element at a time.  diamond-types' own wire encoding is run-length encoded
(src/rope.rs:214); this module brings that granularity to the merge: one
wire op per contiguous insert run or delete interval, so the sequential
batch count scales with runs instead of characters.

Element ids are (lamport, agent) with lamport-consecutive runs: a run's
j-th element has key ``head_key + j * MAX_AGENTS``.  The union is
integrated in ascending head-key order, so each new run lands directly
after its anchor element.  Runs are atomic per batch, which is sound
unless a run head anchoring at a non-last element ``o`` ties ``o``'s chain
child on lamport with a smaller agent: :func:`check_no_skip` checks that on
the host, and callers fall back to the unit merge when it fails.

Within a batch, the run forest (same-batch anchor containment) is resolved
in parallel by :func:`_run_batch_fragments`: a child run anchored mid-parent
splits the parent, so the batch emits up to 2W fragments in the wire form
of the range downstream apply (``engine/downstream_range.py
_apply_range_update_batch5``, K7), which integrates them.  Deletes commute
and positions are physical, so delete intervals fold once after every
insert (:func:`delete_fold`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..lint.boundary import boundary
from ..device import resolve_device
from ..ops.apply2 import MAX_COMBO_CAPACITY
from ..ops.idpos import snap_rebuild
from ..traces.loader import TestData
from ..traces.tensorize import DELETE, INSERT, tensorize
from .downstream import DownPacked, decode_packed, down_packed_init
from .downstream_range import _apply_range_update_batch5
from .merge import INT32_MAX, MAX_AGENTS, MergeSimulation, OpLog

I32 = torch.int32

#: Head key of a padding run (sorts after every real run).
BIGKEY = INT32_MAX

GRANULARITIES = ("coalesced", "patch", "unit")
SCHEDULES = ("flat", "batched")


@dataclass
class RunLog:
    """One agent's op log as runs (the RLE wire form, numpy).

    Insert runs: ``rlen`` lamport- and slot-consecutive elements;
    ``origin`` is the head's origin slot (-1 = document head) and element j
    chains on element j - 1.  Delete intervals: inclusive slot ranges
    [dlo, dhi]."""

    lamport: np.ndarray  # int32[Nr] head lamport
    agent: np.ndarray  # int32[Nr]
    slot0: np.ndarray  # int32[Nr]
    rlen: np.ndarray  # int32[Nr]
    origin: np.ndarray  # int32[Nr] head origin slot (-1 = doc head)
    dlo: np.ndarray  # int32[Nd] delete interval first slot
    dhi: np.ndarray  # int32[Nd] delete interval last slot
    n_unit_ops: int  # unit ops this log compresses (element count)


def runs_from_oplog(log: OpLog,
                    patch_start: np.ndarray | None = None) -> RunLog:
    """Run-length encode a lamport-ascending unit-op log into insert runs
    and delete intervals (host, untimed: wire translation).

    ``patch_start`` (optional bool[len(log)]): force a break wherever True,
    the per-patch wire granularity (one update per trace patch, as the
    reference generates them, src/rope.rs:196-220).  None = maximal RLE."""
    lam, ag, kind = log.lamport, log.agent, log.kind
    elem, orig = log.elem, log.origin
    is_ins = kind == INSERT
    prev_elem = np.roll(elem, 1)
    cont = (is_ins & np.roll(is_ins, 1) & (orig == prev_elem)
            & (lam == np.roll(lam, 1) + 1) & (elem == prev_elem + 1))
    if patch_start is not None:
        cont &= ~patch_start
    if len(cont):
        cont[0] = False
    head = is_ins & ~cont
    hidx = np.nonzero(head)[0]
    run_id = np.cumsum(head) - 1
    rlen = np.bincount(run_id[is_ins], minlength=len(hidx)).astype(np.int32)

    # delete intervals: ascending-contiguous target slots coalesce
    didx = np.nonzero(kind == DELETE)[0]
    dtgt = elem[didx]
    if len(dtgt):
        brk = np.concatenate([[True], np.diff(dtgt) != 1])
        if patch_start is not None:
            brk |= patch_start[didx]
        d0 = np.nonzero(brk)[0]
        d1 = np.concatenate([d0[1:], [len(dtgt)]])
        dlo = dtgt[d0].astype(np.int32)
        dhi = dtgt[d1 - 1].astype(np.int32)
    else:
        dlo = dhi = np.zeros(0, np.int32)

    return RunLog(
        lamport=lam[hidx].astype(np.int32), agent=ag[hidx].astype(np.int32),
        slot0=elem[hidx].astype(np.int32), rlen=rlen,
        origin=orig[hidx].astype(np.int32), dlo=dlo, dhi=dhi,
        n_unit_ops=int(is_ins.sum() + len(didx)),
    )


def check_no_skip(runlogs: list[RunLog]) -> bool:
    """The host precondition of run-atomic integration: every run head
    anchoring at a non-last element ``o`` of some run must outrank o's
    chain child, i.e. NOT (head.lamport == o.lamport + 1 AND head.agent <
    o.agent).  True = the run merge is exact."""
    slot0 = np.concatenate([r.slot0 for r in runlogs])
    if not len(slot0):
        return True
    rlen = np.concatenate([r.rlen for r in runlogs])
    lam0 = np.concatenate([r.lamport for r in runlogs])
    ag = np.concatenate([r.agent for r in runlogs])
    order = np.argsort(slot0)
    s0, rl, l0, a0 = slot0[order], rlen[order], lam0[order], ag[order]
    for r in runlogs:
        m = r.origin >= 0
        if not m.any():
            continue
        o = r.origin[m]
        j = np.clip(np.searchsorted(s0, o, side="right") - 1, 0, len(s0) - 1)
        off = o - s0[j]
        has_child = (off >= 0) & (off < rl[j] - 1)
        bad = has_child & (r.lamport[m] == l0[j] + off + 1) & (
            r.agent[m] < a0[j])
        if bad.any():
            return False
    return True


# ---- device integration -----------------------------------------------------


def _closure(A):
    """Proper-ancestor closure of the bool parent matrix A[W, W] by log2 W
    squarings.  fp32 operands: 0/1 entries and sums of at most W are exact
    (JAX multiplies bf16 with fp32 accumulation; a bf16 product on CUDA
    returns bf16, which rounds a sum above 256)."""
    W = A.shape[0]
    for _ in range(max(1, (W - 1).bit_length())):
        Af = A.float()
        A = A | ((Af @ Af) > 0)
    return A


def _run_batch_fragments(key, slot0, rlen, origin):
    """One batch's run forest -> integration fragments, W x W work shared
    by every replica (the run-granular ``engine/merge.py
    _chain_structure``).

    Inputs are the batch's runs (int32[W]) sorted ascending by ``key``
    (BIGKEY rows = padding).  Returns fragment arrays int32[2W]: (anchor
    slot, char-offset rank within the anchor's gap group, slot0, rlen);
    invalid fragments have slot0 == -1 and rlen == 0."""
    W = key.shape[0]
    j = torch.arange(W, dtype=I32, device=key.device)
    live = (key < BIGKEY) & (rlen > 0)
    s = lambda x, dim: x.sum(dim=dim, dtype=I32)

    # parent: the same-batch run that holds my head's origin element
    inside = ((origin[:, None] >= slot0[None, :])
              & (origin[:, None] < (slot0 + rlen)[None, :])
              & live[None, :] & live[:, None])
    parent = s(torch.where(inside, j[None, :] + 1, 0), 1) - 1
    internal = parent >= 0
    # chars of the parent before my splice point
    off = torch.where(
        internal, origin - s(torch.where(inside, slot0[None, :], 0), 1) + 1,
        0)

    A = _closure((parent[:, None] == j[None, :]) & internal[:, None])
    AoS = A | ((j[:, None] == j[None, :]) & live[:, None])
    size = rlen + s(torch.where(A, rlen[:, None], 0), 0)

    # frame precedence M[a, b]: a's subtree entirely before b's at a shared
    # frame (same internal parent, or roots sharing an external anchor);
    # newest first: at one offset the larger op index goes first
    both = live[:, None] & live[None, :]
    same_int = (internal[:, None] & internal[None, :]
                & (parent[:, None] == parent[None, :]))
    root_pair = (~internal[:, None] & ~internal[None, :]
                 & (origin[:, None] == origin[None, :]))
    framed = both & (same_int | root_pair) & (j[:, None] != j[None, :])
    less = (off[:, None] < off[None, :]) | (
        (off[:, None] == off[None, :]) & (j[:, None] > j[None, :]))
    M = framed & less

    # g before r as a whole subtree: g frame-precedes an ancestor-or-self
    # of r (fp32 operands, exact as in _closure)
    topb = (M.float() @ AoS.float().T) > 0
    rank_chars = s(torch.where(topb, size[:, None], 0), 0) + s(
        torch.where(AoS, torch.where(internal, off, 0)[None, :], 0), 1)

    # external anchor: my root's origin
    is_root = live & ~internal
    root = s(torch.where(AoS & is_root[None, :], j[None, :] + 1, 0), 1) - 1
    anchor = torch.where(live, origin[root.clamp(0, W - 1).long()], -2)
    anchor = torch.where(live & ~internal, origin, anchor)

    # fragments: the head piece of run w, chars [0, first cut); the parent
    # piece after w's cut, chars [off_w, next cut), owned by the oldest
    # (smallest op index) child at (parent, off)
    big = torch.full((), 1 << 30, dtype=I32, device=key.device)
    child_of = (parent[None, :] == j[:, None]) & internal[None, :]  # [p, c]
    first_cut = torch.where(child_of, off[None, :], big).amin(dim=1)
    head_len = torch.minimum(rlen, first_cut)
    # (a row of -1 picks the last row, as JAX's negative index does; only
    # internal rows are read)
    next_cut = torch.where(child_of[parent.long()] & (off[None, :]
                                                      > off[:, None]),
                           off[None, :], big).amin(dim=1)
    p_idx = parent.clamp(0, W - 1).long()
    piece_len = torch.minimum(rlen[p_idx], next_cut) - off
    same_cut = ((parent[None, :] == parent[:, None]) & internal[None, :])
    owner = internal & (s(same_cut & (off[None, :] == off[:, None])
                          & (j[None, :] < j[:, None]), 1) == 0)
    # chars of sibling subtrees cut at or before my offset
    sib_before = s(torch.where(same_cut & (off[None, :] <= off[:, None]),
                               size[None, :], 0), 1)
    piece_rank = rank_chars[p_idx] + off + sib_before
    piece_slot0 = slot0[p_idx] + off
    piece_anchor = anchor[p_idx]

    f_anchor = torch.cat([torch.where(live, anchor, -2),
                          torch.where(owner, piece_anchor, -2)])
    f_rank = torch.cat([torch.where(live, rank_chars, 0),
                        torch.where(owner, piece_rank, 0)])
    f_slot0 = torch.cat([torch.where(live & (head_len > 0), slot0, -1),
                         torch.where(owner & (piece_len > 0), piece_slot0,
                                     -1)])
    f_rlen = torch.cat([torch.where(live, head_len, 0),
                        torch.where(owner, piece_len.clamp(min=0), 0)])
    f_rlen = torch.where(f_slot0 >= 0, f_rlen, 0)
    return f_anchor, f_rank, f_slot0, f_rlen


def _arrange_runs(lamport, agent, slot0, rlen, origin):
    """The causal order of run heads: (key, slot0, rlen, origin) sorted by
    head key (stable, as JAX's ``argsort``; padding rows last)."""
    key = torch.where(rlen > 0, lamport * MAX_AGENTS + agent, BIGKEY)
    perm = torch.sort(key, stable=True).indices
    return key[perm], slot0[perm], rlen[perm], origin[perm]


@boundary(
    dtypes=(None, "int32", "int32", "int32", "int32", "int32"),
    shapes=(None, "N", "N", "N", "N", "N"),
    donates=(0,),
)
def merge_runlogs(state: DownPacked, lamport, agent, slot0, rlen, origin,
                  *, batch: int = 256, epoch: int = 8) -> DownPacked:
    """Integrate a union of insert-run logs (int32[N] tensors; delete
    intervals fold separately, :func:`delete_fold`): the causal-order sort
    of run heads (:func:`_arrange_runs`), then per batch the fragments and
    the range apply, the snapshot rebuilt after each ``epoch`` batches.  N
    must be a multiple of ``batch * epoch`` (pad with rlen == 0 rows)."""
    key, slot0, rlen, origin = _arrange_runs(lamport, agent, slot0, rlen,
                                             origin)
    NB = key.shape[0] // batch
    K = min(epoch, NB)
    if NB % K or key.shape[0] % batch:
        raise ValueError(f"{key.shape[0]} runs not a multiple of "
                         f"batch {batch} x epoch {K}")
    neg1 = torch.full((2 * batch,), -1, dtype=I32, device=key.device)
    doc, snap, length, nvis = state
    for e0 in range(0, NB, K):
        levels: list = []
        for k in range(e0, e0 + K):
            sl = slice(k * batch, (k + 1) * batch)
            fa, fr, fs, fl = _run_batch_fragments(key[sl], slot0[sl],
                                                  rlen[sl], origin[sl])
            doc, length, nvis, lv = _apply_range_update_batch5(
                doc, length, nvis, snap, levels, fa, fr, fs, fl,
                torch.ones_like(fa),  # alive: deletes fold later
                neg1, neg1)  # no delete intervals
            levels.append(lv)
        snap = snap_rebuild(doc)
    return DownPacked(doc, snap, length, nvis)


def delete_fold(state: DownPacked, dlo, dhi) -> DownPacked:
    """Fold every delete interval (int32[Nd], slot ranges; dlo < 0 = none)
    in one pass: paint a killed-slot indicator from the intervals, scatter
    it through the slot -> position snapshot (exact here: both schedules
    end with it), clear visibility."""
    R, C = state.doc.shape
    dev = state.doc.device
    on = (dlo >= 0).to(I32)
    starts = torch.zeros(C + 1, dtype=I32, device=dev).index_add_(
        0, dlo.clamp(0, C).long(), on)
    stops = torch.zeros(C + 1, dtype=I32, device=dev).index_add_(
        0, (dhi + 1).clamp(0, C).long(), on)
    killed = (torch.cumsum(starts - stops, dim=0, dtype=I32)[:C] > 0).to(I32)
    # positions outside [0, C) (the flat schedule's -1 for unused slots)
    # go to a spill column
    snap = state.snap
    tgt = torch.where((snap >= 0) & (snap < C), snap, C).long()
    kill_doc = torch.zeros((R, C + 1), dtype=I32, device=dev).scatter_add_(
        1, tgt, killed.expand(R, C))[:, :C]
    vis = state.doc & 1
    newvis = vis * (kill_doc == 0).to(I32)
    in_doc = torch.arange(C, device=dev) < state.length[:, None]
    return DownPacked(doc=state.doc - (vis - newvis), snap=snap,
                      length=state.length,
                      nvis=(newvis * in_doc.to(I32)).sum(dim=1, dtype=I32))


# ---- host side -------------------------------------------------------------


class RunMergeSimulation:
    """Run-granular view over a :class:`MergeSimulation`: RLE wire
    translation (untimed), the precondition check, the device merge and
    the delete fold.  The wire is uploaded once, on the simulation's
    device."""

    def __init__(self, sim: MergeSimulation, batch: int = 256,
                 epoch: int = 8,
                 patch_starts: list[np.ndarray] | None = None):
        # the port's one capacity bound: the fused apply's int32 combo (the
        # JAX engine's 2^20 bounds its 3 x 7-bit delta chunks)
        if sim.capacity >= MAX_COMBO_CAPACITY:
            raise ValueError(
                f"capacity {sim.capacity} >= 2^28: the fused apply's combo "
                "operand would overflow int32; use the unit merge"
            )
        self.sim = sim
        self.batch = batch
        self.epoch = epoch
        # patch_starts: per-agent forced break masks; None = maximal RLE
        self.runlogs = [
            runs_from_oplog(lg, None if patch_starts is None
                            else patch_starts[i])
            for i, lg in enumerate(sim.agent_logs)
        ]
        self.fast_ok = check_no_skip(self.runlogs)
        self.n_runs = int(sum(len(r.slot0) for r in self.runlogs))
        self.n_unit_ops = int(sum(r.n_unit_ops for r in self.runlogs))
        cat = lambda f: np.concatenate([getattr(r, f) for r in self.runlogs])
        n = self.n_runs
        m = batch * min(epoch, max(1, -(-n // batch)))
        z = lambda fill: np.full((-n) % m, fill, np.int32)
        lamport = np.concatenate([cat("lamport"), z(0)])
        agent = np.concatenate([cat("agent"), z(0)])
        slot0 = np.concatenate([cat("slot0"), z(-1)])
        rlen = np.concatenate([cat("rlen"), z(0)])
        origin = np.concatenate([cat("origin"), z(-2)])
        if int(lamport.max(initial=0)) * MAX_AGENTS + MAX_AGENTS >= BIGKEY:
            raise ValueError("lamport too large for the packed run key")
        # sorted by head key on the host, as JAX does to size its batches;
        # the device sort inside the timed merge is then the identity
        key = np.where(rlen > 0, lamport * MAX_AGENTS + agent, BIGKEY)
        perm = np.argsort(key, kind="stable")
        self.lamport, self.agent = lamport[perm], agent[perm]
        self.slot0, self.rlen, self.origin = slot0[perm], rlen[perm], origin[
            perm]
        self.dlo, self.dhi = cat("dlo"), cat("dhi")
        self.epoch_eff = min(epoch, len(self.lamport) // batch)
        dev = sim.device
        t = lambda a: torch.as_tensor(a, dtype=I32, device=dev)
        self._dev = tuple(t(a) for a in (self.lamport, self.agent,
                                         self.slot0, self.rlen, self.origin))
        self._dev_del = ((t(self.dlo), t(self.dhi)) if len(self.dlo)
                         else None)

    def _check(self) -> None:
        if not self.fast_ok:
            raise ValueError(
                "run-atomic precondition violated; use the unit merge")

    def merge(self, n_replicas: int = 1) -> DownPacked:
        """Timed region: fresh replicas, the whole run integration and the
        delete fold (callers add the convergence check)."""
        self._check()
        st = down_packed_init(n_replicas, self.sim.capacity, self.sim.n_base,
                              device=self.sim.device)
        if self.n_runs:
            st = merge_runlogs(st, *self._dev, batch=self.batch,
                               epoch=self.epoch_eff)
        if self._dev_del is not None:
            st = delete_fold(st, *self._dev_del)
        return st

    def merge_flat(self, n_replicas: int = 1) -> DownPacked:
        """Timed region of the one-shot schedule: the whole wire in one
        pass (``engine/downstream_flat.py flatten_runs``), then the delete
        fold.  Same wire, preconditions and final state as :meth:`merge`."""
        from .downstream_flat import flatten_runs

        self._check()
        lam, ag, s0, rl, orig = self._dev
        key = torch.where(rl > 0, lam * MAX_AGENTS + ag, BIGKEY)
        st = flatten_runs(
            key, s0, rl, orig, n_base=self.sim.n_base,
            capacity=self.sim.capacity,
            n_elems=self.sim.n_base + int(self.rlen.sum()),
            n_replicas=n_replicas,
        )
        if self._dev_del is not None:
            st = delete_fold(st, *self._dev_del)
        return st

    def decode(self, state: DownPacked, replica: int = 0) -> str:
        return decode_packed(state, self.sim.chars, replica)


class TorchRunDownstreamBackend:
    """Downstream bench backend at run granularity (the ``runs``, ``patch``
    and ``unitwire`` columns): a single-writer log is the one-agent case of
    the run merge, so the RLE'd wire stream integrates through it, with the
    anchor resolution, fragment placement and delete fold inside the timed
    region and the wire translation untimed (src/main.rs:60).

    ``granularity``: ``coalesced`` (maximal RLE, diamond-types' internal
    oplog form), ``patch`` (one wire update per trace patch component, the
    reference's own generation granularity) or ``unit`` (every run length
    1, the v5 engine's wire).  ``schedule``: ``flat`` (default, the one-shot
    ``engine/downstream_flat.py``) or ``batched`` (:func:`merge_runlogs`);
    same wire, same final state."""

    def __init__(self, n_replicas: int = 1, batch: int = 512, epoch: int = 8,
                 granularity: str = "coalesced", schedule: str = "flat",
                 device: str | torch.device = "cuda"):
        if granularity not in GRANULARITIES:
            raise ValueError(f"unknown granularity {granularity!r}")
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        self.device = resolve_device(device)
        self.n_replicas = n_replicas
        self.batch = batch
        self.epoch = epoch
        self.granularity = granularity
        self.schedule = schedule
        self._rm: RunMergeSimulation | None = None
        self._end_len = 0

    @property
    def NAME(self) -> str:
        tag = f"-r{self.n_replicas}" if self.n_replicas > 1 else ""
        kind = {"coalesced": "runs", "patch": "patch",
                "unit": "unitwire"}[self.granularity]
        kind += "-flat" if self.schedule == "flat" else ""
        return f"torch-{self.device.type}{tag}-{kind}"

    @property
    def engine(self) -> RunMergeSimulation:
        if self._rm is None:
            raise RuntimeError("call prepare(trace) first")
        return self._rm

    def prepare(self, trace: TestData) -> None:
        tt = tensorize(trace, batch=512)
        sim = MergeSimulation([tt], base=trace.start_content,
                              batch=self.batch, device=self.device)
        patch_starts = None
        if self.granularity == "patch":
            ps = np.zeros(tt.n_ops, bool)
            u = 0
            for _pos, d, ins in trace.iter_patches():
                ps[u] = True
                u += d + len(ins)
            patch_starts = [ps]
        elif self.granularity == "unit":
            patch_starts = [np.ones(tt.n_ops, bool)]
        self._rm = RunMergeSimulation(sim, batch=self.batch, epoch=self.epoch,
                                      patch_starts=patch_starts)
        if not self._rm.fast_ok:  # one writer: always holds
            raise RuntimeError("single-writer wire violates the run "
                               "precondition")
        self._end_len = len(trace.end_content)

    def _merge(self) -> DownPacked:
        fn = (self.engine.merge_flat if self.schedule == "flat"
              else self.engine.merge)
        return fn(n_replicas=self.n_replicas)

    def replay_once(self) -> int:
        lengths = self._merge().nvis.cpu()  # waits for the device
        if not bool((lengths == self._end_len).all()):
            raise RuntimeError(
                f"length mismatch: {lengths.tolist()[:8]} != {self._end_len}"
            )
        return int(lengths[0])

    def final_content(self) -> str:
        return self.engine.decode(self._merge())
