"""Multi-agent concurrent merge: divergent replicas -> converged document
(the JAX package's ``engine/merge.py``; the reference's merge capability,
diamond-types' ``decode_and_add`` and automerge's ``doc.merge``,
src/rope.rs:222-235).

Every element has a globally unique id ``(lamport, agent)``; every op is
``INSERT(elem, origin, ch)`` or ``DELETE(target)``.  Sorting the union of
the agents' op logs by ``(lamport, agent)`` gives a causal total order, and
integrating in that order with each insert placed directly after its
origin gives the RGA document order (a later sibling under one origin
lands closer to it).  So a merge is a sort and a dedup, then batched
integration:

- :func:`merge_oplogs` (v1, the slot-indexed ``DownState``): per batch, a
  splice of same-batch origin chains and pointer doubling to (head, rank),
  then the counting merge of ``engine/downstream.py apply_update_batch``;
- :func:`merge_oplogs_packed` (the packed ``DownPacked``, the merge
  cells' path): per batch, the chain structure of :func:`_chain_structure`
  in the downstream anchor/rank wire form, integrated by the v5 apply
  ``_apply_update_batch5`` (the idpos query, the producer and K7).

Sorts are stable wherever the JAX ones are (``torch.sort`` is not stable by
default), and every scatter that JAX runs with ``mode="drop"`` routes its
out-of-range indices to a spill column that is sliced off.  The wire-side
work (the sort, the chain structure) is computed once for all replicas, as
in JAX; only the state apply runs per replica.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..lint.boundary import boundary
from ..device import resolve_device
from ..ops.apply import init_state
from ..ops.apply2 import MAX_COMBO_CAPACITY
from ..ops.idpos import snap_rebuild
from ..traces.tensorize import DELETE, INSERT, PAD, TensorizedTrace
from .downstream import (
    DownPacked,
    DownState,
    _apply_update_batch5,
    apply_update_batch,
    decode_packed,
    down_packed_init,
    init_down_state,
)
from .replay import _round_up, decode_to_str, replay_batches_collect

I32 = torch.int32
INT32_MAX = 2**31 - 1

#: Agent-id capacity of the packed rank key (lamport * MAX_AGENTS + agent).
MAX_AGENTS = 64

_LOG_FIELDS = ("lamport", "agent", "kind", "elem", "origin", "ch")


@dataclass
class OpLog:
    """One agent's op log in exchange ("wire") format (numpy).

    ``elem``: the inserted element's global slot (INSERT) or the target
    slot (DELETE).  ``origin``: global slot of the left-origin element (-1
    = document head); -2 for deletes.  ``lamport``: per-op Lamport clock.
    """

    lamport: np.ndarray  # int32[N]
    agent: np.ndarray  # int32[N]
    kind: np.ndarray  # int32[N]  PAD / INSERT / DELETE
    elem: np.ndarray  # int32[N]
    origin: np.ndarray  # int32[N]
    ch: np.ndarray  # int32[N]

    def __len__(self) -> int:
        return len(self.lamport)

    @staticmethod
    def concat(logs: "list[OpLog]") -> "OpLog":
        return OpLog(*(np.concatenate([getattr(lg, f) for lg in logs])
                       for f in _LOG_FIELDS))


def agent_oplog(
    tt: TensorizedTrace, agent: int, slot_base: int, n_base: int,
    device: str | torch.device = "cuda",
) -> OpLog:
    """Agent ``agent``'s op log, from one replay of its local edit stream on
    ``device`` (the v1 replay with K5, untimed, like the reference's update
    generation, src/main.rs:60).

    The agent starts from the shared base document (global slots
    ``0..n_base-1``); its local insert slot ``k >= n_base`` maps to global
    slot ``slot_base + (k - n_base)``.  Local op ``i`` gets Lamport clock
    ``n_base + 1 + i``: it has seen the base and its own prior ops.
    """
    if len(tt.init_chars) != n_base:
        raise ValueError("all agents must share the same base document")
    dev = resolve_device(device)
    capacity = _round_up(max(tt.capacity, 1), 128)
    kind_b, pos_b, _, slot_b = tt.batched()
    as_t = lambda a: torch.as_tensor(a, dtype=I32, device=dev)
    state, dslot_b = replay_batches_collect(
        init_state(1, capacity, n_base, device=dev),
        as_t(kind_b), as_t(pos_b), as_t(slot_b),
    )
    origin_local = state.origin[0].cpu().numpy()
    dslot = dslot_b[:, 0].cpu().numpy().reshape(-1)[: tt.n_ops]

    def to_global(local: np.ndarray) -> np.ndarray:
        return np.where(
            local < 0, local,
            np.where(local < n_base, local, slot_base + (local - n_base)),
        ).astype(np.int32)

    n = tt.n_ops
    kind = tt.kind[:n].astype(np.int32)
    is_ins = kind == INSERT
    elem = np.where(is_ins, to_global(tt.slot[:n]), to_global(dslot))
    origin = np.where(
        is_ins, to_global(origin_local[np.clip(tt.slot[:n], 0, None)]), -2
    ).astype(np.int32)
    return OpLog(
        lamport=(n_base + 1 + np.arange(n, dtype=np.int32)),
        agent=np.full(n, agent, np.int32),
        kind=kind,
        elem=elem.astype(np.int32),
        origin=origin,
        ch=tt.ch[:n].astype(np.int32),
    )


# ---- the causal order -------------------------------------------------------


def _rank_sorted_segments(lamport, agent, kind, elem, origin, ch,
                          segments: tuple[int, ...]):
    """The causal-order arrangement of a union that is a concatenation of
    per-agent logs, each already lamport-sorted (the natural wire layout):
    every op's rank is its index in its segment plus, for each other
    segment, the count of that segment's keys below its own (one
    ``searchsorted`` a segment pair; the JAX package runs these counts in
    65,536-query chunks, which only bound a TPU buffer).

    Keys are (lamport, agent) packed as lamport * MAX_AGENTS + agent (the
    caller guards int32); PAD keys are per-segment sentinels just below
    int32 max, so every rank is distinct and one permutation arranges the
    arrays.  Returns (lamport, agent, kind, elem, origin, ch) with only
    kind, elem and origin arranged, as in JAX: integration reads no other
    field."""
    n = lamport.shape[0]
    nseg = len(segments)
    bounds = np.concatenate([[0], np.cumsum(np.asarray(segments))])
    if bounds[-1] != n:
        raise ValueError(f"segments sum to {bounds[-1]}, not {n}")
    seg_id = torch.zeros(n, dtype=I32, device=lamport.device)
    for s in range(1, nseg):
        seg_id[int(bounds[s]):] += 1
    key = torch.where(kind == PAD, INT32_MAX - nseg + seg_id,
                      lamport * MAX_AGENTS + agent)
    seg = [key[int(bounds[s]):int(bounds[s + 1])] for s in range(nseg)]
    parts = []
    for s in range(nseg):
        r = torch.arange(seg[s].shape[0], dtype=I32, device=key.device)
        for s2 in range(nseg):
            if s2 != s:
                # count_lt: keys are distinct across segments
                r += torch.searchsorted(seg[s2], seg[s], out_int32=True)
        parts.append(r)
    rank = torch.cat(parts).long()
    inv = torch.empty_like(rank)
    inv[rank] = torch.arange(n, device=rank.device)
    return lamport, agent, kind[inv], elem[inv], origin[inv], ch


def _sort_dedup(lamport, agent, kind, elem, origin, ch):
    """Sort ops by (lamport, agent), PAD ops last, and PAD out exact
    duplicates (idempotent delivery).  Two stable argsorts, agent then
    lamport, as in JAX."""
    is_pad = kind == PAD
    lam_k = torch.where(is_pad, INT32_MAX, lamport)
    p1 = torch.sort(agent, stable=True).indices
    p2 = torch.sort(lam_k[p1], stable=True).indices
    perm = p1[p2]
    lam_s, ag_s = lam_k[perm], agent[perm]
    dup = torch.zeros_like(is_pad)
    dup[1:] = ((lam_s[1:] == lam_s[:-1]) & (ag_s[1:] == ag_s[:-1])
               & (lam_s[1:] < INT32_MAX))
    kind = torch.where(dup, PAD, kind[perm])
    return (lamport[perm], agent[perm], kind, elem[perm], origin[perm],
            ch[perm])


# ---- v1: splice and pointer doubling on the slot-indexed state -------------


def _splice_rank(kind, elem, origin, C: int):
    """The wire side of :func:`_integrate_batch` for one id-sorted batch
    (numpy int32[B] each): per insert, the external anchor element (-1 =
    document head) and its rank among the chain under that anchor.  The
    successor splice is a sequential loop over the batch's ops (JAX's
    ``lax.scan``), run on the host: it reads only the shared wire."""
    B = kind.shape[0]
    j32 = np.arange(B, dtype=np.int32)
    is_ins = kind == INSERT
    opof = np.full(C + 1, -1, np.int32)
    opof[np.where(is_ins & (elem >= 0) & (elem < C), elem, C)] = j32
    opof[C] = -1
    org_op = np.where(origin >= 0, opof[np.clip(origin, 0, C - 1)], -1)
    internal = is_ins & (org_op >= 0) & (org_op < j32)
    # representative head per external-origin group: its smallest op index
    ext_origin = np.where(is_ins & ~internal, origin, -2)
    hidx = np.clip(ext_origin, -1, C - 1) + 1
    headof = np.full(C + 1, B, np.int32)
    np.minimum.at(headof, hidx, np.where(ext_origin >= -1, j32, B))
    rep = np.where(is_ins & ~internal, headof[hidx], -1)

    # node space: 0..B-1 batch inserts, B + r the sentinel of rep r, 2B nil
    NIL = 2 * B
    nxt = [NIL] * (2 * B + 1)
    for j, ins, intern, k, r in zip(range(B), is_ins.tolist(),
                                    internal.tolist(), org_op.tolist(),
                                    rep.tolist()):
        if ins:
            pred = k if intern else B + r
            nxt[j] = nxt[pred]
            nxt[pred] = j
    nxt = np.asarray(nxt, np.int32)

    # pointer doubling of predecessors to (sentinel head, rank)
    node = np.arange(2 * B + 1, dtype=np.int32)
    pred0 = np.full(2 * B + 1, NIL, np.int32)
    pred0[np.where(nxt < NIL, nxt, NIL)] = node
    pred0[NIL] = NIL
    is_root = node >= B
    par = np.where(is_root, node, pred0[node])
    dist = np.where(is_root | (par == node), 0, 1).astype(np.int32)
    for _ in range(max(1, (2 * B).bit_length())):
        par, dist = par[par], dist + np.where(par != node, dist[par], 0)
    head_op = par[:B] - B
    rank = dist[:B] - 1
    anchor = origin[np.clip(head_op, 0, B - 1)]
    return anchor.astype(np.int32), rank.astype(np.int32)


def _integrate_batch(state: DownState, kind, elem, origin):
    """Integrate one id-sorted op batch (numpy int32[B] each, shared by
    every replica) into the slot-indexed state: the chain splice and rank
    (:func:`_splice_rank`), then the downstream counting merge, which is
    the same computation as JAX's tail of ``_integrate_batch``."""
    C = state.order.shape[1]
    anchor, rank = _splice_rank(kind, elem, origin, C)
    is_ins = kind == INSERT
    dev = state.order.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    return apply_update_batch(
        state, t(np.where(is_ins, elem, -1)), t(np.where(is_ins, anchor, -1)),
        t(rank), t(np.where(kind == DELETE, elem, -1)),
    )


def merge_oplogs(state: DownState, lamport, agent, kind, elem, origin, ch,
                 *, batch: int = 256) -> DownState:
    """Merge a union of op logs (int32[N] tensors; any delivery order,
    duplicates allowed) into ``state``.  N must be a multiple of ``batch``
    (PAD-pad beforehand)."""
    if kind.shape[0] % batch:
        raise ValueError(f"{kind.shape[0]} ops not a multiple of {batch}")
    _, _, kind, elem, origin, _ = _sort_dedup(lamport, agent, kind, elem,
                                              origin, ch)
    kind, elem, origin = (x.cpu().numpy() for x in (kind, elem, origin))
    for b0 in range(0, kind.shape[0], batch):
        sl = slice(b0, b0 + batch)
        state = _integrate_batch(state, kind[sl], elem[sl], origin[sl])
    return state


# ---- the packed path --------------------------------------------------------


def _chain_structure(kind, elem, origin):
    """One batch's RGA chain structure (int32[B] tensors), in parallel.

    The batch's inserts form a forest: an insert whose origin was inserted
    in this batch points at that op (its parent); the rest are roots
    grouped by external origin.  Children of a node end up in descending
    op order, so each insert's rank under its external anchor is

      rank(x) = depth(x) + sum over ancestors-or-self x' of
                (total subtree size of x''s larger-index siblings).

    The ancestor closure is log2(B) squarings of the 0/1 parent matrix.
    JAX multiplies bf16 with fp32 accumulation; here the operands are fp32
    (a bf16 product on CUDA returns bf16, which rounds a sum above 256),
    and 0/1 entries with sums of at most B are exact.  Returns (ins,
    anchor, rank, dslot), each int32[B], in the downstream anchor/rank
    wire form."""
    B = kind.shape[0]
    j = torch.arange(B, dtype=I32, device=kind.device)
    is_ins = kind == INSERT
    is_del = kind == DELETE
    ins = torch.where(is_ins, elem, -1)
    dslot = torch.where(is_del, elem, -1)

    eq = ((origin[:, None] == ins[None, :]) & is_ins[:, None]
          & (ins[None, :] >= 0))
    org_op = torch.where(eq, j[None, :] + 1, 0).sum(dim=1, dtype=I32) - 1
    parent = torch.where(is_ins & (org_op >= 0), org_op, -1)

    A = (parent[:, None] == j[None, :]) & (parent[:, None] >= 0)
    for _ in range(max(1, (B - 1).bit_length())):
        Af = A.float()
        A = A | ((Af @ Af) > 0)
    Ai = A.to(I32)
    depth = Ai.sum(dim=1, dtype=I32)
    size = 1 + Ai.sum(dim=0, dtype=I32)

    both_ins = is_ins[:, None] & is_ins[None, :]
    same_par = parent[:, None] == parent[None, :]
    root_pair = ((parent[:, None] < 0) & (parent[None, :] < 0)
                 & (origin[:, None] == origin[None, :]))
    sib = (both_ins & torch.where(parent[:, None] >= 0, same_par, root_pair)
           & (j[:, None] != j[None, :]))
    larger = sib & (j[None, :] > j[:, None])
    W = torch.where(larger, size[None, :], 0).sum(dim=1, dtype=I32)

    AoS = A | (j[:, None] == j[None, :])
    rank = depth + torch.where(AoS, W[None, :], 0).sum(dim=1, dtype=I32)

    is_root = is_ins & (parent < 0)
    root = torch.where(AoS & is_root[None, :], j[None, :] + 1, 0).sum(
        dim=1, dtype=I32) - 1
    anchor = torch.where(is_ins, origin[root.clamp(0, B - 1).long()], -1)
    return ins, anchor, torch.where(is_ins, rank, 0), dslot


@boundary(
    dtypes=(None, "int32", "int32", "int32", "int32", "int32", "int32"),
    shapes=(None, "N", "N", "N", "N", "N", "N"),
    donates=(0,),
)
def merge_oplogs_packed(state: DownPacked, lamport, agent, kind, elem,
                        origin, ch, *, batch: int = 512, epoch: int = 32,
                        max_unique: int | None = None,
                        segments: tuple[int, ...] | None = None
                        ) -> DownPacked:
    """:func:`merge_oplogs` on the packed doc-order state: the causal
    order (sort + dedup, or :func:`_rank_sorted_segments` when
    ``segments`` gives the lengths of concatenated lamport-sorted
    per-agent logs), then per batch the chain structure and the v5
    id-resolved apply (``engine/downstream.py _apply_update_batch5``, K7),
    the snapshot rebuilt after each ``epoch`` batches.  N must be a
    multiple of ``batch * epoch`` (PAD-pad).

    ``max_unique`` bounds the distinct op count: under duplicated delivery
    the whole stream is sorted and deduplicated, but integration walks only
    the unique prefix (dedup PADs duplicates in place; a stable sort on
    ``kind == PAD`` compacts the survivors to the front first)."""
    if segments is not None:
        _, _, kind, elem, origin, _ = _rank_sorted_segments(
            lamport, agent, kind, elem, origin, ch, segments)
    else:
        _, _, kind, elem, origin, _ = _sort_dedup(
            lamport, agent, kind, elem, origin, ch)
    B = batch
    if max_unique is not None and max_unique < kind.shape[0]:
        keep = -(-max_unique // (B * epoch)) * (B * epoch)
        if keep < kind.shape[0]:
            perm = torch.sort((kind == PAD).to(I32), stable=True).indices
            perm = perm[:keep]
            kind, elem, origin = kind[perm], elem[perm], origin[perm]
    nb = kind.shape[0] // B
    K = min(epoch, nb)
    if nb % K:
        raise ValueError(f"batch count {nb} not a multiple of epoch {K}")
    doc, snap, length, nvis = state
    for e0 in range(0, nb, K):
        levels: list = []
        for k in range(e0, e0 + K):
            sl = slice(k * B, (k + 1) * B)
            ins, anchor, rank, dslot = _chain_structure(kind[sl], elem[sl],
                                                        origin[sl])
            doc, length, nvis, lv = _apply_update_batch5(
                doc, length, nvis, snap, levels, ins, anchor, rank, dslot)
            levels.append(lv)
        snap = snap_rebuild(doc)
    return DownPacked(doc, snap, length, nvis)


# ---- host side -------------------------------------------------------------


class MergeSimulation:
    """A agents editing concurrently from a shared base, then replicas
    merging the union of their op logs (BASELINE.md configs 4-5).

    ``streams``: one TensorizedTrace per agent (its local edit stream),
    all with the same base document.  The op logs are generated on
    ``device`` (untimed)."""

    def __init__(self, streams: list[TensorizedTrace], base: str = "",
                 batch: int = 256, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.batch = batch
        self.n_agents = len(streams)
        if self.n_agents >= MAX_AGENTS - 1:
            raise ValueError(
                f"{self.n_agents} agents exceeds the packed rank key's"
                f" MAX_AGENTS={MAX_AGENTS} (agent ids 1..A must stay below"
                " the key's agent field)"
            )
        n_base = len(base)
        if any(len(tt.init_chars) != n_base for tt in streams):
            raise ValueError("all agent streams must share the base document")
        slot_base = n_base
        logs, self.chars_parts = [], []
        for a, tt in enumerate(streams):
            logs.append(agent_oplog(tt, agent=a + 1, slot_base=slot_base,
                                    n_base=n_base, device=self.device))
            self.chars_parts.append(tt.ch[tt.slot >= n_base])
            slot_base += tt.n_inserts
        self.capacity = _round_up(max(slot_base, 1), 128)
        self.n_base = n_base
        chars = np.zeros(self.capacity, np.int32)
        chars[:n_base] = np.asarray([ord(c) for c in base], np.int32)
        off = n_base
        for part in self.chars_parts:
            chars[off:off + len(part)] = part
            off += len(part)
        self.chars = torch.as_tensor(chars, device=self.device)
        self.agent_logs = logs  # per agent, for distributed exchange
        self.log = OpLog.concat(logs)

    def stacked_logs(self) -> dict[str, np.ndarray]:
        """Per-agent logs padded to a common batch-multiple length and
        stacked to int32[A, N] (the sharded update-exchange layout)."""
        n = _round_up(max(len(lg) for lg in self.agent_logs), self.batch)
        fills = dict(lamport=0, agent=0, kind=PAD, elem=-1, origin=-2, ch=0)
        return {
            f: np.stack([
                np.concatenate([getattr(lg, f),
                                np.full(n - len(lg), fill, np.int32)])
                for lg in self.agent_logs
            ])
            for f, fill in fills.items()
        }

    def _padded(self, log: OpLog, multiple: int | None = None) -> OpLog:
        n = len(log)
        m = multiple or self.batch
        n_pad = (-n) % m if n else m
        if not n_pad:
            return log
        z = lambda fill: np.full(n_pad, fill, np.int32)
        fills = dict(lamport=0, agent=0, kind=PAD, elem=-1, origin=-2, ch=0)
        return OpLog(*(np.concatenate([getattr(log, f), z(fills[f])])
                       for f in _LOG_FIELDS))

    def device_log(self, log: OpLog) -> list[torch.Tensor]:
        """The log's six fields as int32 tensors on the device."""
        return [torch.as_tensor(getattr(log, f), dtype=I32,
                                device=self.device) for f in _LOG_FIELDS]

    def merge(self, log: OpLog | None = None) -> DownState:
        """One replica integrates the (padded) union of op logs (v1)."""
        log = self._padded(log if log is not None else self.log)
        state = init_down_state(1, self.capacity, self.n_base,
                                device=self.device)
        return merge_oplogs(state, *self.device_log(log), batch=self.batch)

    def packed_schedule(self, log: OpLog | None = None, epoch: int = 32):
        """(epoch, segments) of :meth:`merge_packed` for ``log`` (None: the
        plain per-agent union, ranked by sorted segments)."""
        src = log if log is not None else self.log
        # never pad beyond the real batch count; clamp before the segments,
        # whose pad segment must match _padded's target multiple
        epoch = min(epoch, max(1, -(-max(len(src), 1) // self.batch)))
        if log is not None:
            return epoch, None
        n = sum(len(lg) for lg in self.agent_logs)
        n_pad = (-n) % (self.batch * epoch) if n else self.batch * epoch
        segments = tuple(len(lg) for lg in self.agent_logs if len(lg)) + (
            (n_pad,) if n_pad else ())
        max_lamport = max(
            (int(lg.lamport.max(initial=0)) for lg in self.agent_logs),
            default=0,
        )
        # real packed keys must stay strictly below the per-segment pad
        # sentinels at [2^31-1 - nseg, 2^31-2], or a real op's rank
        # collides with a pad's
        if (max_lamport * MAX_AGENTS + MAX_AGENTS - 1
                >= INT32_MAX - len(segments)):
            raise ValueError("lamport too large for the packed rank key")
        return epoch, segments

    def merge_packed(self, log: OpLog | None = None, n_replicas: int = 1,
                     epoch: int = 32, max_unique: int | None = None
                     ) -> DownPacked:
        """Replica-batched merge on the packed path
        (:func:`merge_oplogs_packed`).  For delivered streams with
        duplicates, pass ``max_unique`` (the distinct-op bound,
        ``len(self.log)``).  When ``log`` is None (the plain per-agent
        union), the sorted-segments rank replaces the sort."""
        if self.capacity >= MAX_COMBO_CAPACITY:
            raise ValueError(
                f"capacity {self.capacity} >= 2^28 exceeds the packed fill"
                " range (int32 combo)"
            )
        epoch, segments = self.packed_schedule(log, epoch)
        src = log if log is not None else self.log
        padded = self._padded(src, multiple=self.batch * epoch)
        state = down_packed_init(n_replicas, self.capacity, self.n_base,
                                 device=self.device)
        return merge_oplogs_packed(
            state, *self.device_log(padded), batch=self.batch, epoch=epoch,
            max_unique=max_unique, segments=segments,
        )

    def decode(self, state, replica: int = 0) -> str:
        """A replica's visible document as a string."""
        if isinstance(state, DownPacked):
            return decode_packed(state, self.chars, replica)
        return decode_to_str(state, self.chars, replica)


# ---- native cross-validation ------------------------------------------------


def to_native_ops(sim: MergeSimulation, log: OpLog | None = None,
                  base_agent: int = 1_000_000):
    """Translate a (union) op log into the native treap's struct-of-array
    form (``backends/native.py NativeMerge``): ids become (agent,
    seq=lamport); base slot k maps to (base_agent, k+1); origin -1 maps to
    the native HEAD (0, 0); DELETE rows carry the target's id.  Ops are
    (lamport, agent)-sorted on the host.  Returns (type, id_agent, id_seq,
    org_agent, org_seq, ch)."""
    log = log if log is not None else sim.log
    agent_of = np.zeros(sim.capacity, np.uint32)
    seq_of = np.zeros(sim.capacity, np.uint32)
    nb = sim.n_base
    agent_of[:nb] = base_agent
    seq_of[:nb] = np.arange(1, nb + 1, dtype=np.uint32)
    for lg in sim.agent_logs:
        ins = lg.kind == INSERT
        agent_of[lg.elem[ins]] = lg.agent[ins].astype(np.uint32)
        seq_of[lg.elem[ins]] = lg.lamport[ins].astype(np.uint32)

    live = log.kind != PAD
    order = np.lexsort((log.agent[live], log.lamport[live]))
    k = log.kind[live][order]
    elem = log.elem[live][order]
    origin = log.origin[live][order]
    is_ins = k == INSERT
    type_ = np.where(is_ins, 1, 2).astype(np.uint8)
    id_agent = np.where(is_ins, log.agent[live][order].astype(np.uint32),
                        agent_of[np.clip(elem, 0, None)]).astype(np.uint32)
    id_seq = np.where(is_ins, log.lamport[live][order].astype(np.uint32),
                      seq_of[np.clip(elem, 0, None)]).astype(np.uint32)
    head = origin < 0
    org_agent = np.where(head, 0, agent_of[np.clip(origin, 0, None)]
                         ).astype(np.uint32)
    org_seq = np.where(head, 0, seq_of[np.clip(origin, 0, None)]
                       ).astype(np.uint32)
    return (type_, id_agent, id_seq, org_agent, org_seq,
            log.ch[live][order].astype(np.int32))


def native_merge_content(sim: MergeSimulation,
                         log: OpLog | None = None) -> str:
    """The merged document per the independent native RGA treap."""
    from ..backends.native import NativeMerge

    nm = NativeMerge("".join(chr(int(c))
                             for c in sim.chars[: sim.n_base].tolist()))
    try:
        nm.integrate(*to_native_ops(sim, log))
        return nm.content()
    finally:
        nm.close()


# ---- pure-Python merge oracle -----------------------------------------------


def merge_oracle(log: OpLog, base: str, chars: np.ndarray) -> str:
    """Sequential reference: sort ops by (lamport, agent), dedup, insert each
    element directly after its origin in a Python list, tombstone deletes.
    Ground truth for the batched merges on small logs."""
    order = np.argsort(
        log.lamport.astype(np.int64) * (int(log.agent.max(initial=0)) + 2)
        + log.agent,
        kind="stable",
    )
    seen: set[tuple[int, int]] = set()
    doc: list[int] = list(range(len(base)))  # global slots
    visible = {s: True for s in doc}
    for i in order:
        k = int(log.kind[i])
        if k == PAD:
            continue
        key = (int(log.lamport[i]), int(log.agent[i]))
        if key in seen:
            continue
        seen.add(key)
        if k == INSERT:
            org = int(log.origin[i])
            at = doc.index(org) + 1 if org >= 0 else 0
            doc.insert(at, int(log.elem[i]))
            visible[int(log.elem[i])] = True
        else:
            visible[int(log.elem[i])] = False
    return "".join(chr(int(chars[s])) for s in doc if visible[s])
