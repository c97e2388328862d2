"""One-shot RGA flatten: integrate a whole run-granular wire stream in one
pass, with no sequential batch loop (the JAX package's
``engine/downstream_flat.py``; the ``flat`` merge cell and the default
schedule of the run downstream columns).

Under ascending-head-key integration with the no-skip precondition
(``engine/merge_range.py check_no_skip``), every run lands directly after
its anchor element.  The end state of that sequential process is a linked
list whose successor pointers follow from per-anchor relations alone:

- ``next[a]`` = the head of the highest-keyed run anchored at element
  ``a`` (it was integrated last, so it sits closest to ``a``), else ``a``'s
  natural within-run successor;
- a run's tail chains to the next-lower-keyed sibling at the same anchor;
  the lowest-keyed sibling falls through to the anchor's natural
  successor.

One segmented sort (runs by (anchor asc, key desc), two stable sorts) and
scatters give those pointers, and each element's final position is a
weighted list rank over them: pointer doubling, ceil(log2(M)) rounds of
gathers.  Plain torch ops (sorts, scatters, gathers, a ``cummax``), no
kernel.  Positions come from ranks, not painted deltas, so capacity is
bound only by the int32 node ids: C + N + 2 < 2^31.  Scatters that JAX
runs with ``mode="drop"`` send their out-of-range indices to a spill
element that is sliced off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..traces.tensorize import DELETE, INSERT
from . import merge_range
from .downstream import DownPacked
from .merge import INT32_MAX, MAX_AGENTS, MergeSimulation, OpLog

I32 = torch.int32


def _rightmost_fill(marks: torch.Tensor) -> torch.Tensor:
    """The latest nonnegative value at or before each index (a segment
    fill; JAX's associative 'rightmost valid' scan, which leaves marks[0]
    where none is valid): a ``cummax`` over the valid indices."""
    idx = torch.arange(marks.shape[0], device=marks.device, dtype=torch.int64)
    last = torch.cummax(torch.where(marks >= 0, idx, -1), dim=0).values
    return torch.where(last >= 0, marks[last.clamp(min=0)], marks[0])


def _set(n: int, fill: int, idx, val, device) -> torch.Tensor:
    """int32[n] of ``fill`` with out[idx] = val, indices outside [0, n)
    dropped (JAX's ``.at[].set(mode="drop")``); kept indices distinct."""
    out = torch.full((n + 1,), fill, dtype=I32, device=device)
    ok = (idx >= 0) & (idx < n)
    out[torch.where(ok, idx, n).long()] = val.to(I32)
    return out[:n]


def _link_and_rank(key, slot0, rlen, origin, *, n_base: int, C: int,
                   NE: int) -> torch.Tensor:
    """Each element's 0-indexed document position int32[C] from the wire
    (int32[N] each); elements at and past NE get -1."""
    dev = key.device
    N = key.shape[0]
    NR = N + 1  # plus the base pseudo-run at index 0
    root = C + NR
    term = root + 1
    M = term + 1
    cat1 = lambda v, x: torch.cat([torch.full((1,), v, dtype=I32,
                                              device=dev), x])
    # base pseudo-run: key -1 sorts below every real key, so the start
    # content ends up last among the document head's children (it was
    # integrated first)
    keyb = cat1(-1, key)
    s0b = cat1(0, slot0)
    rlb = cat1(n_base, rlen)
    orb = cat1(-1, origin)
    valid = rlb > 0

    # slot -> (run, offset, tail?) by a segment fill over run starts
    ridx = torch.arange(NR, dtype=I32, device=dev)
    run_of = _rightmost_fill(_set(C, -1, torch.where(valid, s0b, C), ridx,
                                  dev)).long()
    elem = torch.arange(C, dtype=I32, device=dev)
    off = elem - s0b[run_of]
    is_tail = off == rlb[run_of] - 1

    # runs by (anchor asc, key desc): a stable descending-key sort, then a
    # stable anchor sort of that arrangement
    p1 = torch.sort(-keyb, stable=True).indices
    anch = torch.where(valid, orb + 1, INT32_MAX)[p1]
    perm = p1[torch.sort(anch, stable=True).indices]
    o_s = torch.where(valid, orb, -2)[perm]  # -1 = root, -2 = pad
    head_s = s0b[perm]
    valid_s = valid[perm]
    exit_s = C + perm.to(I32)

    # first child per anchor node (segment firsts)
    seg_first = torch.ones_like(valid_s)
    seg_first[1:] = o_s[1:] != o_s[:-1]
    anchor_node = torch.where(o_s >= 0, o_s, root)
    first_child = _set(M, -1, torch.where(seg_first & valid_s, anchor_node, M),
                       head_s, dev)

    # natural (child-free) successor of each element
    base_next_elem = torch.where(is_tail, C + run_of.to(I32), elem + 1)

    # exit pointers: the next-lower-keyed sibling, else the anchor's
    # natural successor (the root anchor falls through to the terminal)
    nxt_head = torch.cat([head_s[1:], head_s.new_full((1,), -1)])
    same_seg = torch.zeros_like(valid_s)
    same_seg[:-1] = (o_s[1:] == o_s[:-1]) & valid_s[1:]
    anchor_cont = torch.where(
        o_s >= 0, base_next_elem[o_s.clamp(0, C - 1).long()], term)
    exit_ptr = torch.where(same_seg, nxt_head, anchor_cont)

    # next pointers over [elements | exits | root | term]; the orphan
    # padding slots [NE, C) are fenced to the terminal
    elem_next = torch.where(first_child[:C] >= 0, first_child[:C],
                            base_next_elem)
    elem_next = torch.where(elem < NE, elem_next, term)
    nxt = torch.cat([elem_next,
                     torch.full((NR + 2,), term, dtype=I32, device=dev)])
    nxt = torch.cat([nxt, nxt.new_zeros(1)])  # spill for dropped exits
    nxt[torch.where(valid_s, exit_s, M).long()] = exit_ptr
    nxt = nxt[:M]
    rc = first_child[root]
    nxt[root] = torch.where(rc >= 0, rc, term)

    # predecessor pointers: each reachable node has exactly one; the
    # writes into the terminal (garbage in JAX) go to the spill instead
    nodes = torch.arange(M, dtype=I32, device=dev)
    prev = _set(M, root, torch.where((nodes != term) & (nxt != term), nxt,
                                     M), nodes, dev).long()
    prev[root] = root

    # weighted list rank by pointer doubling: rank(v) = the element nodes
    # on root -> v inclusive (root: weight 0, a self-loop)
    acc = torch.cat([(elem < NE).to(I32),
                     torch.zeros(NR + 2, dtype=I32, device=dev)])
    for _ in range(max(1, (M - 1).bit_length())):
        acc, prev = acc + acc[prev], prev[prev]
    return acc[:C] - 1


def flatten_runs(key, slot0, rlen, origin, *, n_base: int, capacity: int,
                 n_elems: int | None = None,
                 n_replicas: int = 1) -> DownPacked:
    """Integrate the whole insert-run wire in one pass.

    Inputs int32[N] (pad rows have ``rlen == 0``): the head key
    ``lamport * MAX_AGENTS + agent`` (BIGKEY for pads), the run's first
    slot (runs partition [n_base, n_elems) once), its length and its
    head's anchor element (-1 = document head).  ``n_elems`` = n_base +
    the insert chars, the real element slots; the tail [n_elems, capacity)
    is fenced out of the pointer graph.  Returns a ``DownPacked`` with
    every real element placed and visible; fold deletes afterwards with
    :func:`engine.merge_range.delete_fold`.  The wire -> position work is
    computed once for all replicas, as in JAX; each replica's row is then
    written by its own scatter, and ``snap`` is a dense (R, C) tensor."""
    C = capacity
    NE = C if n_elems is None else n_elems
    N = key.shape[0]
    if C + N + 2 >= INT32_MAX:
        raise ValueError(f"capacity {C} + {N} runs overflow the int32 node "
                         "ids (C + N + 2 < 2^31)")
    pos = _link_and_rank(key, slot0, rlen, origin, n_base=n_base, C=C, NE=NE)
    R = n_replicas
    elem = torch.arange(C, dtype=I32, device=key.device)
    fill = ((elem + 2) << 1) | 1
    idx = torch.where(elem < NE, pos, C).long()
    doc = torch.full((R, C + 1), 2, dtype=I32, device=key.device)
    doc.scatter_(1, idx.expand(R, C), fill.expand(R, C))
    return DownPacked(
        doc=doc[:, :C].contiguous(),
        snap=pos.expand(R, C).contiguous(),
        length=torch.full((R,), NE, dtype=I32, device=key.device),
        nvis=torch.full((R,), NE, dtype=I32, device=key.device),
    )


def flatten_unit_log(lamport, agent, kind, elem, origin, *, n_base: int,
                     capacity: int, n_elems: int, max_unique: int,
                     n_replicas: int = 1) -> DownPacked:
    """One-shot merge of a delivered unit-op log (int32[N] each, shuffled,
    every op possibly delivered many times): one descending-key stable sort
    (duplicates become adjacent), first-occurrence compaction into a dense
    ``max_unique``-wide prefix, then :func:`flatten_runs` with every run of
    length 1 (which makes the run precondition vacuous: exact for any
    log).  Deletes are not deduplicated: the delete fold's interval paint is
    idempotent.  ``max_unique`` >= the unique inserts; ``n_elems`` = n_base
    + that count."""
    dev = lamport.device
    key_raw = torch.where(kind == INSERT, lamport * MAX_AGENTS + agent,
                          INT32_MAX)
    p1 = torch.sort(-key_raw, stable=True).indices
    key_s = key_raw[p1]
    keep = key_s != INT32_MAX
    keep[1:] &= key_s[1:] != key_s[:-1]
    urank = torch.cumsum(keep.to(I32), dim=0, dtype=I32) - 1
    MU = max_unique
    idx = torch.where(keep & (urank < MU), urank, MU)
    return flatten_runs(
        _set(MU, INT32_MAX, idx, key_s, dev),
        _set(MU, -1, idx, elem[p1], dev),
        _set(MU, 0, idx, torch.ones_like(idx), dev),
        _set(MU, -2, idx, origin[p1], dev),
        n_base=n_base, capacity=capacity, n_elems=n_elems,
        n_replicas=n_replicas,
    )


def make_flat_merge(sim: MergeSimulation, delivered: OpLog,
                    n_replicas: int = 1):
    """The one construction of the flat merge cell, shared by the bench,
    its check and the tests.  Untimed here: the upload of the delivered log,
    the delete intervals (wire translation) and the packed-key guard.
    Returns a zero-argument callable whose call is the timed region: device
    dedup, one-shot integration and the delete fold."""
    max_lam = int(delivered.lamport.max(initial=0))
    if max_lam * MAX_AGENTS + MAX_AGENTS >= INT32_MAX:
        # a wrapped key would drop or misorder inserts identically on every
        # replica, which the convergence digest cannot see
        raise ValueError(
            f"lamport {max_lam} too large for the packed int32 run key"
            f" (needs lamport * {MAX_AGENTS} + {MAX_AGENTS} < 2^31 - 1)"
        )
    n_uni = int((sim.log.kind == INSERT).sum())
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=sim.device)
    dev = tuple(t(getattr(delivered, f))
                for f in ("lamport", "agent", "kind", "elem", "origin"))
    is_del = delivered.kind == DELETE
    dlo = t(np.where(is_del, delivered.elem, -1))
    dhi = t(np.where(is_del, delivered.elem, -2))
    n_base, capacity = sim.n_base, sim.capacity

    def run() -> DownPacked:
        st = flatten_unit_log(
            *dev, n_base=n_base, capacity=capacity, n_elems=n_base + n_uni,
            max_unique=n_uni, n_replicas=n_replicas,
        )
        return merge_range.delete_fold(st, dlo, dhi)

    return run
