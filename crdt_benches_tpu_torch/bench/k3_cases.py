"""K3's worst cases (the fused range apply split across blocks,
``csrc/range_apply_blocked.cu``): operands made with numpy from a seed,
shared by the CPU tests (``tests/test_torch_range_blocked.py``) and
``chip_smoke.py`` (``[k3 worst]``).  The same functions make K2's worst
cases (``csrc/range_apply.cu``, one block per row; :func:`k2_case`,
``tests/test_torch_range_k2.py`` and ``[k2 worst]``) with the span set to
K2's widths.

``span`` is the block width a case is built around: the kernel's 4096
columns on the card, the JAX blocked kernel's 1024 (``block_tiles=8``) in
the CPU tests.  Rows follow the range producer's contract (disjoint delete
intervals over the old columns, disjoint insert runs at increasing
destinations, slot deltas painted at run starts) except ``depth2`` and
``noise``:

- ``paste``: a run longer than the span at column 0, so that every later
  source lies blocks to the left, plus a few small runs;
- ``span_delete``: one delete over most of the old row, inserts inside it;
- ``edge_runs``: runs that start just before each block edge and end past
  it, and one run over several edges;
- ``nlen_edges``: four rows whose new lengths fall on a block edge, inside
  a tile, at 0 and at C;
- ``full``: every row ends exactly at C, so every column is read;
- ``mixed``: random rows, a different new length per row;
- ``depth2``: overlapping runs and overlapping deletes (run and delete
  depth 2), beyond the producer's {0, 1} run depth;
- ``noise``: small random integers in every operand at random columns
  (run depth of any sign) and random new lengths.
"""

from __future__ import annotations

import numpy as np

#: Bit position of the stop counts in ``delpk`` (the producer's choice up
#: to batch 1024).
DSH = 14

CASES = ("paste", "span_delete", "edge_runs", "nlen_edges", "full", "mixed",
         "depth2", "noise")

#: (name, R, C) at the card's size, with the kernel's 4096-column span:
#: R = 64 full rows run 16,384 blocks through both chains; C = 2^20 + 1152
#: leaves a ragged last block.
CHIP_CASES = (
    ("paste", 2, 1 << 20),
    ("span_delete", 2, 1 << 20),
    ("edge_runs", 2, 1 << 20),
    ("nlen_edges", 4, 1 << 20),
    ("full", 2, 1 << 20),
    ("full", 64, 1 << 20),
    ("mixed", 1, 1 << 20),
    ("mixed", 3, (1 << 20) + 1152),
    ("depth2", 2, 1 << 20),
    ("noise", 3, (1 << 20) + 1152),
)


#: K2's cases: the paste is built around K2's x ring (so that it is wider
#: than the ring and later sources lie left of it), the others
#: around K2's chunk (``nlen_edges`` puts a new length on a chunk edge).
K2_CASES = ("paste", "nlen_edges", "full", "mixed", "depth2", "noise")

#: (name, R, C) at the card's size for K2: R >= 132 (the rows alone fill
#: the H100's 132 SMs, where the dispatch takes K2) and R = 1, 2 and 3, at
#: the headline capacity (89.5 chunks: a ragged last chunk) and at 2^20 +
#: 1152 columns.
K2_CHIP_CASES = (
    ("paste", 132, 183_296),
    ("nlen_edges", 132, 183_296),
    ("full", 132, 183_296),
    ("mixed", 1, 183_296),
    ("mixed", 2, (1 << 20) + 1152),
    ("mixed", 3, 183_296),
    ("depth2", 132, 183_296),
    ("depth2", 2, 183_296),
    ("noise", 132, 183_296),
    ("noise", 3, 183_296),
)


def k2_case(name, R, C, chunk, ring, seed):
    """One of ``K2_CASES`` for a K2 of ``chunk`` columns a chunk and an x
    ring of ``ring`` columns: :func:`k3_case` with the span each needs."""
    return k3_case(name, R, C, ring if name == "paste" else chunk, seed)


def _old_doc(rng, L0, C):
    """An old row of L0 columns (a quarter invisible), 2 past it."""
    doc = np.full(C, 2, np.int32)
    vis = (rng.random(L0) < 0.75).astype(np.int32)
    doc[:L0] = ((rng.permutation(L0) + 2) << 1) | vis
    return doc


def _row(rng, C, L0, gaps, lens, dels):
    """One producer-contract row: old doc of L0 columns, deletes ``dels``
    ([lo, hi] inclusive old columns, disjoint), insert runs of ``lens``
    chars at old gap positions ``gaps`` (non-decreasing).  Returns (doc,
    delpk, ind_d, dd, new_len)."""
    doc = _old_doc(rng, L0, C)
    delpk = np.zeros(C + 1, np.int64)
    for lo, hi in dels:
        delpk[lo] += 1
        delpk[hi + 1] += 1 << DSH
    gaps = np.asarray(gaps, np.int64)
    lens = np.asarray(lens, np.int64)
    before = np.concatenate([[0], np.cumsum(lens)])[:-1].astype(np.int64)
    dest0 = gaps + before
    new_len = L0 + int(lens.sum())
    assert new_len <= C and (np.diff(gaps) >= 0).all()
    ind = np.zeros(C + 1, np.int64)
    np.add.at(ind, dest0, 1)
    np.add.at(ind, dest0 + lens, -1)
    delta = L0 + 2 + before - dest0  # slot0 - dest0
    dd = np.zeros(C + 1, np.int64)
    np.add.at(dd, dest0, np.diff(np.concatenate([[0], delta])))
    return (doc, delpk[:C].astype(np.int32), ind[:C].astype(np.int32),
            dd[:C].astype(np.int32), new_len)


def _random_row(rng, C, new_len, n_runs, max_run, n_dels, max_del):
    """A producer-contract row ending at ``new_len``: ``n_runs`` random runs
    of 1..max_run chars and ``n_dels`` disjoint deletes of 1..max_del."""
    lens = rng.integers(1, max_run + 1, n_runs)
    while lens.sum() > new_len // 2 and len(lens):
        lens = lens[: len(lens) // 2]
    L0 = new_len - int(lens.sum())
    gaps = np.sort(rng.integers(0, L0 + 1, len(lens)))
    return _row(rng, C, L0, gaps, lens, _random_dels(rng, L0, n_dels, max_del))


def _random_dels(rng, L0, n, max_len):
    """Up to ``n`` disjoint [lo, hi] intervals over [0, L0)."""
    if L0 < 2 or n == 0:
        return []
    starts = np.unique(rng.integers(0, L0, n))
    ends = np.minimum(starts + rng.integers(0, max_len, len(starts)),
                      np.append(starts[1:] - 1, L0 - 1))
    return list(zip(starts.tolist(), ends.tolist()))


def _depth2_row(rng, C, span):
    """Runs that overlap (ind_d prefix 2) and deletes that overlap (delete
    depth 2), over a random old row."""
    L0 = C // 2
    w = min(span, C // 4)
    doc, delpk, ind, dd, _ = _random_row(rng, C, L0 + L0 // 8, 24, w // 8,
                                         12, w // 4)
    for a in rng.integers(0, C - w - 1, 6):
        b = a + int(rng.integers(1, w // 2))
        ind[a] += 1
        ind[b] += 1
        ind[b + w // 2] -= 1
        ind[a + w] -= 1
        dd[a] += int(rng.integers(-500, 500))
        lo = int(rng.integers(0, L0 - w))
        delpk[lo] += 1
        delpk[lo + w // 4] += 1
        delpk[lo + w // 2] += 1 << DSH
        delpk[lo + w] += 1 << DSH
    return doc, delpk, ind, dd, int(rng.integers(C // 2, C + 1))


def _noise_row(rng, C):
    """Small random integers at random columns of every operand."""
    doc = rng.integers(0, 1 << 20, C).astype(np.int32)
    delpk, ind, dd = (np.zeros(C, np.int32) for _ in range(3))
    for arr, vals in ((ind, rng.integers(-2, 3, C)),
                      (delpk, rng.integers(0, 3, C)
                       + (rng.integers(0, 3, C) << DSH)),
                      (dd, rng.integers(-1000, 1000, C))):
        hit = rng.random(C) < 0.03
        arr[hit] = vals[hit]
    return doc, delpk, ind, dd, int(rng.integers(0, C + 1))


def k3_case(name, R, C, span, seed):
    """One case: numpy (doc, delpk, ind_d, dd int32[R, C], new_len
    int32[R]) with ``DSH`` as the stop shift."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(R):
        if name == "paste":
            n = min(span + span // 2, C // 2)
            tail = rng.integers(1, 9, 8)
            L0 = C - n - int(tail.sum()) - int(rng.integers(0, C // 8))
            gaps = np.concatenate([[0], np.sort(rng.integers(0, L0, 8))])
            rows.append(_row(rng, C, L0, gaps, np.concatenate([[n], tail]),
                             _random_dels(rng, L0, 8, 16)))
        elif name == "span_delete":
            L0 = C * 3 // 4
            lo, hi = L0 // 10, L0 * 9 // 10
            gaps = np.sort(rng.integers(lo, hi, 16))
            rows.append(_row(rng, C, L0, gaps,
                             rng.integers(1, min(40, C // 64), 16),
                             [(lo, hi)]))
        elif name == "edge_runs":
            L0 = C - C // 4
            gaps, lens, cum = [], [], 0
            for e in range(span, C, span):
                g, n = e - 3 - cum, int(rng.integers(4, 40))
                if (gaps and g < gaps[-1]) or g > L0 or L0 + cum + n > C:
                    break
                gaps.append(g)
                lens.append(n)
                cum += n
            if L0 + cum + 2 * span + 7 <= C:  # one run over several edges
                gaps.append(max(gaps[-1] if gaps else 0, L0 - 5))
                lens.append(2 * span + 7)
            rows.append(_row(rng, C, L0, gaps, lens,
                             _random_dels(rng, L0, 16, span // 2)))
        elif name in ("nlen_edges", "full", "mixed"):
            if name == "nlen_edges":
                e = max(1, (C // span) // 2) * span  # a block edge
                if e > C:  # no edge inside the row: a tile edge
                    e = C // 256 * 128
                nl = (e, min(e + 77, C), 0, C)[r % 4]
            elif name == "full":
                nl = C
            else:
                nl = int(rng.integers(C // 4, C + 1))
            if nl == 0:
                z = np.zeros(C, np.int32)
                rows.append((np.full(C, 2, np.int32), z, z, z, 0))
            else:
                rows.append(_random_row(rng, C, nl, max(1, nl // 64), 24,
                                        max(1, nl // 128), 12))
        elif name == "depth2":
            rows.append(_depth2_row(rng, C, span))
        elif name == "noise":
            rows.append(_noise_row(rng, C))
        else:
            raise ValueError(f"unknown K3 case {name!r}")
    return tuple(np.stack([row[k] for row in rows]).astype(np.int32)
                 for k in range(4)) + (
        np.array([row[4] for row in rows], np.int32),)


def max_holes(ind_d):
    """Largest hole count cnt over the rows (the JAX roll cascade is exact
    while 2^nbits exceeds it)."""
    run = np.cumsum(ind_d.astype(np.int64), axis=1) > 0
    return int(run.sum(axis=1).max()) if ind_d.size else 0
