"""The frozen yardstick of the roofline shares: the operations and bytes a
kernel role needs, from a cell's trace and shapes alone.

Copied from ``chip_smoke.py`` (``k1_ops`` over ``range_token_walk``,
``range_apply_bound`` and the K7 byte count, these two over the live
columns only: see :func:`range_apply_work`) and from the range layout the
port's engines stage (``coalesce_patches``, ``tensorize_ranges``,
``_stage_capacity``), so that a later change to the program moves the
measured time and never the counted work.  Plain Python and NumPy.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator

import numpy as np

PAD, INSERT, DELETE = 0, 1, 2

#: Batches a range replay stages at one capacity, and the capacity lane of
#: the range engine v4 (``engine/replay_range.py``).
RANGE_CHUNK = 32
RANGE_LANE = 8 * 128
#: Capacity lane of the unit-op update form (``generate_updates``).
UNIT_LANE = 128


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def token_list_size(B: int) -> int:
    """The resolver's token list for a batch of B range ops: round_up(2B +
    2, 128)."""
    return round_up(2 * B + 2, 128)


def stage_capacity(need: int, lane: int) -> int:
    """Smallest staged capacity >= need on the sqrt(2)-spaced grid lane *
    {8, 12, 16, 24, 32, ...}."""
    s = 8 * lane
    while s < need:
        s2 = s + s // 2
        if s2 >= need:
            return s2
        s *= 2
    return s


def coalesce(patches: Iterable[tuple[int, int, str]]) -> Iterator[tuple]:
    """Adjacent patches that make one contiguous run merged into one: a
    typing run, a forward delete, a backspace run.  Order never changes."""
    pend: list | None = None
    for pos, del_count, ins in patches:
        if del_count:
            if pend is not None and pend[1] and not pend[2]:
                if pos == pend[0]:
                    pend[1] += del_count
                    del_count = 0
                elif pos + del_count == pend[0]:
                    pend[0] = pos
                    pend[1] += del_count
                    del_count = 0
            if del_count:
                if pend is not None:
                    yield tuple(pend)
                pend = [pos, del_count, ""]
        if ins:
            if (pend is not None and pend[2] and not pend[1]
                    and pos == pend[0] + len(pend[2])):
                pend[2] += ins
            else:
                if pend is not None:
                    yield tuple(pend)
                pend = [pos, 0, ins]
    if pend is not None:
        yield tuple(pend)


def range_batches(patches, batch: int) -> tuple[np.ndarray, ...]:
    """The coalesced trace as range ops (a delete run, then an insert run,
    per patch), padded with PAD to whole batches: (kind, pos, rlen)
    int64[n_batches, batch]."""
    ops = []
    for pos, d, ins in coalesce(patches):
        if d:
            ops.append((DELETE, pos, d))
        if ins:
            ops.append((INSERT, pos, len(ins)))
    n_pad = (-len(ops)) % batch if ops else batch
    ops += [(PAD, 0, 0)] * n_pad
    a = np.asarray(ops, np.int64).reshape(-1, batch, 3)
    return a[:, :, 0], a[:, :, 1], a[:, :, 2]


def unit_insert_batches(patches, batch: int) -> np.ndarray:
    """Inserted characters in each batch of ``batch`` unit ops (a patch
    is its deletes, then one insert per character)."""
    flags = []
    for _, d, ins in patches:
        flags += [0] * d + [1] * len(ins)
    n_pad = (-len(flags)) % batch if flags else batch
    flags += [0] * n_pad
    return np.asarray(flags, np.int64).reshape(-1, batch).sum(axis=1)


def token_walk(kind, pos, rlen, v0: int):
    """One replica's walk of a batch of range ops over the resolver's token
    list (``range_token_walk`` at one row): for each op, the token it acts
    on (-1: it changes nothing), the tail of tokens after it that it moves
    or clamps, and the tokens in use before it; and the visible total
    after the batch."""
    B = len(kind)
    T = token_list_size(B)
    col = np.arange(T + 1)
    C = np.zeros(T + 1, np.int64)
    C[1:] = v0
    total, nused = int(v0), 1
    op_t = np.full(B, -1, np.int64)
    tail = np.zeros(B, np.int64)
    before = np.zeros(B, np.int64)
    for j in range(B):
        before[j] = nused
        k, p0, L0 = int(kind[j]), int(pos[j]), int(rlen[j])
        p = min(max(p0, 0), total)
        D = min(max(L0, 0), total - p) if k == DELETE else 0
        is_ins = k == INSERT and L0 > 0
        if not (is_ins or D > 0):
            continue
        L = L0 if is_ins else 0
        pD = p + D
        t = min(int((C[1:] <= p).sum()), nused)
        pre, c_t = int(C[t]), int(C[t + 1])
        split = p > pre and (is_ins or pD < c_t)
        m = (2 if is_ins else 1) + int(split)
        clamped = np.minimum(C, p) + np.maximum(C - pD, 0)
        moved = clamped if D > 0 else C + L
        Y = moved[np.maximum(col - (m - 1), 0)]
        Y = np.where(col <= t, C, Y)
        if is_ins:
            pieces = (p if split else pre + L, p + L if split else c_t + L,
                      c_t + L)
        else:
            pieces = (p if split else int(clamped[t + 1]), c_t - D, c_t + L)
        for q, v in enumerate(pieces[:m]):
            Y[t + 1 + q] = v
        C = Y
        op_t[j] = t
        tail[j] = nused - t
        total += L - D
        nused += m - 1
    return op_t, tail, before, total


def resolve_ops(op_t, tail, before) -> int:
    """K1's int32 operations for one row's walk (``k1_ops``): per op that
    acts, three fields of each tail token it moves or clamps, and its
    search steps, ceil(log2(tokens in use + 1)) compares."""
    acts = op_t >= 0
    steps = np.ceil(np.log2(before[acts].astype(np.float64) + 1))
    return int(3 * tail[acts].sum() + steps.sum())


def resolve_bytes(R: int, B: int) -> int:
    """K1's bytes for one batch: the four op fields read, v0 read, the
    four token fields, three delete fields and nused written a row."""
    T = token_list_size(B)
    return 4 * B * 4 + R * 4 + R * (4 * T + 3 * B + 1) * 4


def range_apply_work(R: int, new_len: int, C: int) -> tuple[int, int]:
    """(bytes, operations) of the fused range apply (K2 and K3 compute
    one function) for R rows of ``new_len`` columns in a capacity of C,
    counting what the inputs need: the live columns below the new length.
    doc, delpk, ind_d and dd read (16 B a column), doc (int32) and
    cv_intile (int16) written (6 B), vis_tile written a live 128-column
    tile, new_len read; 12 int32 operations a column.  (``chip_smoke.py``'s
    ``range_apply_bound`` also counts the constant written past the new
    length in every column of C; on rustcode's batches K2 beat that count
    at 3.35 TB/s, 118% of it, so those stores do not cost full bandwidth,
    and what the inputs determine stops at the new length.)"""
    live = min(new_len, C)
    return (R * (22 * live + 4 * ((live + 127) // 128) + 4), R * 12 * live)


def down_apply_work(R: int, new_len: int, C: int) -> tuple[int, int]:
    """(bytes, operations) of the no-cv fused apply (K7) for R rows,
    counting the live columns below the new length as
    :func:`range_apply_work` does: doc_predel and combo read, the output
    written (12 B a column), cnt_base read a live tile, new_len read; 6
    int32 operations a column."""
    live = min(new_len, C)
    return (R * (12 * live + 4 * ((live + 127) // 128) + 4), R * 6 * live)
