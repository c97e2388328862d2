"""Trace tensorization: patches -> padded integer op arrays.

Two layouts.  Unit ops (:func:`tensorize`): each patch ``(pos, del, ins)``
is exploded into ``del`` single-char deletes at ``pos`` followed by one
single-char insert per char of ``ins`` (at ``pos``, ``pos+1``, ...).
Range ops (:func:`tensorize_ranges`): one op per patch component
(delete-range and/or insert-run), so the sequential resolver does
O(patches) work.  Either way ops pad to a multiple of the batch size with
``PAD`` no-ops, and each insert is pre-assigned its slot id (its index in
the insertion-order physical buffer); slot ids double as element ids.

Pure NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .loader import TestData

# Op kinds.
PAD = 0
INSERT = 1
DELETE = 2


@dataclass
class TensorizedTrace:
    """A trace as padded unit-op arrays plus static sizing metadata."""

    kind: np.ndarray  # int32[N_pad]  PAD / INSERT / DELETE
    pos: np.ndarray  # int32[N_pad]  visible char position at op time
    ch: np.ndarray  # int32[N_pad]  codepoint for INSERT, 0 otherwise
    slot: np.ndarray  # int32[N_pad]  preassigned slot id for INSERT, -1 otherwise
    init_chars: np.ndarray  # int32[S] start-content codepoints (slots 0..S-1)
    n_ops: int  # real (unpadded) unit-op count
    n_patches: int  # throughput element count
    n_inserts: int  # INSERT unit-op count
    capacity: int  # S + n_inserts = total slots ever allocated
    batch: int  # batch size the padding is aligned to
    end_content: str

    @property
    def n_batches(self) -> int:
        return len(self.kind) // self.batch

    def batched(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The op arrays reshaped to (n_batches, batch)."""
        nb, b = self.n_batches, self.batch
        return (
            self.kind.reshape(nb, b),
            self.pos.reshape(nb, b),
            self.ch.reshape(nb, b),
            self.slot.reshape(nb, b),
        )


def explode_unit_ops(trace: TestData) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Explode patches into (kind, pos, ch) unit-op arrays (no padding)."""
    kinds: list[int] = []
    poss: list[int] = []
    chs: list[int] = []
    for pos, del_count, ins in trace.iter_patches():
        kinds.extend([DELETE] * del_count)
        poss.extend([pos] * del_count)
        chs.extend([0] * del_count)
        kinds.extend([INSERT] * len(ins))
        poss.extend(range(pos, pos + len(ins)))
        chs.extend(ord(c) for c in ins)
    return (
        np.asarray(kinds, dtype=np.int32),
        np.asarray(poss, dtype=np.int32),
        np.asarray(chs, dtype=np.int32),
    )


def tensorize(trace: TestData, batch: int = 256) -> TensorizedTrace:
    """Tensorize a trace as unit ops, padded to a multiple of ``batch``."""
    kind, pos, ch = explode_unit_ops(trace)
    n_ops = len(kind)
    n_pad = (-n_ops) % batch if n_ops else batch
    if n_pad:
        kind = np.concatenate([kind, np.zeros(n_pad, np.int32)])
        pos = np.concatenate([pos, np.zeros(n_pad, np.int32)])
        ch = np.concatenate([ch, np.zeros(n_pad, np.int32)])
    init_chars = np.asarray([ord(c) for c in trace.start_content], np.int32)
    s = len(init_chars)
    is_ins = kind == INSERT
    # slot id = S + (number of inserts strictly before this op)
    slot = np.where(
        is_ins, s + np.cumsum(is_ins, dtype=np.int64) - 1, -1
    ).astype(np.int32)
    n_inserts = int(is_ins.sum())
    return TensorizedTrace(
        kind=kind,
        pos=pos,
        ch=ch,
        slot=slot,
        init_chars=init_chars,
        n_ops=n_ops,
        n_patches=len(trace),
        n_inserts=n_inserts,
        capacity=s + n_inserts,
        batch=batch,
        end_content=trace.end_content,
    )


@dataclass
class RangeTrace:
    """A trace as padded RANGE-op arrays plus static sizing metadata."""

    kind: np.ndarray  # int32[N_pad]  PAD / INSERT / DELETE
    pos: np.ndarray  # int32[N_pad]  visible char position at op time
    rlen: np.ndarray  # int32[N_pad]  run length (chars inserted / deleted)
    slot0: np.ndarray  # int32[N_pad] first slot id for INSERT, -1 otherwise
    init_chars: np.ndarray  # int32[S]
    n_ops: int
    n_patches: int
    n_ins_chars: int  # total inserted chars
    capacity: int  # S + n_ins_chars
    batch: int
    end_content: str
    max_batch_ins: int  # max inserted chars in any one op batch
    chars: np.ndarray  # int32[capacity] slot -> codepoint

    @property
    def n_batches(self) -> int:
        return len(self.kind) // self.batch

    def batched(self):
        nb, b = self.n_batches, self.batch
        return (
            self.kind.reshape(nb, b),
            self.pos.reshape(nb, b),
            self.rlen.reshape(nb, b),
            self.slot0.reshape(nb, b),
        )


def coalesce_patches(trace: TestData):
    """Merge ADJACENT patches whose combined effect is one contiguous run
    into a single (pos, del, ins) patch — run-length encoding of the edit
    stream.  Three patterns:

    - typing run: insert at ``prev_pos + len(prev_ins)`` extends the run;
    - forward delete: delete at the SAME position extends;
    - backspace run: delete ending where the previous delete began.

    Order never changes — only adjacent ops merge — so replaying the
    coalesced stream is byte-identical to the original.  Yields
    (pos, del, ins).
    """
    pend: list | None = None  # [pos, del_count, ins] — pure del or pure ins

    for pos, del_count, ins in trace.iter_patches():
        if del_count:
            if pend is not None and pend[1] and not pend[2]:
                if pos == pend[0]:  # forward delete continues
                    pend[1] += del_count
                    del_count = 0
                elif pos + del_count == pend[0]:  # backspace grows leftward
                    pend[0] = pos
                    pend[1] += del_count
                    del_count = 0
            if del_count:  # could not merge: flush and start a new delete
                if pend is not None:
                    yield tuple(pend)
                pend = [pos, del_count, ""]
        if ins:
            if (
                pend is not None
                and pend[2]
                and not pend[1]
                and pos == pend[0] + len(pend[2])
            ):
                pend[2] += ins  # typing run continues
            else:
                if pend is not None:
                    yield tuple(pend)
                pend = [pos, 0, ins]
    if pend is not None:
        yield tuple(pend)


def split_insert_runs(
    kind: np.ndarray, pos: np.ndarray, rlen: np.ndarray, slot0: np.ndarray,
    max_ins: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split INSERT runs longer than ``max_ins`` chars into consecutive
    pieces: inserting ``L`` chars at ``p`` equals inserting the first
    ``max_ins`` at ``p``, the next at ``p + max_ins``, ... with slot ids
    advancing in step.  Deletes pass through whole."""
    if max_ins < 1:
        raise ValueError(f"max_ins must be >= 1, got {max_ins}")
    splits = (kind == INSERT) & (rlen > max_ins)
    if not splits.any():
        return kind, pos, rlen, slot0
    reps = np.where(splits, -(-rlen // max_ins), 1).astype(np.int64)
    idx = np.repeat(np.arange(len(kind)), reps)
    first = np.concatenate([[0], np.cumsum(reps)[:-1]])
    off = (np.arange(len(idx)) - np.repeat(first, reps)).astype(np.int64)
    chars_before = (off * max_ins).astype(np.int32)
    k2 = kind[idx]
    is_ins = k2 == INSERT
    p2 = np.where(is_ins, pos[idx] + chars_before, pos[idx]).astype(np.int32)
    r2 = np.where(
        is_ins, np.minimum(max_ins, rlen[idx] - chars_before), rlen[idx]
    ).astype(np.int32)
    s2 = np.where(is_ins, slot0[idx] + chars_before, slot0[idx]).astype(
        np.int32
    )
    return k2, p2, r2, s2


def tensorize_ranges(
    trace: TestData, batch: int = 512, coalesce: bool = False,
    patches=None,
) -> RangeTrace:
    """Tensorize a trace as range ops (no per-char explosion).  With
    ``coalesce`` the patch stream is first run-length encoded across patch
    boundaries (:func:`coalesce_patches`).  ``patches`` lets a caller that
    already materialized the (coalesced) patch list pass it in."""
    kinds: list[int] = []
    poss: list[int] = []
    lens: list[int] = []
    slot0s: list[int] = []
    init_chars = np.asarray([ord(c) for c in trace.start_content], np.int32)
    s = len(init_chars)
    next_slot = s
    chars: list[int] = []
    if patches is None:
        patches = (
            coalesce_patches(trace) if coalesce else trace.iter_patches()
        )
    for pos, del_count, ins in patches:
        if del_count:
            kinds.append(DELETE)
            poss.append(pos)
            lens.append(del_count)
            slot0s.append(-1)
        if ins:
            kinds.append(INSERT)
            poss.append(pos)
            lens.append(len(ins))
            slot0s.append(next_slot)
            chars.extend(ord(c) for c in ins)
            next_slot += len(ins)
    n_ops = len(kinds)
    n_pad = (-n_ops) % batch if n_ops else batch
    kind = np.asarray(kinds + [PAD] * n_pad, np.int32)
    pos = np.asarray(poss + [0] * n_pad, np.int32)
    rlen = np.asarray(lens + [0] * n_pad, np.int32)
    slot0 = np.asarray(slot0s + [-1] * n_pad, np.int32)
    n_ins_chars = next_slot - s
    char_table = np.zeros(s + n_ins_chars, np.int32)
    char_table[:s] = init_chars
    char_table[s:] = np.asarray(chars, np.int32)
    nb = len(kind) // batch
    ins_per_batch = (
        np.where(kind == INSERT, rlen, 0).reshape(nb, batch).sum(axis=1)
    )
    return RangeTrace(
        kind=kind,
        pos=pos,
        rlen=rlen,
        slot0=slot0,
        init_chars=init_chars,
        n_ops=n_ops,
        n_patches=len(trace),
        n_ins_chars=int(n_ins_chars),
        capacity=int(s + n_ins_chars),
        batch=batch,
        end_content=trace.end_content,
        max_batch_ins=int(ins_per_batch.max(initial=0)),
        chars=char_table,
    )
