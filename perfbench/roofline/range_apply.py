"""Work of the range apply role (K2, ``range_apply_kernel``, or K3,
``range_apply_blocked_kernel``, as the program dispatches): one launch a
batch of range ops over R rows at the capacity the range engine stages
for the batch's chunk (``workcount.stage_capacity``).  The bytes bind."""

import numpy as np

from perfbench import workcount as wc


def capacities(trace, config) -> tuple[np.ndarray, list[int]]:
    """Each batch's new physical length and the staged capacity of each
    batch."""
    kind, _, rlen = wc.range_batches(trace.patches, config["batch"])
    S = len(trace.start)
    ins = np.where(kind == wc.INSERT, rlen, 0).sum(axis=1)
    new_len = S + np.cumsum(ins)
    capacity = wc.round_up(max(S + int(ins.sum()), 1), wc.RANGE_LANE)
    chunk = wc.round_up(wc.RANGE_CHUNK, config["pack"])
    n = len(new_len)
    caps: list[int] = []
    prev = 0
    for i in range(0, n, chunk):
        need = int(new_len[min(i + chunk, n) - 1])
        prev = max(prev, min(capacity, wc.stage_capacity(need, wc.RANGE_LANE)))
        caps += [prev] * (min(i + chunk, n) - i)
    return new_len, caps


def work(trace, config) -> list[tuple[int, int]]:
    """(bytes, int32 operations) of each launch of one replay, in order."""
    new_len, caps = capacities(trace, config)
    return [wc.range_apply_work(config["replicas"], int(n), C)
            for n, C in zip(new_len, caps)]
