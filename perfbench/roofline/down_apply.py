"""Work of the downstream apply role (K7, ``apply_blocked_kernel``): one
launch a batch of ``batch`` unit ops over R rows at the whole capacity,
round_up(start + inserted characters, 128).  The bytes bind."""

import numpy as np

from perfbench import workcount as wc


def work(trace, config) -> list[tuple[int, int]]:
    """(bytes, int32 operations) of each launch of one apply, in order."""
    ins = wc.unit_insert_batches(trace.patches, config["batch"])
    S = len(trace.start)
    C = wc.round_up(max(S + int(ins.sum()), 1), wc.UNIT_LANE)
    return [wc.down_apply_work(config["replicas"], int(n), C)
            for n in S + np.cumsum(ins)]
