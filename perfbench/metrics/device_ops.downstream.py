"""``device_ops.downstream``: kernels, copies and fills a run enqueues on the
device (a count from the trace, so it repeats exactly)."""


def read(c):
    if not c.device:
        return None
    return len(c.device) / c.runs
