"""``torch_ops_ms.downstream``: device milliseconds a run of everything that is
not one of the program's own kernels (PyTorch's kernels, copies, fills):
the producer's torch ops."""


def read(c):
    if not c.device:
        return None
    secs, _ = c.device_time_s(lambda name: not c.is_hand_kernel(name))
    return 1e3 * secs / c.runs
