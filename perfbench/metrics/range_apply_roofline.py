"""``range_apply_roofline``: the range apply's share of its roofline (K2,
or K3 where the program dispatches it), in percent: the bound of
``roofline/range_apply.py``'s work (the bytes bind) summed over the
captured launches, over the time of the kernels of those names."""

KERNELS = ("range_apply_kernel", "range_apply_blocked_kernel")


def read(c):
    return c.roofline_pct("range_apply", KERNELS)
