"""``down_apply_roofline``: the downstream apply's (K7) share of its
roofline, in percent: the bound of ``roofline/down_apply.py``'s work (the
bytes bind) summed over the captured launches, over the time of the
kernels of that name."""

KERNELS = ("apply_blocked_kernel",)


def read(c):
    return c.roofline_pct("down_apply", KERNELS)
