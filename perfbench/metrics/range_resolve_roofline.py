"""``range_resolve_roofline``: the range resolver's (K1) share of its
roofline, in percent: the bound of ``roofline/range_resolve.py``'s work
(the larger of int32 operations over the int32 rate and bytes over 3.35
TB/s; the operations bind at R = 1024) summed over the captured
launches, over the time of the kernels of that name."""

KERNELS = ("resolve_range_kernel",)


def read(c):
    return c.roofline_pct("range_resolve", KERNELS)
