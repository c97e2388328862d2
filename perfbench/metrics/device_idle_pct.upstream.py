"""``device_idle_pct.upstream``: the share of the traced window in which no
kernel, copy or fill ran on the device (1 - the union of device activity /
the window), in percent."""


def read(c):
    if not c.device:
        return None
    return 100.0 * (1.0 - c.busy_s / c.window_s)
