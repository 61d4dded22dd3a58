"""device_idle_share: the share of the traced slice in which the device
ran no kernel, copy or set (the union of their intervals)."""


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
