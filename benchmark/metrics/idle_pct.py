"""idle_pct: the share of the traced part of the window in which no
operation ran on the device."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
