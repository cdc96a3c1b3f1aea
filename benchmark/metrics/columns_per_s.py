"""columns_per_s: every column of every call issued in the window, over the
host's time from the first issue to the final synchronise."""


def read(ctx):
    return ctx.calls * ctx.ncol / ctx.window_s
