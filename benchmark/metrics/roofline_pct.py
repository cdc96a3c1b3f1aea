"""roofline_pct: the call's least time (the larger of its bytes at the card's
peak bandwidth and its operations at its peak rate, frozen in
benchmark/roofline.py from the cell's shapes) over the device's busy time
per traced call."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.traced_calls:
        return None
    busy_per_call = tr.busy_s() / ctx.traced_calls
    return 100.0 * ctx.least_time_s / busy_per_call
