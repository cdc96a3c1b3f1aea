"""ad_sweep_roofline_pct: the AD sweep's (``csrc/cloudsc2_ad.cu``) least
time, the larger of its launch's bytes at the card's peak bandwidth and
its operations at the dtype's peak rate (frozen in benchmark/sweep_work.py
from the cell's shapes), over the self time of the ``cloudsc2.ad_sweep``
span per traced call.  Nothing where the run has no device trace or the program no
such span."""

from benchmark import program_spans, sweep_work


def read(ctx):
    ms = program_spans.self_ms(ctx, "ad_sweep")
    if ms is None:
        return None
    return 100.0 * sweep_work.least_time_s("ad_sweep", ctx.config, ctx.traffic) * 1e3 / ms
