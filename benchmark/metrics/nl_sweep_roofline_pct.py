"""nl_sweep_roofline_pct: the NL sweep's (``csrc/cloudsc2_nl.cu``) least
time, the larger of its launch's bytes at the card's peak bandwidth and its
operations at the dtype's peak rate (frozen in benchmark/nl_sweep_work.py
from the cell's shapes), over the self time of the ``cloudsc2.nl_sweep``
span per traced call.  Nothing where the run has no device trace or the
program no such span."""

from benchmark import nl_sweep_work, program_spans


def read(ctx):
    ms = program_spans.self_ms(ctx, "nl_sweep")
    if ms is None:
        return None
    return 100.0 * nl_sweep_work.least_time_s(ctx.config) * 1e3 / ms
