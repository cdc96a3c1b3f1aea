"""ad_sweep_fill_pct: how full the card's warp slots were while the AD
sweep's kernel ran: the ``fill_pct`` counter the program's
``cloudsc2.ad_sweep`` span carries from the stamps its kernel's traced twin
writes, one a warp (the warps' summed time over the SMs' resident warps
times the kernel's first start to last end), a mean over the traced calls'
launches.  Nothing where the run has no device trace or the span no such
counter (a program whose sweeps do not stamp their warps)."""

from benchmark import program_spans


def read(ctx):
    span = (program_spans.summary(ctx) or {}).get(program_spans.PREFIX + "ad_sweep", {})
    fill = span.get("counters", {}).get("fill_pct")
    return None if fill is None else float(fill)
