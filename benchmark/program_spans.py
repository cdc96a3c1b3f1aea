"""The program's own spans over a run's traced part: what the per-layer
metrics of single layers read (``prelude_ms``, the sweeps' ``*_sweep_ms``,
``glue_ms``, ``launches_per_call``).

``cloudsc2jax_torch.spans`` records a span per layer of each call while
``torch.profiler`` records, each timed on the card by a pair of CUDA events
and named ``cloudsc2.<layer>`` in the profiler's trace.  The traced calls
are the last ones it recorded (the profiler is off outside the traced
part).  Nothing is read where the run has no device trace (the CPU's plain
versions), nor where the program has no such module or span.
"""

from __future__ import annotations

import importlib

PREFIX = "cloudsc2."
# the entry spans, one per call
ENTRIES = (PREFIX + "run_nl", PREFIX + "run_tlad")
# the runtime and driver calls that put an operation on the device
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"))


def _traced(ctx) -> bool:
    tr = ctx.trace
    return tr is not None and bool(tr.device) and bool(ctx.traced_calls)


def summary(ctx):
    """The spans of the traced calls by range name, or None."""
    if not _traced(ctx):
        return None
    try:
        spans = importlib.import_module("cloudsc2jax_torch.spans")
    except ImportError:
        return None
    return spans.summary(ctx.traced_calls)


def self_ms(ctx, *layers):
    """Self device milliseconds per traced call of the spans of ``layers``
    (names without the prefix), summed; None where none was recorded."""
    found = [s for name, s in (summary(ctx) or {}).items()
             if name[len(PREFIX):] in layers]
    if not found:
        return None
    return sum(s["self_ms"] for s in found) / ctx.traced_calls


def launches(ctx, within=ENTRIES):
    """The launch calls of the host's trace that begin inside one of the
    (disjoint) ranges named in ``within``, launches made inside another
    launch not counted; None where the trace holds no such range."""
    if not _traced(ctx):
        return None
    ranges = sorted((ts, end) for ts, end, name in ctx.trace.host if name in within)
    if not ranges:
        return None
    calls = sorted((ts, end) for ts, end, name in ctx.trace.host if name in LAUNCHES)
    count, outer_end, i = 0, float("-inf"), 0
    for ts, end in calls:
        if ts < outer_end:
            continue  # a driver call made by a runtime call
        outer_end = end
        while i < len(ranges) and ranges[i][1] <= ts:
            i += 1
        count += i < len(ranges) and ranges[i][0] <= ts
    return count
