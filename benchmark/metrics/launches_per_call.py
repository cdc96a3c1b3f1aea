"""launches_per_call: the device operations a call issues: the profiler's
kernel launches, copies and fills (runtime and driver calls) inside the
program's ``cloudsc2.run_nl`` / ``cloudsc2.run_tlad`` ranges, per traced
call.  PyTorch's own launches count beside the hand-written kernels'."""

from benchmark import program_spans


def read(ctx):
    n = program_spans.launches(ctx)
    return None if n is None else n / ctx.traced_calls
