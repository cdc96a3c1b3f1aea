"""nl_sweep_ms: device milliseconds per traced call of the NL sweep
(``cloudsc2_nl_kernel``): the ``cloudsc2.nl_sweep`` span's self time around
the hand-written kernel's launch, timed by the program's CUDA events."""

from benchmark import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, "nl_sweep")
