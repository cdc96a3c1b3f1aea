"""tl_sweep_ms: device milliseconds per traced call of the TL sweep
(increments in registers, or streamed): the ``cloudsc2.tl_sweep`` span's
self time around the hand-written kernel's launch, timed by the program's
CUDA events."""

from benchmark import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, "tl_sweep")
