"""fwd_sweep_ms: device milliseconds per traced call of the forward-checkpoint
sweep of the standard contract's adjoint: the ``cloudsc2.fwd_sweep`` span's
self time around the hand-written kernel's launch, timed by the program's
CUDA events."""

from benchmark import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, "fwd_sweep")
