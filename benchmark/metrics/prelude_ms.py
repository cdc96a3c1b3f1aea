"""prelude_ms: device milliseconds per traced call of ``kernel_prelude``
(the ``cloudsc2.prelude`` span's self time: the tropopause's masked max,
ztp1, the surface pressure), timed by the program's CUDA events."""

from benchmark import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, "prelude")
