"""setup_s: from the start of the process to the first call of the window:
imports, the card, the kernels' build or load, the inputs, the warm-up."""


def read(ctx):
    return ctx.setup_s
