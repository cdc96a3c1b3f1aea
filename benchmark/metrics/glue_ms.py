"""glue_ms: device milliseconds per traced call of the standard contract's
glue: the 16 increment products, ``to_levels_major`` and the contract's
assembly (``unblock_outputs``, ``seed_streams``,
``assemble_shifted_adjoints``), the self times of the ``cloudsc2.increments``,
``cloudsc2.levels_major`` and ``cloudsc2.contract`` spans."""

from benchmark import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, "increments", "levels_major", "contract")
