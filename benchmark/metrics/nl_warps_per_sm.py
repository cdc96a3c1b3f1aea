"""nl_warps_per_sm: the warps of the NL sweep's kernel an SM holds at once:
the ``blocks_per_sm`` counter the program's ``cloudsc2.nl_sweep`` span
carries for the instance it launched (cudaOccupancyMaxActiveBlocksPerMultiprocessor
at the launch's block size), times the warps of its block.  Nothing where
the run has no device trace or the span no such counter (a program without
the NL sweep's counters)."""

from benchmark import program_spans

# 128 threads a block (kThreads in csrc/cloudsc2_nl_sweep.cuh)
WARPS_PER_BLOCK = 4


def read(ctx):
    span = (program_spans.summary(ctx) or {}).get(program_spans.PREFIX + "nl_sweep", {})
    blocks = span.get("counters", {}).get("blocks_per_sm")
    return None if blocks is None else float(blocks * WARPS_PER_BLOCK)
