"""host_ms: the host's milliseconds per call inside the benchmark's span
around the entry (the drivers' Python and launches), each call issued to a
drained device so that no launch waits for room in the queue; the mean."""


def read(ctx):
    if not ctx.host_ms:
        return None
    return sum(ctx.host_ms) / len(ctx.host_ms)
