"""call_ms_p95: the 95th percentile of the window's calls, each timed on the
device by events recorded around it and read after the window."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.call_ms, 95))
