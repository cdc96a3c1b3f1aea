"""aten_ms: device milliseconds per call of PyTorch's own operations (the
``at::`` kernels, copies and fills) in the traced calls."""

_COPIES = ("gpu_memcpy", "gpu_memset")


def is_aten(name, cat):
    return cat in _COPIES or "at::" in name or "at_cuda_detail" in name


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not ctx.traced_calls:
        return None
    total = sum(end - ts for ts, end, name, cat in tr.device if is_aten(name, cat))
    return total * 1e-3 / ctx.traced_calls
