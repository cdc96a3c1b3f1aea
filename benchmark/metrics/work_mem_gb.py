"""work_mem_gb: the peak of allocated device memory during the window above
what was allocated when it began (the input pool): the call's working set."""


def read(ctx):
    if ctx.work_mem_bytes is None:
        return None
    return ctx.work_mem_bytes / 1e9
