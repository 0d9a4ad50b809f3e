"""1 - the union of the device operations' intervals over the profiled
window, in %. Layer: the device."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
