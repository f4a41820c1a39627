"""device_idle_pct: the share of the traced window in which no kernel,
copy or fill runs on the card, in %."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
