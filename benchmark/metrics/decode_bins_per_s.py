"""decode_bins_per_s: every bin decoded in the window over the window's
seconds (whole calls, the last one straddling the window's end)."""


def read(ctx):
    return sum(w for _, w in ctx.records) / ctx.window_s
