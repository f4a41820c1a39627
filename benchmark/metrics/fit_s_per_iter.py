"""fit_s_per_iter: the seconds of the window's whole fits over the EM
iterations they completed (each fit's initial posterior and every M-step
included)."""


def read(ctx):
    return ctx.window_s / sum(w for _, w in ctx.records)
