"""mfu.fit: the operations an EM iteration needs (``roofline.py``: the
statistics and emission products, the recursions once; Adam left out)
over the traced window's seconds times the card's peak, in %."""

from benchmark import roofline


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.traced_work:
        return None
    ops = sum(o for o, _ in ctx.em_iter_work.values()) * ctx.traced_work
    return 100.0 * ops / (ctx.trace.window_s * roofline.PEAK_OPS_PER_S)
