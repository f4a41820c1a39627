"""mfu.decode: the operations a decode call needs (``roofline.py``: the
emission product, the recursions once, the pairwise joint) over the
traced window's seconds times the card's peak, in %."""

from benchmark import roofline


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.traced_calls:
        return None
    ops = sum(o for o, _ in ctx.decode_work.values()) * ctx.traced_calls
    return 100.0 * ops / (ctx.trace.window_s * roofline.PEAK_OPS_PER_S)
