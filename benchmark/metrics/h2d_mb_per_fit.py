"""h2d_mb_per_fit: megabytes (1e6 B) copied from the host to the card per
traced fit, the program's counter ``h2d_bytes`` over its ``fit_em``
spans."""

from benchmark import spans


def read(ctx):
    b = spans.counter_sum(ctx, "fit_em", "h2d_bytes")
    return None if b is None else b / 1e6 / ctx.traced_calls
