"""host_syncs_per_iter.fit: reads of a device value by the host (the
program's counter ``host_syncs``) over the traced fits' ``fit_em`` spans,
per EM iteration."""

from benchmark import spans


def read(ctx):
    n = spans.counter_sum(ctx, "fit_em", "host_syncs")
    if n is None or not ctx.traced_work:
        return None
    return n / ctx.traced_work
