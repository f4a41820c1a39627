"""adam_steps_per_em_iter.sweep: trips of the batched Adam runner's loop
(the program's counter ``adam_steps``) over the traced ``sweep`` calls,
per EM iteration."""

from benchmark import spans


def read(ctx):
    n = spans.counter_sum(ctx, "sweep", "adam_steps")
    if n is None:
        return None
    return n / (ctx.traced_calls * ctx.info["n_iter"])
