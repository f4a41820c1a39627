"""adam_live_pct.sweep: the share of the batched Adam runner's work spent
on runs that have not stopped, in %: the program's counters
``adam_run_steps`` (runs still moving, summed over the loop's trips) over
``adam_steps`` (the trips) times the runs, over the traced ``sweep``
calls."""

from benchmark import spans


def read(ctx):
    steps = spans.counter_sum(ctx, "sweep", "adam_steps")
    live = spans.counter_sum(ctx, "sweep", "adam_run_steps")
    if not steps or live is None:
        return None
    return 100.0 * live / (steps * ctx.info["runs"])
