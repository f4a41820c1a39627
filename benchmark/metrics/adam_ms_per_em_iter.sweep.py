"""adam_ms_per_em_iter.sweep: milliseconds of the program's span
``sweep.m_step`` (the batched Adam runner and the tuning) inside the
traced ``sweep`` calls, per EM iteration."""

from benchmark import spans


def read(ctx):
    ms = spans.ms_per_call(ctx, "sweep", "sweep.m_step")
    return None if ms is None else ms / ctx.info["n_iter"]
