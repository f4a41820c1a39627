"""mfu.sweep: the operations of the traced sweep calls
(``roofline_grid.call_ops``: the statistics and emission products, each
run's recursions once, the tuning, Adam's objective and gradient at each
M-step's start and per trip of a run still moving, from the program's
counter ``adam_run_steps``) over the traced window's seconds times the
card's peak, in %."""

from benchmark import roofline, roofline_grid, spans


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    live = spans.counter_sum(ctx, "sweep", "adam_run_steps")
    if live is None:
        return None
    cfg, info = ctx.config, ctx.info
    ops = ctx.traced_calls * roofline_grid.call_ops(
        ctx.cell.traffic["T"], cfg.n_neuron, cfg.n_latent, cfg.n_dyn,
        info["n_basis"], info["movement_variances"], info["n_iter"], 0)
    ops += roofline_grid.adam_ops(cfg.n_latent, info["n_basis"],
                                  cfg.n_neuron, live)
    return 100.0 * ops / (ctx.trace.window_s * roofline.PEAK_OPS_PER_S)
