"""scan_batch_roofline.sweep: the bound of the sweep's batched E-steps
(``roofline_grid.py``: each run's recursions at its own movement variance,
its weights read and its marginal written once; the band padded to the
widest run's counted as waste) over the device time of the sequential
scan kernels (K1, K2, their config-indexed forms) in the traced calls,
in %."""

from benchmark import roofline_grid

SCAN = r"filter_cfg_kernel|smoother_cfg_kernel|filter_kernel|smoother_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.traced_calls:
        return None
    s = ctx.trace.kernel_seconds(SCAN)
    if s <= 0:
        return None
    cfg = ctx.config
    bound = roofline_grid.e_step_bound_s(
        ctx.cell.traffic["T"], cfg.n_latent, cfg.n_dyn,
        tuple(ctx.info["movement_variances"]))
    return 100.0 * bound * ctx.info["n_iter"] * ctx.traced_calls / s
