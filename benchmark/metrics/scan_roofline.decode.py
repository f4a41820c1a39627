"""scan_roofline.decode: the smoother's bound (``roofline.py``: the
recursions' operations counted once, the emission weights read and the
smoothed posterior written once) over the device time of the scan
kernels (K1-K4, ``joint_acc``) in the traced decode calls, in %."""

from benchmark import roofline

SCAN = (r"pfilter_kernel|psmooth_kernel|joint_acc|filter_kernel|"
        r"smoother_kernel|smoother_push|filter_cfg_kernel|smoother_cfg_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.traced_calls:
        return None
    s = ctx.trace.kernel_seconds(SCAN)
    if s <= 0:
        return None
    bound = roofline.bound_s(*ctx.decode_work["smoother"])
    return 100.0 * bound * ctx.traced_calls / s
