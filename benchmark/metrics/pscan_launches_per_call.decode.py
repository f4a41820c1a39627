"""pscan_launches_per_call.decode: launches of the smoother's kernels
(K3 ``pfilter_pass``, K4 ``psmooth_pass``, ``joint_acc``, and the
sequential K1/K2 wrappers) counted by the program's wrappers over the
window, per decode call: the fixed-point passes in effect."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(ctx.launches.values()) / len(ctx.records)
