"""pscan_launches_per_iter.fit: launches of the smoother's kernels counted
by the program's wrappers over the window, per EM iteration."""


def read(ctx):
    iters = sum(w for _, w in ctx.records)
    return sum(ctx.launches.values()) / iters if iters else None
