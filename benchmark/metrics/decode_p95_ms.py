"""decode_p95_ms: the 95th percentile of the window's decode calls' wall
times, each from its start to a device synchronise after it returns."""

import numpy as np


def read(ctx):
    return float(np.percentile([s for s, _ in ctx.records], 95)) * 1e3
