"""Gaps between the program's outputs and the reference's, taken in blocks
of rows so that the comparison fits beside the reference's tensors."""

from __future__ import annotations

import math

import torch


def max_abs_gap(prog, ref, rows=100_000):
    """Largest |prog - ref| over all entries, in the reference's dtype;
    infinite where any entry of either side is not finite."""
    prog = torch.as_tensor(prog)
    if prog.shape != ref.shape:
        raise ValueError(f"shape {tuple(prog.shape)} against the "
                         f"reference's {tuple(ref.shape)}")
    gap = 0.0
    for a in range(0, max(1, ref.shape[0]), rows):
        d = (prog[a:a + rows].to(ref.device, ref.dtype) - ref[a:a + rows])
        if not bool(torch.isfinite(d).all()):
            return math.inf
        gap = max(gap, float(d.abs().max()))
    return gap


def rel_gap(a, b):
    """|a - b| / |b|."""
    return abs(a - b) / abs(b)
