"""The yardstick's work counts and the card's peaks.

The operations are the multiply-adds the algorithm needs, 2 operations
each, counted once whatever implements them: the emission product
2 T N L; the M-step's statistics product 2 T N L; each recursion direction
2 nnz a step, where nnz is the multiply-adds of one step of the dynamics x
latent transition (the dynamics mix n_dyn^2 L, the continuous channel's
nonzeros, a row sum for the uniform jump channel), not once per
fixed-point pass; the pairwise joint 2 T (n_dyn L)^2 where the entry
computes it.  Adam's iterations are left out: they depend on where its
loop stops.  The bytes are each input read once and each output written
once, for what the mode stores, in float32.
"""

from __future__ import annotations

import torch

#: NVIDIA H100 SXM, dense: the bf16 tensor-core peak, the highest rate at
#: which any precision could do these operations on the card
PEAK_OPS_PER_S = 989e12
#: HBM3 bandwidth of the H100 SXM
PEAK_BYTES_PER_S = 3.35e12
F4 = 4


def continuous_nnz(L, movement_variance):
    """Nonzeros of the continuous channel's row-normalised RBF transition
    in float32 (the entries that do not underflow)."""
    pts = torch.arange(L, dtype=torch.float32)
    diff = pts[:, None] - pts[None, :]
    k = torch.exp(-(diff * diff) / movement_variance ** 2)
    return int(((k / k.sum(dim=1, keepdim=True)) > 0).sum())


def step_macs(L, n_dyn, movement_variance):
    """Multiply-adds of one recursion step: the dynamics mix, the
    continuous channel's nonzeros and the jump channel's row sum."""
    return n_dyn * n_dyn * L + continuous_nnz(L, movement_variance) + \
        (n_dyn - 1) * L


def smoother_work(T, L, n_dyn, movement_variance, outputs):
    """(operations, bytes) of the forward and backward recursions over T
    steps: the emission weights (T, L) read once, ``outputs`` float32
    values written once."""
    ops = 2 * 2.0 * step_macs(L, n_dyn, movement_variance) * T
    return ops, F4 * (T * L + outputs)


def decode_work(T, N, L, n_dyn, movement_variance):
    """Work of one ``decode_latent`` call (memory mode 'full').  Returns a
    dict of (operations, bytes) by part: 'emission', 'smoother' (K3/K4:
    the smoothed posterior written) and 'joint' (the pairwise joint)."""
    state = T * n_dyn * L
    return {
        "emission": (2.0 * T * N * L, F4 * (T * N + L * N + T * L)),
        "smoother": smoother_work(T, L, n_dyn, movement_variance, state),
        "joint": (2.0 * T * (n_dyn * L) ** 2,
                  F4 * (2 * state + (n_dyn * L) ** 2)),
    }


def em_iter_work(T, N, L, n_dyn, movement_variance):
    """Work of one EM iteration of a lean fit, Adam left out: 'statistics'
    (the M-step's product), 'emission', 'smoother' (marginal mode: the
    latent and dynamics marginals written)."""
    return {
        "statistics": (2.0 * T * N * L, F4 * (T * L + T * N + L * N)),
        "emission": (2.0 * T * N * L, F4 * (T * N + L * N + T * L)),
        "smoother": smoother_work(T, L, n_dyn, movement_variance,
                                  T * (L + n_dyn)),
    }


def bound_s(ops, nbytes):
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the peak bandwidth."""
    return max(ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
