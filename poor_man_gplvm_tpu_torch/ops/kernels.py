"""Kernel functions and transition-matrix builders (PyTorch).

Counterpart of ``poor_man_gplvm_tpu/ops/kernels.py``: every Gram matrix is
one broadcast over the (L, L) grid, and every builder returns
``(val, log_val)`` pairs so the probability-space and log-space engines
share one source of truth.
"""

from __future__ import annotations

import torch

__all__ = [
    "rbf_gram",
    "uniform_gram",
    "create_transition_prob_1d",
]


def _safe_log(val):
    """log with -inf for zeros (the JAX package's ``_safe_log``)."""
    pos = val > 0
    return torch.where(
        pos, torch.log(torch.where(pos, val, torch.ones_like(val))),
        torch.full_like(val, -float("inf")),
    )


def rbf_gram(points, ls, var=1.0):
    """Full (L, L) RBF Gram matrix in one broadcast.

    ``gram[i, j] = exp(-(points[i]-points[j])^2 / ls^2) * var`` (no 1/2).
    Returns (val, log_val)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    diff = points[:, None] - points[None, :]
    log_val = -(diff * diff) / (ls**2) + torch.log(
        torch.tensor(var, dtype=torch.float32, device=points.device)
    )
    return torch.exp(log_val), log_val


def uniform_gram(n_state, dtype=torch.float32, device=None):
    """(n, n) uniform matrix with value 1/n. Returns (val, log_val)."""
    val = torch.full((n_state, n_state), 1.0 / n_state, dtype=dtype,
                     device=device)
    return val, torch.log(val)


def _row_normalize(val, log_val):
    """Row-normalize a kernel matrix in both prob and log space."""
    normalizer = val.sum(dim=-1, keepdim=True)
    return val / normalizer, log_val - torch.log(normalizer)


def create_transition_prob_1d(
    possible_latent_bin,
    possible_dynamics,
    movement_variance=1.0,
    p_move_to_jump=0.01,
    p_jump_to_move=0.01,
    custom_kernel=None,
):
    """Build the (n_dyn, L, L) latent transition stack ``[RBF, uniform]``
    (or ``[custom_kernel, uniform]``), each row-normalized, and the 2x2
    dynamics transition matrix.

    NOTE: like the JAX package and its reference, ``movement_variance`` is
    used as the RBF *lengthscale* argument.

    Returns (latent_transition_kernel_l, log_latent_transition_kernel_l,
    dynamics_transition_kernel, log_dynamics_transition_kernel), all f32 on
    ``possible_latent_bin``'s device.
    """
    possible_latent_bin = torch.as_tensor(possible_latent_bin)
    device = possible_latent_bin.device
    n_latent_bin = possible_latent_bin.shape[0]

    if custom_kernel is None:
        move_val, move_log = rbf_gram(possible_latent_bin, movement_variance,
                                      1.0)
    else:
        move_val = torch.as_tensor(custom_kernel, dtype=torch.float32,
                                   device=device)
        move_log = _safe_log(move_val)
    move_val, move_log = _row_normalize(move_val, move_log)

    jump_val, jump_log = _row_normalize(*uniform_gram(n_latent_bin,
                                                      device=device))

    dyn = torch.tensor(
        [[1.0 - p_move_to_jump, p_move_to_jump],
         [p_jump_to_move, 1.0 - p_jump_to_move]],
        dtype=torch.float32, device=device,
    )
    del possible_dynamics  # implied by the 2x2 structure; kept for API parity
    return (
        torch.stack([move_val, jump_val]),
        torch.stack([move_log, jump_log]),
        dyn,
        _safe_log(dyn),
    )
