"""Kernel functions and transition-matrix builders (PyTorch).

Counterpart of ``poor_man_gplvm_tpu/ops/kernels.py``: every Gram matrix is
one broadcast over the (L, L) grid, and every builder returns
``(val, log_val)`` pairs so the probability-space and log-space engines
share one source of truth.
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.utils import profiling

__all__ = [
    "rbf_kernel",
    "rbf_kernel_multi_d",
    "uniform_kernel",
    "discrete_transition_kernel",
    "rbf_gram",
    "uniform_gram",
    "create_transition_prob_1d",
    "create_transition_prob_latent_1d",
    "get_custom_kernel_rbf_plus_isolated",
]


def _safe_log(val):
    """log with -inf for zeros (the JAX package's ``_safe_log``)."""
    pos = val > 0
    return torch.where(
        pos, torch.log(torch.where(pos, val, torch.ones_like(val))),
        torch.full_like(val, -float("inf")),
    )


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# scalar-convention kernels (kept for API parity with the JAX package)
# ---------------------------------------------------------------------------

def rbf_kernel(x, y, ls, var):
    """RBF kernel ``exp(-||x-y||^2 / ls^2) * var`` (no factor 1/2).
    Returns (val, log_val)."""
    x = _f32(x)
    dist_sq = torch.sum(torch.square(x - _f32(y, x.device)))
    log_val = -dist_sq / ls**2 + torch.log(_f32(var, x.device))
    return torch.exp(log_val), log_val


def rbf_kernel_multi_d(x, y, ls, var):
    """Multi-dimensional RBF with per-dimension lengthscales ``ls``.
    Returns (val, log_val)."""
    x = _f32(x)
    dist_sq_per_dim = torch.square(x - _f32(y, x.device))
    log_val = -torch.sum(dist_sq_per_dim / _f32(ls, x.device) ** 2) \
        + torch.log(_f32(var, x.device))
    return torch.exp(log_val), log_val


def uniform_kernel(x, y, n_state):
    """Uniform kernel 1/n.  Returns (val, log_val): a Python float and its
    f32 log."""
    del x, y
    val = 1.0 / n_state
    return val, torch.log(_f32(val))


def discrete_transition_kernel(x, y, trans_mat):
    """Table-lookup kernel ``trans_mat[x, y]``.  Returns (val, log_val),
    with -inf for a zero entry."""
    val = _f32(trans_mat)[x, y]
    return val, _safe_log(val)


# ---------------------------------------------------------------------------
# vectorized Gram builders
# ---------------------------------------------------------------------------

def rbf_gram(points, ls, var=1.0):
    """Full (L, L) RBF Gram matrix in one broadcast.

    ``gram[i, j] = exp(-(points[i]-points[j])^2 / ls^2) * var`` (no 1/2).
    Returns (val, log_val)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    diff = points[:, None] - points[None, :]
    log_val = -(diff * diff) / (ls**2) + torch.log(profiling.to_device(
        torch.tensor(var, dtype=torch.float32), points.device))
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

    dyn = profiling.to_device(torch.tensor(
        [[1.0 - p_move_to_jump, p_move_to_jump],
         [p_jump_to_move, 1.0 - p_jump_to_move]],
        dtype=torch.float32), device)
    del possible_dynamics  # implied by the 2x2 structure; kept for API parity
    return (
        torch.stack([move_val, jump_val]),
        torch.stack([move_log, jump_log]),
        dyn,
        _safe_log(dyn),
    )


def create_transition_prob_latent_1d(possible_latent_bin, movement_variance=1.0,
                                     custom_kernel=None):
    """The single (L, L) latent transition of the latent-only models, row
    normalised: the RBF with ``movement_variance`` as its lengthscale (the
    JAX package's quirk), or ``custom_kernel``.  Returns (val, log_val), f32
    on ``possible_latent_bin``'s device."""
    possible_latent_bin = torch.as_tensor(possible_latent_bin)
    if custom_kernel is None:
        val, log_val = rbf_gram(possible_latent_bin, movement_variance, 1.0)
    else:
        val = _f32(custom_kernel, possible_latent_bin.device)
        log_val = _safe_log(val)
    return _row_normalize(val, log_val)


def get_custom_kernel_rbf_plus_isolated(possible_latent_bin, tuning_lengthscale,
                                        transition_lengthscale, var=1.0,
                                        p_to_isolated=0.001):
    """An RBF kernel plus one isolated latent bin, index 0.

    The tuning kernel shares no smoothness between bin 0 and the others
    (its row and column zero, its diagonal ``var``).  The transition kernel
    leaves bin 0 uniformly, enters it with ``p_to_isolated`` from every
    other bin, and spreads the remaining ``1 - p_to_isolated`` of each
    other row by the RBF.  The operation order is the JAX package's: row 0
    is set to ones and then the WHOLE matrix is scaled by 1/n, so only row
    0 keeps that 1/n.  Returns (tuning_kernel, transition_kernel), f32."""
    possible_latent_bin = torch.as_tensor(possible_latent_bin)
    n_latent_bin = possible_latent_bin.shape[0]

    tuning_kernel, _ = rbf_gram(possible_latent_bin, tuning_lengthscale, var)
    tuning_kernel = tuning_kernel.clone()
    tuning_kernel[0, :] = 0.0
    tuning_kernel[:, 0] = 0.0
    tuning_kernel[0, 0] = var

    transition_kernel, _ = rbf_gram(possible_latent_bin,
                                    transition_lengthscale, var)
    transition_kernel = transition_kernel.clone()
    transition_kernel[0, :] = 1.0
    transition_kernel = transition_kernel * (1.0 / n_latent_bin)
    transition_kernel[1:, 0] = p_to_isolated
    rest = transition_kernel[1:, 1:]
    rest = rest / rest.sum(dim=1, keepdim=True) * (1.0 - p_to_isolated)
    transition_kernel[1:, 1:] = rest
    return tuning_kernel, transition_kernel
