"""Tuning links (PyTorch).

Counterpart of the link functions in ``poor_man_gplvm_tpu/ops/mstep.py``.
The rest of the M-step (statistics, objectives, Adam) comes with the fit
slice (ROADMAP item 6).
"""

from __future__ import annotations

import torch

__all__ = ["get_tuning_linear", "get_tuning_softplus"]


def get_tuning_linear(params, basis):
    """tuning = basis @ params; params: (n_basis, N), basis: (L, n_basis)."""
    return basis @ params


def get_tuning_softplus(params, basis):
    """softplus link for nonnegative Poisson rates, computed as
    ``logaddexp(x, 0)`` like ``jax.nn.softplus`` (``F.softplus`` switches
    to the identity above x=20, which the JAX link does not)."""
    x = get_tuning_linear(params, basis)
    return torch.logaddexp(x, torch.zeros_like(x))
