"""Tuning-curve basis generation (PyTorch).

Counterpart of ``poor_man_gplvm_tpu/ops/basis.py::generate_basis``: SVD of
the (L, L) RBF (or custom) Gram matrix, keep the leading ``n_basis``
singular vectors scaled by the fourth root of the singular values, prepend
a bias column; or clamped cubic B-splines on the latent grid
(``basis_type='bspline'``).  ``n_basis`` is data-dependent, so it is
computed on the host at model-construction time.
"""

from __future__ import annotations

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops.kernels import rbf_gram

__all__ = ["generate_basis"]


def _bspline_design(n_points, n_basis, order=4):
    """(n_points, n_basis) B-spline design matrix (cubic by default) on a
    uniform grid over [0, 1] with clamped (repeated-boundary) knots, through
    ``scipy.interpolate.BSpline.design_matrix``; the JAX package's
    ``_bspline_design``."""
    from scipy.interpolate import BSpline

    if n_basis < order:
        raise ValueError(
            f"bspline basis needs n_basis >= order ({order}); got {n_basis}"
        )
    degree = order - 1
    n_interior = n_basis - order
    interior = (
        np.linspace(0.0, 1.0, n_interior + 2)[1:-1]
        if n_interior > 0 else np.empty(0)
    )
    knots = np.concatenate([np.zeros(order), interior, np.ones(order)])
    x = np.linspace(0.0, 1.0 - 1e-9, n_points)  # keep the last point in span
    return np.asarray(
        BSpline.design_matrix(x, knots, degree).toarray(), dtype=np.float32
    )


def generate_basis(
    lengthscale,
    n_latent_bin,
    explained_variance_threshold_basis=0.999,
    include_bias=True,
    basis_type="rbf",
    custom_kernel=None,
    n_basis_bspline=None,
    device=None,
):
    """Build the (L, n_basis[+1]) tuning basis on ``device``.

    Rank rule: ``n_basis = (cumsum(s / s.sum()) < thresh).sum() + 1``;
    columns scaled by ``s**0.25``.  Singular vectors are defined up to sign,
    so two SVD implementations agree on the projector ``U U^T``, not on the
    columns; ``convert.load_jax_state`` carries a basis across exactly.

    ``basis_type='bspline'``: ``n_basis_bspline`` clamped cubic B-splines
    (default ``max(4, L // 3)``), no SVD; equal to the JAX basis entry for
    entry (both evaluate the same scipy design matrix).
    """
    if custom_kernel is not None:
        basis_type = "custom_kernel"
    if basis_type == "bspline":
        nb = (int(n_basis_bspline) if n_basis_bspline is not None
              else max(4, n_latent_bin // 3))
        tuning_basis = torch.as_tensor(_bspline_design(n_latent_bin, nb),
                                       device=device)
        if include_bias:
            tuning_basis = torch.cat(
                [torch.ones((n_latent_bin, 1), dtype=tuning_basis.dtype,
                            device=tuning_basis.device), tuning_basis], dim=1)
        return tuning_basis
    if basis_type == "rbf":
        gram, _ = rbf_gram(torch.arange(n_latent_bin, device=device),
                           lengthscale, 1.0)
    elif basis_type == "custom_kernel":
        if custom_kernel is None:
            raise ValueError(
                "custom_kernel must be provided when basis_type is "
                "custom_kernel")
        gram = torch.as_tensor(custom_kernel, dtype=torch.float32,
                               device=device)
    else:
        raise ValueError(f"Unsupported basis_type: {basis_type!r}")

    tuning_basis, sing_val, _ = torch.linalg.svd(gram)
    sing_val_np = sing_val.cpu().numpy()
    n_basis = int((np.cumsum(sing_val_np / sing_val_np.sum()) <
                   explained_variance_threshold_basis).sum()) + 1
    quarter_root = torch.sqrt(torch.sqrt(sing_val[:n_basis]))
    tuning_basis = tuning_basis[:, :n_basis] * quarter_root[None, :]

    if include_bias:
        tuning_basis = torch.cat(
            [torch.ones((tuning_basis.shape[0], 1), dtype=tuning_basis.dtype,
                        device=tuning_basis.device), tuning_basis], dim=1,
        )
    return tuning_basis
