"""Tuning-curve basis generation (PyTorch).

Counterpart of ``poor_man_gplvm_tpu/ops/basis.py::generate_basis``: SVD of
the (L, L) RBF (or custom) Gram matrix, keep the leading ``n_basis``
singular vectors scaled by the fourth root of the singular values, prepend
a bias column.  ``n_basis`` is data-dependent, so it is computed on the host
at model-construction time.
"""

from __future__ import annotations

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops.kernels import rbf_gram

__all__ = ["generate_basis"]


def generate_basis(
    lengthscale,
    n_latent_bin,
    explained_variance_threshold_basis=0.999,
    include_bias=True,
    basis_type="rbf",
    custom_kernel=None,
    device=None,
):
    """Build the (L, n_basis[+1]) tuning basis on ``device``.

    Rank rule: ``n_basis = (cumsum(s / s.sum()) < thresh).sum() + 1``;
    columns scaled by ``s**0.25``.  Singular vectors are defined up to sign,
    so two SVD implementations agree on the projector ``U U^T``, not on the
    columns; ``convert.load_jax_state`` carries a basis across exactly.
    The B-spline basis is not ported yet.
    """
    if custom_kernel is not None:
        basis_type = "custom_kernel"
    if basis_type == "rbf":
        gram, _ = rbf_gram(torch.arange(n_latent_bin, device=device),
                           lengthscale, 1.0)
    elif basis_type == "custom_kernel":
        gram = torch.as_tensor(custom_kernel, dtype=torch.float32,
                               device=device)
    elif basis_type == "bspline":
        raise NotImplementedError(
            "basis_type='bspline' is not ported yet (ROADMAP item 11)"
        )
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
