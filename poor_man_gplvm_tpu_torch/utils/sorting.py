"""Post-fit neuron sorting and numpy helper kernels.

The port's own copy of ``poor_man_gplvm_tpu/utils/sorting.py``.  The
functions take the port's results as they come: a fit's ``tuning`` and a
spike matrix may be tensors on the card, and are copied to the host
(``compat.to_numpy``); the sort itself runs in numpy, as in the JAX
package.  ``post_fit_sort_neurons`` (plural) is the alias the reference's
README spells.
"""

from __future__ import annotations

import numpy as np

from poor_man_gplvm_tpu_torch.utils import compat

__all__ = ["rbf_kernel", "post_fit_sort_neuron", "post_fit_sort_neurons",
           "pca_init"]


def rbf_kernel(X, Y=None, length_scale=1.0):
    """numpy RBF Gram matrix ``exp(-0.5 d^2 / ls^2)`` (the 1/2 factor of
    the reference's ``utils.rbf_kernel``, which ``gp_kernel.rbf_kernel``
    does not have)."""
    X = compat.to_numpy(X)
    Y = X if Y is None else compat.to_numpy(Y)
    XX = np.sum(X**2, axis=1)[:, np.newaxis]
    YY = np.sum(Y**2, axis=1)[np.newaxis, :]
    XY = np.dot(X, Y.T)
    sq_dists = XX + YY - 2 * XY
    return np.exp(-0.5 * sq_dists / (length_scale**2))


def post_fit_sort_neuron(fit_res, spk=None, do_norm="max",
                         method="tuning_peak", t_l=None):
    """Argsort neurons by the latent bin of their tuning peak; optionally
    normalise and sort the spike matrix (T, N) for raster plots, as
    TsdFrames when ``t_l`` is given.  Returns numpy arrays."""
    if method == "tuning_peak":
        assert "tuning" in fit_res, "Tuning is not in the fit result"
        tuning = compat.to_numpy(fit_res["tuning"])
        argsort = np.argsort(np.argmax(tuning, axis=0))
    else:
        raise ValueError(f"Invalid method: {method}")

    to_return = {}
    if spk is not None:
        spk = compat.to_numpy(spk)
        if do_norm == "max":
            spk_to_plot = spk / spk.max(axis=0, keepdims=True)
        elif do_norm == "zscore":
            spk_to_plot = (spk - spk.mean(axis=0, keepdims=True)) / spk.std(
                axis=0, keepdims=True
            )
        elif do_norm is None:
            spk_to_plot = spk
        else:
            raise ValueError(f"Invalid normalization method: {do_norm}")
        spk_no_sort = spk_to_plot
        spk_to_plot = spk_to_plot[:, argsort]
        if t_l is not None:
            spk_to_plot = compat.tsdframe(d=spk_to_plot, t=t_l)
            spk_no_sort = compat.tsdframe(d=spk_no_sort, t=t_l)
        to_return["spk_to_plot"] = spk_to_plot
        to_return["spk_no_sort"] = spk_no_sort

    to_return["argsort"] = argsort
    return to_return


post_fit_sort_neurons = post_fit_sort_neuron


def pca_init(Y, latent_dim):
    """PCA latent init in numpy (the reference keeps it for parity and
    notes it is not used)."""
    Y = compat.to_numpy(Y)
    Y_centered = Y - np.mean(Y, axis=0)
    U, S, _ = np.linalg.svd(Y_centered, full_matrices=False)
    return U[:, :latent_dim] * S[:latent_dim]
