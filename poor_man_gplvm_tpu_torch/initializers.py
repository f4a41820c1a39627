"""Initial latent posteriors: from PCA of the spikes, or from a behavioural
label.

Counterpart of ``poor_man_gplvm_tpu/initializers.py``.  Both run on the
host in numpy, with neither sklearn nor pandas: the PCA is a
``numpy.linalg.svd`` of the centred data with sklearn's sign convention,
and the label binning is ``pandas.cut(x, bins=n, labels=False)`` redone in
numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.utils import compat
from poor_man_gplvm_tpu_torch.utils.table import cut_codes

__all__ = ["init_with_pca", "init_with_label_1D"]


def _pca_transform(y, n_components):
    """``sklearn.decomposition.PCA(n_components).fit_transform(y)``: the
    centred data projected on its leading right singular vectors, each
    vector's sign set so that its entry of largest magnitude is positive
    (sklearn's ``svd_flip(u_based_decision=False)``, which every PCA solver
    of sklearn >= 1.5 applies)."""
    y = np.asarray(y, dtype=np.float64)
    centred = y - y.mean(axis=0)
    _, _, vt = np.linalg.svd(centred, full_matrices=False)
    vt = vt[:n_components]
    biggest = np.argmax(np.abs(vt), axis=1)
    vt = vt * np.sign(vt[np.arange(len(vt)), biggest])[:, None]
    return centred @ vt.T


def init_with_pca(y, n_latent_bin, n_pca_components=None, noise_scale=0,
                  generator=None):
    """PCA projection of the spikes ``y`` (T, N), plus Gaussian noise of
    ``noise_scale`` (drawn from ``generator``, a CPU ``torch.Generator``),
    each row scaled to unit norm, then log-softmax over the components:
    a (T, n_pca_components) float32 tensor (the default is one component
    per latent bin).  It keeps the time-to-time correlation of the data in
    the initial posterior.  Needs ``n_latent_bin < N``."""
    y = np.asarray(y)
    if not n_latent_bin < y.shape[1]:
        raise ValueError("n_latent_bin should be less than n_neuron")
    if n_pca_components is None:
        n_pca_components = n_latent_bin
    latent = torch.as_tensor(_pca_transform(y, n_pca_components),
                             dtype=torch.float32)
    if noise_scale > 0:
        generator = torch.Generator().manual_seed(0) if generator is None \
            else generator
        latent = latent + torch.randn(latent.shape,
                                      generator=generator) * noise_scale
    latent = latent / torch.linalg.norm(latent, dim=1, keepdim=True)
    return latent - torch.logsumexp(latent, dim=1, keepdim=True)


def _cut_codes(x, n_bins):
    """``pandas.cut(x, bins=n_bins, labels=False)`` for finite numeric x:
    ``n_bins`` equal-width bins over [min, max], the lowest edge moved
    down by 0.1 % of the range (or both edges moved out by 0.1 % when all
    values are equal), right-closed bins; the 0-based bin of each value."""
    x = np.asarray(x)
    if x.size == 0:
        raise ValueError("Cannot cut empty array")
    if not np.all(np.isfinite(x)):
        raise ValueError("the label must be finite")
    mn, mx = x.min(), x.max()
    if mn == mx:
        mn -= 0.001 * abs(mn) if mn != 0 else 0.001
        mx += 0.001 * abs(mx) if mx != 0 else 0.001
        bins = np.linspace(mn, mx, n_bins + 1, endpoint=True)
    else:
        bins = np.linspace(mn, mx, n_bins + 1, endpoint=True)
        bins[0] -= (mx - mn) * 0.001
    # every value lies inside the edges: no NaN code
    return cut_codes(x, bins)


def init_with_label_1D(label_tsd, n_latent_bin=100, t_l=None, seed=0,
                       noise_scale=1e-3):
    """Supervised initial log posterior (T, n_latent_bin), float64 numpy:
    the label binned into ``n_latent_bin`` equal-width bins, probability ~1
    on each step's bin, plus uniform noise of ``noise_scale`` from
    ``np.random.default_rng(seed)``, rows normalised; zeros floored at
    -1e20.  ``label_tsd``: the label values, one per time bin, as a Tsd or
    an array (anything ``numpy.asarray`` takes).

    With bin times ``t_l`` (a numpy array or a ``Ts``) the posterior has
    one row per bin time: the label is aligned to them by
    ``Ts.value_from`` (the nearest label sample inside the label's time
    support); bins outside that support start uniform.  ``label_tsd`` is
    then a Tsd, assumed contiguous in time."""
    rng = np.random.default_rng(seed)
    if t_l is not None:
        T = len(t_l)
        if isinstance(t_l, np.ndarray):
            t_l = compat.timeseries_module().Ts(t_l)
        label_aligned = t_l.value_from(label_tsd)
        codes = _cut_codes(np.asarray(label_aligned.d), n_latent_bin)
        posterior = np.ones((T, n_latent_bin)) / n_latent_bin
        sl = t_l.get_slice(label_tsd.time_support.start[0],
                           label_tsd.time_support.end[0])
        sl = np.arange(sl.start, sl.stop, sl.step or 1)
        posterior[sl, :] = 0.0
        posterior[sl, codes] = 1.0
    else:
        label = np.asarray(label_tsd)
        T = len(label)
        posterior = np.zeros((T, n_latent_bin))
        posterior[np.arange(T), _cut_codes(label, n_latent_bin)] = 1.0
    posterior = posterior + rng.random(posterior.shape) * noise_scale
    posterior = posterior / posterior.sum(axis=1, keepdims=True)
    return np.where(posterior > 0, np.log(posterior), -1e20)
