"""Emission log-likelihoods in matmul form (PyTorch).

Counterpart of ``poor_man_gplvm_tpu/ops/emissions.py``:

Poisson (lam = tuning*dt + RATE_FLOOR, every entry > 0):
    ll[t, l] = (ma*y)[t] @ log(lam)[l] - ma[t] @ lam[l]
               - sum_n ma[t, n] * lgamma(y[t, n] + 1)

Gaussian (mu = tuning*dt, precision weights w = 1/noise_std^2, a scalar or
one per neuron):
    ll[t, l] = -1/2 * ( (ma*y^2*w)[t].sum - 2 (ma*y*w)[t] @ mu[l]
                        + (ma*w)[t] @ (mu^2)[l] )
               - (log s + log sqrt(2 pi)) * ma[t].sum

A per-time dt (T,) takes the elementwise (T, L, N) form instead (the
naive-Bayes path with ``dt_l``).  The (T, N) @ (N, L) products are plain
``torch.matmul`` in float32: on the card that needs TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, the default), matching
the JAX package's ``Precision.HIGHEST``.  The Gaussian expansion subtracts
terms of the size of sum_n y^2 w, so TF32's 10-bit mantissa would lose the
result entirely.
"""

from __future__ import annotations

import math

import torch

RATE_FLOOR = 1e-20
MASK_NEG = -1e20

__all__ = [
    "RATE_FLOOR",
    "MASK_NEG",
    "poisson_loglik",
    "poisson_lgamma_term",
    "gaussian_loglik",
    "get_loglikelihood_ma_all",
    "get_loglikelihood_ma_all_changing_dt",
    "get_naive_bayes_ma",
    "get_naive_bayes_ma_chunk",
]


def _as_f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _scalar_or_array(x, device):
    """A scalar as a 0-dim f32 tensor on the host (an operand of device ops
    with no copy to the device), an array as an f32 tensor on ``device``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x if x.ndim == 0 else x.to(device)


def _mask_latent(ll, ma_latent):
    keep = _as_f32(ma_latent, ll.device).bool()[None, :]
    return torch.where(keep, ll, torch.full_like(ll, MASK_NEG))


def poisson_lgamma_term(y, ma_neuron):
    """(T,) mask-weighted ``sum_n lgamma(y+1)``, the parameter-free part of
    the Poisson log-likelihood."""
    ma = _as_f32(ma_neuron, y.device)
    if ma.ndim == 1:
        ma = ma[None, :]
    return (torch.lgamma(y + 1.0) * ma).sum(dim=-1)


def poisson_loglik(y, tuning, ma_neuron, ma_latent, dt=1.0, lgamma_term=None):
    """(T, L) Poisson log-likelihood.

    y: (T, N) counts; tuning: (L, N) rates; ma_neuron: (N,) or (T, N);
    ma_latent: (L,); dt: scalar or (T,).  With a scalar dt a 1-D neuron
    mask is folded into the (L, N) side (one matmul, no (T, N)
    temporaries); a 2-D mask takes two matmuls, exactly like the JAX
    function, so both packages round alike.  A per-time dt takes the
    elementwise (T, L, N) form: the rate floor does not factor out of
    log(tuning*dt).  Masked latent bins are set to ``MASK_NEG``."""
    y = _as_f32(y, tuning.device)
    ma = _as_f32(ma_neuron, y.device)
    if lgamma_term is None:
        lgamma_term = poisson_lgamma_term(y, ma)
    dt = _scalar_or_array(dt, y.device)
    if dt.ndim == 0:
        lam = tuning * dt + RATE_FLOOR  # (L, N)
        log_lam = torch.log(lam)
        if ma.ndim == 1:
            ll = (
                y @ (log_lam * ma[None, :]).T
                - (lam * ma[None, :]).sum(dim=-1)[None, :]
                - lgamma_term[:, None]
            )
        else:
            ma = torch.broadcast_to(ma, y.shape)
            ll = (y * ma) @ log_lam.T - ma @ lam.T - lgamma_term[:, None]
    else:
        ma = torch.broadcast_to(ma, y.shape)
        lam = tuning[None, :, :] * dt[:, None, None] + RATE_FLOOR  # (T, L, N)
        ll = (
            torch.einsum("tn,tln->tl", y * ma, torch.log(lam))
            - torch.einsum("tn,tln->tl", ma, lam)
            - lgamma_term[:, None]
        )
    return _mask_latent(ll, ma_latent)


def gaussian_loglik(y, tuning, noise_std, ma_neuron, ma_latent, dt=1.0):
    """(T, L) Gaussian log-likelihood.

    ``noise_std``: a scalar or a per-neuron (N,) vector; ``ma_neuron`` (N,)
    or (T, N); ``dt`` scalar (the matmul form) or (T,) (elementwise)."""
    y = _as_f32(y, tuning.device)
    ma = torch.broadcast_to(_as_f32(ma_neuron, y.device), y.shape)
    dt = _scalar_or_array(dt, y.device)
    noise_std = _scalar_or_array(noise_std, y.device)
    const = -(torch.log(noise_std) + 0.5 * math.log(2.0 * math.pi))
    if dt.ndim == 0:
        mu = tuning * dt  # (L, N)
        w = 1.0 / (noise_std**2)  # scalar or (N,) precision weights
        quad = (
            (ma * y * y * w).sum(dim=-1)[:, None]
            - 2.0 * ((ma * y * w) @ mu.T)
            + (ma * w) @ (mu * mu).T
        )
        ll = -0.5 * quad + (ma * const).sum(dim=-1)[:, None]
    else:
        mu = tuning[None, :, :] * dt[:, None, None]  # (T, L, N)
        resid = (y[:, None, :] - mu) / noise_std
        ll = ((-0.5 * resid * resid + const) * ma[:, None, :]).sum(dim=-1)
    return _mask_latent(ll, ma_latent)


def _loglik(y_l, tuning, hyperparam, ma_neuron, ma_latent, observation_model,
            dt=1.0, lgamma_term=None):
    if observation_model == "poisson":
        return poisson_loglik(y_l, tuning, ma_neuron, ma_latent, dt=dt,
                              lgamma_term=lgamma_term)
    if observation_model == "gaussian":
        return gaussian_loglik(y_l, tuning, hyperparam["noise_std"],
                               ma_neuron, ma_latent, dt=dt)
    raise ValueError(f"observation_model must be 'poisson' or 'gaussian', got "
                     f"{observation_model!r}")


def get_loglikelihood_ma_all(
    y_l, tuning, hyperparam, ma_neuron, ma_latent, observation_model="poisson",
    lgamma_term=None,
):
    """(T, L) log-likelihood with dt=1.  ``lgamma_term``: the precomputed
    ``poisson_lgamma_term`` (Poisson only; a Gaussian model ignores it).
    The Gaussian model reads ``hyperparam['noise_std']``."""
    return _loglik(y_l, tuning, hyperparam, ma_neuron, ma_latent,
                   observation_model, lgamma_term=lgamma_term)


def get_loglikelihood_ma_all_changing_dt(
    y_l, tuning, hyperparam, ma_neuron, ma_latent, dt_l,
    observation_model="poisson",
):
    """(T, L) log-likelihood with a per-time dt ``dt_l`` (T,)."""
    return _loglik(y_l, tuning, hyperparam, ma_neuron, ma_latent,
                   observation_model, dt=dt_l)


def get_naive_bayes_ma(
    y_l, tuning, hyperparam, ma_neuron, ma_latent, dt_l=1.0,
    observation_model="poisson",
):
    """Per-time posterior with no temporal smoothing; ``dt_l`` a scalar (the
    matmul form) or (T,).

    Returns (log_post (T,L), log_marginal_l (T,), log_marginal scalar,
    ll_per_pos_l (T,L))."""
    ll = _loglik(y_l, tuning, hyperparam, ma_neuron, ma_latent,
                 observation_model, dt=dt_l)
    log_marginal_l = torch.logsumexp(ll, dim=-1, keepdim=True)
    log_post = ll - log_marginal_l
    return log_post, log_marginal_l[:, 0], log_marginal_l.sum(), ll


def get_naive_bayes_ma_chunk(
    y,
    tuning,
    hyperparam,
    ma_neuron,
    ma_latent,
    dt_l=1.0,
    n_time_per_chunk=10000,
    observation_model="poisson",
):
    """Chunked naive Bayes; chunking only bounds peak memory.
    Returns (log_post_l, log_marginal_l, log_marginal_total, ll_per_pos_l)."""
    n_time_tot = y.shape[0]
    n_chunks = -(-n_time_tot // n_time_per_chunk)
    dt_l = _scalar_or_array(dt_l, tuning.device)
    if dt_l.ndim > 0:
        dt_l = torch.broadcast_to(dt_l, (n_time_tot,))
    ma_neuron = _as_f32(ma_neuron, tuning.device)
    ma_is_2d = ma_neuron.ndim == 2
    log_post_l, log_marginal_l_l, ll_l = [], [], []
    log_marginal_total = 0.0
    for n in range(n_chunks):
        sl = slice(n * n_time_per_chunk, (n + 1) * n_time_per_chunk)
        log_post, lml_l, lml, ll = get_naive_bayes_ma(
            y[sl], tuning, hyperparam,
            ma_neuron[sl] if ma_is_2d else ma_neuron, ma_latent,
            dt_l if dt_l.ndim == 0 else dt_l[sl],
            observation_model=observation_model,
        )
        log_post_l.append(log_post)
        log_marginal_l_l.append(lml_l)
        ll_l.append(ll)
        log_marginal_total = log_marginal_total + lml
    return (
        torch.cat(log_post_l, dim=0),
        torch.cat(log_marginal_l_l, dim=0),
        log_marginal_total,
        torch.cat(ll_l, dim=0),
    )
