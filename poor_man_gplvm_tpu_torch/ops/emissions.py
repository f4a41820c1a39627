"""Poisson emission log-likelihoods in matmul form (PyTorch).

Counterpart of ``poor_man_gplvm_tpu/ops/emissions.py`` for the Poisson
model with a scalar dt:

    lam = tuning*dt + RATE_FLOOR       (L, N), every entry > 0
    ll[t, l] = (ma*y)[t] @ log(lam)[l] - ma[t] @ lam[l]
               - sum_n ma[t, n] * lgamma(y[t, n] + 1)

The (T, N) @ (N, L) products are plain ``torch.matmul`` in float32: on the
card that needs TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``,
the default), matching the JAX package's ``Precision.HIGHEST``.  Gaussian
emissions and the per-time-dt path are not ported yet (ROADMAP item 11).
"""

from __future__ import annotations

import torch

RATE_FLOOR = 1e-20
MASK_NEG = -1e20

__all__ = [
    "RATE_FLOOR",
    "MASK_NEG",
    "poisson_loglik",
    "poisson_lgamma_term",
    "get_loglikelihood_ma_all",
    "get_naive_bayes_ma",
    "get_naive_bayes_ma_chunk",
]


def _as_f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _scalar_dt(dt):
    if torch.as_tensor(dt).ndim != 0:
        raise NotImplementedError(
            "per-time dt is not ported yet (ROADMAP item 11); pass a scalar"
        )
    return float(dt)


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
    ma_latent: (L,); dt: scalar.  A 1-D neuron mask is folded into the
    (L, N) side (one matmul, no (T, N) temporaries); a 2-D mask takes two
    matmuls, exactly like the JAX function, so both packages round alike.
    Masked latent bins are set to ``MASK_NEG``."""
    y = _as_f32(y, tuning.device)
    ma = _as_f32(ma_neuron, y.device)
    if lgamma_term is None:
        lgamma_term = poisson_lgamma_term(y, ma)
    lam = tuning * _scalar_dt(dt) + RATE_FLOOR  # (L, N)
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
    keep = _as_f32(ma_latent, y.device).bool()[None, :]
    return torch.where(keep, ll, torch.full_like(ll, MASK_NEG))


def get_loglikelihood_ma_all(
    y_l, tuning, hyperparam, ma_neuron, ma_latent, observation_model="poisson",
    lgamma_term=None,
):
    """(T, L) log-likelihood with dt=1."""
    if observation_model != "poisson":
        raise NotImplementedError(
            "Gaussian emissions are not ported yet (ROADMAP item 11)"
        )
    del hyperparam  # the Poisson likelihood has no emission hyperparameter
    return poisson_loglik(y_l, tuning, ma_neuron, ma_latent,
                          lgamma_term=lgamma_term)


def get_naive_bayes_ma(
    y_l, tuning, hyperparam, ma_neuron, ma_latent, dt_l=1.0,
    observation_model="poisson",
):
    """Per-time posterior with no temporal smoothing.

    Returns (log_post (T,L), log_marginal_l (T,), log_marginal scalar,
    ll_per_pos_l (T,L))."""
    if observation_model != "poisson":
        raise NotImplementedError(
            "Gaussian emissions are not ported yet (ROADMAP item 11)"
        )
    del hyperparam
    ll = poisson_loglik(y_l, tuning, ma_neuron, ma_latent, dt=dt_l)
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
    ma_neuron = _as_f32(ma_neuron, tuning.device)
    ma_is_2d = ma_neuron.ndim == 2
    log_post_l, log_marginal_l_l, ll_l = [], [], []
    log_marginal_total = 0.0
    for n in range(n_chunks):
        sl = slice(n * n_time_per_chunk, (n + 1) * n_time_per_chunk)
        log_post, lml_l, lml, ll = get_naive_bayes_ma(
            y[sl], tuning, hyperparam,
            ma_neuron[sl] if ma_is_2d else ma_neuron, ma_latent, dt_l,
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
