"""Reference-compatible gain decoder module (counterpart of
``poor_man_gplvm_tpu/experimental/decoder_exp.py``, mirroring
``poor_man_gplvm.experimental.decoder_exp``).

The per-timestep population gain enters the Poisson/Gaussian emission as a
rate multiplier, so it folds into the per-bin dt path (rate = tuning *
(gain * dt)): every function here is a thin wrapper over ``ops.emissions``
and ``ops.hmm``, with the rules of ``decoder`` (``device="cuda"``;
``engine=None``, the JAX engine names).  The smoother runs K1-K4 on the
card through ``smooth_combined_chunked(dt_l=gain)``, the filter K1.
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.decoder import (  # noqa: F401
    _f32,
    _filter_all,
    _joint,
    _setup,
    filter_all_step,
    smooth_all_step,
    smooth_one_step,
)
from poor_man_gplvm_tpu_torch.ops.emissions import (
    gaussian_loglik,
    get_loglikelihood_ma_all_changing_dt,
    poisson_loglik,
)
from poor_man_gplvm_tpu_torch.ops.hmm import smooth_combined_chunked

__all__ = [
    "get_loglikelihood_ma_poisson_gain",
    "get_loglikelihood_ma_gaussian_gain",
    "get_loglikelihood_ma_all_gain",
    "get_loglikelihood_ma_all_changing_dt_gain",
    "get_naive_bayes_ma_gain",
    "get_naive_bayes_ma_chunk_gain",
    "filter_all_step_combined_ma_gain",
    "smooth_all_step_combined_ma_chunk_gain",
    "smooth_one_step",
    "smooth_all_step",
]


def _per_bin(x, n_time, device):
    """A scalar or (T,) per-bin factor as a (T,) f32 tensor."""
    return torch.broadcast_to(_f32(x, device), (n_time,))


def get_loglikelihood_ma_poisson_gain(y, tuning, hyperparam, ma_neuron,
                                      ma_latent, dt=1.0, gain=1.0,
                                      device="cuda"):
    """Single-timepoint gain-scaled Poisson LL
    (reference experimental/decoder_exp.py:85-99)."""
    device, _ = _setup(device)
    return poisson_loglik(
        _f32(y, device)[None, :], _f32(tuning, device),
        _f32(ma_neuron, device)[None, :], ma_latent,
        dt=(_f32(dt, device) * _f32(gain, device)).reshape(1))[0]


def get_loglikelihood_ma_gaussian_gain(y, tuning, hyperparam, ma_neuron,
                                       ma_latent, dt=1.0, gain=1.0,
                                       device="cuda"):
    """Single-timepoint gain-scaled Gaussian LL
    (reference experimental/decoder_exp.py:101-109)."""
    device, _ = _setup(device)
    return gaussian_loglik(
        _f32(y, device)[None, :], _f32(tuning, device),
        hyperparam["noise_std"], _f32(ma_neuron, device)[None, :], ma_latent,
        dt=(_f32(dt, device) * _f32(gain, device)).reshape(1))[0]


def get_loglikelihood_ma_all_gain(y_l, tuning, hyperparam, ma_neuron,
                                  ma_latent, gain_l,
                                  observation_model="poisson", device="cuda"):
    """(T, L) gain-scaled LL, dt=1
    (reference experimental/decoder_exp.py:111-123)."""
    device, _ = _setup(device)
    y_l = _f32(y_l, device)
    return get_loglikelihood_ma_all_changing_dt(
        y_l, _f32(tuning, device), hyperparam, _f32(ma_neuron, device),
        ma_latent, _per_bin(gain_l, y_l.shape[0], device),
        observation_model=observation_model)


def get_loglikelihood_ma_all_changing_dt_gain(
    y_l, tuning, hyperparam, ma_neuron, ma_latent, dt_l, gain_l,
    observation_model="poisson", device="cuda",
):
    """(T, L) LL with per-time dt AND gain
    (reference experimental/decoder_exp.py:125-135)."""
    device, _ = _setup(device)
    y_l = _f32(y_l, device)
    T = y_l.shape[0]
    return get_loglikelihood_ma_all_changing_dt(
        y_l, _f32(tuning, device), hyperparam, _f32(ma_neuron, device),
        ma_latent, _per_bin(dt_l, T, device) * _per_bin(gain_l, T, device),
        observation_model=observation_model)


def get_naive_bayes_ma_gain(y_l, tuning, hyperparam, ma_neuron, ma_latent,
                            dt_l=1, gain_l=1.0, observation_model="poisson",
                            device="cuda"):
    """Naive-Bayes decode with gain
    (reference experimental/decoder_exp.py:138-148).  Returns (log_post,
    log_marginal_l, log_marginal, ll)."""
    ll = get_loglikelihood_ma_all_changing_dt_gain(
        y_l, tuning, hyperparam, ma_neuron, ma_latent, dt_l, gain_l,
        observation_model=observation_model, device=device)
    log_marginal_l = torch.logsumexp(ll, dim=-1, keepdim=True)
    return ll - log_marginal_l, log_marginal_l[:, 0], log_marginal_l.sum(), ll


def get_naive_bayes_ma_chunk_gain(y, tuning, hyperparam, ma_neuron, ma_latent,
                                  dt_l=1, n_time_per_chunk=10000,
                                  observation_model="poisson", gain_l=1.0,
                                  device="cuda"):
    """Chunked naive Bayes with gain
    (reference experimental/decoder_exp.py:150-184); a (T, N) neuron mask
    is cut with the chunks."""
    device, _ = _setup(device)
    y = _f32(y, device)
    T = y.shape[0]
    dt_l, gain_l = _per_bin(dt_l, T, device), _per_bin(gain_l, T, device)
    ma_neuron = _f32(ma_neuron, device)
    posts, lml_l, lls = [], [], []
    total = 0.0
    for a in range(0, T, n_time_per_chunk):
        sl = slice(a, a + n_time_per_chunk)
        p, ml, m, ll = get_naive_bayes_ma_gain(
            y[sl], tuning, hyperparam,
            ma_neuron[sl] if ma_neuron.ndim == 2 else ma_neuron, ma_latent,
            dt_l[sl], gain_l[sl], observation_model=observation_model,
            device=device)
        posts.append(p)
        lml_l.append(ml)
        lls.append(ll)
        total = total + m
    return (torch.cat(posts, dim=0), torch.cat(lml_l, dim=0), total,
            torch.cat(lls, dim=0))


def filter_all_step_combined_ma_gain(
    y, tuning, hyperparam, log_latent_transition_kernel_l,
    log_dynamics_transition_kernel, ma_neuron, ma_latent, carry_init=None,
    likelihood_scale=1, observation_model="poisson", gain_l=1.0,
    device="cuda",
):
    """Fused gain-scaled likelihood + causal filter
    (reference experimental/decoder_exp.py:186-195): one launch of K1 on
    the card.  Returns (log_post, log_marginal, log_prior, ratios, ll)."""
    device, _ = _setup(device)
    y = _f32(y, device)
    ll = get_loglikelihood_ma_all_gain(
        y, tuning, hyperparam,
        torch.broadcast_to(_f32(ma_neuron, device), y.shape), ma_latent,
        gain_l, observation_model=observation_model, device=device)
    trans = _joint(log_latent_transition_kernel_l,
                   log_dynamics_transition_kernel, device)
    post, lml, prior, ratios = _filter_all(ll, trans, carry_init,
                                           likelihood_scale, device)
    return post, lml, prior, ratios, ll


def smooth_all_step_combined_ma_chunk_gain(
    y, tuning, hyperparam, log_latent_transition_kernel_l,
    log_dynamics_transition_kernel, ma_neuron, ma_latent=None,
    likelihood_scale=1, n_time_per_chunk=10000, observation_model="poisson",
    gain_l=1.0, engine=None, device="cuda",
):
    """Chunked forward-backward smoother with gain
    (reference experimental/decoder_exp.py:198-259):
    ``smooth_combined_chunked(dt_l=gain)``, K1/K2 or K3/K4 on the card."""
    device, engine = _setup(device, engine)
    y = _f32(y, device)
    trans = _joint(log_latent_transition_kernel_l,
                   log_dynamics_transition_kernel, device)
    return smooth_combined_chunked(
        y, _f32(tuning, device), hyperparam, trans, _f32(ma_neuron, device),
        None if ma_latent is None else _f32(ma_latent, device),
        likelihood_scale=likelihood_scale, n_time_per_chunk=n_time_per_chunk,
        observation_model=observation_model, engine=engine,
        dt_l=_per_bin(gain_l, y.shape[0], device))
