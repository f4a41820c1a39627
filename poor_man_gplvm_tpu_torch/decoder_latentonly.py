"""Reference-compatible latent-only decoder module.

Counterpart of ``poor_man_gplvm_tpu/decoder_latentonly.py``
(``poor_man_gplvm.decoder_latentonly``) on the port's engine: the rules of
``decoder`` (``device="cuda"``, ``engine=None``, the JAX engine names,
K1/K2 on the card for ``filter_all_step_latent`` and
``smooth_all_step_latent``) with one (L, L) latent transition, which the
kernels run as one channel (n_dyn = 1).
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.decoder import (
    _f32,
    _filter_all,
    _filter_one,
    _setup,
    _smooth_all,
    _smooth_one,
)
from poor_man_gplvm_tpu_torch.ops.emissions import (  # noqa: F401
    get_loglikelihood_ma_all,
    get_loglikelihood_ma_all_changing_dt,
    get_naive_bayes_ma,
    get_naive_bayes_ma_chunk,
)
from poor_man_gplvm_tpu_torch.ops.hmm import (  # noqa: F401
    LatentTransition,
    compute_transition_posterior_prob_latent,
    filter_combined,
    smooth_combined_chunked,
)

__all__ = [
    "filter_all_step_combined_ma_latent",
    "smooth_all_step_combined_ma_chunk_latent",
    "compute_transition_posterior_prob_latent",
]


def _latent(log_latent_transition_kernel, device=None):
    """The ``LatentTransition`` of a log (L, L) matrix: its exp and the log
    itself, on ``device`` (None: where the tensor is)."""
    log_t = _f32(log_latent_transition_kernel, device)
    return LatentTransition(T=torch.exp(log_t), logT=log_t)


def filter_all_step_combined_ma_latent(
    y, tuning, hyperparam, log_latent_transition_kernel, ma_neuron, ma_latent,
    carry_init=None, likelihood_scale=1, observation_model="poisson",
    engine=None, device="cuda",
):
    """Fused likelihood + causal filter, latent-only
    (reference decoder_latentonly.py:82-94): one launch of K1 on the
    card."""
    device, engine = _setup(device, engine)
    trans = _latent(log_latent_transition_kernel, device)
    y = _f32(y, device)
    return filter_combined(
        y, _f32(tuning, device), hyperparam, trans,
        torch.broadcast_to(_f32(ma_neuron, device), y.shape),
        _f32(ma_latent, device), carry_init=carry_init,
        likelihood_scale=likelihood_scale,
        observation_model=observation_model, engine=engine)


def smooth_all_step_combined_ma_chunk_latent(
    y, tuning, hyperparam, log_latent_transition_kernel, ma_neuron,
    ma_latent=None, likelihood_scale=1, n_time_per_chunk=10000,
    observation_model="poisson", engine=None, device="cuda",
):
    """Chunked forward-backward smoother, latent-only
    (reference decoder_latentonly.py:156-224): on the card K1/K2, or K3/K4
    from ``hmm._PARALLEL_UPGRADE_MIN_T`` steps on."""
    device, engine = _setup(device, engine)
    trans = _latent(log_latent_transition_kernel, device)
    return smooth_combined_chunked(
        _f32(y, device), _f32(tuning, device), hyperparam, trans,
        _f32(ma_neuron, device),
        None if ma_latent is None else _f32(ma_latent, device),
        likelihood_scale=likelihood_scale, n_time_per_chunk=n_time_per_chunk,
        observation_model=observation_model, engine=engine)


def filter_one_step_latent(carry, ll_curr, log_latent_transition_kernel,
                           likelihood_scale=1, device="cuda"):
    """One causal filter step, latent-only, log space
    (reference decoder_latentonly.py:33-56)."""
    device, _ = _setup(device)
    return _filter_one(carry, ll_curr,
                       _latent(log_latent_transition_kernel, device),
                       likelihood_scale, device)


def filter_all_step_latent(log_likelihood_all, log_latent_transition_kernel,
                           carry_init=None, likelihood_scale=1,
                           device="cuda"):
    """Causal filter over a precomputed (T, L) log-likelihood, latent-only
    (reference decoder_latentonly.py:58-81): one launch of K1 on the card.
    Returns (log_posterior_all, log_marginal_final, log_prior_all,
    ratios)."""
    device, _ = _setup(device)
    return _filter_all(log_likelihood_all,
                       _latent(log_latent_transition_kernel, device),
                       carry_init, likelihood_scale, device)


def smooth_one_step_latent(carry, x, log_latent_transition_kernel,
                           device="cuda"):
    """One acausal smoother step, latent-only, log space
    (reference decoder_latentonly.py:96-123)."""
    device, _ = _setup(device)
    return _smooth_one(carry, x,
                       _latent(log_latent_transition_kernel, device), device)


def smooth_all_step_latent(log_causal_posterior_all, log_causal_prior_all,
                           log_latent_transition_kernel, carry_init=None,
                           device="cuda"):
    """Reverse smoother over one chunk, latent-only, log space
    (reference decoder_latentonly.py:126-154): one launch of K2 on the
    card."""
    device, _ = _setup(device)
    return _smooth_all(log_causal_posterior_all, log_causal_prior_all,
                       _latent(log_latent_transition_kernel, device),
                       carry_init, device)
