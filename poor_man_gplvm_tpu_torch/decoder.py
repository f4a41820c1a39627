"""Reference-compatible decoder module (drop-in import surface).

Counterpart of ``poor_man_gplvm_tpu/decoder.py``: the functional decoder
of the reference (``poor_man_gplvm.decoder``), the same names and
signatures, on the port's engine.  A script written against the JAX
package runs unchanged, with two additions to every entry point that
filters or smooths:

* ``device="cuda"``: inputs (numpy arrays or tensors) are moved there; the
  card by default, ``'cpu'`` on request; without a card ``'cuda'`` raises;
* ``engine=None`` where the JAX function takes ``engine="prob"``: None
  resolves by the device, ``'cuda'`` on the card (K1/K2, upgraded to the
  parallel-in-time K3/K4 for long sequences), ``'prob'`` on the CPU; the
  JAX names ``'pallas'`` and ``'pallas_parallel'`` are taken as
  ``'cuda'`` and ``'cuda_parallel'``.

``filter_all_step`` and ``smooth_all_step`` (a precomputed log-likelihood
and filter in, log space out) run K1 and K2 on the card and the port's
log-space scans (the JAX package's order of operations) on the CPU; on
the card they return the logs of the kernels' probabilities, so where a
probability underflows in f32 the card gives the floor -3e38
(``hmm.prob_to_log``) where the log-space scans give a finite log.  The
single-step functions are torch ops on one row on either device.  The
emission functions re-exported from ``ops.emissions`` follow the device
of ``tuning``.
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.models.base import resolve_device, resolve_engine
from poor_man_gplvm_tpu_torch.ops import hmm
from poor_man_gplvm_tpu_torch.ops.emissions import (  # noqa: F401
    gaussian_loglik,
    get_loglikelihood_ma_all,
    get_loglikelihood_ma_all_changing_dt,
    get_naive_bayes_ma,
    get_naive_bayes_ma_chunk,
    poisson_loglik,
)
from poor_man_gplvm_tpu_torch.ops.hmm import (  # noqa: F401
    JOINT_ACC_INIT,
    JointTransition,
    compute_transition_posterior_prob,
    filter_combined,
    prob_to_log,
    smooth_combined_chunked,
)

__all__ = [
    "get_loglikelihood_ma_poisson",
    "get_loglikelihood_ma_gaussian",
    "get_loglikelihood_ma_all",
    "get_loglikelihood_ma_all_changing_dt",
    "get_naive_bayes_ma",
    "get_naive_bayes_ma_chunk",
    "filter_one_step",
    "filter_all_step",
    "filter_all_step_combined_ma",
    "smooth_one_step",
    "smooth_all_step",
    "smooth_all_step_combined_ma_chunk",
    "compute_transition_posterior_prob",
]


# ---------------------------------------------------------------------------
# shared by the functional modules (decoder_latentonly, experimental)
# ---------------------------------------------------------------------------


def _setup(device, engine=None):
    """(torch.device, engine) of a functional entry point: ``device``
    checked as the models check theirs, ``engine`` None resolved by it,
    the JAX engine names taken as the port's."""
    device = resolve_device(device)
    return device, resolve_engine(hmm.ENGINE_ALIASES.get(engine, engine),
                                  device)


def _runs_kernels(device):
    """Whether ``filter_all_step``/``smooth_all_step`` run K1/K2 (on the
    card) rather than the log-space scans (on the CPU)."""
    return device.type == "cuda"


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _carry(carry, device):
    return tuple(_f32(c, device) for c in carry)


def _filter_all(ll, trans, carry_init, likelihood_scale, device):
    """Causal filter over a (T, L) log-likelihood from ``carry_init`` (the
    uniform state and 0 when None): one launch of K1 on the card, the
    log-space scan on the CPU.  Returns (log post, log marginal, log
    prior, ratios)."""
    ll = _f32(ll, device)
    if carry_init is None:
        carry_init = (trans.uniform_log_init(), 0.0)
    log_p, logz = _carry(carry_init, device)
    if _runs_kernels(device):
        post, prior, ratios = trans.cuda_filter(ll, torch.exp(log_p),
                                                likelihood_scale)
        return prob_to_log(post), logz + ratios.sum(), prob_to_log(prior), \
            ratios
    post, prior, ratios, (_, logz) = hmm._forward_scan_log(
        ll, trans, (log_p, logz), likelihood_scale)
    return post, logz, prior, ratios


def _smooth_all(log_filt, log_prior, trans, carry_init, device):
    """Reverse smoother over one chunk, log space in and out: one launch
    of K2 on the card (the pairwise joint ``trans.outer_acc`` over its
    ratios, as ``smooth_batch_full`` forms it), the log-space scan on the
    CPU.  ``carry_init`` None starts from the last filter posterior and
    smooths the steps before it (``log_prior``: the T - 1 priors of steps
    1 .. T-1); else (log smoothed posterior of the next step, log joint so
    far) and every step.  Returns (log smoothed posteriors, log joint)."""
    filt = _f32(log_filt, device)
    prior = _f32(log_prior, device)
    if carry_init is None:
        xs, init, acc_in = filt[:-1], filt[-1], None
    else:
        xs = filt
        init, acc_in = _carry(carry_init, device)
    if prior.shape[0] != xs.shape[0]:
        raise ValueError(f"{xs.shape[0]} filter steps to smooth, but "
                         f"{prior.shape[0]} priors of the steps after them")
    if _runs_kernels(device):
        if xs.shape[0] == 0:  # one step: nothing to smooth over
            smooth = xs
            acc = torch.zeros(trans.joint_shape(), dtype=torch.float32,
                              device=device)
        else:
            p_xs = torch.exp(xs)
            smooth_p, r = trans.cuda_smooth(p_xs, torch.exp(prior),
                                            torch.exp(init))
            smooth, acc = prob_to_log(smooth_p), trans.outer_acc(p_xs, r)
        if acc_in is not None:
            acc = acc + torch.exp(acc_in)
        acc = prob_to_log(acc)
    else:
        if acc_in is None:
            acc_in = torch.full(trans.joint_shape(), JOINT_ACC_INIT,
                                dtype=torch.float32, device=device)
        smooth, acc = hmm._backward_scan_log(xs, prior, trans,
                                             (init, acc_in))
    if carry_init is None:
        smooth = torch.cat([smooth, filt[-1][None]], dim=0)
    return smooth, acc


def _filter_one(carry, ll_curr, trans, likelihood_scale, device):
    """One causal filter step in log space (torch ops on one row)."""
    post, prior, ratios, carry_out = hmm._forward_scan_log(
        _f32(ll_curr, device)[None], trans, _carry(carry, device),
        likelihood_scale)
    return carry_out, (post[0], prior[0], ratios[0])


def _smooth_one(carry, x, trans, device):
    """One acausal smoother step in log space (torch ops on one row)."""
    log_smooth_next, log_acc = _carry(carry, device)
    log_filt_curr, log_prior_next = _carry(x, device)
    log_smooth_curr, inside = trans.smooth_step_log(
        log_smooth_next, log_filt_curr, log_prior_next)
    return (log_smooth_curr, torch.logaddexp(log_acc, inside)), \
        log_smooth_curr


def _joint(log_latent_transition_kernel_l, log_dynamics_transition_kernel,
           device=None):
    """The ``JointTransition`` of log matrices (n_dyn, L, L) and (n_dyn,
    n_dyn): their exps and the logs themselves, on ``device`` (None: where
    the tensors are; numpy on the CPU)."""
    log_lat = _f32(log_latent_transition_kernel_l, device)
    log_dyn = _f32(log_dynamics_transition_kernel, device)
    return JointTransition(Tdyn=torch.exp(log_dyn), Tlat=torch.exp(log_lat),
                           logTdyn=log_dyn, logTlat=log_lat)


# ---------------------------------------------------------------------------
# the reference's functions
# ---------------------------------------------------------------------------


def get_loglikelihood_ma_poisson(y, tuning, hyperparam, ma_neuron, ma_latent,
                                 dt=1.0, device="cuda"):
    """Single-timepoint Poisson log-likelihood over latent bins
    (reference decoder.py:31-48 signature)."""
    device, _ = _setup(device)
    return poisson_loglik(
        _f32(y, device)[None, :], _f32(tuning, device),
        _f32(ma_neuron, device)[None, :], ma_latent, dt=dt)[0]


def get_loglikelihood_ma_gaussian(y, tuning, hyperparam, ma_neuron, ma_latent,
                                  dt=1.0, device="cuda"):
    """Single-timepoint Gaussian log-likelihood over latent bins
    (reference decoder.py:50-57 signature)."""
    device, _ = _setup(device)
    return gaussian_loglik(
        _f32(y, device)[None, :], _f32(tuning, device),
        hyperparam["noise_std"], _f32(ma_neuron, device)[None, :], ma_latent,
        dt=dt)[0]


def filter_one_step(carry, ll_curr, log_latent_transition_kernel_l,
                    log_dynamics_transition_kernel, likelihood_scale=1,
                    device="cuda"):
    """One causal filter step in log space
    (reference decoder.py:151-172 signature): carry = (log_posterior_prev,
    log_marginal_tillprev) -> (carry_next, (log_post, log_prior, ratio))."""
    device, _ = _setup(device)
    trans = _joint(log_latent_transition_kernel_l,
                   log_dynamics_transition_kernel, device)
    return _filter_one(carry, ll_curr, trans, likelihood_scale, device)


def filter_all_step(log_likelihood_all, log_latent_transition_kernel_l,
                    log_dynamics_transition_kernel, carry_init=None,
                    likelihood_scale=1, device="cuda"):
    """Causal filter over a precomputed (T, L) log-likelihood, log space
    (reference decoder.py:174-187 signature): one launch of K1 on the
    card.  Returns (log_posterior_all, log_marginal_final, log_prior_all,
    log_one_step_predictive_marginals)."""
    device, _ = _setup(device)
    trans = _joint(log_latent_transition_kernel_l,
                   log_dynamics_transition_kernel, device)
    return _filter_all(log_likelihood_all, trans, carry_init,
                       likelihood_scale, device)


def smooth_one_step(carry, x, log_latent_transition_kernel_l,
                    log_dynamics_transition_kernel, device="cuda"):
    """One acausal smoother step in log space
    (reference decoder.py:200-226 signature): carry = (log_smooth_next,
    log_acc), x = (log_filt_curr, log_prior_next)."""
    device, _ = _setup(device)
    trans = _joint(log_latent_transition_kernel_l,
                   log_dynamics_transition_kernel, device)
    return _smooth_one(carry, x, trans, device)


def smooth_all_step(log_causal_posterior_all, log_causal_prior_all,
                    log_latent_transition_kernel_l,
                    log_dynamics_transition_kernel, carry_init=None,
                    device="cuda"):
    """Reverse smoother over one chunk, log space
    (reference decoder.py:230-256 signature): one launch of K2 on the
    card.  Returns (log_acausal_posterior_all,
    log_accumulated_joint_final)."""
    device, _ = _setup(device)
    trans = _joint(log_latent_transition_kernel_l,
                   log_dynamics_transition_kernel, device)
    return _smooth_all(log_causal_posterior_all, log_causal_prior_all, trans,
                       carry_init, device)


def filter_all_step_combined_ma(
    y, tuning, hyperparam, log_latent_transition_kernel_l,
    log_dynamics_transition_kernel, ma_neuron, ma_latent, carry_init=None,
    likelihood_scale=1, observation_model="poisson", engine=None,
    device="cuda",
):
    """Fused likelihood + causal filter (reference decoder.py:189-198),
    ``hmm.filter_combined``: one launch of K1 on the card.  A (N,)
    ``ma_neuron`` is broadcast to y's shape.

    Returns (log_posterior_all, log_marginal_final, log_prior_curr_all,
    log_one_step_predictive_marginals, log_likelihood_all)."""
    device, engine = _setup(device, engine)
    trans = _joint(log_latent_transition_kernel_l,
                   log_dynamics_transition_kernel, device)
    y = _f32(y, device)
    return filter_combined(
        y, _f32(tuning, device), hyperparam, trans,
        torch.broadcast_to(_f32(ma_neuron, device), y.shape),
        _f32(ma_latent, device), carry_init=carry_init,
        likelihood_scale=likelihood_scale,
        observation_model=observation_model, engine=engine)


def smooth_all_step_combined_ma_chunk(
    y, tuning, hyperparam, log_latent_transition_kernel_l,
    log_dynamics_transition_kernel, ma_neuron, ma_latent=None,
    likelihood_scale=1, n_time_per_chunk=10000, observation_model="poisson",
    engine=None, device="cuda",
):
    """Chunked forward-backward smoother (reference decoder.py:258-332),
    ``hmm.smooth_combined_chunked``: on the card K1/K2, or K3/K4 from
    ``hmm._PARALLEL_UPGRADE_MIN_T`` steps on.

    Returns the reference 6-tuple (log_acausal_posterior_all,
    log_marginal_final, log_causal_posterior_all,
    log_one_step_predictive_marginals, log_accumulated_joint,
    log_likelihood_all)."""
    device, engine = _setup(device, engine)
    trans = _joint(log_latent_transition_kernel_l,
                   log_dynamics_transition_kernel, device)
    return smooth_combined_chunked(
        _f32(y, device), _f32(tuning, device), hyperparam, trans,
        _f32(ma_neuron, device),
        None if ma_latent is None else _f32(ma_latent, device),
        likelihood_scale=likelihood_scale, n_time_per_chunk=n_time_per_chunk,
        observation_model=observation_model, engine=engine)
