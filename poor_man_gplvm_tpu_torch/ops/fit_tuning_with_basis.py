"""Legacy per-neuron L-BFGS M-step on grouped statistics (PyTorch).

Counterpart of ``poor_man_gplvm_tpu/ops/fit_tuning_with_basis.py``
(reference poor_man_gplvm/fit_tuning_with_basis.py, the pre-Adam fitting
path, kept for parity): each neuron's params are a (weights, bias) tuple,
the objective is the grouped Poisson log joint normalised by the
latent-bin count, with a Gaussian prior on the weights.

The JAX package vmaps ``optax.lbfgs`` over neurons.  Here one L-BFGS runs
all N neurons at once on (N, n_basis + 1) tensors: the two-loop recursion
over the last ``LBFGS_MEMORY`` pairs, each neuron with its own history
(a pair with s.y <= 0 is skipped for that neuron only) and its own
inverse-Hessian scale, and a per-neuron backtracking line search whose
``LINESEARCH_STEPS`` trial steps (1, 1/2, 1/4, ...) are evaluated in one
batched call; each neuron takes the longest that meets the Armijo
condition (none: it stays).  Nothing is read to the host inside the loop.
The iterates differ from optax's (another line search); the objective
values are what the two packages share.
"""

from __future__ import annotations

import torch

__all__ = [
    "glm_get_tuning",
    "gaussian_logprior",
    "get_log_prior_params",
    "group_spk_occupancy_chunk_neuron",
    "get_log_poisson_p_y_given_params_oneneuron_grouped",
    "get_log_poisson_p_y_joint_params_oneneuron_grouped",
    "m_step_get_tuning_all_neuron_grouped",
]

LBFGS_MEMORY = 10
LINESEARCH_STEPS = 20
ARMIJO_C1 = 1e-4


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def glm_get_tuning(params, basis):
    """softplus(basis @ w + b) with a (w, b) param tuple
    (reference fit_tuning_with_basis.py:13-22)."""
    params_w, params_b = params
    return _softplus(basis @ params_w + params_b)


def gaussian_logprior(params, var):
    return torch.sum(-torch.sum(params**2, dim=0) / (2 * var))


def get_log_prior_params(params_one, prior_hyper):
    """Gaussian prior on the weights only (not the bias)
    (reference fit_tuning_with_basis.py:29-33)."""
    return gaussian_logprior(params_one[0], prior_hyper)


def group_spk_occupancy_chunk_neuron(spk, post_x_l, n_neuron_per_chunk=100,
                                     dt=1.0):
    """Grouped statistics: posterior-weighted spikes (L, N) and occupancy
    (L,) with an optional per-time dt (reference
    fit_tuning_with_basis.py:59-76); one (L, T) @ (T, N) product, so no
    neuron chunking."""
    del n_neuron_per_chunk
    spk = torch.as_tensor(spk, dtype=torch.float32)
    post_x_l = torch.as_tensor(post_x_l, dtype=torch.float32,
                               device=spk.device)
    dt_l = torch.broadcast_to(
        torch.as_tensor(dt, dtype=spk.dtype, device=spk.device),
        (spk.shape[0],))
    t_b = (post_x_l * dt_l[:, None]).sum(dim=0)
    return post_x_l.T @ spk, t_b


def get_log_poisson_p_y_given_params_oneneuron_grouped(params_one, s_b_one,
                                                       basis, t_b):
    """Grouped Poisson log-likelihood for one neuron
    (reference fit_tuning_with_basis.py:79-88)."""
    pf_one = glm_get_tuning(params_one, basis)
    return torch.sum(torch.xlogy(s_b_one, pf_one + 1e-20) - pf_one * t_b)


def get_log_poisson_p_y_joint_params_oneneuron_grouped(params_one, s_b_one,
                                                       basis, t_b,
                                                       prior_hyper):
    """Log joint, normalised by the latent-bin count
    (reference fit_tuning_with_basis.py:90-96)."""
    l_p = get_log_poisson_p_y_given_params_oneneuron_grouped(
        params_one, s_b_one, basis, t_b)
    l_prior = get_log_prior_params(params_one, prior_hyper)
    return (l_p + l_prior) / s_b_one.shape[0]


def _neg_objective(params_one, s_b_one, basis, t_b, prior_hyper):
    return -get_log_poisson_p_y_joint_params_oneneuron_grouped(
        params_one, s_b_one, basis, t_b, prior_hyper)


def _neg_objective_all(x, s_b, basis, t_b, prior_hyper):
    """The negative objective of every neuron at once: x (..., N, n_basis
    + 1), each neuron's weights then its bias; returns (..., N)."""
    w, b = x[..., :-1], x[..., -1]
    pf = _softplus(torch.einsum("lk,...nk->...nl", basis, w) + b[..., None])
    l_p = torch.sum(torch.xlogy(s_b.T, pf + 1e-20) - pf * t_b, dim=-1)
    l_prior = -torch.sum(w**2, dim=-1) / (2 * prior_hyper)
    return -(l_p + l_prior) / s_b.shape[0]


def _value_and_grad(fun, x):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        f = fun(x)
        (g,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), g


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _lbfgs(fun, x, maxiter):
    """Batched L-BFGS on x (N, D), ``fun`` -> (N,) independent objectives
    (see the module docstring).  Returns (x, f(x))."""
    f, g = _value_and_grad(fun, x)
    hist = []  # (s, y, rho) per accepted iteration, rho = 0 where skipped
    gamma = 1.0 / torch.clamp(g.norm(dim=-1), min=1.0)
    alphas = 0.5 ** torch.arange(LINESEARCH_STEPS, dtype=x.dtype,
                                 device=x.device)
    for _ in range(maxiter):
        # two-loop recursion: d = -H g
        q = g
        a_l = []
        for s, y, rho in reversed(hist):
            a = rho * _dot(s, q)
            q = q - a[:, None] * y
            a_l.append(a)
        r = gamma[:, None] * q
        for (s, y, rho), a in zip(hist, reversed(a_l)):
            bcoef = rho * _dot(y, r)
            r = r + s * (a - bcoef)[:, None]
        d = -r
        gd = _dot(g, d)
        descent = gd < 0
        d = torch.where(descent[:, None], d, -gamma[:, None] * g)
        gd = torch.where(descent, gd, -gamma * _dot(g, g))
        # every trial step at once; each neuron takes the longest that
        # meets the Armijo condition
        trial = x[None] + alphas[:, None, None] * d[None]
        f_trial = fun(trial)  # (K, N)
        ok = f_trial <= f[None] + ARMIJO_C1 * alphas[:, None] * gd[None]
        ok &= torch.isfinite(f_trial)
        first = torch.argmax(ok.to(torch.int8), dim=0)
        step = torch.where(ok.any(dim=0), alphas[first], 0.0)
        x_new = x + step[:, None] * d
        f_new, g_new = _value_and_grad(fun, x_new)
        s, y = x_new - x, g_new - g
        sy = _dot(s, y)
        good = sy > 1e-10
        rho = torch.where(good, 1.0 / torch.where(good, sy, 1.0), 0.0)
        gamma = torch.where(good, sy / torch.clamp(_dot(y, y), min=1e-30),
                            gamma)
        hist.append((s, y, rho))
        if len(hist) > LBFGS_MEMORY:
            hist.pop(0)
        x, f, g = x_new, f_new, g_new
    return x, f


def m_step_get_tuning_all_neuron_grouped(
    params_init, spk, tuning_basis, posterior_marg, prior_hyper, maxiter=500,
    stepsize=0.001, n_time_per_chunk=50000, n_neuron_per_chunk=100, dt=1,
):
    """Per-neuron L-BFGS M-step, all neurons in one batched solve
    (reference fit_tuning_with_basis.py:100-115).

    params_init: ((n_basis, N), (N,)) weights/bias tuple.  Runs on the
    device of ``spk``.  Returns (params_fit, tuning_fit (L, N), final_err:
    the summed negative objective at the fit)."""
    del stepsize, n_time_per_chunk  # the line search picks its own step
    spk = torch.as_tensor(spk, dtype=torch.float32)
    dev = spk.device
    basis = torch.as_tensor(tuning_basis, dtype=torch.float32, device=dev)
    s_b, t_b = group_spk_occupancy_chunk_neuron(
        spk, posterior_marg, n_neuron_per_chunk=n_neuron_per_chunk, dt=dt)
    w0, b0 = (torch.as_tensor(p, dtype=torch.float32, device=dev)
              for p in params_init)
    x0 = torch.cat([w0.T, b0[:, None]], dim=1)  # (N, n_basis + 1)

    def fun(x):
        return _neg_objective_all(x, s_b, basis, t_b, prior_hyper)

    x, f = _lbfgs(fun, x0, maxiter)
    params_fit = (x[:, :-1].T.contiguous(), x[:, -1].contiguous())
    return params_fit, glm_get_tuning(params_fit, basis), f.sum()


def get_s_b(spk_chunk, post_x_l):
    """Posterior-weighted spikes per latent state, (L, N)
    (reference fit_tuning_with_basis.py:55-57)."""
    return torch.as_tensor(post_x_l, dtype=torch.float32).T @ torch.as_tensor(
        spk_chunk, dtype=torch.float32)
