"""M-step: sufficient statistics, tuning links, the Poisson objectives and
their Adam runner, and the Gaussian ridge solve (PyTorch).

Counterpart of ``poor_man_gplvm_tpu/ops/mstep.py``, and the M-step of B
runs at once (``*_batch``: a sweep's runs, ``parallel/sweep.py``; the JAX
package vmaps the single-run functions instead).
The EM M-step works on *grouped* statistics, the posterior-weighted counts
``y_weighted`` (L, N) and occupancy ``t_weighted`` (L,), so its cost does
not depend on T; the statistics are one (T, L)^T @ (T, N) matmul.

Adam is written out by hand in optax's order of operations (``optax.adam``
with b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0), with an explicit state
``AdamState(count, mu, nu)``, so that a fit resumed from a JAX optimizer
state (``convert.adam_state_from_jax``) computes the same thing.  The
runner keeps the JAX package's stopping rule; its loop reads the stopping
test on the host once per iteration after the first five.  The scalar
constants of the loop (Adam's decay rates, the prior's scale) are made on
the device once and reused (``_const``), so an iteration copies nothing
from the host.
"""

from __future__ import annotations

import functools
import math
import numbers
from typing import NamedTuple

import torch

from poor_man_gplvm_tpu_torch.ops.precision import matmul

__all__ = [
    "AdamState",
    "adam_init",
    "adam_init_batch",
    "adam_update",
    "batch_trim_m_step_histories",
    "gaussian_m_step_analytic",
    "gaussian_m_step_analytic_batch",
    "get_statistics",
    "get_statistics_batch",
    "get_tuning_linear",
    "get_tuning_softplus",
    "make_adam_runner",
    "make_adam_runner_batch",
    "make_adam_runner_cached",
    "package_adam_result",
    "poisson_m_step_objective",
    "poisson_m_step_objective_batch",
    "poisson_m_step_objective_smoothness",
    "tree_l2_norm",
]

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

@functools.lru_cache(maxsize=64)  # swept hyperparameters: stay bounded
def _const(value, device, dtype=torch.float32):
    """0-dim tensor of a Python scalar on ``device``, made once per (value,
    device, dtype) by a fill on the device: the bits of
    ``torch.tensor(value, dtype=dtype)`` without its host-to-device copy at
    every use."""
    return torch.full((), float(value), dtype=dtype, device=device)


def get_tuning_linear(params, basis):
    """tuning = basis @ params; params: (n_basis, N), basis: (L, n_basis)."""
    return basis @ params


def get_tuning_softplus(params, basis):
    """softplus link for nonnegative Poisson rates, computed as
    ``logaddexp(x, 0)`` like ``jax.nn.softplus`` (``F.softplus`` switches
    to the identity above x=20, which the JAX link does not)."""
    x = get_tuning_linear(params, basis)
    return torch.logaddexp(x, torch.zeros_like(x))


def _statistics_block(log_posterior_probs, y):
    posterior_probs = torch.exp(log_posterior_probs)
    return matmul(posterior_probs.T, y), posterior_probs.sum(dim=0)


def get_statistics(log_posterior_probs, y, n_time_per_chunk=200_000):
    """Posterior-weighted observations and occupancy per latent bin,
    accumulated over time chunks so the exp + matmul transients stay
    O(chunk).  The product ``post.T @ y`` runs at the matmul precision
    (``ops/precision.py``; on the card at a lower level ``post.T`` is read
    in place).  Returns (y_weighted (L, N), t_weighted (L,))."""
    y = torch.as_tensor(y, dtype=torch.float32,
                        device=log_posterior_probs.device)
    T = log_posterior_probs.shape[0]
    if T <= n_time_per_chunk:
        return _statistics_block(log_posterior_probs, y)
    y_weighted = t_weighted = None
    for start in range(0, T, n_time_per_chunk):
        sl = slice(start, start + n_time_per_chunk)
        yw, tw = _statistics_block(log_posterior_probs[sl], y[sl])
        if y_weighted is None:
            y_weighted, t_weighted = yw, tw
        else:
            y_weighted = y_weighted + yw
            t_weighted = t_weighted + tw
    return y_weighted, t_weighted


def get_statistics_batch(log_posterior_probs, y, n_time_per_chunk=200_000):
    """``get_statistics`` of B runs' posteriors (B, T, L) against one y
    (T, N): returns (y_weighted (B, L, N), t_weighted (B, L))."""
    y = torch.as_tensor(y, dtype=torch.float32,
                        device=log_posterior_probs.device)
    T = log_posterior_probs.shape[1]
    y_weighted = t_weighted = None
    for start in range(0, T, n_time_per_chunk):
        post = torch.exp(log_posterior_probs[:, start:start + n_time_per_chunk])
        yw = matmul(post.transpose(1, 2),
                    y[start:start + n_time_per_chunk])
        tw = post.sum(dim=1)
        if y_weighted is None:
            y_weighted, t_weighted = yw, tw
        else:
            y_weighted = y_weighted + yw
            t_weighted = t_weighted + tw
    return y_weighted, t_weighted


def _norm_logpdf(x, scale):
    """``jax.scipy.stats.norm.logpdf(x, 0, scale)`` in its order of
    operations: (log(2 pi scale^2) + x^2 / scale^2) / -2."""
    if isinstance(scale, numbers.Real):
        scale = _const(float(scale), x.device, x.dtype)
    else:
        scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    log_normalizer = torch.log(2 * math.pi * scale**2)
    return (log_normalizer + x**2 / scale**2) / -2


def poisson_m_step_objective(param, hyperparam, basis_mat, y_weighted,
                             t_weighted):
    """Negative expected log joint on grouped statistics plus the Gaussian
    prior on the basis weights."""
    pf_hat = get_tuning_softplus(param, basis_mat)  # (L, N)
    norm_term = pf_hat * t_weighted[:, None]
    fit_term = torch.xlogy(y_weighted, pf_hat + 1e-20)
    log_likelihood = torch.sum(fit_term - norm_term)
    log_prior = _norm_logpdf(param, hyperparam["param_prior_std"]).sum()
    return -log_likelihood - log_prior


def poisson_m_step_objective_smoothness(param, hyperparam, basis_mat,
                                        y_weighted, t_weighted):
    """The Poisson objective plus a roughness penalty on the tuning curves,
    ``smoothness_penalty`` times the sum of their squared second finite
    differences over the latent bins (the objective of the B-spline
    basis)."""
    tuning = get_tuning_softplus(param, basis_mat)
    second_diff = tuning[2:] - 2.0 * tuning[1:-1] + tuning[:-2]
    roughness_term = hyperparam["smoothness_penalty"] * torch.sum(
        second_diff**2)
    norm_term = tuning * t_weighted[:, None]
    fit_term = torch.xlogy(y_weighted, tuning + 1e-20)
    log_likelihood = torch.sum(fit_term - norm_term)
    log_prior = _norm_logpdf(param, hyperparam["param_prior_std"]).sum()
    return -log_likelihood - log_prior + roughness_term


def _run_scalar(v, like):
    """A per-run (B,) hyperparameter as (B, 1, 1) on ``like``'s device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(
        -1, 1, 1)


def poisson_m_step_objective_batch(param, hyperparam, basis_mat, y_weighted,
                                   t_weighted):
    """``poisson_m_step_objective`` of B runs at once: param (B, n_basis,
    N), basis_mat (B, L, n_basis) or one (L, n_basis), y_weighted (B, L,
    N), t_weighted (B, L), ``hyperparam['param_prior_std']`` (B,).
    Returns the (B,) losses."""
    pf_hat = get_tuning_softplus(param, basis_mat)  # (B, L, N)
    norm_term = pf_hat * t_weighted[:, :, None]
    fit_term = torch.xlogy(y_weighted, pf_hat + 1e-20)
    log_likelihood = torch.sum(fit_term - norm_term, dim=(1, 2))
    scale = _run_scalar(hyperparam["param_prior_std"], param)
    log_prior = ((torch.log(2 * math.pi * scale**2) + param**2 / scale**2)
                 / -2).sum(dim=(1, 2))
    return -log_likelihood - log_prior


def gaussian_m_step_analytic_batch(hyperparam, basis_mat, y_weighted,
                                   t_weighted):
    """``gaussian_m_step_analytic`` of B runs at once: one batched
    (n_basis, n_basis) solve; ``noise_std`` and ``param_prior_std`` (B,),
    basis_mat (B, L, n_basis) or one (L, n_basis).  Returns (B, n_basis,
    N)."""
    B = y_weighted.shape[0]
    basis_mat = basis_mat.expand(B, *basis_mat.shape[-2:])
    n_basis = basis_mat.shape[-1]
    noise_var = _run_scalar(hyperparam["noise_std"], y_weighted) ** 2
    prior_std = _run_scalar(hyperparam["param_prior_std"], y_weighted)
    gram = torch.einsum("bqd,bq,bqc->bdc", basis_mat, t_weighted, basis_mat)
    H = gram / noise_var + torch.eye(
        n_basis, dtype=gram.dtype, device=gram.device) / (prior_std**2)
    rhs = basis_mat.transpose(1, 2) @ y_weighted / noise_var
    return torch.linalg.solve(H, rhs)


def gaussian_m_step_analytic(hyperparam, basis_mat, y_weighted, t_weighted):
    """Closed-form ridge solve of the Gaussian M-step,
    ``w = (B^T D B / s^2 + I / tau^2)^{-1} B^T y_w / s^2`` with D the
    occupancy ``t_weighted``, s ``hyperparam['noise_std']`` (a scalar) and
    tau ``hyperparam['param_prior_std']``: one (n_basis, n_basis) system,
    ``torch.linalg.solve`` (the JAX package solves it outside any Pallas
    kernel too).  Returns the (n_basis, N) weights."""
    n_basis = basis_mat.shape[1]
    noise_var = hyperparam["noise_std"] ** 2
    param_prior_std = hyperparam["param_prior_std"]
    gram = torch.einsum("qd,q,qb->db", basis_mat, t_weighted, basis_mat)
    H = gram / noise_var + torch.eye(
        n_basis, dtype=gram.dtype, device=gram.device) / (param_prior_std**2)
    rhs = basis_mat.T @ y_weighted / noise_var
    return torch.linalg.solve(H, rhs)


def tree_l2_norm(tree_x, squared=False):
    """L2 norm across a tensor, or a list, tuple or dict of tensors (the
    JAX package's pytree; reference fit_tuning_helper.py:199-205); its
    square with ``squared``."""
    if torch.is_tensor(tree_x):
        sqnorm = torch.sum(torch.square(tree_x))
    else:
        leaves = tree_x.values() if isinstance(tree_x, dict) else tree_x
        sqnorm = sum(torch.sum(torch.square(leaf)) for leaf in leaves)
    return sqnorm if squared else torch.sqrt(sqnorm)


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: step count (int32) and moments."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


def adam_init(params):
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params.device),
        mu=torch.zeros_like(params), nu=torch.zeros_like(params),
    )


def adam_update(grads, state, step_size):
    """One ``optax.adam(step_size)`` update: returns (updates, new state).
    The order of operations is optax's: moment EMAs, count + 1, bias
    corrections 1 - b**count in f32, mu_hat / (sqrt(nu_hat) + eps), then
    the scale by -step_size.  A (B,) count (``adam_init_batch``) is one
    count per run along the leading axis."""
    mu = (1 - ADAM_B1) * grads + ADAM_B1 * state.mu
    nu = (1 - ADAM_B2) * grads**2 + ADAM_B2 * state.nu
    count = state.count + 1
    b1 = _const(ADAM_B1, grads.device)  # 0-dim f32, as optax's b**count
    b2 = _const(ADAM_B2, grads.device)
    c1, c2 = 1 - b1**count, 1 - b2**count
    if count.ndim:
        c1 = c1.reshape(count.shape + (1,) * (mu.ndim - 1))
        c2 = c2.reshape(c1.shape)
    mu_hat = mu / c1
    nu_hat = nu / c2
    updates = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
    return -step_size * updates, AdamState(count, mu, nu)


def make_adam_runner(fun, step_size, maxiter=1000, tol=1e-6):
    """Adam loop with the JAX package's (and the reference's) stopping
    rule: at least 5 iterations, then stop once the relative loss change
    is <= ``tol``, and at ``maxiter - 1`` at the latest.  The first loop
    iteration re-evaluates the loss at the unchanged initial parameters,
    duplicating the evaluation before the loop, as the reference does.
    Loss and error histories are allocated at ``maxiter`` and trimmed by
    the callers.

    Returns ``(run, adam_init)``; ``run(init_params, opt_state, *args)``
    -> dict with params / opt_state / n_iter / final_loss / final_error /
    loss_history / error_history (tensors on the parameters' device)."""

    def value_and_grad(params, args):
        params = params.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = fun(params, *args)
            (grads,) = torch.autograd.grad(loss, params)
        return loss.detach(), grads

    def run(init_params, opt_state, *args):
        params = init_params
        loss, grads = value_and_grad(params, args)
        error = tree_l2_norm(grads)
        loss_history = torch.zeros(maxiter, device=params.device)
        error_history = torch.zeros(maxiter, device=params.device)
        loss_history[0], error_history[0] = loss, error
        loss_prev = loss
        i = 0
        while i < maxiter - 1:
            if i >= 5:
                rel_change = (loss - loss_prev).abs() / torch.clamp(
                    loss.abs(), min=1e-8)
                if not bool(rel_change > tol):
                    break
            new_loss, grads = value_and_grad(params, args)
            updates, opt_state = adam_update(grads, opt_state, step_size)
            params = params + updates
            error = tree_l2_norm(grads)
            loss_prev, loss = loss, new_loss
            i += 1
            loss_history[i], error_history[i] = loss, error
        return {
            "params": params,
            "opt_state": opt_state,
            "n_iter": torch.full((), i + 1, dtype=torch.int64,
                                 device=params.device),
            "final_loss": loss,
            "final_error": error,
            "loss_history": loss_history,
            "error_history": error_history,
        }

    return run, adam_init


def make_adam_runner_cached(fun, step_size, maxiter=1000, tol=1e-6):
    """``make_adam_runner``.  The JAX package keeps its compiled Adam
    program per (objective, settings) in a cache; the port compiles no
    program, so there is nothing to keep and this is the same runner."""
    return make_adam_runner(fun, step_size, maxiter=maxiter, tol=tol)


def make_adam_runner_batch(fun, step_size, maxiter=1000, tol=1e-6):
    """``make_adam_runner`` for B independent runs at once (what the JAX
    package's vmap of the while-loop computes): ``fun(params (B, ...),
    *args)`` returns the (B,) losses.  Each run stops at its own iteration
    by the single runner's rule, and its params, state, loss and error
    freeze from then on; the loop ends when every run has stopped, or at
    ``maxiter - 1``.  All B stop flags come to the host in one read per
    iteration.  Adam's step count is per run, (B,) int32.

    Returns ``run(init_params, opt_state, *args)`` -> dict with params /
    opt_state / n_iter (B,) / final_loss (B,) / final_error (B,) /
    loss_history and error_history (B, maxiter), zero past each run's
    ``n_iter``."""

    def value_and_grad(params, args):
        params = params.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = fun(params, *args)
            (grads,) = torch.autograd.grad(loss.sum(), params)
        return loss.detach(), grads

    def run(init_params, opt_state, *args):
        params = init_params
        B = params.shape[0]
        dev = params.device
        bshape = (B,) + (1,) * (params.ndim - 1)
        loss, grads = value_and_grad(params, args)
        error = torch.sqrt(torch.sum(torch.square(grads),
                                     dim=tuple(range(1, grads.ndim))))
        loss_history = torch.zeros((B, maxiter), device=dev)
        error_history = torch.zeros((B, maxiter), device=dev)
        loss_history[:, 0], error_history[:, 0] = loss, error
        n_iter = torch.ones((B,), dtype=torch.int64, device=dev)
        active = torch.ones((B,), dtype=torch.bool, device=dev)
        loss_prev = loss
        i = 0
        while i < maxiter - 1:
            if i >= 5:
                rel_change = (loss - loss_prev).abs() / torch.clamp(
                    loss.abs(), min=1e-8)
                active = active & (rel_change > tol)
                if not bool(active.any()):
                    break
            new_loss, grads = value_and_grad(params, args)
            updates, new_state = adam_update(grads, opt_state, step_size)
            keep = active.reshape(bshape)
            params = torch.where(keep, params + updates, params)
            opt_state = AdamState(
                torch.where(active, new_state.count, opt_state.count),
                torch.where(keep, new_state.mu, opt_state.mu),
                torch.where(keep, new_state.nu, opt_state.nu))
            new_error = torch.sqrt(torch.sum(
                torch.square(grads), dim=tuple(range(1, grads.ndim))))
            error = torch.where(active, new_error, error)
            loss_prev = torch.where(active, loss, loss_prev)
            loss = torch.where(active, new_loss, loss)
            i += 1
            n_iter = torch.where(active, i + 1, n_iter)
            loss_history[:, i] = torch.where(active, loss, 0.0)
            error_history[:, i] = torch.where(active, error, 0.0)
        return {"params": params, "opt_state": opt_state, "n_iter": n_iter,
                "final_loss": loss, "final_error": error,
                "loss_history": loss_history,
                "error_history": error_history}

    return run


def adam_init_batch(params):
    """``adam_init`` of B runs: a (B,) int32 step count."""
    return AdamState(
        count=torch.zeros((params.shape[0],), dtype=torch.int32,
                          device=params.device),
        mu=torch.zeros_like(params), nu=torch.zeros_like(params),
    )


def package_adam_result(adam_res, host_trim=True, extra=None):
    """Package an Adam runner result for m_step callers.  ``host_trim``
    trims the pre-allocated histories to the realised iteration count;
    ``host_trim=False`` leaves that to ``batch_trim_m_step_histories``
    after the EM loop.  ``extra``: more entries of the result (the gain
    model's tuning and gain)."""
    out = {k: adam_res[k] for k in (
        "params", "opt_state", "n_iter", "final_loss", "final_error",
        "loss_history", "error_history")}
    if host_trim:
        n_iter = int(adam_res["n_iter"])
        out["n_iter"] = n_iter
        out["loss_history"] = adam_res["loss_history"][:n_iter].cpu().numpy()
        out["error_history"] = (
            adam_res["error_history"][:n_iter].cpu().numpy())
    if extra:
        out.update(extra)
    return out


def batch_trim_m_step_histories(m_step_res_l):
    """Trim the deferred (``host_trim=False``) M-step histories of every EM
    iteration in one batch.  Mutates and returns the dict."""
    if not m_step_res_l.get("loss_history"):
        return m_step_res_l
    if isinstance(m_step_res_l["n_iter"][0], int):
        return m_step_res_l  # already trimmed (host_trim=True path)
    n_arr = torch.stack(m_step_res_l["n_iter"]).cpu().tolist()
    loss_h = torch.stack(m_step_res_l["loss_history"]).cpu().numpy()
    err_h = torch.stack(m_step_res_l["error_history"]).cpu().numpy()
    m_step_res_l["n_iter"] = [int(v) for v in n_arr]
    m_step_res_l["loss_history"] = [loss_h[j, :v] for j, v in enumerate(n_arr)]
    m_step_res_l["error_history"] = [err_h[j, :v] for j, v in enumerate(n_arr)]
    return m_step_res_l
