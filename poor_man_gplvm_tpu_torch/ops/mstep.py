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
test on the host once per iteration after the first five (the batched
runner on a card: once in ten, replaying a CUDA graph of its iteration).
The scalar constants of the loop (Adam's decay rates, the prior's scale)
are made on the device once and reused (``_const``), so an iteration
copies nothing from the host.  On a card the batched runner's trip on
``poisson_m_step_objective_batch`` is two hand-written kernels
(``csrc/adam_poisson.cu``): the objective, its analytic gradient and the
update in one pass over each run's statistics; its plain version is
``poisson_value_and_grad_batch_plain``.
"""

from __future__ import annotations

import functools
import math
import numbers
from typing import NamedTuple

import torch

from poor_man_gplvm_tpu_torch.ops.precision import matmul
from poor_man_gplvm_tpu_torch.utils import profiling

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
    "poisson_value_and_grad_batch_plain",
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


def poisson_value_and_grad_batch_plain(params, hyperparam, basis_mat,
                                       y_weighted, t_weighted,
                                       opt_state=None, active=None,
                                       step_size=None):
    """The fused Adam trip of ``csrc/adam_poisson.cu`` in plain PyTorch
    (its kernels' arithmetic, for the tests and ``chip_smoke.py``; no
    runner calls it).  The (B,) losses of
    ``poisson_m_step_objective_batch``, the gradient written out, G =
    sigmoid(X) (t - y_w / (pf + 1e-20)) with X = basis @ params and pf =
    softplus(X) (kernel A divides once, in another arrangement of the same
    quantity), ``grads = basis^T G + params / s^2``, and
    the error, the norm of each run's gradient; the losses' terms and the
    squared gradients are summed in float64, as the kernels sum them.
    Returns ``{'loss', 'error', 'grads'}``; given ``opt_state``, ``active``
    (B,) bool and ``step_size`` also ``'params'`` and ``'opt_state'``
    after ``adam_update`` on the live runs, each stopped run's entries as
    they were."""
    x = get_tuning_linear(params, basis_mat)  # (B, L, N)
    pf = torch.logaddexp(x, torch.zeros_like(x))
    t = t_weighted[:, :, None]
    floored = pf + 1e-20
    g_x = torch.sigmoid(x) * (t - y_weighted / floored)
    var = _run_scalar(hyperparam["param_prior_std"], params) ** 2
    grads = basis_mat.transpose(-1, -2) @ g_x + params / var
    fit = (pf * t).double() - torch.xlogy(y_weighted, floored).double()
    prior = 0.5 * (torch.log(2 * math.pi * var).double()
                   + (params**2 / var).double())
    out = {"loss": (fit.sum(dim=(1, 2)) + prior.sum(dim=(1, 2))).float(),
           "error": torch.sqrt(torch.square(grads.double()).sum(
               dim=(1, 2))).float(),
           "grads": grads}
    if opt_state is not None:
        updates, new_state = adam_update(grads, opt_state, step_size)
        keep = active.reshape(-1, 1, 1)
        out["params"] = torch.where(keep, params + updates, params)
        out["opt_state"] = AdamState(
            torch.where(active, new_state.count, opt_state.count),
            torch.where(keep, new_state.mu, opt_state.mu),
            torch.where(keep, new_state.nu, opt_state.nu))
    return out


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
    profiling.host_sync("ridge_solve")  # the solve's error check
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
    profiling.host_sync("ridge_solve")  # the solve's error check
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
                profiling.host_sync("adam_stop")
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


#: neurons a block of the fused trip's kernel A; its basis rows come in
#: groups of at most 128, and a larger rank writes the weights out of place
ADAM_TRIP_TILE = 64
_ADAM_TRIP_GROUP = 128


def _adam_lib():
    from poor_man_gplvm_tpu_torch.ops._build import load

    return load("adam_poisson")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch_adam_trip(params, out, mu, nu, count, active, ops, parts,
                      step_size):
    """Kernel A on the current stream: the loss and grad^2 partials of
    every run into ``parts`` (2, B, tiles), and with ``active`` Adam on the
    live runs, the weights into ``out`` (``params`` itself where the rank
    allows), ``mu`` and ``nu`` in place."""
    B, K, N = params.shape
    with torch.cuda.device(params.device):
        err = _adam_lib().pmg_adam_poisson_trip(
            params.data_ptr(), _ptr(out), _ptr(mu), _ptr(nu),
            ops["basis_t"].data_ptr(), ops["basis_stride"],
            ops["yw"].data_ptr(), ops["tw"].data_ptr(),
            ops["prior_std"].data_ptr(), _ptr(count), _ptr(active),
            parts[0].data_ptr(), parts[1].data_ptr(), B, ops["L"],
            ops["basis_t"].shape[-1], K, N,
            float(step_size), torch.cuda.current_stream(
                params.device).cuda_stream)
    _raise_on(err, "adam_poisson trip")
    _launch_adam_trip.launches += 1


_launch_adam_trip.launches = 0


def _launch_adam_finish(parts, active, s, histories, step):
    """Kernel B on the current stream: each run's partials summed; without
    ``active`` into the (B,) tensors ``s['loss']`` and ``s['error']``, with
    it the trip's state ``s`` and the histories' column ``step`` (an int,
    or a (1,) int64 tensor on the card) in place."""
    _, B, tiles = parts.shape
    trip = active is not None
    loss_h, error_h = histories if trip else (None, None)
    on_card = torch.is_tensor(step)
    with torch.cuda.device(parts.device):
        err = _adam_lib().pmg_adam_poisson_finish(
            parts[0].data_ptr(), parts[1].data_ptr(), B, tiles, _ptr(active),
            s["loss"].data_ptr(), _ptr(s["loss_prev"]) if trip else None,
            s["error"].data_ptr(), _ptr(s["count"]) if trip else None,
            _ptr(s["n_iter"]) if trip else None, _ptr(loss_h),
            _ptr(error_h), loss_h.shape[1] if trip else 0,
            step.data_ptr() if on_card else None, 0 if on_card else int(step),
            torch.cuda.current_stream(parts.device).cuda_stream)
    _raise_on(err, "adam_poisson finish")
    _launch_adam_finish.launches += 1


_launch_adam_finish.launches = 0


def _fused_poisson_trip(params, args, step_size, histories):
    """The batched runner's trip on ``poisson_m_step_objective_batch`` on a
    card: ``(evaluate, advance)``.  ``evaluate(params)`` -> (loss, error)
    (B,), kernel A in evaluation mode and kernel B; ``advance(s, step)``
    runs trip ``step`` on the runner's state ``s`` in place, its histories'
    column included (kernels A and B; on a rank above 128 the weights go
    out of place and are copied back).  Raises ``ValueError`` on shapes
    the kernels do not take."""
    from poor_man_gplvm_tpu_torch.ops.scan_kernels import MAX_LATENT

    hyper, basis, yw, tw = args
    if params.ndim != 3 or params.dtype != torch.float32:
        raise ValueError("the fused Adam trip takes float32 params (B, "
                         f"n_basis, N); got {params.dtype} "
                         f"{tuple(params.shape)}")
    B, K, N = params.shape
    dev = params.device
    basis = basis.to(torch.float32)
    L = basis.shape[-2]
    if (basis.ndim not in (2, 3) or basis.shape[-1] != K
            or (basis.ndim == 3 and basis.shape[0] != B)):
        raise ValueError(f"basis {tuple(basis.shape)} does not match params "
                         f"{tuple(params.shape)}")
    ops = {"yw": yw.to(torch.float32).contiguous(),
           "tw": tw.to(torch.float32).contiguous(), "L": L}
    if tuple(ops["yw"].shape) != (B, L, N) or tuple(ops["tw"].shape) != (
            B, L):
        raise ValueError(f"statistics {tuple(yw.shape)}, {tuple(tw.shape)} "
                         f"do not match (B, L, N) = {(B, L, N)}")
    if not (1 <= L <= MAX_LATENT and 1 <= K <= L and 1 <= B <= 65535):
        raise ValueError(f"the fused Adam trip takes L <= {MAX_LATENT}, "
                         f"n_basis <= L and B <= 65535; got B = {B}, "
                         f"L = {L}, n_basis = {K}")
    if any(x.device != dev for x in (basis, ops["yw"], ops["tw"])):
        raise ValueError("the fused Adam trip's operands must share the "
                         "params' device")
    prior = hyper["param_prior_std"]
    if isinstance(prior, numbers.Real):
        prior = torch.full((B,), float(prior), device=dev)
    ops["prior_std"] = _run_scalar(prior, params).reshape(-1).expand(
        B).contiguous()
    # the basis transposed, its rows padded to whole 16-byte copies
    Lp = -(-L // 4) * 4
    ops["basis_t"] = torch.zeros(basis.shape[:-2] + (K, Lp), device=dev)
    ops["basis_t"][..., :L] = basis.transpose(-1, -2)
    ops["basis_stride"] = K * Lp if basis.ndim == 3 else 0
    tiles = -(-N // ADAM_TRIP_TILE)
    parts = torch.empty((2, B, tiles), dtype=torch.float64, device=dev)
    out = torch.empty_like(params) if K > _ADAM_TRIP_GROUP else None

    def evaluate(p):
        _launch_adam_trip(p, None, None, None, None, None, ops, parts,
                          step_size)
        r = {"loss": torch.empty((B,), device=dev),
             "error": torch.empty((B,), device=dev)}
        _launch_adam_finish(parts, None, r, None, 0)
        return r["loss"], r["error"]

    def advance(s, step):
        p = s["params"]
        _launch_adam_trip(p, p if out is None else out, s["mu"], s["nu"],
                          s["count"], s["active"], ops, parts, step_size)
        if out is not None:
            p.copy_(out)
        _launch_adam_finish(parts, s["active"], s, histories, step)

    return evaluate, advance


def _check_fused_state(s):
    """Raise ``ValueError`` unless the runner's state ``s`` is what the
    fused trip's kernels write: float32 weights and moments of one shape,
    a (B,) int32 count."""
    B = s["params"].shape[0]
    if (s["mu"].shape != s["params"].shape
            or s["nu"].shape != s["params"].shape
            or s["mu"].dtype != torch.float32
            or s["nu"].dtype != torch.float32
            or s["count"].dtype != torch.int32
            or tuple(s["count"].shape) != (B,)):
        raise ValueError("the fused Adam trip takes float32 moments shaped "
                         "as the params and a (B,) int32 count")


#: per card: the side stream that the batched runner's trip is captured
#: on, and the last CUDA graph captured there, kept so that the next
#: capture shares its memory pool (and reuses its blocks) where a new pool
#: would take new memory every run
_GRAPH_HOMES = {}
#: the card's batched runner reads its runs' state once in this many trips
GRAPH_TRIPS_PER_READ = 10


def make_adam_runner_batch(fun, step_size, maxiter=1000, tol=1e-6):
    """``make_adam_runner`` for B independent runs at once (what the JAX
    package's vmap of the while-loop computes): ``fun(params (B, ...),
    *args)`` returns the (B,) losses.  Each run stops at its own iteration
    by the single runner's rule, and its params, state, loss and error
    freeze from then on; the loop ends when every run has stopped, or at
    ``maxiter - 1``.  Adam's step count is per run, (B,) int32.  The
    counters ``adam_steps`` (the loop's trips that moved a run) and
    ``adam_run_steps`` (the runs moving, summed over the trips) come from
    the loop's own reads (``host_syncs.adam_stop``).

    The trip is autograd's, its ops launched one by one, and all B stop
    flags come to the host in one read per trip from the sixth on.  On a
    card, with ``fun`` ``poisson_m_step_objective_batch`` itself, the
    start's evaluation and every trip are instead the two kernels of
    ``csrc/adam_poisson.cu`` on the state in place
    (``_fused_poisson_trip``; a stopped run's entries keep their bits), and
    the counter ``adam_fused_trips`` counts the trips as ``adam_steps``
    does.  Their gradient is the objective's written out, summed in
    another order than autograd's, so its bits differ from the trip of
    autograd; any other objective, and the CPU, keep that trip.  Shapes
    the kernels do not take raise ``ValueError``.

    The fused trips from the sixth on replay one CUDA graph of the rule's
    test and the trip, captured once a run on static copies of the state:
    the same kernels on the same values, so the same bits as the trips
    launched by the host.  The host reads the runs' ``n_iter`` once in
    ``GRAPH_TRIPS_PER_READ`` replays, and so the loop runs at the card's
    pace and not at the host's.  A replay after every run has stopped
    moves none (a stopped run's entries keep their bits) and leaves
    ``n_iter`` as it was: the read that sees the largest ``n_iter`` fall
    behind the trips replayed ends the loop, and ``n_iter`` gives the
    counters, as if it had ended at the first trip that moved no run.

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

    def stop_test(s):
        """The live flags after the rule's test of the last trip."""
        rel_change = (s["loss"] - s["loss_prev"]).abs() / torch.clamp(
            s["loss"].abs(), min=1e-8)
        return s["active"] & (rel_change > tol)

    def trip(s, args, i):
        """Autograd's trip ``i``: the new state, each stopped run's entries
        as they were."""
        active = s["active"]
        keep = active.reshape((-1,) + (1,) * (s["params"].ndim - 1))
        new_loss, grads = value_and_grad(s["params"], args)
        updates, new_state = adam_update(
            grads, AdamState(s["count"], s["mu"], s["nu"]), step_size)
        new_error = torch.sqrt(torch.sum(
            torch.square(grads), dim=tuple(range(1, grads.ndim))))
        return {"params": torch.where(keep, s["params"] + updates,
                                      s["params"]),
                "count": torch.where(active, new_state.count, s["count"]),
                "mu": torch.where(keep, new_state.mu, s["mu"]),
                "nu": torch.where(keep, new_state.nu, s["nu"]),
                "error": torch.where(active, new_error, s["error"]),
                "loss_prev": torch.where(active, s["loss"], s["loss_prev"]),
                "loss": torch.where(active, new_loss, s["loss"]),
                "n_iter": torch.where(active, i + 1, s["n_iter"])}

    def replay(s, i, advance):
        """Trips ``i + 1`` on, on the card: captures the test and the fused
        trip ``advance`` over ``s`` (replaced by static copies, updated in
        place), then replays them, ``GRAPH_TRIPS_PER_READ`` between reads,
        until a read finds no run moved or the cap.  Returns the runs'
        ``n_iter``."""
        dev = s["params"].device
        stream, last = _GRAPH_HOMES.get(dev, (None, None))
        with torch.cuda.device(dev):
            if stream is None:
                stream = torch.cuda.Stream(dev)
            for k in s:
                s[k] = s[k].clone()
            step = torch.full((1,), i, dtype=torch.int64, device=dev)
            graph = torch.cuda.CUDAGraph()
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=None if last is None
                                    else last.pool())
                s["active"].copy_(stop_test(s))
                step += 1
                advance(s, step)
                graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(stream)
            _GRAPH_HOMES[dev] = (stream, graph)
            while True:
                n = min(GRAPH_TRIPS_PER_READ, maxiter - 1 - i)
                for _ in range(n):
                    graph.replay()
                i += n
                profiling.host_sync("adam_stop")
                n_iter = s["n_iter"].tolist()
                if max(n_iter) <= i or i >= maxiter - 1:
                    return n_iter

    def run(init_params, opt_state, *args):
        params = init_params
        B = params.shape[0]
        dev = params.device
        loss_history = torch.zeros((B, maxiter), device=dev)
        error_history = torch.zeros((B, maxiter), device=dev)
        advance = None
        if fun is poisson_m_step_objective_batch and dev.type == "cuda":
            evaluate, advance = _fused_poisson_trip(
                params, args, step_size, (loss_history, error_history))
            loss, error = evaluate(params)
        else:
            loss, grads = value_and_grad(params, args)
            error = torch.sqrt(torch.sum(torch.square(grads),
                                         dim=tuple(range(1, grads.ndim))))
        loss_history[:, 0], error_history[:, 0] = loss, error
        s = {"params": params, "count": opt_state.count,
             "mu": opt_state.mu, "nu": opt_state.nu, "error": error,
             "loss": loss, "loss_prev": loss,
             "n_iter": torch.ones((B,), dtype=torch.int64, device=dev),
             "active": torch.ones((B,), dtype=torch.bool, device=dev)}
        if advance is not None:  # the kernels update the state in place
            _check_fused_state(s)
            s = {k: v.clone(memory_format=torch.contiguous_format)
                 for k, v in s.items()}
        i = run_steps = 0
        live = B
        while i < maxiter - 1:
            if i >= 5:
                if advance is not None:
                    n_iter = replay(s, i, advance)
                    i, run_steps = max(n_iter) - 1, sum(n_iter) - B
                    break
                s["active"] = stop_test(s)
                profiling.host_sync("adam_stop")
                live = int(s["active"].sum())
                if not live:
                    break
            run_steps += live
            i += 1
            if advance is not None:
                advance(s, i)
                continue
            s.update(trip(s, args, i))
            loss_history[:, i] = torch.where(s["active"], s["loss"], 0.0)
            error_history[:, i] = torch.where(s["active"], s["error"], 0.0)
        profiling.count("adam_steps", i)
        profiling.count("adam_run_steps", run_steps)
        if advance is not None:
            profiling.count("adam_fused_trips", i)
        return {"params": s["params"],
                "opt_state": AdamState(s["count"], s["mu"], s["nu"]),
                "n_iter": s["n_iter"], "final_loss": s["loss"],
                "final_error": s["error"], "loss_history": loss_history,
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
        profiling.host_sync("adam_history", 3)
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
    profiling.host_sync("adam_history", 3)
    n_arr = torch.stack(m_step_res_l["n_iter"]).cpu().tolist()
    loss_h = torch.stack(m_step_res_l["loss_history"]).cpu().numpy()
    err_h = torch.stack(m_step_res_l["error_history"]).cpu().numpy()
    m_step_res_l["n_iter"] = [int(v) for v in n_arr]
    m_step_res_l["loss_history"] = [loss_h[j, :v] for j, v in enumerate(n_arr)]
    m_step_res_l["error_history"] = [err_h[j, :v] for j, v in enumerate(n_arr)]
    return m_step_res_l
