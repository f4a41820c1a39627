"""The EM fit of the jump model, in plain PyTorch: the initial posterior,
the M-step (Adam on the grouped Poisson objective, or the Gaussian ridge
solve) and the E-step (``smoother.smooth``'s latent marginal).

Adam follows optax's ``adam`` (b1 = 0.9, b2 = 0.999, eps = 1e-8) with the
JAX package's stopping rule: the loss and gradient at the start, then at
least five iterations, and a stop once the relative change of the loss is
at most ``tol``, or at ``maxiter - 1`` iterations at the latest; each
iteration evaluates the loss and gradient at the parameters before its
update (so the first one repeats the start).  Its state carries over from
one EM iteration to the next.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference import model as rm
from benchmark.reference import smoother

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def initial_posterior(T, L, seed, random_scale=0.1):
    """(T, L) float32 CPU posterior: uniform draws times ``random_scale``
    from a CPU generator seeded with ``seed``, each row normalised (the
    jump models' random initial posterior)."""
    g = torch.Generator().manual_seed(seed)
    post = torch.rand((T, L), generator=g) * random_scale
    return post / post.sum(dim=1, keepdim=True)


def statistics(post, y, prec=rm.F64, rows=200_000):
    """Posterior-weighted observations (L, N) and occupancy (L,)."""
    yw = tw = 0.0
    for a in range(0, post.shape[0], rows):
        p = prec(post[a:a + rows])
        yw = yw + prec.mm(p.T, prec(y[a:a + rows]))
        tw = tw + p.sum(dim=0)
    return yw, tw


def poisson_objective(params, basis, yw, tw, prior_std, prec=rm.F64):
    """Negative expected log joint of the grouped statistics plus the
    Gaussian prior's negative log density on the weights."""
    lam = rm.tuning(params, basis, "softplus", prec)
    ll = torch.sum(torch.xlogy(yw, lam + rm.OBJ_FLOOR) - lam * tw[:, None])
    log_prior = ((math.log(2 * math.pi * prior_std ** 2)
                  + params ** 2 / prior_std ** 2) / -2).sum()
    return -ll - log_prior


@dataclasses.dataclass
class Adam:
    count: int = 0
    mu: torch.Tensor = None
    nu: torch.Tensor = None


def adam_m_step(params, state, basis, yw, tw, prior_std, prec=rm.F64,
                step_size=0.01, maxiter=1000, tol=1e-6):
    """Adam on ``poisson_objective`` from ``params`` and ``state``; returns
    (params, state, iterations counted as the program counts them)."""

    def value_and_grad(p):
        p = p.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = poisson_objective(p, basis, yw, tw, prior_std, prec)
            (g,) = torch.autograd.grad(loss, p)
        return loss.item(), g

    if state.mu is None:
        state = Adam(0, torch.zeros_like(params), torch.zeros_like(params))
    loss, _ = value_and_grad(params)
    loss_prev, i = loss, 0
    while i < maxiter - 1:
        if i >= 5 and not abs(loss - loss_prev) / max(abs(loss), 1e-8) > tol:
            break
        new_loss, g = value_and_grad(params)
        mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu
        nu = (1 - ADAM_B2) * g * g + ADAM_B2 * state.nu
        count = state.count + 1
        upd = (mu / (1 - ADAM_B1 ** count)) / (
            torch.sqrt(nu / (1 - ADAM_B2 ** count)) + ADAM_EPS)
        params = params - step_size * upd
        state = Adam(count, mu, nu)
        loss_prev, loss = loss, new_loss
        i += 1
    return params, state, i + 1


def ridge_m_step(basis, yw, tw, noise_std, prior_std, prec=rm.F64):
    """The Gaussian M-step's closed-form ridge solve."""
    b = prec(basis)
    gram = b.T @ (tw[:, None] * b)
    H = gram / noise_std ** 2 + torch.eye(
        b.shape[1], dtype=b.dtype, device=b.device) / prior_std ** 2
    return torch.linalg.solve(H, prec.mm(b.T, yw) / noise_std ** 2)


@dataclasses.dataclass
class Fit:
    """A reference fit: the log-marginal of each EM iteration, the weights
    after the first M-step and after the last, and the last E-step."""

    log_marginal_l: list
    params_first: torch.Tensor
    params: torch.Tensor
    last: smoother.Smoothed
    adam_iters: list


def e_step(y, params, basis, cfg, trans, prec=rm.F64):
    """The E-step from weights ``params``: ``smoother.Smoothed``."""
    tun = rm.tuning(params, basis, cfg.link, prec)
    ll = rm.loglik(y, tun, cfg.family, cfg.noise_std, prec)
    return smoother.smooth(ll, trans, prec)


def fit(y, cfg, post0, n_iter, prec=rm.F64):
    """``n_iter`` EM iterations from the initial posterior ``post0`` (T, L)
    on the observations ``y`` (T, N); ``cfg`` a ``config.ModelConfig``."""
    dev = y.device
    basis = prec(cfg.basis().to(dev))
    params = prec(rm.initial_params(basis.shape[1], cfg.n_neuron,
                                    cfg.rng_init_int).to(dev))
    trans = rm.transition(cfg.n_latent, cfg.movement_variance,
                          cfg.p_move_to_jump, cfg.p_jump_to_move, dev, prec)
    post, state = post0.to(dev), Adam()
    lml, iters, first, last = [], [], None, None
    for _ in range(n_iter):
        yw, tw = statistics(post, y, prec)
        if cfg.family == "poisson":
            params, state, n = adam_m_step(params, state, basis, yw, tw,
                                           cfg.param_prior_std, prec)
            iters.append(n)
        else:
            params = ridge_m_step(basis, yw, tw, cfg.noise_std,
                                  cfg.param_prior_std, prec)
        first = params if first is None else first
        del post
        last = e_step(y, params, basis, cfg, trans, prec)
        lml.append(last.log_marginal)
        post = last.latent_marg
    return Fit(lml, first, params, last, iters)
