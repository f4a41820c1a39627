"""A grid of Poisson jump fits, in plain PyTorch: the runs that
``sweep_fit_poisson_jump`` fits in one batch, one at a time.

The grid is the Cartesian product of the swept hyperparameters, in the
order of their keys, each configuration repeated ``n_repeat`` times for
independent chains (run b is configuration b // n_repeat, chain
b % n_repeat).  A run starts from its own draws, by the sweep's recipe:

* the call's CPU generator draws one seed per run
  (``torch.randint(0, 2**62, (B,))``), and each run's CPU generator is
  seeded with its seed;
* from it the run draws its weights, standard normal (n_basis, N) in
  float32, then one more seed, ``torch.randint(0, 2**62, (1,))``, for a
  generator on the device;
* that generator draws the run's (T, L) uniforms on the device, scaled
  by 0.1 in float32; each row, normalised, is the initial posterior.

Each run then goes through ``n_iter`` EM iterations under its own dense
transition (``model.transition``): ``em.statistics``, ``em.adam_m_step``
(its state carried from one M-step to the next) and ``em.e_step``.

Departures from the program: everything after the draws is float64, TF32
off (the program computes in float32); the initial posterior is
normalised in float64 (the program in float32: a few ulps apart); the
smoother is the chunked fixed point of ``smoother.smooth`` rather than
one sequential pass per run; the swept values are the program's float32
grid values, so the transitions are built from the same numbers.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from benchmark.reference import em
from benchmark.reference import model as rm

#: the sweep's scale of the initial uniforms
RANDOM_SCALE = 0.1


def grid_runs(ranges, n_repeat):
    """One dict of hyperparameters per run, in the program's run order;
    each value rounded to float32, as the program's grid holds it."""
    keys = list(ranges)
    out = []
    for combo in itertools.product(*(ranges[k] for k in keys)):
        hp = {k: float(np.float32(v)) for k, v in zip(keys, combo)}
        out += [hp] * n_repeat
    return out


def run_seeds(call_seed, n_runs):
    """The seed of each run's CPU generator, drawn from the call's."""
    g = torch.Generator().manual_seed(int(call_seed))
    return [int(s) for s in torch.randint(0, 2 ** 62, (n_runs,),
                                          generator=g)]


def run_start(seed, T, L, n_basis, N, device):
    """A run's (initial weights (n_basis, N), initial posterior (T, L)),
    float64 on ``device``, from the run's seed."""
    g = torch.Generator().manual_seed(seed)
    params0 = torch.randn((n_basis, N), generator=g)
    dseed = int(torch.randint(0, 2 ** 62, (1,), generator=g))
    gd = torch.Generator(device=device).manual_seed(dseed)
    u = (torch.rand((T, L), generator=gd, device=device)
         * RANDOM_SCALE).double()
    return params0.double().to(device), u / u.sum(dim=1, keepdim=True)


@dataclasses.dataclass
class RunFit:
    """One run's fit: the log-marginal of each EM iteration, the weights
    after the first M-step and after the last, the last E-step, and the
    Adam iterations of each M-step."""

    log_marginal_l: list
    params_first: torch.Tensor
    params: torch.Tensor
    last: object
    adam_iters: list


def tf32_off():
    """Matrix products in float32 at float32 (the card's default may round
    them to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_transition(cfg, hp, device, prec=rm.F64):
    """The run's transition from its hyperparameters ``hp``."""
    return rm.transition(cfg.n_latent, hp["movement_variance"],
                         hp["p_move_to_jump"], hp["p_jump_to_move"], device,
                         prec)


def fit_run(y, cfg, basis, hp, params0, post0, n_iter, step_size=0.01,
            maxiter=100, tol=1e-6, prec=rm.F64):
    """``n_iter`` EM iterations of one run with hyperparameters ``hp``
    from weights ``params0`` and posterior ``post0`` (T, L) on the
    observations ``y`` (T, N); ``cfg`` a ``config.ModelConfig`` (family,
    link, L)."""
    tf32_off()
    basis = prec(basis)
    trans = run_transition(cfg, hp, y.device, prec)
    params, post, state = prec(params0), post0, em.Adam()
    lml, iters, first, last = [], [], None, None
    for _ in range(n_iter):
        yw, tw = em.statistics(post, y, prec)
        params, state, n = em.adam_m_step(
            params, state, basis, yw, tw, hp["param_prior_std"], prec,
            step_size=step_size, maxiter=maxiter, tol=tol)
        iters.append(n)
        first = params if first is None else first
        del post
        last = em.e_step(y, params, basis, cfg, trans, prec)
        lml.append(last.log_marginal)
        post = last.latent_marg
    return RunFit(lml, first, params, last, iters)


def e_step(y, cfg, basis, hp, params, prec=rm.F64):
    """The E-step of one run from its weights ``params``, under its own
    transition: ``smoother.Smoothed``."""
    tf32_off()
    return em.e_step(y, prec(params), prec(basis), cfg,
                     run_transition(cfg, hp, y.device, prec), prec)
