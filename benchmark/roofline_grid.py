"""The work counts of a grid of fits (``sweep_fit_poisson_jump``), beside
``roofline.py``'s counts of one model.

The K1/K2 batch bound of one E-step counts each run at its own movement
variance: its recursions' operations (``roofline.step_macs``: the
continuous channel's own nonzeros), its emission weights (T, L) read once
and its latent marginal (T, L) written once.  The band that the launch
pads to the widest run's is waste, not work.  A call's operations add,
for each run and EM iteration, the statistics and emission products
(2 T N L each), the recursions once, and the tuning 2 L n_basis N; and
for Adam, the objective and its gradient (4 L n_basis N) at each M-step's
start and at every trip of a run still moving (``adam_run_steps``).
"""

from __future__ import annotations

import functools

from benchmark import roofline


@functools.lru_cache(maxsize=32)
def _run_smoother_work(T, L, n_dyn, movement_variance):
    return roofline.smoother_work(T, L, n_dyn, movement_variance, T * L)


def e_step_work(T, L, n_dyn, movement_variances):
    """(operations, bytes) of one batched E-step: each run's recursions at
    its own movement variance, its weights read and its marginal
    written."""
    ops = nbytes = 0.0
    for mv in movement_variances:
        o, b = _run_smoother_work(T, L, n_dyn, float(mv))
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes


def e_step_bound_s(T, L, n_dyn, movement_variances):
    """The least time one batched E-step's K1 and K2 could take."""
    return roofline.bound_s(*e_step_work(T, L, n_dyn, movement_variances))


def adam_ops(L, n_basis, N, evaluations):
    """Operations of ``evaluations`` evaluations of one run's objective
    and gradient: the tuning product and its transpose."""
    return 4.0 * L * n_basis * N * evaluations


def call_ops(T, N, L, n_dyn, n_basis, movement_variances, n_iter,
             adam_run_steps):
    """Operations of one sweep call of the runs ``movement_variances``
    over ``n_iter`` EM iterations, whose Adam loops moved runs
    ``adam_run_steps`` times in all."""
    runs = len(movement_variances)
    per_iter = runs * (2.0 * 2.0 * T * N * L + 2.0 * L * n_basis * N) + \
        e_step_work(T, L, n_dyn, movement_variances)[0]
    return n_iter * per_iter + adam_ops(L, n_basis, N,
                                        runs * n_iter + adam_run_steps)
