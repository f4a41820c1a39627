"""Faults planted under the sweep's timed path, for the ``sweep`` cell's
check: each must make a run's ``correct`` come out false.

``faults.py`` plants its faults in the model families' M-steps,
``hmm._loglik`` and the models' ``fit_em`` and ``decode_latent``, none of
which ``sweep_fit_poisson_jump`` calls; here the same faults are planted
where the sweep does the work, and two that only a grid has:

* ``state_unchanged``: every batched M-step returns the weights it was
  given;
* ``later_state_unchanged``: every batched M-step of a call after its
  first returns the weights it was given;
* ``half_batch``: every run's emission log-likelihood is taken over the
  first half of the neurons and doubled;
* ``answer_altered``: one bin of one run's returned latent posterior is
  reversed;
* ``nan_answer``: one bin of one run's returned latent posterior is NaN;
* ``neighbour_config``: one run's E-steps run under the next configuration
  index of the call's transition stack (a neighbour's transition);
* ``stopped_runs_moving``: the batched Adam runner keeps moving the runs
  that have stopped, until the last one stops.
"""

from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "later_state_unchanged", "half_batch",
          "answer_altered", "nan_answer", "neighbour_config",
          "stopped_runs_moving")


@contextlib.contextmanager
def planted(fault, pm):
    """Plant ``fault`` into the program package ``pm`` for the ``with``
    block."""
    from poor_man_gplvm_tpu_torch.ops import mstep
    from poor_man_gplvm_tpu_torch.parallel import sweep

    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    orig_runner = mstep.make_adam_runner_batch
    if fault in ("state_unchanged", "later_state_unchanged"):
        first_kept = fault == "later_state_unchanged"

        def make(fun, step_size, maxiter=1000, tol=1e-6):
            run = orig_runner(fun, step_size, maxiter=maxiter, tol=tol)
            n_calls = [0]

            def faulty(init_params, opt_state, *args):
                res = run(init_params, opt_state, *args)
                n_calls[0] += 1
                if n_calls[0] > 1 or not first_kept:
                    res = dict(res, params=init_params)
                return res

            return faulty

        patch(mstep, "make_adam_runner_batch", make)
    elif fault == "stopped_runs_moving":

        def make(fun, step_size, maxiter=1000, tol=1e-6):
            run = orig_runner(fun, step_size, maxiter=maxiter, tol=tol)

            def faulty(init_params, opt_state, *args):
                trips = int(run(init_params, opt_state,
                                *args)["n_iter"].max()) - 1
                # no run stops (the rule's test never fails at a negative
                # tolerance): each moves as many trips as the slowest
                every = orig_runner(fun, step_size, maxiter=trips + 1,
                                    tol=-1.0)
                return every(init_params, opt_state, *args)

            return faulty

        patch(mstep, "make_adam_runner_batch", make)
    elif fault == "half_batch":
        orig = sweep.get_loglikelihood_ma_all

        def loglik(y, tuning, hyperparam, ma_neuron, ma_latent,
                   observation_model="poisson", lgamma_term=None):
            h = y.shape[1] // 2
            return 2.0 * orig(y[:, :h], tuning[:, :h], hyperparam,
                              ma_neuron[..., :h], ma_latent,
                              observation_model)

        patch(sweep, "get_loglikelihood_ma_all", loglik)
    elif fault in ("answer_altered", "nan_answer"):
        orig = sweep.sweep_fit_poisson_jump

        def sweep_fit(*a, **k):
            res = orig(*a, **k)
            post = res["log_posterior_latent"]
            b, t = post.shape[0] // 2, post.shape[1] // 2
            if fault == "answer_altered":
                post[b, t] = post[b, t].flip(0)
            else:
                post[b, t] = float("nan")
            return res

        patch(sweep, "sweep_fit_poisson_jump", sweep_fit)
    elif fault == "neighbour_config":
        orig = sweep._e_step

        def e_step(ll, stack, cfg, *a, **k):
            cfg = cfg.clone()
            j = cfg.shape[0] // 2
            cfg[j] = (cfg[j] + 1) % stack.Tlat.shape[0]
            return orig(ll, stack, cfg, *a, **k)

        patch(sweep, "_e_step", e_step)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
