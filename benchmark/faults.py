"""Faults planted under the timed path, for the check's own tests: each
must make a run's ``correct`` come out false.

* ``state_unchanged``: every M-step returns the weights it was given;
* ``later_state_unchanged``: every M-step of a fit after its first
  returns the weights it was given;
* ``half_batch``: every emission log-likelihood is taken over the first
  half of the neurons and doubled (the mean over the rest);
* ``answer_altered``: one bin of the latent marginal that a decode or a
  fit returns is reversed;
* ``nan_answer``: one bin of the latent marginal that a decode or a fit
  returns is NaN.

The one-chip cells have no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "later_state_unchanged", "half_batch",
          "answer_altered", "nan_answer")


def _reverse(post, t):
    post[t] = post[t].flip(0)


def _nan(post, t):
    post[t] = float("nan")


def _alter(res, how):
    post = res["posterior_latent_marg"]  # a fit's 'posterior' is the same
    how(post, post.shape[0] // 2)
    return res


@contextlib.contextmanager
def planted(fault, pm):
    """Plant ``fault`` into the program package ``pm`` for the ``with``
    block."""
    from poor_man_gplvm_tpu_torch.models import base
    from poor_man_gplvm_tpu_torch.ops import hmm

    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, obj.__dict__[name]))
        setattr(obj, name, new)

    if fault in ("state_unchanged", "later_state_unchanged"):
        # every fit builds a new model, so a model counts its fit's M-steps
        first_kept = fault == "later_state_unchanged"
        for fam in (base._PoissonFamily, base._GaussianFamily):
            orig = fam.__dict__["m_step"]

            def m_step(self, param_curr, *a, _orig=orig, **k):
                res = dict(_orig(self, param_curr, *a, **k))
                n = self.__dict__.get("_fault_m_steps", 0)
                self._fault_m_steps = n + 1
                if n > 0 or not first_kept:
                    res["params"] = param_curr
                return res

            patch(fam, "m_step", m_step)
    elif fault == "half_batch":
        orig = hmm._loglik

        def loglik(y, tuning, hyperparam, ma_neuron, ma_latent,
                   observation_model, dt_l=None, lgamma_term=None):
            h = y.shape[1] // 2
            return 2.0 * orig(y[:, :h], tuning[:, :h], hyperparam,
                              ma_neuron[..., :h], ma_latent,
                              observation_model, dt_l)

        patch(hmm, "_loglik", loglik)
    elif fault in ("answer_altered", "nan_answer"):
        how = _reverse if fault == "answer_altered" else _nan
        orig_f = base._GPLVMCommon.__dict__["fit_em"]

        def fit_em(self, *a, **k):
            return _alter(orig_f(self, *a, **k), how)

        patch(base._GPLVMCommon, "fit_em", fit_em)
        jump = pm.models.jump1d.AbstractGPLVMJump1D
        orig_d = jump.__dict__["decode_latent"]

        def decode_latent(self, *a, **k):
            return _alter(orig_d(self, *a, **k), how)

        patch(jump, "decode_latent", decode_latent)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
