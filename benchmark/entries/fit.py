"""Entry ``fit``: whole ``fit_em`` fits on one recording, back to back,
each from a new model and its own CPU generator seeded from the run's seed
and the fit's index.

The check follows one fit drawn from the seed.  The reference runs the
whole fit, all its EM iterations, from the same start (the initial
posterior drawn from the fit's generator by the jump models' recipe, the
weights of the models' construction seed).  It compares the first
iteration's log-marginal and the first M-step's change of the weights,
and the last iteration's log-marginal, which judges every M-step and
E-step of the fit.  Besides, the reference's E-step from the fit's final
weights is compared with the fit's final log-marginal and marginals: they
judge the answer the fit returns against its own weights.  (From the second iteration on the
program warm-starts its fixed points and exits them at 1e-4, which moves
the log-marginal by up to 4e-4 from seed to seed: the last iteration's
limit is set above that.  The whole fit's change of the weights swings
with those exits far more, and is not compared.)
"""

from __future__ import annotations

import random

import torch

from benchmark.compare import max_abs_gap, rel_gap
from benchmark.reference import em
from benchmark.reference import model as rm


def fit_seed(seed, index):
    """The CPU generator seed of the run's ``index``-th fit."""
    return (int(seed) * 1_000_003 + 7_919 * index + 1) % (1 << 62)


class Entry:
    unit = "iters"

    def __init__(self, pm, cell, data, seed, device):
        self.pm, self.cfg, self.data = pm, cell.config, data
        self.device, self.seed = device, seed
        t = cell.traffic
        self.n_iter, self.warmup_iters = t["n_iter"], t["warmup_iters"]
        self.keep_index = random.Random(seed).randrange(t["sampled_calls"])
        self.kept = {}
        self.info = {"adam_iters": []}

    def _fit(self, generator, n_iter):
        model = getattr(self.pm, self.cfg.model)(**self.cfg.args,
                                                 device=self.device)
        return model.fit_em(self.data["y"], generator=generator,
                            n_iter=n_iter, output_mode="lean",
                            verboase=False, save_every=10**9)

    def warm_up(self):
        self._fit(torch.Generator().manual_seed(fit_seed(self.seed, -1)),
                  self.warmup_iters)

    def call(self, i):
        s = fit_seed(self.seed, i)
        res = self._fit(torch.Generator().manual_seed(s), self.n_iter)
        lml = [float(v) for v in res["log_marginal_l"]]
        self.info["adam_iters"].extend(
            res["m_step_res_l"].get("n_iter", []))
        if i <= self.keep_index:
            self.kept = {
                "fit_seed": s, "lml": lml,
                "adam_iters": res["m_step_res_l"].get("n_iter", [])[:1],
                "params_first": res["params_saved"][0],
                "params": res["params"],
                "posterior_latent_marg": res["posterior_latent_marg"],
                "posterior_dynamics_marg": res["posterior_dynamics_marg"]}
        del res
        return len(lml)

    def window_closed(self):
        pass

    def _post0(self, seed):
        T, L = self.data["y"].shape[0], self.cfg.n_latent
        return em.initial_posterior(T, L, seed)

    def control(self, prec=rm.TF32):
        """The reference fit in the program's place, in ``prec``."""
        ctrl = em.fit(self.data["y"], self.cfg,
                      self._post0(self.kept["fit_seed"]), self.n_iter, prec)
        return {"fit_seed": self.kept["fit_seed"], "lml": ctrl.log_marginal_l,
                "params_first": ctrl.params_first, "params": ctrl.params,
                "posterior_latent_marg": ctrl.last.latent_marg,
                "posterior_dynamics_marg": ctrl.last.dyn_marg}

    def compare(self, kept):
        """The numbers the check holds against their limits."""
        cfg, y = self.cfg, self.data["y"]
        dev = y.device
        ref = em.fit(y, cfg, self._post0(kept["fit_seed"]), self.n_iter)
        basis = cfg.basis().to(dev)
        p_init = rm.initial_params(basis.shape[1], cfg.n_neuron,
                                   cfg.rng_init_int).to(dev)
        ref_change = float((ref.params_first - p_init).norm())
        prog_change = float((kept["params_first"].to(dev).double()
                             - p_init).norm())
        lml_ref = ref.log_marginal_l
        out = {
            "lml_first_rel": rel_gap(kept["lml"][0], lml_ref[0]),
            "change_rel": abs(prog_change - ref_change) / ref_change,
            "lml_last_rel": (rel_gap(kept["lml"][-1], lml_ref[-1])
                             if len(kept["lml"]) == len(lml_ref)
                             else float("inf")),
        }
        self.info["check_detail"] = {
            "adam_iters": kept.get("adam_iters"),
            "ref_adam_iters": ref.adam_iters,
            "lml_rel_by_iter": [rel_gap(a, b)
                                for a, b in zip(kept["lml"], lml_ref)]}
        del ref
        trans = rm.transition(cfg.n_latent, cfg.movement_variance,
                              cfg.p_move_to_jump, cfg.p_jump_to_move, dev)
        last = em.e_step(y, kept["params"].to(dev).double(), basis, cfg,
                         trans)
        out["lml_final_rel"] = rel_gap(kept["lml"][-1], last.log_marginal)
        out["marg_final_gap"] = max(
            max_abs_gap(kept["posterior_latent_marg"], last.latent_marg),
            max_abs_gap(kept["posterior_dynamics_marg"], last.dyn_marg))
        return out
