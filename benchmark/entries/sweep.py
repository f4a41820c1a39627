"""Entry ``sweep``: whole ``sweep_fit_poisson_jump`` calls over the
configuration's grid on one recording, back to back, each from a new CPU
generator seeded from the run's seed and the call's index.

A call fits every run of the grid (the configuration file's ``grid``, each
point ``n_repeat`` times, with its ``p_jump_to_move`` and
``param_prior_std``) for ``n_iter`` EM iterations; its work is runs x EM
iterations.

The check follows one call drawn from the seed.  For one run of each
configuration (its chain drawn from the seed), the reference
(``reference/sweep.py``) redraws the run's start and runs its whole fit:
the first iteration's log-marginal and the first M-step's change of the
weights, and the last iteration's log-marginal, are compared.  For every
run, the reference's E-step from the run's final weights, under its own
transition, is compared with the run's last log-marginal and its returned
latent marginal.  Each number is the largest over the runs it covers.

The call returns no weights from before its last M-step, so after the
window one more call with ``n_iter`` = 1 from the kept call's generator
gives the first M-step's weights; its log-marginals must equal the kept
call's first ones bit for bit (else ``change_rel`` is infinite).
"""

from __future__ import annotations

import json
import math
import random
import sys

import torch

from benchmark.compare import max_abs_gap, rel_gap
from benchmark.config import BENCH_DIR
from benchmark.entries.fit import fit_seed
from benchmark.reference import model as rm
from benchmark.reference import sweep as rs

#: the basis threshold ``sweep_fit_poisson_jump`` builds its basis at
SWEEP_BASIS_THRESHOLD = 0.999


def grid_spec(cfg, bench_dir=BENCH_DIR):
    """(the swept ranges, ``n_repeat``) of the configuration's file: its
    ``grid`` and, as one value each, its ``p_jump_to_move`` and
    ``param_prior_std``."""
    with open(bench_dir / "configs" / f"{cfg.name}.json") as f:
        d = json.load(f)
    ranges = {**d["grid"], "p_jump_to_move": [cfg.p_jump_to_move],
              "param_prior_std": [cfg.param_prior_std]}
    return ranges, int(d["n_repeat"])


def _worst(values):
    """The largest of ``values``, infinite where one is not finite."""
    return max((v if math.isfinite(v) else math.inf for v in values),
               default=math.inf)


class Entry:
    unit = "run-iters"

    def __init__(self, pm, cell, data, seed, device):
        cfg = cell.config
        if cfg.explained_variance_threshold_basis != SWEEP_BASIS_THRESHOLD:
            raise ValueError("sweep_fit_poisson_jump builds its basis at "
                             f"the threshold {SWEEP_BASIS_THRESHOLD}")
        self.pm, self.cfg, self.data = pm, cfg, data
        self.device, self.seed = device, seed
        t = cell.traffic
        self.ranges, n_repeat = grid_spec(cfg)
        self.hps = rs.grid_runs(self.ranges, n_repeat)
        self.n_iter, self.warmup = t["n_iter"], t["warmup_calls"]
        self.adam = dict(step_size=t["m_step_size"], maxiter=t["m_maxiter"],
                         tol=t["m_tol"])
        self.kw = dict(n_repeat=n_repeat, n_latent_bin=cfg.n_latent,
                       tuning_lengthscale=cfg.tuning_lengthscale,
                       m_step_size=t["m_step_size"],
                       m_maxiter=t["m_maxiter"], m_tol=t["m_tol"],
                       device=device)
        rng = random.Random(seed)
        self.keep_index = rng.randrange(t["sampled_calls"])
        self.fit_runs = [c + rng.randrange(n_repeat)
                         for c in range(0, len(self.hps), n_repeat)]
        self.basis = cfg.basis()
        self.kept = {}
        self.info = {"runs": len(self.hps), "n_iter": self.n_iter,
                     "n_basis": self.basis.shape[1],
                     "movement_variances": [hp["movement_variance"]
                                            for hp in self.hps]}

    def _sweep(self, call_seed, n_iter):
        return self.pm.parallel.sweep.sweep_fit_poisson_jump(
            self.data["y"], self.ranges, n_iter=n_iter,
            generator=torch.Generator().manual_seed(call_seed), **self.kw)

    def warm_up(self):
        for k in range(self.warmup):
            self._sweep(fit_seed(self.seed, -1 - k), self.n_iter)

    def call(self, i):
        s = fit_seed(self.seed, i)
        res = self._sweep(s, self.n_iter)
        if i <= self.keep_index:
            self.kept = {"call_seed": s, "res": res}
        del res
        return len(self.hps) * self.n_iter

    def window_closed(self):
        """The kept call's outputs by run, and its first M-step's weights
        from a one-iteration call from the same generator."""
        res = self.kept.pop("res", None)
        if res is None:
            return
        s = self.kept["call_seed"]
        lml = res["log_marginal_l"]
        try:
            one = self._sweep(s, 1)
        except Exception as exc:  # the run still prints its result
            print(f"the one-iteration call raised {type(exc).__name__}: "
                  f"{exc}", file=sys.stderr)
            one = None
        repeats = one is not None and torch.equal(
            one["log_marginal_l"][:, 0], lml[:, 0])
        lml = lml.double().cpu().tolist()
        B = len(self.hps)
        self.kept = {
            "call_seed": s, "first_repeats": repeats,
            "lml": {b: lml[b] for b in range(B)},
            "params_first": {b: one["params"][b] for b in range(B)}
            if repeats else {},
            "params": {b: res["params"][b] for b in range(B)},
            "log_post": {b: res["log_posterior_latent"][b]
                         for b in range(B)}}
        del res, one

    def _start(self, call_seed):
        """Each fit run's (initial weights, initial posterior), as the
        reference redraws them."""
        seeds = rs.run_seeds(call_seed, len(self.hps))
        T, N = self.data["y"].shape
        dev = self.data["y"].device
        for b in self.fit_runs:
            yield b, rs.run_start(seeds[b], T, self.cfg.n_latent,
                                  self.basis.shape[1], N, dev)

    def _fit(self, b, start, prec=rm.F64):
        p0, post0 = start
        return rs.fit_run(self.data["y"], self.cfg,
                          self.basis.to(p0.device), self.hps[b], p0, post0,
                          self.n_iter, prec=prec, **self.adam)

    def control(self, prec=rm.TF32):
        """The reference fit in the program's place, in ``prec``, for the
        fit runs of the call drawn from the seed."""
        s = fit_seed(self.seed, self.keep_index)
        kept = {"call_seed": s, "first_repeats": True, "lml": {},
                "params_first": {}, "params": {}, "log_post": {}}
        for b, start in self._start(s):
            ctrl = self._fit(b, start, prec)
            kept["lml"][b] = ctrl.log_marginal_l
            kept["params_first"][b] = ctrl.params_first
            kept["params"][b] = ctrl.params
            kept["log_post"][b] = torch.log(ctrl.last.latent_marg)
            del ctrl
        return kept

    def compare(self, kept):
        """The numbers the check holds against their limits."""
        y = self.data["y"]
        first, change, last, detail = [], [], [], {}
        for b, start in self._start(kept["call_seed"]):
            ref = self._fit(b, start)
            p0 = start[0]
            del start
            lml = kept["lml"][b]
            first.append(rel_gap(lml[0], ref.log_marginal_l[0]))
            change.append(math.inf)
            if kept["first_repeats"]:
                ref_change = float((ref.params_first - p0).norm())
                prog_change = float(
                    (kept["params_first"][b].to(p0) - p0).norm())
                change[-1] = abs(prog_change - ref_change) / ref_change
            last.append(rel_gap(lml[-1], ref.log_marginal_l[-1])
                        if len(lml) == len(ref.log_marginal_l)
                        else math.inf)
            detail[b] = {"ref_adam_iters": ref.adam_iters,
                         "lml_rel_by_iter": [
                             rel_gap(a, r) for a, r in
                             zip(lml, ref.log_marginal_l)]}
            del ref, p0
        final, marg = [], []
        basis = self.basis.to(y.device)
        for b, params in kept["params"].items():
            e = rs.e_step(y, self.cfg, basis, self.hps[b], params.to(y.device))
            final.append(rel_gap(kept["lml"][b][-1], e.log_marginal))
            marg.append(max_abs_gap(torch.exp(kept["log_post"][b]),
                                    e.latent_marg))
            del e
        self.info["check_detail"] = {
            "first_repeats": kept["first_repeats"], "fit_runs": detail,
            "lml_final_rel_by_run": final, "marg_final_gap_by_run": marg}
        return {"lml_first_rel": _worst(first), "change_rel": _worst(change),
                "lml_last_rel": _worst(last),
                "lml_final_rel": _worst(final),
                "marg_final_gap": _worst(marg)}
