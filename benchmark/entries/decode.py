"""Entry ``decode``: ``decode_latent(y, tuning=...)`` on one recording,
called back to back.

Every call decodes the same recording, so every call's answer is the same:
each call's log-marginal is compared, and all the outputs of one call drawn
from the seed (the latent and dynamics marginals, ``p_joint_full`` and
``p_transition_dynamics``).
"""

from __future__ import annotations

import random

from benchmark.compare import max_abs_gap
from benchmark.reference import model as rm
from benchmark.reference import smoother


class Entry:
    unit = "bins"

    def __init__(self, pm, cell, data, seed, device):
        cfg = cell.config
        self.cfg, self.data = cfg, data
        self.model = getattr(pm, cfg.model)(**cfg.args, device=device)
        self.T = data["y"].shape[0]
        self.warmup = cell.traffic["warmup_calls"]
        self.keep_index = random.Random(seed).randrange(
            cell.traffic["sampled_calls"])
        self.kept = {"lml": []}
        self.info = {}

    def warm_up(self):
        for _ in range(self.warmup):
            self._decode()

    def _decode(self):
        return self.model.decode_latent(self.data["y"],
                                        tuning=self.data["tuning"])

    def call(self, i):
        res = self._decode()
        self.kept["lml"].append(float(res["log_marginal_final"]))
        if i <= self.keep_index:
            for key in ("posterior_latent_marg", "posterior_dynamics_marg",
                        "p_joint_full", "p_transition_dynamics"):
                self.kept[key] = res[key]
        del res
        return self.T

    def window_closed(self):
        """Free the program's state; keep the inputs and the outputs the
        check reads."""
        self.model = None

    def control(self, prec=rm.TF32):
        """The reference in the program's place, in ``prec``: its outputs
        in the form ``call`` keeps."""
        ref = self._reference(prec)
        keys = smoother.joint_keys(ref.joint)
        return {"lml": [ref.log_marginal],
                "posterior_latent_marg": ref.latent_marg,
                "posterior_dynamics_marg": ref.dyn_marg, **keys}

    def _reference(self, prec=rm.F64):
        cfg, dev = self.cfg, self.data["y"].device
        trans = rm.transition(cfg.n_latent, cfg.movement_variance,
                              cfg.p_move_to_jump, cfg.p_jump_to_move, dev,
                              prec)
        ll = rm.loglik(self.data["y"], self.data["tuning"].double(),
                       cfg.family, cfg.noise_std, prec)
        return smoother.smooth(ll, trans, prec, want_joint=True)

    def compare(self, kept):
        """The numbers the check holds against their limits."""
        ref = self._reference()
        keys = smoother.joint_keys(ref.joint)
        lml = ref.log_marginal
        out = {
            "lml_rel": max(abs(v - lml) for v in kept["lml"]) / abs(lml),
            "marg_gap": max(
                max_abs_gap(kept["posterior_latent_marg"], ref.latent_marg),
                max_abs_gap(kept["posterior_dynamics_marg"], ref.dyn_marg)),
            "joint_gap": max_abs_gap(kept["p_joint_full"],
                                     keys["p_joint_full"])
            / float(keys["p_joint_full"].max()),
            "trans_dyn_gap": max_abs_gap(kept["p_transition_dynamics"],
                                         keys["p_transition_dynamics"]),
        }
        del ref
        return out

