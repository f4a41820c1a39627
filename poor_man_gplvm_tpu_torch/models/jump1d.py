"""Jump models: smooth 1-D latent + 2-state (continuous/jump) dynamics HMM.

Counterpart of ``AbstractGPLVMJump1D``, ``PoissonGPLVMJump1D`` and
``GaussianGPLVMJump1D`` in ``poor_man_gplvm_tpu/models/jump1d.py`` for
decoding, sampling and fitting.  Random draws take an explicit
``torch.Generator`` (a CPU generator, so a seed gives the same draws on
every device) in place of a ``jax.random`` key; the two give different
numbers from the same seed.
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.models.base import (
    _GaussianFamily,
    _GPLVMCommon,
    _PoissonFamily,
    _seeded,
)
from poor_man_gplvm_tpu_torch.ops import hmm
from poor_man_gplvm_tpu_torch.ops import kernels as gpk
from poor_man_gplvm_tpu_torch.utils import compat

__all__ = ["AbstractGPLVMJump1D", "PoissonGPLVMJump1D", "GaussianGPLVMJump1D"]


class AbstractGPLVMJump1D(_GPLVMCommon):
    """GPLVM with smooth 1d latent + jumps.

    The latent governs firing rate; the 2-state dynamics governs the latent
    transition law (RBF-smooth when 'continuous', uniform when 'jump').
    The model lives on ``device``, the card by default; without a card
    that raises, and ``device='cpu'`` runs on the CPU."""

    has_dynamics = True
    init_plus_uniform = False

    def __init__(
        self,
        n_neuron,
        n_latent_bin=100,
        tuning_lengthscale=1.0,
        param_prior_std=1.0,
        movement_variance=1.0,
        explained_variance_threshold_basis=0.999,
        rng_init_int=123,
        w_init_variance=1.0,
        w_init_mean=0.0,
        p_move_to_jump=0.01,
        p_jump_to_move=0.01,
        basis_type="rbf",
        custom_tuning_kernel=None,
        custom_transition_kernel=None,
        smoothness_penalty=0.0,
        inference_engine="auto",
        device="cuda",
    ):
        self.p_move_to_jump = p_move_to_jump
        self.p_jump_to_move = p_jump_to_move
        self._init_common(
            n_neuron, n_latent_bin, tuning_lengthscale, param_prior_std,
            movement_variance, explained_variance_threshold_basis,
            rng_init_int, w_init_variance, w_init_mean, basis_type,
            custom_tuning_kernel, custom_transition_kernel, smoothness_penalty,
            inference_engine, device,
        )
        self.possible_dynamics = torch.arange(2, device=self.device)

    # ------------------------------------------------------------------
    def _adopt_hyperparam(self, hyperparam):
        self.tuning_lengthscale = hyperparam.get(
            "tuning_lengthscale", self.tuning_lengthscale
        )
        self.movement_variance = hyperparam.get(
            "movement_variance", self.movement_variance
        )
        self.p_move_to_jump = hyperparam.get("p_move_to_jump",
                                             self.p_move_to_jump)
        self.p_jump_to_move = hyperparam.get("p_jump_to_move",
                                             self.p_jump_to_move)

    _TRANSITION_HYPER_KEYS = (
        "movement_variance", "p_move_to_jump", "p_jump_to_move",
    )

    @classmethod
    def transition_of(cls, hp, n_latent_bin, device, custom_kernel=None):
        lat, log_lat, dyn, log_dyn = gpk.create_transition_prob_1d(
            torch.arange(n_latent_bin, device=device),
            torch.arange(2, device=device), hp["movement_variance"],
            hp["p_move_to_jump"], hp["p_jump_to_move"],
            custom_kernel=custom_kernel,
        )
        trans = hmm.JointTransition(Tdyn=dyn, Tlat=lat, logTdyn=log_dyn,
                                    logTlat=log_lat)
        kernel_attrs = {
            "log_latent_transition_kernel_l": log_lat,
            "log_dynamics_transition_kernel": log_dyn,
        }
        return trans, kernel_attrs

    def _decode_latent(
        self, y, tuning, hyperparam, log_latent_transition_kernel_l,
        log_dynamics_transition_kernel, ma_neuron, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=None,
    ):
        """Smooth with explicit log transition matrices (n_dyn, L, L) and
        (n_dyn, n_dyn) through the model's engine (K1/K2 or K3/K4 on the
        card, each reading the band of these matrices' nonzeros: W = L for
        a dense matrix).  Returns ``hmm.smooth_combined_chunked``'s tuple,
        as the JAX method does."""
        log_lat = self._as_device(log_latent_transition_kernel_l)
        log_dyn = self._as_device(log_dynamics_transition_kernel)
        trans = hmm.JointTransition(
            Tdyn=torch.exp(log_dyn), Tlat=torch.exp(log_lat),
            logTdyn=log_dyn, logTlat=log_lat)
        return self._smooth(
            self._as_device(y), tuning, self._emission_hyper(hyperparam),
            trans, ma_neuron, ma_latent, likelihood_scale, n_time_per_chunk,
        )

    #: the decode keys wrapped as TsdFrames when bin times are given
    _TSD_WRAP_KEYS = ("posterior_latent_marg", "posterior_dynamics_marg")

    def _decode_res(self, log_posterior_all, log_one_step_pred, log_acc,
                    log_likelihood_all):
        """The decode result dict (no ``log_marginal_final``) from the
        smoother's outputs."""
        posterior_all = torch.exp(log_posterior_all)
        res = {
            "log_posterior_all": log_posterior_all,
            "posterior_all": posterior_all,
            "posterior_latent_marg": posterior_all.sum(dim=1),
            "posterior_dynamics_marg": posterior_all.sum(dim=2),
            "log_one_step_predictive_marginals_all": log_one_step_pred,
            "log_likelihood_all": log_likelihood_all,
        }
        res.update(hmm.compute_transition_posterior_prob(log_acc))
        return res

    # ------------------------------------------------------------------
    def decode_latent(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=None, t_l=None, mesh=None,
    ):
        """Full smoother decode: 7 base keys + 12 transition-posterior
        keys + ``log_marginal_final``, as the JAX ``decode_latent``.  With
        bin times ``t_l`` (or a TsdFrame ``y``, whose times win) the latent
        and dynamics marginals are TsdFrames.  ``mesh``: run the smoother
        sharded over a ('data', 'time', 'neuron') ``parallel.spmd.Mesh``."""
        if compat.is_tsdframe(y):
            t_l = y.t
            y = y.d
        hyperparam = self._emission_hyper(hyperparam)
        if tuning is None:
            tuning = self.tuning
        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default

        trans, _ = self._make_transition(hyperparam)
        return self._decode_dispatch(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, n_time_per_chunk, t_l, mesh,
            self._TSD_WRAP_KEYS, self._decode_res,
        )

    # ------------------------------------------------------------------
    def sample_latent(
        self, T, generator=None, movement_variance=1, p_move_to_jump=0.01,
        p_jump_to_move=0.01, init_dynamics=None, init_latent=None,
    ):
        """Ancestral sampling of (dynamics, latent) paths.  Returns a (T, 2)
        int64 tensor [dynamics, latent] on the model's device."""
        g = _seeded(generator, 0)
        lat, _, dyn, _ = gpk.create_transition_prob_1d(
            torch.arange(self.n_latent_bin), None, movement_variance,
            p_move_to_jump, p_jump_to_move,
        )
        if init_dynamics is None:
            init_dynamics = int(torch.randint(2, (), generator=g))
        if init_latent is None:
            init_latent = int(torch.randint(self.n_latent_bin, (),
                                            generator=g))
        # inverse-CDF draws against pre-drawn uniforms
        u = torch.rand((T, 2), generator=g, dtype=torch.float64)
        cdf_dyn = torch.cumsum(dyn.double(), dim=-1)
        cdf_lat = torch.cumsum(lat.double(), dim=-1)
        d, lt = int(init_dynamics), int(init_latent)
        out = torch.empty((T, 2), dtype=torch.int64)
        for t in range(T):
            row = cdf_dyn[d]
            d = min(int(torch.searchsorted(row, u[t, 0] * row[-1],
                                           right=True)), 1)
            row = cdf_lat[d, lt]
            lt = min(int(torch.searchsorted(row, u[t, 1] * row[-1],
                                            right=True)),
                     self.n_latent_bin - 1)
            out[t, 0], out[t, 1] = d, lt
        return out.to(self.device)

    def sample(
        self, T, hyperparam=None, generator=None, init_dynamics=None,
        init_latent=None, dt=1.0, tuning=None,
    ):
        """Sample a latent path and observations; returns (latent_l, y_l)."""
        hyperparam = {} if hyperparam is None else hyperparam
        g = _seeded(generator, 0)
        latent_l = self.sample_latent(
            T, g,
            hyperparam.get("movement_variance", self.movement_variance),
            hyperparam.get("p_move_to_jump", self.p_move_to_jump),
            hyperparam.get("p_jump_to_move", self.p_jump_to_move),
            init_dynamics, init_latent,
        )
        y_l = self.sample_y(latent_l[:, 1], hyperparam, tuning, dt, g)
        return latent_l, y_l


class PoissonGPLVMJump1D(_PoissonFamily, AbstractGPLVMJump1D):
    """Poisson GPLVM with jumps: the flagship model."""


class GaussianGPLVMJump1D(_GaussianFamily, AbstractGPLVMJump1D):
    """Gaussian GPLVM with jumps: linear link and the analytic ridge
    M-step; ``noise_std`` (default 0.5) is a constructor argument."""
