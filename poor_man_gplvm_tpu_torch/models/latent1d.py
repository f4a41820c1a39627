"""Latent-only models: smooth 1-D latent, no dynamics HMM.

Counterpart of ``AbstractGPLVM1D``, ``PoissonGPLVM1D`` and
``GaussianGPLVM1D`` in ``poor_man_gplvm_tpu/models/latent1d.py``.  The
transition is one (L, L) channel (``hmm.LatentTransition``), which the
scan kernels take as the n_dyn = 1 stack with no constant channel.  Random
draws take an explicit CPU ``torch.Generator`` in place of a
``jax.random`` key.
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.models.base import (
    _GaussianFamily,
    _GPLVMCommon,
    _log_posterior_init,
    _PoissonFamily,
    _seeded,
)
from poor_man_gplvm_tpu_torch.ops import hmm
from poor_man_gplvm_tpu_torch.ops import kernels as gpk
from poor_man_gplvm_tpu_torch.utils import compat

__all__ = ["AbstractGPLVM1D", "PoissonGPLVM1D", "GaussianGPLVM1D"]


class AbstractGPLVM1D(_GPLVMCommon):
    """GPLVM with a smooth 1-D latent and no dynamics.  The model lives on
    ``device``, the card by default; without a card that raises, and
    ``device='cpu'`` runs on the CPU."""

    has_dynamics = False

    def __init__(
        self,
        n_neuron,
        n_latent_bin=100,
        tuning_lengthscale=5.0,
        param_prior_std=1.0,
        movement_variance=1.0,
        explained_variance_threshold_basis=0.999,
        rng_init_int=123,
        w_init_variance=1.0,
        w_init_mean=0.0,
        basis_type="rbf",
        custom_tuning_kernel=None,
        custom_transition_kernel=None,
        smoothness_penalty=0.0,
        inference_engine="auto",
        device="cuda",
    ):
        self._init_common(
            n_neuron, n_latent_bin, tuning_lengthscale, param_prior_std,
            movement_variance, explained_variance_threshold_basis,
            rng_init_int, w_init_variance, w_init_mean, basis_type,
            custom_tuning_kernel, custom_transition_kernel, smoothness_penalty,
            inference_engine, device,
        )

    # ------------------------------------------------------------------
    def _adopt_hyperparam(self, hyperparam):
        self.tuning_lengthscale = hyperparam.get(
            "tuning_lengthscale", self.tuning_lengthscale
        )
        self.movement_variance = hyperparam.get(
            "movement_variance", self.movement_variance
        )

    _TRANSITION_HYPER_KEYS = ("movement_variance",)

    def _build_transition(self, hyperparam):
        kernel, log_kernel = gpk.create_transition_prob_latent_1d(
            self.possible_latent_bin,
            hyperparam.get("movement_variance", self.movement_variance),
            custom_kernel=self.custom_transition_kernel,
        )
        trans = hmm.LatentTransition(T=kernel, logT=log_kernel)
        return trans, {"log_latent_transition_kernel": log_kernel}

    def _decode_latent(
        self, y, tuning, hyperparam, log_latent_transition_kernel, ma_neuron,
        ma_latent=None, likelihood_scale=1.0, n_time_per_chunk=None,
    ):
        """Smooth with an explicit log transition matrix (L, L) through the
        model's engine (K1/K2 or K3/K4 on the card, reading the band of the
        matrix's nonzeros: W = L for a dense matrix).  Returns
        ``hmm.smooth_combined_chunked``'s tuple, as the JAX method does."""
        log_kernel = self._as_device(log_latent_transition_kernel)
        trans = hmm.LatentTransition(T=torch.exp(log_kernel), logT=log_kernel)
        return self._smooth(
            self._as_device(y), tuning, self._emission_hyper(hyperparam),
            trans, ma_neuron, ma_latent, likelihood_scale, n_time_per_chunk,
        )

    #: the decode keys wrapped as TsdFrames when bin times are given
    _TSD_WRAP_KEYS = ("posterior_all",)

    def _decode_res(self, log_posterior_all, log_one_step_pred, log_acc,
                    log_likelihood_all):
        """The decode result dict (no ``log_marginal_final``) from the
        smoother's outputs."""
        res = {
            "log_posterior_all": log_posterior_all,
            "posterior_all": torch.exp(log_posterior_all),
            "log_one_step_predictive_marginals_all": log_one_step_pred,
            "log_likelihood_all": log_likelihood_all,
        }
        res.update(hmm.compute_transition_posterior_prob_latent(log_acc))
        return res

    # ------------------------------------------------------------------
    def decode_latent(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=None, t_l=None, mesh=None,
    ):
        """Full smoother decode: the 4 base keys, the 4 keys of
        ``hmm.compute_transition_posterior_prob_latent`` and
        ``log_marginal_final``, as the JAX ``decode_latent``.  With bin
        times ``t_l`` (or a TsdFrame ``y``, whose times win)
        ``posterior_all`` is a TsdFrame.  ``mesh``: run the smoother sharded
        over a ('data', 'time', 'neuron') ``parallel.spmd.Mesh``."""
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
    def sample_latent(self, T, generator=None, movement_variance=1,
                      init_latent=None):
        """Ancestral sampling of a latent path; a (T,) int64 tensor on the
        model's device."""
        g = _seeded(generator, 0)
        L = self.n_latent_bin
        kernel, _ = gpk.create_transition_prob_latent_1d(
            torch.arange(L), movement_variance,
            custom_kernel=self.custom_transition_kernel,
        )
        if init_latent is None:
            init_latent = int(torch.randint(L, (), generator=g))
        # inverse-CDF draws against pre-drawn uniforms
        u = torch.rand((T,), generator=g, dtype=torch.float64)
        cdf = torch.cumsum(kernel.double(), dim=-1)
        lt = int(init_latent)
        out = torch.empty((T,), dtype=torch.int64)
        for t in range(T):
            row = cdf[lt]
            lt = min(int(torch.searchsorted(row, u[t] * row[-1], right=True)),
                     L - 1)
            out[t] = lt
        return out.to(self.device)

    def sample(self, T, hyperparam=None, generator=None, init_latent=None,
               dt=1.0, tuning=None):
        """Sample a latent path and observations; returns (latent_l, y_l)."""
        hyperparam = {} if hyperparam is None else hyperparam
        g = _seeded(generator, 0)
        latent_l = self.sample_latent(
            T, g, hyperparam.get("movement_variance", self.movement_variance),
            init_latent,
        )
        return latent_l, self.sample_y(latent_l, hyperparam, tuning, dt, g)

    def init_latent_posterior(self, T, generator, random_scale=0.1):
        """Uniform-plus-noise initial posterior (T, L), intentionally
        different from the jump family's pure-random one; returns
        (log_post, post)."""
        L = self.n_latent_bin
        post = torch.ones((T, L)) / L + torch.rand(
            (T, L), generator=generator) * random_scale
        return _log_posterior_init(post / post.sum(dim=1, keepdim=True),
                                   self.device)


class PoissonGPLVM1D(_PoissonFamily, AbstractGPLVM1D):
    """Poisson latent-only GPLVM."""


class GaussianGPLVM1D(_GaussianFamily, AbstractGPLVM1D):
    """Gaussian latent-only GPLVM: linear link and the analytic ridge
    M-step; ``noise_std`` (default 0.5) is a constructor argument."""
