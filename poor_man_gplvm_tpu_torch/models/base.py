"""Shared model machinery for the decode path (PyTorch).

Counterpart of the parts of ``poor_man_gplvm_tpu/models/base.py`` that
``decode_latent`` needs: construction, parameter initialisation, the
memoised transition build, the smoother call, the decode driver and
naive-Bayes decoding.  The classes hold a handful of scalars plus
``params`` (n_basis, N), ``tuning_basis`` (L, n_basis) and ``tuning``
(L, N), all on the model's ``device``.  ``fit_em`` and the M-step come with
the fit slice (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import emissions, hmm
from poor_man_gplvm_tpu_torch.ops.basis import generate_basis


def resolve_engine(inference_engine, device):
    """'auto' resolves by the model's device: 'cuda' on a CUDA device,
    'prob' on the CPU.  Engines the port does not run raise."""
    if inference_engine in (None, "auto"):
        inference_engine = "cuda" if device.type == "cuda" else "prob"
    hmm.check_engine(inference_engine)
    return inference_engine


class _GPLVMCommon(ABC):
    """Template shared by the model families."""

    has_dynamics: bool = False
    observation_model: str = "poisson"

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _init_common(
        self,
        n_neuron,
        n_latent_bin,
        tuning_lengthscale,
        param_prior_std,
        movement_variance,
        explained_variance_threshold_basis,
        rng_init_int,
        w_init_variance,
        w_init_mean,
        basis_type,
        custom_tuning_kernel,
        custom_transition_kernel,
        smoothness_penalty,
        inference_engine,
        device,
    ):
        self.device = torch.device(device)
        self.n_latent_bin = n_latent_bin
        self.tuning_lengthscale = tuning_lengthscale
        self.param_prior_std = param_prior_std
        self.movement_variance = movement_variance
        self.explained_variance_threshold_basis = (
            explained_variance_threshold_basis
        )
        self.rng_init_int = rng_init_int
        self.n_neuron = n_neuron
        self.possible_latent_bin = torch.arange(n_latent_bin,
                                                device=self.device)
        self.w_init_variance = w_init_variance
        self.w_init_mean = w_init_mean
        self.smoothness_penalty = smoothness_penalty
        self.basis_type = basis_type
        self.custom_tuning_kernel = custom_tuning_kernel
        self.custom_transition_kernel = custom_transition_kernel
        self.inference_engine = resolve_engine(inference_engine, self.device)

        # the SVD runs on the host so that every device gets the same basis
        self.tuning_basis = generate_basis(
            self.tuning_lengthscale,
            self.n_latent_bin,
            self.explained_variance_threshold_basis,
            include_bias=True,
            basis_type=basis_type,
            custom_kernel=custom_tuning_kernel,
        ).to(self.device)
        self.n_basis = self.tuning_basis.shape[1]
        self.ma_neuron_default = torch.ones(n_neuron, device=self.device)
        self.ma_latent_default = torch.ones(n_latent_bin, device=self.device)
        self.initialize_params(torch.Generator().manual_seed(rng_init_int))

    @abstractmethod
    def get_tuning(self, params, hyperparam, tuning_basis):
        """Link function mapping basis weights to tuning curves."""

    @abstractmethod
    def sample_y(self, latent_l, hyperparam=None, tuning=None, dt=1.0,
                 generator=None):
        """Sample observations given a latent path."""

    #: hyperparam keys the transition matrices depend on (subclass sets);
    #: the memoization key of _make_transition
    _TRANSITION_HYPER_KEYS: tuple = ()

    @abstractmethod
    def _build_transition(self, hyperparam):
        """Build the hmm Transition + matrices from instance attributes with
        per-call hyperparam overrides (``hyperparam.get(key, self.key)``)."""

    def _make_transition(self, hyperparam):
        """Memoized ``_build_transition``: repeated decodes with the same
        dynamics hyperparameters reuse the built (L, L) matrices and their
        host-side constant-channel flags."""
        key = self._transition_cache_key(hyperparam)
        if key is None:
            return self._build_transition(hyperparam)
        cache = getattr(self, "_trans_cache", None)
        if cache is None:
            cache = self._trans_cache = {}
        hit = cache.get(key)
        if hit is None:
            if len(cache) >= 64:  # sweeps over many configs: stay bounded
                cache.clear()
            hit = cache[key] = self._build_transition(hyperparam)
        return hit

    def _transition_cache_key(self, hyperparam):
        if self.custom_transition_kernel is not None:
            return None  # array-valued dependency: don't guess identity
        vals = []
        for k in self._TRANSITION_HYPER_KEYS:
            v = hyperparam.get(k, getattr(self, k))
            if not isinstance(v, (int, float, np.integer, np.floating)):
                return None
            vals.append(float(v))
        return tuple(vals)

    @abstractmethod
    def init_latent_posterior(self, T, generator, random_scale=0.1):
        """Initial E-step posterior."""

    # ------------------------------------------------------------------
    # shared numerics
    # ------------------------------------------------------------------
    def initialize_params(self, generator):
        """Random normal basis weights from ``generator`` (a CPU
        ``torch.Generator``, so a seed gives the same weights on every
        device)."""
        params_init = (
            torch.randn((self.n_basis, self.n_neuron), generator=generator)
            * float(np.sqrt(self.w_init_variance)) + self.w_init_mean
        ).to(self.device)
        self.params = params_init
        self.tuning = self.get_tuning(params_init, hyperparam={},
                                      tuning_basis=self.tuning_basis)
        return self.params, self.tuning

    def _as_device(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _smooth(self, y, tuning, hyperparam, trans, ma_neuron, ma_latent,
                likelihood_scale, n_time_per_chunk, **smooth_kwargs):
        return hmm.smooth_combined_chunked(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk,
            observation_model=self.observation_model,
            engine=self.inference_engine,
            **smooth_kwargs,
        )

    def _decode_dispatch(self, y, tuning, hyperparam, trans, ma_neuron,
                         ma_latent, likelihood_scale, n_time_per_chunk,
                         build_res):
        """Shared decode driver: smoother, then the family's result dict.
        The ``float()`` host sync of the log-marginal comes LAST, after all
        device work is enqueued."""
        (
            log_posterior_all, log_marginal_final, _log_causal,
            log_one_step_pred, log_acc, log_likelihood_all,
        ) = self._smooth(
            self._as_device(y), tuning, hyperparam, trans, ma_neuron,
            ma_latent, likelihood_scale, n_time_per_chunk,
        )
        decoding_res = build_res(
            log_posterior_all, log_one_step_pred, log_acc, log_likelihood_all
        )
        decoding_res["log_marginal_final"] = float(log_marginal_final)
        return decoding_res

    def predict_expected_rate(self, post_latent_marg, tuning=None):
        """Expected firing rate (T, N) under the latent posterior (T, L)."""
        if tuning is None:
            tuning = self.tuning
        return torch.einsum("pn,tp->tn", tuning,
                            self._as_device(post_latent_marg))

    def decode_latent_naive_bayes(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=10000, dt_l=1.0,
        observation_model=None,
    ):
        """Per-time posterior without temporal smoothing."""
        hyperparam = {} if hyperparam is None else hyperparam
        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default
        if tuning is None:
            tuning = self.tuning
        if observation_model is None:
            observation_model = self.observation_model
        del likelihood_scale  # unused by the reference NB path too

        log_post, log_marginal_l, log_marginal_total, ll_per_pos_l = (
            emissions.get_naive_bayes_ma_chunk(
                self._as_device(y), tuning, hyperparam, ma_neuron, ma_latent,
                dt_l=dt_l, n_time_per_chunk=n_time_per_chunk,
                observation_model=observation_model,
            )
        )
        return {
            "log_posterior_latent": log_post,
            "log_marginal_l": log_marginal_l,
            "log_marginal_total": float(log_marginal_total),
            "posterior_latent": torch.exp(log_post),
            "ll_per_pos_l": ll_per_pos_l,
        }
