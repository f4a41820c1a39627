"""Shared model machinery (PyTorch).

Counterpart of the parts of ``poor_man_gplvm_tpu/models/base.py`` that
``decode_latent`` and ``fit_em`` need: construction, parameter
initialisation, the memoised transition build, the smoother call, the
decode driver, naive-Bayes decoding and the EM host loop.  The classes hold
a handful of scalars plus ``params`` (n_basis, N), ``tuning_basis``
(L, n_basis) and ``tuning`` (L, N), all on the model's ``device``.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import emissions, hmm, mstep
from poor_man_gplvm_tpu_torch.ops.basis import generate_basis


def resolve_engine(inference_engine, device):
    """'auto' resolves by the model's device: 'cuda' on a CUDA device
    (upgraded to 'cuda_parallel' for long sequences, see
    ``hmm.engine_resolves_parallel``), 'prob' on the CPU.  Engines the port
    does not run raise."""
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
        self.adam_runner = None
        self.opt_state_init_fun = None
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

    @abstractmethod
    def m_step(self, param_curr, y, log_posterior_curr, tuning_basis,
               hyperparam, opt_state_curr=None, host_trim=True):
        """One M-step on grouped statistics."""

    @abstractmethod
    def _adopt_hyperparam(self, hyperparam):
        """Copy per-call hyperparam overrides back onto instance attrs."""

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

    # ------------------------------------------------------------------
    # EM template
    # ------------------------------------------------------------------
    def fit_em(
        self, y, hyperparam=None, generator=None, n_iter=20,
        log_posterior_init=None, opt_state_curr=None, ma_neuron=None,
        ma_latent=None, n_time_per_chunk=None, dt=1.0, likelihood_scale=1.0,
        save_every=None, posterior_init_kwargs=None, verboase=True,
        profile=False, checkpoint_dir=None, checkpoint_every=None,
        resume=False, output_mode="full", memory_mode=None, nan_guard=None,
        mesh=None, **kwargs,
    ):
        """EM: alternate the M-step (Adam on the grouped Poisson objective)
        and the E-step (the forward-backward smoother), ``n_iter`` times.

        The JAX package's host loop with its ``em_res`` keys, for
        ``output_mode='full'``.  ``generator`` (a CPU ``torch.Generator``)
        takes the place of the JAX ``key`` for the random initial posterior;
        pass ``log_posterior_init`` to start from a given one (a float64
        numpy array is clamped to ``JOINT_ACC_INIT`` first).  ``dt`` is
        accepted and unused, as in the reference.  ``profile=True`` syncs
        the device after each phase and adds ``em_res['profile']`` with the
        per-iteration ``m_step`` / ``e_step`` / ``collect`` seconds and the
        parallel engine's fixed-point diagnostics (``scan_passes``).

        The port has no fused program: ``fused=`` is accepted and the host
        loop always runs (a CUDA-graph counterpart waits for evidence on the
        card, ROADMAP queue 1, item 10).  ``checkpoint_dir``/``resume``,
        ``output_mode='lean'`` and ``mesh`` are not ported."""
        del dt  # unused, as in the reference
        if checkpoint_dir is not None or resume:
            raise NotImplementedError(
                "checkpoint_dir/resume are not ported yet (ROADMAP queue 1, "
                "item 15)")
        if output_mode != "full":
            raise NotImplementedError(
                f"output_mode={output_mode!r} is not ported yet (ROADMAP "
                "queue 1, item 12); use 'full'")
        if mesh is not None:
            raise NotImplementedError(
                "mesh is not ported yet (ROADMAP queue 1, item 14)")
        del checkpoint_every
        kwargs.pop("fused", None)  # always the host loop (see docstring)
        verboase = kwargs.pop("verbose", verboase)
        if kwargs:
            raise TypeError(f"unexpected keyword arguments {sorted(kwargs)}")
        if n_iter < 1:
            raise ValueError(
                f"n_iter={n_iter} requests no EM iterations; n_iter must be "
                ">= 1.")
        hyperparam = {} if hyperparam is None else hyperparam
        generator = torch.Generator().manual_seed(0) if generator is None \
            else generator
        posterior_init_kwargs = (
            {"random_scale": 0.1} if posterior_init_kwargs is None
            else posterior_init_kwargs
        )
        y_ = self._as_device(y)
        self._adopt_hyperparam(hyperparam)
        if save_every is None:
            save_every = n_iter

        trans, kernel_attrs = self._make_transition(hyperparam)
        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default

        # a swept tuning_lengthscale regenerates the basis; a changed rank
        # re-initialises the params (and the optimizer state built on them)
        if "tuning_lengthscale" in hyperparam:
            tuning_basis = generate_basis(
                self.tuning_lengthscale, self.n_latent_bin,
                self.explained_variance_threshold_basis, include_bias=True,
                basis_type=self.basis_type,
                custom_kernel=self.custom_tuning_kernel,
            ).to(self.device)
            if tuning_basis.shape[1] != self.params.shape[0]:
                self.tuning_basis = tuning_basis
                self.n_basis = tuning_basis.shape[1]
                self.initialize_params(generator)
                if opt_state_curr is not None:
                    opt_state_curr = self.opt_state_init_fun(self.params)
        else:
            tuning_basis = self.tuning_basis

        if log_posterior_init is None:
            log_posterior_init, _ = self.init_latent_posterior(
                y_.shape[0], generator, **posterior_init_kwargs
            )
        else:
            if isinstance(log_posterior_init, np.ndarray) and \
                    log_posterior_init.dtype == np.float64:
                # reference inits floor -inf at -1e40, which overflows f32:
                # clamp to the shared finite sentinel first (both carry zero
                # probability mass)
                log_posterior_init = np.maximum(
                    log_posterior_init, hmm.JOINT_ACC_INIT
                ).astype(np.float32)
            log_posterior_init = self._as_device(log_posterior_init)

        log_posterior_curr = log_posterior_init
        log_marginal_l = []
        m_step_res_l = {}
        params = self.params
        log_posterior_all_saved, params_saved = [], []
        tuning_saved, iter_saved, log_marginal_saved = [], [], []
        phase_times = {"m_step": [], "e_step": [], "collect": [],
                       "scan_passes": []}

        def sync():
            if profile and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        for i in range(n_iter):
            t0 = time.perf_counter()
            m_res = self.m_step(
                params, y_, log_posterior_curr, tuning_basis, hyperparam,
                opt_state_curr=opt_state_curr, host_trim=False,
            )
            sync()
            t1 = time.perf_counter()
            params = m_res["params"]
            opt_state_curr = m_res.get("opt_state", None)
            tuning = self.get_tuning(params, hyperparam, tuning_basis)
            diag = []
            (
                log_posterior_all, log_marginal_final, _log_causal,
                _log_pred, _log_acc, _ll,
            ) = self._smooth(
                y_, tuning, hyperparam, trans, ma_neuron, ma_latent,
                likelihood_scale, n_time_per_chunk, want_acc=False,
                diag_out=diag,
                **({"memory_mode": memory_mode} if memory_mode else {}),
            )
            if self.has_dynamics:
                log_posterior_curr = torch.logsumexp(log_posterior_all, dim=1)
            else:
                log_posterior_curr = log_posterior_all
            sync()
            t2 = time.perf_counter()

            if not m_step_res_l:
                m_step_res_l = {k: [] for k in m_res}
            for k in m_res:
                if k not in ("params", "opt_state"):
                    m_step_res_l[k].append(m_res[k])
            log_marginal_l.append(log_marginal_final)
            if i % save_every == 0:
                log_posterior_all_saved.append(log_posterior_all)
                params_saved.append(params)
                tuning_saved.append(tuning)
                log_marginal_saved.append(log_marginal_final)
                iter_saved.append(i)
            t3 = time.perf_counter()
            phase_times["m_step"].append(t1 - t0)
            phase_times["e_step"].append(t2 - t1)
            phase_times["collect"].append(t3 - t2)
            phase_times["scan_passes"].extend(d[:2] for d in diag)
            if verboase:
                print(f"EM iteration {i + 1}/{n_iter}", flush=True)

            # a non-finite log marginal means the fit diverged; the check
            # costs one host read, so it is off unless nan_guard=True
            if nan_guard and not np.isfinite(float(log_marginal_final)):
                raise FloatingPointError(
                    f"EM diverged: log marginal is "
                    f"{float(log_marginal_final)} at iteration {i} "
                    f"(T={y_.shape[0]}, n_latent_bin={self.n_latent_bin}). "
                    "Check hyperparam values and neuron/latent masks."
                )

        mstep.batch_trim_m_step_histories(m_step_res_l)

        self.params = params
        self.tuning = tuning
        self.log_marginal_final = log_marginal_final
        for attr_name, attr_val in kernel_attrs.items():
            setattr(self, attr_name, attr_val)
        self.tuning_basis = tuning_basis

        posterior = torch.exp(log_posterior_all)
        em_res = {
            "log_posterior_all_saved": log_posterior_all_saved,
            "log_posterior_init": log_posterior_init,
            "params_saved": params_saved,
            "tuning_saved": tuning_saved,
            "iter_saved": iter_saved,
            "params": params,
            "tuning": tuning,
            "log_posterior_final": log_posterior_all,
            "log_marginal": log_marginal_final,
            "log_marginal_l": log_marginal_l,
            "log_marginal_saved": log_marginal_saved,
            "posterior": posterior,
            "m_step_res_l": m_step_res_l,
        }
        if profile:
            em_res["profile"] = phase_times
        if self.has_dynamics:
            em_res["posterior_latent_marg"] = posterior.sum(dim=1)
            em_res["posterior_dynamics_marg"] = posterior.sum(dim=2)
        return em_res
