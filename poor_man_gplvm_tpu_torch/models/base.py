"""Shared model machinery (PyTorch).

Counterpart of the parts of ``poor_man_gplvm_tpu/models/base.py`` that
``decode_latent``, ``decode_latent_epochs`` and ``fit_em`` need:
construction, parameter initialisation, pickling, the memoised transition
build, the smoother call, the shared decode routine (with ``t_l`` /
TsdFrame results), naive-Bayes decoding, the batched decode of short
epochs, and the EM schedule (host loop, fused middle iterations, lean
output, checkpoint/resume).  The classes hold a handful of scalars
plus ``params`` (n_basis, N), ``tuning_basis`` (L, n_basis) and ``tuning``
(L, N), all on the model's ``device``.

The two emission families are mixins that the concrete classes put before
their dynamics family (``models/latent1d.py``, ``models/jump1d.py``):
``_PoissonFamily`` (softplus link, Adam M-step on the grouped Poisson
objective) and ``_GaussianFamily`` (linear link, ``noise_std``, the
analytic ridge M-step).
"""

from __future__ import annotations

import numbers
import time
import warnings
from abc import ABC, abstractmethod

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import emissions, hmm, mstep
from poor_man_gplvm_tpu_torch.ops.basis import generate_basis
from poor_man_gplvm_tpu_torch.ops.hmm import JOINT_ACC_INIT
from poor_man_gplvm_tpu_torch.utils import compat
from poor_man_gplvm_tpu_torch.utils.checkpoint import EMCheckpointer

#: the fused middle EM iterations warm-start the parallel scans' fixed
#: points only from this much per-pass matvec work, T * n_dyn * L^2, on
#: (an explicit engine='cuda_parallel' warm-starts at every size), as in
#: the JAX package.  On the H100 at 2e9 (T = 1e5, L = 100, n_dyn = 2) warm
#: start halves a middle E-step, but the fit's time did not resolve the
#: gain from the host's spread (PERF.md), so the gate stays here.
WARM_START_MIN_WORK = 5e10


def resolve_device(device):
    """``torch.device(device)``; a CUDA device needs a card, and without
    one this raises rather than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU"
        )
    return device


def _check_t_l(t_l, n_time):
    """Raise unless the bin times ``t_l`` have one entry per time bin (the
    JAX package builds a TsdFrame whose times and rows disagree, and fails
    later, at the first use of that frame)."""
    if t_l is not None and len(t_l) != n_time:
        raise ValueError(
            f"t_l has {len(t_l)} bin times, but y has {n_time} time bins")


def _seeded(generator, seed):
    """``generator``, or a CPU ``torch.Generator`` seeded with ``seed``."""
    return torch.Generator().manual_seed(seed) if generator is None \
        else generator


def _log_posterior_init(post, device):
    """(log_post, post) on ``device`` of a normalised (T, L) CPU posterior,
    zeros floored at ``JOINT_ACC_INIT``."""
    post = post.to(device)
    log_post = torch.log(post)
    log_post = torch.where(torch.isneginf(log_post),
                           torch.full_like(log_post, JOINT_ACC_INIT), log_post)
    return log_post, post


def _epoch_intervals(intervals, t_l, n_time):
    """(E, 2) int64 ``[start, end)`` bin indices of the epochs: integer
    intervals as given, time-valued ones (a float array, or a
    pynapple-style IntervalSet, duck-typed by ``.values``/``.loc``)
    converted with the bin times ``t_l``.  Raises on a wrong shape, an
    empty interval, or a bound outside [0, n_time]."""
    if hasattr(intervals, "values") and hasattr(intervals, "loc"):
        intervals = intervals.values
    intervals = np.asarray(intervals)
    if intervals.ndim != 2 or intervals.shape[1] != 2:
        raise ValueError(f"intervals must be (E, 2); got {intervals.shape}")
    if not np.issubdtype(intervals.dtype, np.integer):
        if t_l is None:
            raise ValueError(
                "float (time-valued) intervals need t_l (or a TsdFrame y) "
                "to convert to bin indices")
        t_l = np.asarray(t_l)
        starts = np.searchsorted(t_l, intervals[:, 0], side="left")
        ends = np.searchsorted(t_l, intervals[:, 1], side="right")
        intervals = np.stack([starts, ends], axis=1)
    intervals = intervals.astype(np.int64)
    if np.any(intervals[:, 1] - intervals[:, 0] <= 0):
        raise ValueError("every interval must contain >= 1 bin")
    if np.any(intervals[:, 0] < 0) or np.any(intervals[:, 1] > n_time):
        raise ValueError(
            f"interval bounds must lie in [0, {n_time}] (the bins of y); got "
            f"{int(intervals[:, 0].min())} to {int(intervals[:, 1].max())}")
    return intervals


def _check_numeric_hyperparam(hyperparam):
    """Raise on a hyperparameter value that is not a number or a numeric
    array (it could only be dropped silently)."""
    for key, v in hyperparam.items():
        if isinstance(v, np.ndarray):
            ok = np.issubdtype(v.dtype, np.number)
        else:
            ok = isinstance(v, (numbers.Number, np.number, torch.Tensor))
        if not ok:
            raise TypeError(
                f"hyperparam[{key!r}] must be a number or a numeric array, "
                f"got {type(v).__name__}")


def _first_failed_certificate(diag_mid):
    """(iteration, residuals) of the first fused iteration whose post-hoc
    emit residual breaks the 1e-3 certificate, or None.  Written as
    ~(x <= tol), so that NaN residuals (a diverged solve) FAIL it."""
    if "scan_emit_delta" not in diag_mid:
        return None
    emit_delta = np.asarray(diag_mid["scan_emit_delta"])
    bad_mask = ~(emit_delta <= 1e-3)
    if np.any(bad_mask):
        bad = int(np.argmax(bad_mask.any(axis=1)))
        return bad, emit_delta[bad]
    return None


def resolve_engine(inference_engine, device):
    """'auto' resolves by the model's device: 'cuda' on a CUDA device
    (upgraded to 'cuda_parallel' for long sequences, see
    ``hmm.engine_resolves_parallel``), 'prob' on the CPU.  Engines the port
    does not run raise."""
    if inference_engine in (None, "auto"):
        inference_engine = "cuda" if device.type == "cuda" else "prob"
    hmm.check_engine(inference_engine)
    return inference_engine


class _FusedSegment:
    """A running fused segment of ``fit_em``: the state it started from
    (params, Adam state, log posterior, iterations done), its E-step
    settings, the warm-start carries it threads from iteration to
    iteration, and what it reads only at its end (log-marginals, and with
    warm start the fixed-point passes, emit residuals and drifts)."""

    def __init__(self, start, smooth_kw, ws, strict):
        self.start, self.smooth_kw, self.ws = start, smooth_kw, ws
        self.strict = strict
        self.lml, self.passes, self.emit_delta, self.drift = [], [], [], []

    def e_step(self, model, y_, tuning, smooth_args):
        """(log latent marginal, log-marginal) of one fused E-step."""
        if self.ws is None:
            out = model._smooth(y_, tuning, *smooth_args, **self.smooth_kw)
        else:
            out = model._smooth(
                y_, tuning, *smooth_args, scan_carry_in=self.ws,
                want_scan_carry=True, scan_fast=not self.strict,
                **self.smooth_kw)
            f_new, b_new, pred, (fp, bp, ef, eb) = out[6]
            self.ws = (f_new, b_new, pred, True)
            self.passes.append((fp, bp))
            self.emit_delta.append(torch.stack([ef, eb]))
            self.drift.append(pred[:2])
        self.lml.append(out[1])
        return out[0][0], out[1]

    def diag(self):
        """``scan_passes``, ``scan_emit_delta`` and ``scan_drift`` ((n, 2)
        numpy arrays) when the segment was warm-started, else {}."""
        if not self.passes:
            return {}
        return {"scan_passes": np.asarray(self.passes, dtype=np.int64),
                "scan_emit_delta": torch.stack(self.emit_delta).cpu().numpy(),
                "scan_drift": torch.stack(self.drift).cpu().numpy()}


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
        self.device = resolve_device(device)
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

    # pickle support: the Adam closures, the memoised transitions and the
    # band kept on them are dropped, and rebuilt at the next use
    def __getstate__(self):
        state = self.__dict__.copy()
        state["adam_runner"] = None
        state["opt_state_init_fun"] = None
        state.pop("_trans_cache", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    @abstractmethod
    def get_tuning(self, params, hyperparam, tuning_basis):
        """Link function mapping basis weights to tuning curves."""

    @abstractmethod
    def loglikelihood(self, y, ypred, hyperparam):
        """Elementwise log-likelihood of observations ``y`` at the
        predicted means ``ypred``."""

    def _emission_hyper(self, hyperparam):
        """A copy of ``hyperparam`` with the emission hyperparameters the
        family reads filled in from the model (none for Poisson)."""
        return dict(hyperparam or {})

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
                likelihood_scale, n_time_per_chunk, mesh=None,
                **smooth_kwargs):
        """The E-step smoother: ``hmm.smooth_combined_chunked`` on the
        model's engine, or with a ``mesh`` ``parallel.spmd.sharded_smooth``
        (time and neurons sharded; the engine and memory knobs do not
        apply there, and ``marginal_smooth`` is emulated from the full
        posterior, as in the JAX package), its results on the model's
        device."""
        if mesh is not None:
            from poor_man_gplvm_tpu_torch.parallel import spmd

            out = tuple(None if x is None else x.to(self.device)
                        for x in spmd.sharded_smooth(
                            mesh, y, tuning, hyperparam, trans, ma_neuron,
                            ma_latent, likelihood_scale=likelihood_scale,
                            observation_model=self.observation_model))
            if smooth_kwargs.get("marginal_smooth"):
                return (hmm._marginalize_log(out[0]),) + out[1:]
            return out
        return hmm.smooth_combined_chunked(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk,
            observation_model=self.observation_model,
            engine=self.inference_engine,
            **smooth_kwargs,
        )

    def _decode_dispatch(self, y, tuning, hyperparam, trans, ma_neuron,
                         ma_latent, likelihood_scale, n_time_per_chunk, t_l,
                         mesh, tsd_wrap_keys, build_res):
        """Shared decode driver: smoother, then the family's result dict
        (``build_res``).  With bin times ``t_l`` the keys
        ``tsd_wrap_keys`` are wrapped as TsdFrames (numpy, on the host), as
        in the JAX package.  With a ``mesh`` the smoother runs sharded over
        it (``parallel.spmd.sharded_smooth``).  The ``float()`` host sync of
        the log-marginal comes LAST, after all device work is enqueued."""
        y = self._as_device(y)
        _check_t_l(t_l, y.shape[0])
        (
            log_posterior_all, log_marginal_final, _log_causal,
            log_one_step_pred, log_acc, log_likelihood_all,
        ) = self._smooth(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, n_time_per_chunk, mesh=mesh,
        )
        decoding_res = build_res(
            log_posterior_all, log_one_step_pred, log_acc, log_likelihood_all
        )
        if t_l is not None:
            for k in tsd_wrap_keys:
                decoding_res[k] = compat.tsdframe(d=decoding_res[k], t=t_l)
        decoding_res["log_marginal_final"] = float(log_marginal_final)
        return decoding_res

    def predict_expected_rate(self, post_latent_marg, tuning=None):
        """Expected firing rate (T, N) under the latent posterior (T, L); a
        TsdFrame posterior gives a TsdFrame rate on its times."""
        if tuning is None:
            tuning = self.tuning
        if compat.is_tsdframe(post_latent_marg):
            rate = torch.einsum("pn,tp->tn", tuning,
                                self._as_device(post_latent_marg.d))
            return compat.tsdframe(d=rate, t=post_latent_marg.t)
        return torch.einsum("pn,tp->tn", tuning,
                            self._as_device(post_latent_marg))

    def decode_latent_naive_bayes(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=10000, dt_l=1.0,
        observation_model=None, t_l=None,
    ):
        """Per-time posterior without temporal smoothing.  With bin times
        ``t_l`` (or a TsdFrame ``y``, whose times win)
        ``posterior_latent`` is a TsdFrame."""
        if compat.is_tsdframe(y):
            t_l = y.t
            y = y.d
        hyperparam = self._emission_hyper(hyperparam)
        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default
        if tuning is None:
            tuning = self.tuning
        if observation_model is None:
            observation_model = self.observation_model
        del likelihood_scale  # unused by the reference NB path too

        y = self._as_device(y)
        _check_t_l(t_l, y.shape[0])
        log_post, log_marginal_l, log_marginal_total, ll_per_pos_l = (
            emissions.get_naive_bayes_ma_chunk(
                y, tuning, hyperparam, ma_neuron, ma_latent,
                dt_l=dt_l, n_time_per_chunk=n_time_per_chunk,
                observation_model=observation_model,
            )
        )
        posterior_latent = torch.exp(log_post)
        if t_l is not None:
            posterior_latent = compat.tsdframe(d=posterior_latent, t=t_l)
        return {
            "log_posterior_latent": log_post,
            "log_marginal_l": log_marginal_l,
            "log_marginal_total": float(log_marginal_total),
            "posterior_latent": posterior_latent,
            "ll_per_pos_l": ll_per_pos_l,
        }

    # ------------------------------------------------------------------
    # batched short-epoch decoding (reactivation/ripple workloads)
    # ------------------------------------------------------------------
    def decode_latent_epochs(
        self, y, intervals, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, t_l=None, batch_size=None,
    ):
        """Smoother-decode many short epochs as one batch.

        The epochs are cut from ``y``, right-padded to the longest and
        stacked to (E, Tmax, N) on the device, and each is smoothed on its
        own (``hmm.smooth_epochs``).  On a card the model's engine,
        ``'cuda'`` or ``'cuda_parallel'`` alike, runs the sequential
        kernels K1 and K2 once per batch, one thread block per epoch, each
        block over exactly its epoch's bins; ``'prob'`` loops over the
        epochs.  Epochs are short by construction and are never handed to
        the parallel-in-time engine, whatever their length: decode a long
        sequence with ``decode_latent``.  A batch that runs out of the
        card's memory raises ``MemoryError``; pass ``batch_size``.

        Parameters
        ----------
        y : (T, N) array, tensor or TsdFrame-like (``.d``, ``.t``): the
            full binned spike matrix.
        intervals : (E, 2) int array of ``[start, end)`` bin indices, or
            time-valued floats / a pynapple-style IntervalSet (needs
            ``t_l`` or a TsdFrame-like ``y`` to convert times to bins).
            Bounds outside [0, T] raise.
        hyperparam : per-call overrides; a value that is not a number or a
            numeric array raises.
        batch_size : decode the epochs in batches of this size (one launch
            of each kernel per batch) to bound device memory; default: all
            epochs in one batch.

        Returns a dict of numpy arrays: ``posterior_latent_marg`` (E,
        Tmax, L), NaN past each epoch's end, ``posterior_mean`` (E, L) mean
        over an epoch's bins, ``log_marginal_per_epoch`` (E,), ``lengths``
        (E,) and ``valid`` (E, Tmax)."""
        hyperparam = self._emission_hyper(hyperparam)
        _check_numeric_hyperparam(hyperparam)
        if not torch.is_tensor(y) and hasattr(y, "d") and hasattr(y, "t"):
            t_l = y.t if t_l is None else t_l
            y = y.d
        y = self._as_device(y)
        intervals = _epoch_intervals(intervals, t_l, y.shape[0])
        lengths = intervals[:, 1] - intervals[:, 0]
        E, Tmax = len(intervals), int(lengths.max())
        L = self.n_latent_bin

        ma_neuron = self.ma_neuron_default if ma_neuron is None \
            else self._as_device(ma_neuron)
        if ma_neuron.ndim != 1:
            raise ValueError(
                "decode_latent_epochs supports 1-D ma_neuron only (the 2-D "
                "slot carries the epoch padding mask)")
        ma_latent = self.ma_latent_default if ma_latent is None \
            else self._as_device(ma_latent)
        trans, _ = self._make_transition(hyperparam)
        bs = E if batch_size is None else int(batch_size)
        if bs < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        starts = torch.as_tensor(intervals[:, 0], device=self.device)
        lens = torch.as_tensor(lengths, device=self.device)
        steps = torch.arange(Tmax, device=self.device)
        post = torch.empty((E, Tmax, L), dtype=torch.float32,
                           device=self.device)
        lml = torch.empty((E,), dtype=torch.float32, device=self.device)
        for s0 in range(0, E, bs):
            sl = slice(s0, s0 + bs)
            valid_b = steps[None, :] < lens[sl, None]
            rows = (starts[sl, None] + steps[None, :]).clamp(
                max=y.shape[0] - 1)
            y_b = y[rows] * valid_b[:, :, None]  # stack + zero padding
            try:
                post[sl], lml[sl] = hmm.smooth_epochs(
                    y_b, lens[sl], self.tuning, hyperparam, trans, ma_neuron,
                    ma_latent, likelihood_scale=likelihood_scale,
                    observation_model=self.observation_model,
                    engine=self.inference_engine)
            except torch.cuda.OutOfMemoryError as exc:
                raise MemoryError(
                    f"decode_latent_epochs: a batch of {min(bs, E)} epochs of "
                    f"up to {Tmax} bins does not fit the card; pass a smaller "
                    "batch_size (or decode long sequences with "
                    "decode_latent)") from exc
            del y_b
        valid = steps[None, :] < lens[:, None]
        post = torch.where(valid[:, :, None], post, 0.0)
        mean = post.sum(dim=1).double() / lens[:, None].double()
        post = torch.where(valid[:, :, None], post, float("nan"))
        return {
            "posterior_latent_marg": post.cpu().numpy(),
            "posterior_mean": mean.cpu().numpy(),
            "log_marginal_per_epoch": lml.cpu().numpy(),
            "lengths": lengths,
            "valid": valid.cpu().numpy(),
        }

    # ------------------------------------------------------------------
    # EM template
    # ------------------------------------------------------------------
    def _fused_segment(self, y_, trans, ma_neuron, output_mode, memory_mode,
                       start, strict=False):
        """Open the fused segment of a fit (its iterations [1, n_iter-1))
        with the E-step of the JAX package's fused program: marginal
        smoothing without the pairwise joint, memory mode 'checkpoint' in
        lean output ('auto' otherwise), the Poisson lgamma term formed once
        where the parallel engine runs, and warm-started fixed points where
        ``hmm.parallel_scan_carry_spec`` gives a spec and the per-pass
        matvec work T * n_dyn * L^2 reaches ``WARM_START_MIN_WORK`` (always
        for an explicit 'cuda_parallel').  ``start`` is the state to redo
        it from; ``strict`` exits the fixed points strictly (the redo)."""
        mm = memory_mode or (
            "checkpoint" if output_mode == "lean" else "auto"
        )
        engine = self.inference_engine
        T = y_.shape[0]
        ws_spec = hmm.parallel_scan_carry_spec(T, trans, engine,
                                               memory_mode=mm)
        if ws_spec is not None and engine != "cuda_parallel":
            work = float(T) * getattr(trans, "n_dyn", 1) * trans.n_latent ** 2
            if work < WARM_START_MIN_WORK:
                ws_spec = None
        ws = None
        if ws_spec is not None:
            ws = (torch.zeros(ws_spec, device=self.device),
                  torch.zeros(ws_spec, device=self.device),
                  torch.full((4,), float("inf"), device=self.device), False)
        lg = None
        if self.observation_model == "poisson" and \
                hmm.engine_resolves_parallel(T, trans, engine, self.device):
            lg = emissions.poisson_lgamma_term(y_, ma_neuron)
        return _FusedSegment(start, dict(memory_mode=mm, marginal_smooth=True,
                                         lgamma_term=lg, want_acc=False),
                             ws, strict)

    def _e_step(self, y_, tuning, hyperparam, trans, ma_neuron, ma_latent,
                likelihood_scale, n_time_per_chunk, output_mode, memory_mode,
                diag, mesh=None):
        """One host-loop E-step: ``(log_posterior_all, log_posterior_curr,
        log_marginal_final, lean dynamics marginal or None)``.  Lean: the
        marginal smoother in 'checkpoint' memory mode unless told
        otherwise, and log_posterior_all is the (T, L) latent marginal.
        ``mesh``: the smoother sharded over it."""
        if output_mode == "lean":
            smooth_out, log_marginal_final = self._smooth(
                y_, tuning, hyperparam, trans, ma_neuron, ma_latent,
                likelihood_scale, n_time_per_chunk, mesh=mesh, want_acc=False,
                diag_out=diag, memory_mode=memory_mode or "checkpoint",
                marginal_smooth=True,
            )[:2]
            lat, dyn = smooth_out
            return lat, lat, log_marginal_final, dyn
        log_posterior_all, log_marginal_final = self._smooth(
            y_, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, n_time_per_chunk, mesh=mesh, want_acc=False,
            diag_out=diag,
            **({"memory_mode": memory_mode} if memory_mode else {}),
        )[:2]
        curr = torch.logsumexp(log_posterior_all, dim=1) \
            if self.has_dynamics else log_posterior_all
        return log_posterior_all, curr, log_marginal_final, None

    def fit_em(
        self, y, hyperparam=None, generator=None, n_iter=20,
        log_posterior_init=None, opt_state_curr=None, ma_neuron=None,
        ma_latent=None, n_time_per_chunk=None, dt=1.0, likelihood_scale=1.0,
        save_every=None, posterior_init_kwargs=None, verboase=True,
        profile=False, checkpoint_dir=None, checkpoint_every=None,
        resume=False, output_mode="full", memory_mode=None, nan_guard=None,
        mesh=None, **kwargs,
    ):
        """EM: alternate the M-step (Adam on the grouped Poisson objective,
        or the Gaussian ridge solve, which has no optimizer state: its
        ``m_step_res_l`` keeps the keys ``params`` and ``opt_state`` with
        empty lists, as in the JAX package) and the E-step (the
        forward-backward smoother), ``n_iter`` times.

        The JAX package's schedule with its ``em_res`` keys.  ``generator``
        (a CPU ``torch.Generator``) takes the place of the JAX ``key`` for
        the random initial posterior; pass ``log_posterior_init`` to start
        from a given one (a float64 numpy array is clamped to
        ``JOINT_ACC_INIT`` first).  ``dt`` is accepted and unused, as in the
        reference.

        Schedule: with ``fused`` (default ``not verboase``), no profile,
        ``save_every >= n_iter`` and ``n_iter >= 3``, iterations
        [1, n_iter-1) run as the fused segment (``_fused_segment``): the
        same M-step and tuning link, then marginal smoothing with the
        parallel scans' boundary carries threaded from iteration to
        iteration (warm start, fast predicted-residual exits), and nothing
        read until the segment's end.  The JAX package runs the segment as
        one ``lax.scan`` program; the port keeps the host loop.  A segment
        whose warm-started solves fail their post-hoc certificate is
        replayed with strict fixed-point exits (with a warning); a second
        failure raises ``FloatingPointError``.

        ``output_mode='lean'``: every E-step emits only the latent and
        dynamics marginals (memory mode 'checkpoint' unless given);
        ``log_posterior_final`` and ``log_posterior_init`` are None,
        ``posterior`` is the (T, L) latent marginal, and no posterior
        snapshots are kept.  ``nan_guard`` (default: on in lean mode)
        raises ``FloatingPointError`` on a non-finite log marginal, fused
        iterations included.  ``profile=True`` syncs the device after each
        phase and adds ``em_res['profile']`` with the per-iteration
        ``m_step`` / ``e_step`` / ``collect`` seconds and the parallel
        engine's fixed-point pass counts (``scan_passes``).

        ``checkpoint_dir``: save ``{step, params, opt_state,
        log_posterior, rng}`` every ``checkpoint_every`` iterations
        (default 1) through ``utils.checkpoint.EMCheckpointer``;
        ``log_posterior`` is the (T, L) posterior the next M-step reads
        (the latent marginal for a jump model), ``rng`` the state of
        ``generator``.  ``resume=True`` restores params, optimizer state
        and posterior from the latest checkpoint and continues at its step
        + 1 (``log_marginal_l`` and ``m_step_res_l`` then hold the resumed
        iterations only; no initial posterior is drawn, and
        ``em_res['log_posterior_init']`` is the restored one); a checkpoint
        at or past ``n_iter - 1`` raises ``ValueError``.  As in the JAX package the rng state is saved but
        not restored (the restored posterior makes it unneeded), and a
        checkpointed fit runs the host loop, not the fused schedule.

        A TsdFrame ``y`` (full output) gives ``posterior_latent_marg`` and
        ``posterior_dynamics_marg`` (jump models) or ``posterior``
        (latent-only models) as TsdFrames on its times, as in the JAX
        package.  ``mesh`` (a ``parallel.spmd.Mesh``): every E-step runs
        sharded over it (``spmd.sharded_smooth``), on the host loop (no
        fused schedule), as in the JAX package."""
        del dt  # unused, as in the reference
        if output_mode not in ("full", "lean"):
            raise ValueError(
                f"output_mode must be 'full' or 'lean', got {output_mode!r}")
        if mesh is not None:
            from poor_man_gplvm_tpu_torch.parallel import spmd

            spmd.check_mesh(mesh)
        fused = kwargs.pop("fused", None)
        verboase = kwargs.pop("verbose", verboase)
        if kwargs:
            raise TypeError(f"unexpected keyword arguments {sorted(kwargs)}")
        if n_iter < 1:
            raise ValueError(
                f"n_iter={n_iter} requests no EM iterations; n_iter must be "
                ">= 1.")
        lean = output_mode == "lean"
        hyperparam = {} if hyperparam is None else hyperparam
        generator = torch.Generator().manual_seed(0) if generator is None \
            else generator
        posterior_init_kwargs = (
            {"random_scale": 0.1} if posterior_init_kwargs is None
            else posterior_init_kwargs
        )
        y_tsd = y if compat.is_tsdframe(y) else None
        y_ = self._as_device(y.d if y_tsd is not None else y)
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

        params = self.params
        start_iter = 0
        checkpointer = None
        if checkpoint_dir is not None:
            checkpointer = EMCheckpointer(checkpoint_dir)
            checkpoint_every = checkpoint_every or 1
            state = checkpointer.restore() if resume else None
            if state is not None:
                start_iter = int(state["step"]) + 1
                if start_iter >= n_iter:
                    raise ValueError(
                        f"resume: checkpoint step {start_iter - 1} >= "
                        f"n_iter - 1 = {n_iter - 1}; nothing to do. Pass a "
                        "larger n_iter to continue training, or load the "
                        "checkpoint state directly.")
                params = self._as_device(state["params"])
                if state.get("opt_state") is not None:
                    opt_state_curr = mstep.AdamState(**{
                        k: torch.as_tensor(v, device=self.device)
                        for k, v in state["opt_state"].items()})
                # the restored posterior is where the fit starts: no
                # initial posterior is drawn
                log_posterior_init = state["log_posterior"]

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
        log_posterior_all_saved, params_saved = [], []
        tuning_saved, iter_saved, log_marginal_saved = [], [], []
        phase_times = {"m_step": [], "e_step": [], "collect": [],
                       "scan_passes": []}
        check_nan = nan_guard if nan_guard is not None else lean
        smooth_args = (hyperparam, trans, ma_neuron, ma_latent,
                       likelihood_scale, n_time_per_chunk)

        # the fused schedule: iterations [1, n_iter-1) as one segment that
        # reads nothing per iteration, when nothing per iteration is
        # observed.  The segment runs the same loop body with its own
        # E-step; a failed warm-start certificate at its end replays it
        # from its start with strict fixed-point exits.
        can_fuse = (checkpointer is None and not profile and mesh is None
                    and save_every >= n_iter and n_iter >= 3)
        use_fused = (fused if fused is not None else not verboase) \
            and can_fuse
        seg = None

        def sync():
            if profile and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        i = start_iter
        while i < n_iter:
            if use_fused and i == 1 and seg is None:
                seg = self._fused_segment(
                    y_, trans, ma_neuron, output_mode, memory_mode,
                    (params, opt_state_curr, log_posterior_curr, 1))
            t0 = time.perf_counter()
            m_res = self.m_step(
                params, y_, log_posterior_curr, tuning_basis, hyperparam,
                opt_state_curr=opt_state_curr, host_trim=False,
            )
            sync()
            t1 = time.perf_counter()
            params = m_res["params"]
            opt_state_curr = m_res.get("opt_state", None)
            if lean:
                # consumed by iteration 0's M-step; lean em_res drops it
                log_posterior_init = None
            tuning = self.get_tuning(params, hyperparam, tuning_basis)
            diag = []
            # release the previous posteriors before the E-step allocates
            # the new ones (matters at T ~ 1e6 x L ~ 500)
            if i > start_iter and i % save_every != 0:
                log_posterior_all = None
            log_posterior_curr = None
            if seg is None:
                (log_posterior_all, log_posterior_curr, log_marginal_final,
                 lean_dyn_marg) = self._e_step(
                    y_, tuning, *smooth_args, output_mode, memory_mode, diag,
                    mesh)
            else:
                log_posterior_curr, log_marginal_final = seg.e_step(
                    self, y_, tuning, smooth_args)
            sync()
            t2 = time.perf_counter()

            if not m_step_res_l:
                m_step_res_l = {k: [] for k in m_res}
            for k in m_res:
                if k not in ("params", "opt_state"):
                    m_step_res_l[k].append(m_res[k])
            log_marginal_l.append(log_marginal_final)
            if i % save_every == 0:
                if not lean:  # lean keeps no posterior snapshot
                    log_posterior_all_saved.append(log_posterior_all)
                params_saved.append(params)
                tuning_saved.append(tuning)
                log_marginal_saved.append(log_marginal_final)
                iter_saved.append(i)
            if checkpointer is not None and i % checkpoint_every == 0:
                checkpointer.save(i, {
                    "step": i, "params": params, "opt_state": opt_state_curr,
                    "log_posterior": log_posterior_curr, "rng": generator,
                })
            t3 = time.perf_counter()
            phase_times["m_step"].append(t1 - t0)
            phase_times["e_step"].append(t2 - t1)
            phase_times["collect"].append(t3 - t2)
            phase_times["scan_passes"].extend(d[:2] for d in diag)

            if seg is None:
                if verboase:
                    print(f"EM iteration {i + 1}/{n_iter}", flush=True)
                # a non-finite log marginal means the fit diverged; the
                # check costs one host read (default: on in lean mode)
                if check_nan and not np.isfinite(float(log_marginal_final)):
                    raise FloatingPointError(
                        f"EM diverged: log marginal is "
                        f"{float(log_marginal_final)} at iteration {i} "
                        f"(T={y_.shape[0]}, n_latent_bin={self.n_latent_bin})"
                        ". Check hyperparam values and neuron/latent masks."
                    )
            elif i == n_iter - 2:  # the segment's end: its deferred reads
                seg_diag = seg.diag()
                bad_cert = _first_failed_certificate(seg_diag)
                if bad_cert is not None and seg.strict:
                    raise FloatingPointError(
                        "parallel-scan certificate failed even with strict "
                        f"fixed-point exits at fused iteration {bad_cert[0]}"
                        f": emit residual {bad_cert[1]} > 1e-3. The solve "
                        "did not converge; rerun with fused=False or "
                        "inference_engine='cuda'."
                    )
                if bad_cert is not None:
                    warnings.warn(
                        "parallel-scan warm-start certificate failed at "
                        f"fused iteration {bad_cert[0]} (emit residual "
                        f"{bad_cert[1]}); re-running the fused segment with "
                        "strict fixed-point exits."
                    )
                    # nothing was donated: replay from the segment's start
                    params, opt_state_curr, log_posterior_curr, n_done = \
                        seg.start
                    del log_marginal_l[n_done:]
                    for v in m_step_res_l.values():
                        del v[n_done:]
                    seg = self._fused_segment(
                        y_, trans, ma_neuron, output_mode, memory_mode,
                        seg.start, strict=True)
                    i = 1
                    continue
                for key, attr in (("scan_passes", "_scan_passes_mid"),
                                  ("scan_drift", "_scan_drift_mid"),
                                  ("scan_emit_delta", "_scan_emit_delta_mid")):
                    if key in seg_diag:
                        setattr(self, attr, seg_diag[key])
                # divergence over the fused iterations, in one transfer
                if check_nan:
                    lml_host = torch.stack(seg.lml).cpu().numpy()
                    if not np.all(np.isfinite(lml_host)):
                        bad = int(np.argmax(~np.isfinite(lml_host)))
                        raise FloatingPointError(
                            "EM diverged: log marginal is "
                            f"{lml_host[bad]} at iteration {1 + bad} "
                            f"(fused segment; T={y_.shape[0]}, "
                            f"n_latent_bin={self.n_latent_bin}). Check "
                            "hyperparam values and masks."
                        )
                seg = None
            i += 1

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
            "log_posterior_final": None if lean else log_posterior_all,
            "log_marginal": log_marginal_final,
            "log_marginal_l": log_marginal_l,
            "log_marginal_saved": log_marginal_saved,
            "posterior": posterior,
            "m_step_res_l": m_step_res_l,
        }
        if profile:
            em_res["profile"] = phase_times
        if self.has_dynamics and lean:
            em_res["posterior_latent_marg"] = posterior
            em_res["posterior_dynamics_marg"] = torch.exp(lean_dyn_marg)
        elif self.has_dynamics:
            em_res["posterior_latent_marg"] = posterior.sum(dim=1)
            em_res["posterior_dynamics_marg"] = posterior.sum(dim=2)
            if y_tsd is not None:
                for k in ("posterior_latent_marg", "posterior_dynamics_marg"):
                    em_res[k] = compat.tsdframe(d=em_res[k], t=y_tsd.t)
        elif y_tsd is not None:
            em_res["posterior"] = compat.tsdframe(d=posterior, t=y_tsd.t)
        return em_res


# ----------------------------------------------------------------------
# emission families (mixins placed before a dynamics family)
# ----------------------------------------------------------------------
class _PoissonFamily:
    """Poisson counts: softplus link; the M-step runs Adam on the grouped
    Poisson objective (with the roughness penalty on a B-spline basis),
    its optimizer state threaded across EM iterations."""

    observation_model = "poisson"

    def loglikelihood(self, y, ypred, hyperparam):
        """``scipy.stats.poisson.logpmf(y, ypred + 1e-40)`` elementwise."""
        mu = ypred + 1e-40
        logp = torch.xlogy(y, mu) - torch.lgamma(y + 1.0) - mu
        return torch.where((y < 0) | (y != torch.round(y)),
                           torch.full_like(logp, -float("inf")), logp)

    def get_tuning(self, params, hyperparam, tuning_basis):
        return mstep.get_tuning_softplus(params, tuning_basis)

    def sample_y(self, latent_l, hyperparam=None, tuning=None, dt=1.0,
                 generator=None):
        """Poisson counts (T, N) at the rates of the latent path."""
        g = _seeded(generator, 10)
        if tuning is None:
            tuning = self.tuning
        rate = tuning[torch.as_tensor(latent_l, device=tuning.device)] * dt
        return torch.poisson(rate.cpu(), generator=g).to(self.device)

    def m_step(self, param_curr, y, log_posterior_curr, tuning_basis,
               hyperparam, opt_state_curr=None, host_trim=True):
        """Adam M-step on the grouped statistics of ``log_posterior_curr``
        (T, L), continuing from ``opt_state_curr`` (an ``AdamState``).
        ``host_trim=False`` leaves the history trimming to the caller."""
        y_weighted, t_weighted = mstep.get_statistics(log_posterior_curr, y)
        adam_res = self.adam_runner(
            param_curr, opt_state_curr, hyperparam, tuning_basis, y_weighted,
            t_weighted,
        )
        return mstep.package_adam_result(adam_res, host_trim=host_trim)

    def fit_em(self, y, hyperparam=None, generator=None, n_iter=20,
               log_posterior_init=None, ma_neuron=None, ma_latent=None,
               n_time_per_chunk=None, dt=1.0, likelihood_scale=1.0,
               save_every=None, m_step_step_size=0.01, m_step_maxiter=1000,
               m_step_tol=1e-6, **kwargs):
        """EM fit (see ``_GPLVMCommon.fit_em``) with Adam M-steps of
        ``m_step_step_size``, ``m_step_maxiter`` and ``m_step_tol``; the
        optimizer state starts fresh and is threaded across iterations."""
        hyperparam_ = dict(hyperparam or {})
        hyperparam_["param_prior_std"] = hyperparam_.get(
            "param_prior_std", self.param_prior_std)
        hyperparam_["smoothness_penalty"] = hyperparam_.get(
            "smoothness_penalty", self.smoothness_penalty)
        self.adam_runner, self.opt_state_init_fun = mstep.make_adam_runner(
            mstep.poisson_m_step_objective_smoothness
            if self.basis_type == "bspline"
            else mstep.poisson_m_step_objective,
            m_step_step_size, maxiter=m_step_maxiter, tol=m_step_tol,
        )
        return super().fit_em(
            y, hyperparam=hyperparam_, generator=generator, n_iter=n_iter,
            log_posterior_init=log_posterior_init, ma_neuron=ma_neuron,
            ma_latent=ma_latent, n_time_per_chunk=n_time_per_chunk, dt=dt,
            likelihood_scale=likelihood_scale, save_every=save_every,
            opt_state_curr=self.opt_state_init_fun(self.params), **kwargs,
        )


class _GaussianFamily:
    """Gaussian observations with standard deviation ``noise_std`` (a
    scalar): linear link; the M-step is the closed-form ridge solve (no
    optimizer state).  ``noise_std`` fills the emission hyperparameters of
    every decode and fit unless a call passes its own."""

    observation_model = "gaussian"

    def __init__(self, n_neuron, noise_std=0.5, **kwargs):
        super().__init__(n_neuron, **kwargs)
        self.noise_std = noise_std

    def _emission_hyper(self, hyperparam):
        hyperparam = dict(hyperparam or {})
        hyperparam["noise_std"] = hyperparam.get("noise_std", self.noise_std)
        return hyperparam

    def loglikelihood(self, y, ypred, hyperparam):
        """``scipy.stats.norm.logpdf(y, ypred, hyperparam['noise_std'])``
        elementwise."""
        return mstep._norm_logpdf(y - ypred, hyperparam["noise_std"])

    def get_tuning(self, params, hyperparam, tuning_basis):
        return mstep.get_tuning_linear(params, tuning_basis)

    def sample_y(self, latent_l, hyperparam=None, tuning=None, dt=1.0,
                 generator=None):
        """Normal observations (T, N) around the means of the latent path,
        with standard deviation ``noise_std * sqrt(dt)``."""
        g = _seeded(generator, 10)
        if tuning is None:
            tuning = self.tuning
        noise_std = (hyperparam or {}).get("noise_std", self.noise_std)
        rate = (tuning[torch.as_tensor(latent_l, device=tuning.device)]
                * dt).cpu()
        noise = torch.randn(rate.shape, generator=g) * (
            noise_std * float(np.sqrt(dt)))
        return (noise + rate).to(self.device)

    def m_step(self, param_curr, y, log_posterior_curr, tuning_basis,
               hyperparam, opt_state_curr=None, host_trim=True):
        """The ridge solve on the grouped statistics of
        ``log_posterior_curr``; returns ``{'params', 'opt_state': None}``."""
        del param_curr, opt_state_curr, host_trim
        y_weighted, t_weighted = mstep.get_statistics(log_posterior_curr, y)
        return {"params": mstep.gaussian_m_step_analytic(
                    hyperparam, tuning_basis, y_weighted, t_weighted),
                "opt_state": None}

    def fit_em(self, y, hyperparam=None, generator=None, n_iter=20,
               log_posterior_init=None, ma_neuron=None, ma_latent=None,
               n_time_per_chunk=None, dt=1.0, likelihood_scale=1.0,
               save_every=None, **kwargs):
        """EM fit (see ``_GPLVMCommon.fit_em``) with ridge M-steps."""
        hyperparam_ = self._emission_hyper(hyperparam)
        hyperparam_["param_prior_std"] = hyperparam_.get(
            "param_prior_std", self.param_prior_std)
        return super().fit_em(
            y, hyperparam=hyperparam_, generator=generator, n_iter=n_iter,
            log_posterior_init=log_posterior_init, ma_neuron=ma_neuron,
            ma_latent=ma_latent, n_time_per_chunk=n_time_per_chunk, dt=dt,
            likelihood_scale=likelihood_scale, save_every=save_every,
            **kwargs,
        )
