"""Forward-backward smoother over the (dynamics x latent) state space.

Counterpart of ``poor_man_gplvm_tpu/ops/hmm.py`` for the decode and fit
paths: scaled probability-space forward/backward recursions, the chunked
host driver ``smooth_combined_chunked`` in full memory mode, the
parallel-in-time driver, and the transition-posterior extraction.

Engines:
* ``'prob'``: a plain PyTorch loop over time (``_forward_scan_prob``,
  ``_backward_scan_prob``), one small tensor op after another;
* ``'cuda'``: the hand-written sequential kernels K1/K2
  (``ops/scan_kernels.py``), the counterpart of the JAX ``'pallas'``
  engine.  On a CUDA device it is upgraded to ``'cuda_parallel'`` from
  ``_PARALLEL_UPGRADE_MIN_T`` steps on, while the parallel engine's
  buffers fit the card (``engine_resolves_parallel``);
* ``'cuda_parallel'``: the parallel-in-time kernels K3/K4
  (``ops/parallel_scan.py``), the counterpart of ``'pallas_parallel'``;
* ``'log'``: a plain PyTorch loop in log space in the JAX package's
  order of operations (``_forward_scan_log``, ``_backward_scan_log``), the
  second oracle of the probability-space engines.  It runs only when asked
  for by name: ``'auto'`` never resolves to it and it is never upgraded.
On CPU tensors the kernels' wrappers run their plain versions.

``smooth_epochs`` smooths a batch of short sequences (the epochs of
``decode_latent_epochs``): on both CUDA engines through one launch of K1
and one of K2 for the whole batch, one thread block per epoch.
``smooth_batch_full`` smooths a batch of equal-length sequences under one
transition (the shuffles of ``validation.shuffle_and_decode``) with every
output of ``smooth_combined_chunked``, the same way.  ``TransitionStack``
holds G transitions of one shape, and ``_scan_batch`` runs a batch in which
each sequence has its own (the runs of a sweep, ``parallel/sweep.py``).
``forward_filter_lml``, ``filter_lmls`` and ``filter_lml_batch`` give only
log-marginals, through the norm-only K1 (the downsampled-LML metric of
model selection).

As in the JAX package the pairwise-joint accumulation is not carried
through the scan; in probability space it factorizes,

    acc[d,e,i,j] = Tdyn[d,e] * Tlat[e,i,j] * sum_t filt_t[d,i] * r_t[e,j]

with r_t = smooth_{t+1} / prior_{t+1}, so it is one matmul after the scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import band as bd
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
from poor_man_gplvm_tpu_torch.ops.emissions import (
    MASK_NEG,
    get_loglikelihood_ma_all,
    get_loglikelihood_ma_all_changing_dt,
)

# The f32-representable stand-in for the reference's -1e40 zero-probability
# sentinel (the JAX package's JOINT_ACC_INIT).
JOINT_ACC_INIT = -3.0e38

ENGINES = ("prob", "log", "cuda", "cuda_parallel")
MEMORY_MODES = ("auto", "full", "checkpoint", "filter", "filter_bf16")

__all__ = [
    "JOINT_ACC_INIT",
    "LatentTransition",
    "JointTransition",
    "prob_to_log",
    "auto_chunk_size",
    "smooth_combined_chunked",
    "epoch_loglikelihoods",
    "smooth_epochs",
    "sequence_loglikelihoods",
    "smooth_batch_full",
    "TransitionStack",
    "stack_transitions",
    "forward_filter_lml",
    "filter_lmls",
    "filter_lml_batch",
    "engine_resolves_parallel",
    "parallel_scan_carry_spec",
    "compute_transition_posterior_prob",
    "compute_transition_posterior_prob_latent",
]


def check_engine(engine):
    """Raise unless ``engine`` is one the port runs."""
    if engine not in ENGINES:
        raise ValueError(
            f"engine must be one of {ENGINES}, got {engine!r}"
        )


def prob_to_log(p, floor=JOINT_ACC_INIT):
    """Elementwise log with a finite floor for exact zeros."""
    pos = p > 0
    return torch.where(pos, torch.log(torch.where(pos, p, 1.0)),
                       torch.full_like(p, floor))


def _tiny(x):
    return torch.finfo(x.dtype).tiny


# ---------------------------------------------------------------------------
# Transition structures
# ---------------------------------------------------------------------------


def _wants_band(tlat):
    """Whether the sequential kernels read ``tlat`` through its band: only
    the CUDA kernels do (the plain versions on the CPU are dense)."""
    return tlat.device.type == "cuda"


def _cached_band(trans, tlat):
    """The ``Band`` of the transition stack ``tlat`` (n_dyn, L, L) for the
    sequential kernels (K1 reads its push half, K2 its pull half), made at
    the first chunk that needs it and kept on the (frozen) transition
    object, so that a decode over several host chunks reads W to the host
    once; None where no kernel reads a band."""
    if not _wants_band(tlat):
        return None
    if trans._band is None:
        tlat = tlat.contiguous()
        object.__setattr__(trans, "_band", bd.transition_band(
            tlat, tlat.transpose(-1, -2).contiguous(), trans.uniform_rows))
    return trans._band


@dataclasses.dataclass(frozen=True)
class LatentTransition:
    """Latent-only (L, L) transition; T[i, j] = p(j | i)."""

    T: torch.Tensor
    logT: torch.Tensor
    uniform_rows: tuple = None
    _band: object = dataclasses.field(default=None, repr=False,
                                      compare=False)

    def __post_init__(self):
        if self.uniform_rows is None:
            object.__setattr__(self, "uniform_rows",
                               sk._detect_uniform_rows(self.T[None]))

    @property
    def n_latent(self):
        return self.T.shape[-1]

    def uniform_log_init(self):
        L = self.n_latent
        return torch.log(torch.ones((L,), dtype=self.T.dtype,
                                    device=self.T.device) / L)

    def bcast_ll(self, x):
        return x

    def push(self, p):
        return p @ self.T

    def push_batch(self, p):
        return p @ self.T

    def pull(self, r):
        return self.T @ r

    def outer_acc(self, P, R):
        return (P.T @ R) * self.T

    def joint_shape(self):
        return (self.n_latent, self.n_latent)

    # log-space engine (the JAX package's order of operations) ----------
    def push_log(self, logp):
        return torch.logsumexp(logp[:, None] + self.logT, dim=0)

    def smooth_step_log(self, log_smooth_next, log_filt_curr, log_prior_next):
        inside = (self.logT + (log_smooth_next - log_prior_next)[None, :]
                  + log_filt_curr[:, None])
        return torch.logsumexp(inside, dim=1), inside

    # kernel engine ----------------------------------------------------
    def cuda_filter(self, ll, p_init, likelihood_scale):
        ones = torch.ones((1, 1), dtype=self.T.dtype, device=self.T.device)
        post, prior, ratios = sk.filter_chunk(
            ll, self.T[None], ones, p_init[None], likelihood_scale,
            uniform_rows=self.uniform_rows,
            band=_cached_band(self, self.T[None]),
        )
        return post[:, 0], prior[:, 0], ratios

    def cuda_smooth(self, filt_xs, prior_xs, smooth_init):
        ones = torch.ones((1, 1), dtype=self.T.dtype, device=self.T.device)
        smooth, r = sk.smoother_chunk(
            filt_xs[:, None], prior_xs[:, None], self.T[None], ones,
            smooth_init[None], uniform_rows=self.uniform_rows,
            band=_cached_band(self, self.T[None]),
        )
        return smooth[:, 0], r[:, 0]


@dataclasses.dataclass(frozen=True)
class JointTransition:
    """Joint dynamics x latent transition, state shape (n_dyn, L).  The
    forward push applies the dynamics transition first, then the
    dynamics-conditioned latent transition."""

    Tdyn: torch.Tensor  # (n_dyn, n_dyn); Tdyn[d, e] = p(e | d)
    Tlat: torch.Tensor  # (n_dyn, L, L); Tlat[e, i, j] = p(j | i, dyn=e)
    logTdyn: torch.Tensor
    logTlat: torch.Tensor
    uniform_rows: tuple = None
    _band: object = dataclasses.field(default=None, repr=False,
                                      compare=False)

    def __post_init__(self):
        if self.uniform_rows is None:
            object.__setattr__(self, "uniform_rows",
                               sk._detect_uniform_rows(self.Tlat))

    @property
    def n_latent(self):
        return self.Tlat.shape[-1]

    @property
    def n_dyn(self):
        return self.Tdyn.shape[0]

    def uniform_log_init(self):
        n_dyn, L = self.n_dyn, self.n_latent
        return torch.log(torch.ones((n_dyn, L), dtype=self.Tlat.dtype,
                                    device=self.Tlat.device) / (n_dyn * L))

    def bcast_ll(self, x):
        return x[None, :]

    def push(self, p):
        q = self.Tdyn.T @ p  # q[d] = sum_p Tdyn[p, d] * p[p]
        return torch.einsum("di,dij->dj", q, self.Tlat)

    def push_batch(self, p):
        q = torch.einsum("tpl,pd->tdl", p, self.Tdyn)
        return torch.einsum("tdi,dij->tdj", q, self.Tlat)

    def pull(self, r):
        s = torch.einsum("eij,ej->ei", self.Tlat, r)
        return self.Tdyn @ s

    def outer_acc(self, P, R):
        raw = torch.einsum("tdi,tej->deij", P, R)
        return raw * self.Tdyn[:, :, None, None] * self.Tlat[None]

    def joint_shape(self):
        return (self.n_dyn, self.n_dyn, self.n_latent, self.n_latent)

    # log-space engine (the JAX package's order of operations) ----------
    def push_log(self, logp):
        a = torch.logsumexp(logp[:, None, :] + self.logTdyn[:, :, None], dim=0)
        return torch.logsumexp(a[:, :, None] + self.logTlat, dim=1)

    def smooth_step_log(self, log_smooth_next, log_filt_curr, log_prior_next):
        # broadcast to (dyn_curr, dyn_next, lat_curr, lat_next)
        inside = (
            self.logTlat[None, :, :, :]
            + self.logTdyn[:, :, None, None]
            + (log_smooth_next - log_prior_next)[None, :, None, :]
            + log_filt_curr[:, None, :, None]
        )
        return torch.logsumexp(inside, dim=(1, 3)), inside

    # kernel engine ----------------------------------------------------
    def cuda_filter(self, ll, p_init, likelihood_scale):
        return sk.filter_chunk(ll, self.Tlat, self.Tdyn, p_init,
                               likelihood_scale,
                               uniform_rows=self.uniform_rows,
                               band=_cached_band(self, self.Tlat))

    def cuda_smooth(self, filt_xs, prior_xs, smooth_init):
        return sk.smoother_chunk(filt_xs, prior_xs, self.Tlat, self.Tdyn,
                                 smooth_init, uniform_rows=self.uniform_rows,
                                 band=_cached_band(self, self.Tlat))


@dataclasses.dataclass(frozen=True)
class TransitionStack:
    """G transitions of one shape and one set of constant-channel flags,
    stacked for the sequential kernels with a configuration index:
    ``Tlat`` (G, n_dyn, L, L), ``Tdyn`` (G, n_dyn, n_dyn); a latent-only
    transition is the n_dyn = 1 stack (``is_joint`` False).  Made by
    ``stack_transitions``."""

    Tlat: torch.Tensor
    Tdyn: torch.Tensor
    uniform_rows: tuple
    is_joint: bool
    _band: object = dataclasses.field(default=None, repr=False,
                                      compare=False)

    @property
    def n_latent(self):
        return self.Tlat.shape[-1]

    @property
    def n_dyn(self):
        return self.Tlat.shape[1]

    def uniform_log_init(self):
        """The shared uniform initial state: (n_dyn, L), or (L,) for a
        latent-only stack, as each transition's own."""
        n_dyn, L = self.n_dyn, self.n_latent
        shape = (n_dyn, L) if self.is_joint else (L,)
        return torch.log(torch.ones(shape, dtype=self.Tlat.dtype,
                                    device=self.Tlat.device) / (n_dyn * L))


def stack_transitions(trans_l):
    """The ``TransitionStack`` of a list of transitions of one class, L
    and constant-channel flags (raises otherwise)."""
    is_joint = hasattr(trans_l[0], "Tdyn")
    flags = trans_l[0].uniform_rows
    if any(hasattr(t, "Tdyn") != is_joint or t.uniform_rows != flags
           for t in trans_l):
        raise ValueError("stacked transitions must share their class and "
                         "constant-channel flags")
    tlat, tdyn = zip(*(_transition_stack(t) for t in trans_l))
    return TransitionStack(torch.stack(tlat).contiguous(),
                           torch.stack(tdyn).contiguous(), flags, is_joint)


# ---------------------------------------------------------------------------
# probability-space scans (plain PyTorch loops)
# ---------------------------------------------------------------------------


def _forward_scan_prob(ll, trans, carry, likelihood_scale):
    """Scaled causal filter.  The max-shifted weights are elementwise, so
    they are formed for all steps at once; the loop holds the dependent
    push/normalise chain.  Returns (post, prior, ratios, (p_last, logz))."""
    p, logz = carry
    m = ll.amax(dim=1)
    w = torch.exp(likelihood_scale * (ll - m[:, None]))
    T = ll.shape[0]
    post = torch.empty((T, *p.shape), dtype=p.dtype, device=p.device)
    prior = torch.empty_like(post)
    s_all = torch.empty((T,), dtype=p.dtype, device=p.device)
    for t in range(T):
        pr = trans.push(p)
        u = pr * trans.bcast_ll(w[t])
        s = u.sum()
        p = u / torch.clamp(s, min=_tiny(u))
        post[t], prior[t], s_all[t] = p, pr, s
    ratios = torch.log(s_all) + likelihood_scale * m
    return post, prior, ratios, (p, logz + ratios.sum())


def _backward_scan_prob_ratios(p_filt_xs, p_prior_xs, trans, p_smooth_init):
    """Reverse smoother scan; returns (smooth, ratios r)."""
    smooth = torch.empty_like(p_filt_xs)
    ratios = torch.empty_like(p_filt_xs)
    carry = p_smooth_init
    for t in range(p_filt_xs.shape[0] - 1, -1, -1):
        r = sk.smoother_ratio(carry, p_prior_xs[t])
        sm = p_filt_xs[t] * trans.pull(r)
        carry = sm / torch.clamp(sm.sum(), min=_tiny(sm))
        smooth[t], ratios[t] = carry, r
    return smooth, ratios


def _backward_scan_prob(p_filt_xs, p_prior_xs, trans, p_smooth_init):
    smooth, ratios = _backward_scan_prob_ratios(
        p_filt_xs, p_prior_xs, trans, p_smooth_init
    )
    return smooth, trans.outer_acc(p_filt_xs, ratios)


# ---------------------------------------------------------------------------
# log-space scans (plain PyTorch loops, the JAX package's order of operations)
# ---------------------------------------------------------------------------


def _forward_scan_log(ll, trans, carry, likelihood_scale):
    """Log-space causal filter.  Returns (log post, log prior, ratios,
    (logp_last, logz))."""
    logp, logz = carry
    T = ll.shape[0]
    post = torch.empty((T, *logp.shape), dtype=logp.dtype, device=logp.device)
    prior = torch.empty_like(post)
    ratios = torch.empty((T,), dtype=logp.dtype, device=logp.device)
    for t in range(T):
        log_prior = trans.push_log(logp)
        unnorm = log_prior + likelihood_scale * trans.bcast_ll(ll[t])
        ratio = torch.logsumexp(unnorm.reshape(-1), dim=0)
        logp = unnorm - ratio
        post[t], prior[t], ratios[t] = logp, log_prior, ratio
    return post, prior, ratios, (logp, logz + ratios.sum())


def _backward_scan_log(log_filt_xs, log_prior_xs, trans, carry_init):
    """Log-space reverse smoother; the log pairwise joint accumulates by
    logaddexp.  Returns (log smooth, log joint)."""
    log_smooth_next, acc = carry_init
    smooth = torch.empty_like(log_filt_xs)
    for t in range(log_filt_xs.shape[0] - 1, -1, -1):
        log_smooth_next, inside = trans.smooth_step_log(
            log_smooth_next, log_filt_xs[t], log_prior_xs[t])
        acc = torch.logaddexp(acc, inside)
        smooth[t] = log_smooth_next
    return smooth, acc


# ---------------------------------------------------------------------------
# per-chunk programs
# ---------------------------------------------------------------------------


#: bytes of each (rows, L, N) temporary of the per-bin dt emissions
DT_BLOCK_BYTES = 2e9


def _loglik(y, tuning, hyperparam, ma_neuron, ma_latent, observation_model,
            dt_l=None, lgamma_term=None):
    """(T, L) log-likelihoods of a chunk; with a per-bin ``dt_l`` (T,) the
    elementwise (rows, L, N) form, in blocks of rows that keep each
    temporary within ``DT_BLOCK_BYTES`` (every row is computed on its own,
    so the blocks do not change its bits)."""
    if dt_l is None:
        return get_loglikelihood_ma_all(
            y, tuning, hyperparam, ma_neuron, ma_latent,
            observation_model=observation_model, lgamma_term=lgamma_term)
    T = y.shape[0]
    rows = max(1, int(DT_BLOCK_BYTES // (4 * tuning.numel())))
    ll = torch.empty((T, tuning.shape[0]), dtype=torch.float32,
                     device=tuning.device)
    for a in range(0, T, rows):
        ll[a:a + rows] = get_loglikelihood_ma_all_changing_dt(
            y[a:a + rows], tuning, hyperparam, ma_neuron[a:a + rows],
            ma_latent, dt_l[a:a + rows], observation_model=observation_model)
    return ll


def _filter_chunk(y, tuning, hyperparam, trans, ma_neuron, ma_latent, carry,
                  likelihood_scale, observation_model, engine, dt_l=None):
    ll = _loglik(y, tuning, hyperparam, ma_neuron, ma_latent,
                 observation_model, dt_l)
    if engine == "cuda":
        post, prior, ratios = trans.cuda_filter(ll, carry[0],
                                                likelihood_scale)
        carry_out = (post[-1], carry[1] + ratios.sum())
    else:
        scan = _forward_scan_log if engine == "log" else _forward_scan_prob
        post, prior, ratios, carry_out = scan(ll, trans, carry,
                                              likelihood_scale)
    return post, prior, ratios, carry_out, ll


def _backward_chunk(filt_xs, prior_xs, trans, carry, engine):
    if filt_xs.shape[0] == 0:  # T=1 sequence: nothing to smooth over
        return filt_xs, carry
    if engine == "log":
        smooth, acc = _backward_scan_log(filt_xs, prior_xs, trans, carry)
        return smooth, (smooth[0], acc)
    smooth_init, acc_in = carry
    if engine == "cuda":
        smooth, r = trans.cuda_smooth(filt_xs, prior_xs, smooth_init)
        acc = trans.outer_acc(filt_xs, r)
    else:
        smooth, acc = _backward_scan_prob(filt_xs, prior_xs, trans,
                                          smooth_init)
    return smooth, (smooth[0], acc_in + acc)


def _chunk_inputs(y, ma_neuron, n, n_time_per_chunk):
    """Chunk ``n``'s spikes and neuron mask; a (N,) mask is broadcast to the
    chunk's (T', N), as the JAX driver does."""
    sl = slice(n * n_time_per_chunk, (n + 1) * n_time_per_chunk)
    y_chunk = y[sl]
    if ma_neuron.ndim == 2:
        return y_chunk, ma_neuron[sl]
    return y_chunk, torch.broadcast_to(ma_neuron, y_chunk.shape)


def _dt_chunk(dt_l, n, n_time_per_chunk):
    if dt_l is None:
        return None
    return dt_l[n * n_time_per_chunk:(n + 1) * n_time_per_chunk]


# ---------------------------------------------------------------------------
# public driver
# ---------------------------------------------------------------------------


def _device_memory_budget(device):
    """Device memory in bytes: the card's total memory, 8 GB elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return 8e9


def auto_chunk_size(n_time_tot, state_size, n_latent, device="cpu"):
    """``n_time_per_chunk`` used when None is passed: one chunk whenever the
    full-mode working set fits comfortably (chunking is exact, so its only
    upside is bounding peak memory); past that, chunks sized to a fraction
    of the device budget, never below 10000."""
    per_t = (3 * state_size + n_latent) * 4  # posterior+prior+ratio+ll, f32
    budget = _device_memory_budget(device)
    if n_time_tot * per_t <= min(4e9, 0.5 * budget):
        return int(n_time_tot)
    chunk = int(max(1e9, 0.125 * budget) // per_t)
    return int(np.clip(chunk, 10_000, n_time_tot))


def smooth_combined_chunked(
    y,
    tuning,
    hyperparam,
    trans,
    ma_neuron,
    ma_latent=None,
    likelihood_scale=1.0,
    n_time_per_chunk=None,
    observation_model="poisson",
    engine="prob",
    memory_mode="auto",
    marginal_smooth=False,
    scan_carry_in=None,
    want_scan_carry=False,
    scan_fast=False,
    lgamma_term=None,
    want_acc=True,
    diag_out=None,
    dt_l=None,
):
    """Chunked forward-backward smoother.

    Returns ``(log_acausal_posterior_all, log_marginal_final,
    log_causal_posterior_all, log_one_step_predictive_marginals,
    log_accumulated_joint, log_likelihood_all)``, and with
    ``want_scan_carry`` a seventh entry ``(fwd, bwd, pred, (fwd_passes,
    bwd_passes, emit_delta_f, emit_delta_b))`` that warm-starts the next
    same-shape solve (``scan_carry_in``).

    The backward pass consumes the +1-shifted causal prior: chunk [a, b)
    pairs with priors [a+1, b+1), and the final timestep's smoothed
    posterior equals its filter posterior.  Chunking is exact.

    ``marginal_smooth``: the first entry is the pair (latent marginal (T,
    L), dynamics marginal (T, n_dyn) or None for a latent-only model), in
    log space.  The parallel engine forms it in its smoother kernel (K4's
    marginal modes); the sequential engines run full mode and marginalise
    at return (logsumexp of the log posterior, as the JAX package's
    full-mode path does).

    ``memory_mode``: every JAX mode is accepted.  On an 80 GB card the
    full working set of the north-star shape fits, so the sequential
    engines run full mode in every memory mode ('checkpoint', 'filter' and
    'filter_bf16' return None for the causal posteriors and the
    log-likelihoods, as the JAX package's drivers do; the port's
    'filter_bf16' keeps the filter in f32, more exact than the JAX bf16
    store).  On the parallel engine only ``want_post`` depends on it.  The
    ``'log'`` engine takes 'auto' and 'full' only, as in the JAX package.

    ``want_acc=False``: the caller discards ``log_accumulated_joint``
    (``fit_em`` does).  The parallel engine then skips the pairwise joint
    and returns None in that slot; the sequential engines ignore the hint,
    as in the JAX package.  ``scan_fast``: the warm-started fixed points
    exit on the predicted residual (tol 1e-4; strict: 1e-6).
    ``lgamma_term``: the precomputed ``emissions.poisson_lgamma_term``,
    consumed by the parallel engine.  ``diag_out``: a list to which the
    parallel engine appends its fixed-point diagnostics ``(fwd_passes,
    bwd_passes, fwd_delta, bwd_delta[, emit_delta_f, emit_delta_b])``.
    ``dt_l``: a per-bin dt (T,) in the emissions (the gain model's gain
    rides it), formed alike on every engine (``_loglik``)."""
    check_engine(engine)
    if memory_mode not in MEMORY_MODES:
        raise ValueError(
            f"memory_mode must be one of {MEMORY_MODES}, got {memory_mode!r}"
        )
    device = tuning.device
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    n_time_tot = y.shape[0]
    if dt_l is not None:
        dt_l = torch.broadcast_to(torch.as_tensor(
            dt_l, dtype=torch.float32, device=device), (n_time_tot,))
    if engine_resolves_parallel(n_time_tot, trans, engine, device):
        return _smooth_parallel_driver(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, observation_model, memory_mode,
            marginal_smooth, n_time_per_chunk, scan_carry_in,
            want_scan_carry, scan_fast, lgamma_term, want_acc, diag_out,
            dt_l,
        )
    if want_scan_carry:
        raise ValueError(
            "want_scan_carry requires the parallel-in-time engine "
            "(use parallel_scan_carry_spec to gate the request)"
        )
    in_log = engine == "log"
    if in_log and memory_mode not in ("auto", "full"):
        raise ValueError(
            f"memory_mode={memory_mode!r} requires engine prob/cuda")
    if n_time_per_chunk is None:
        n_time_per_chunk = auto_chunk_size(
            n_time_tot, trans.uniform_log_init().numel(), tuning.shape[0],
            device,
        )
    n_chunks = -(-n_time_tot // n_time_per_chunk)
    ma_neuron = torch.as_tensor(ma_neuron, dtype=torch.float32, device=device)
    if ma_latent is None:
        ma_latent = torch.ones(tuning.shape[0], dtype=torch.float32,
                               device=device)

    # ---- forward pass over chunks ----
    to_log = (lambda x: x) if in_log else prob_to_log
    log_init = trans.uniform_log_init()
    carry = (log_init if in_log else torch.exp(log_init),
             torch.zeros((), dtype=torch.float32, device=device))
    post_chunks, prior_chunks, ratio_chunks, ll_chunks = [], [], [], []
    for n in range(n_chunks):
        y_chunk, ma_chunk = _chunk_inputs(y, ma_neuron, n, n_time_per_chunk)
        post, prior, ratios, carry, ll = _filter_chunk(
            y_chunk, tuning, hyperparam, trans, ma_chunk, ma_latent, carry,
            likelihood_scale, observation_model, engine,
            _dt_chunk(dt_l, n, n_time_per_chunk),
        )
        post_chunks.append(post)
        prior_chunks.append(prior)
        ratio_chunks.append(ratios)
        ll_chunks.append(ll)
    log_marginal_final = carry[1]
    prior_all = torch.cat(prior_chunks, dim=0)

    # ---- backward pass over chunks, reversed ----
    smooth_chunks = [None] * n_chunks
    bwd_carry = None
    for n in range(n_chunks - 1, -1, -1):
        a = n * n_time_per_chunk
        b = min((n + 1) * n_time_per_chunk, n_time_tot)
        filt_chunk = post_chunks[n]
        prior_shifted = prior_all[a + 1: b + 1]
        if bwd_carry is None:  # last chunk: start from the last filter post
            bwd_carry = (
                filt_chunk[-1],
                torch.full(trans.joint_shape(),
                           JOINT_ACC_INIT if in_log else 0.0,
                           dtype=torch.float32, device=device),
            )
            smooth, bwd_carry = _backward_chunk(
                filt_chunk[:-1], prior_shifted, trans, bwd_carry, engine
            )
            smooth = torch.cat([smooth, filt_chunk[-1][None]], dim=0)
        else:
            smooth, bwd_carry = _backward_chunk(
                filt_chunk, prior_shifted, trans, bwd_carry, engine
            )
        smooth_chunks[n] = smooth

    smooth_log = to_log(torch.cat(smooth_chunks, dim=0))
    if marginal_smooth:
        smooth_log = _marginalize_log(smooth_log)
    full_store = memory_mode in ("auto", "full")
    return (
        smooth_log,
        log_marginal_final,
        to_log(torch.cat(post_chunks, dim=0)) if full_store else None,
        torch.cat(ratio_chunks, dim=0),
        to_log(bwd_carry[1]),
        torch.cat(ll_chunks, dim=0) if full_store else None,
    )


def _transition_stack(trans):
    """(tlat (n_dyn, L, L), tdyn (n_dyn, n_dyn)) of either transition; a
    latent-only one is the n_dyn = 1 stack.  A ``TransitionStack`` gives
    its (G, ...) stacks."""
    if hasattr(trans, "Tdyn"):
        return trans.Tlat, trans.Tdyn
    return trans.T[None], torch.ones((1, 1), dtype=trans.T.dtype,
                                     device=trans.T.device)


def epoch_loglikelihoods(y_b, lengths, tuning, hyperparam, ma_neuron,
                         ma_latent, observation_model="poisson"):
    """Log-likelihoods (E, Tmax, L) of a batch of right-padded epochs y_b
    (E, Tmax, N) as one (E * Tmax, N) @ (N, L) product; the rows past an
    epoch's length carry an all-zero neuron mask."""
    E, Tmax, N = y_b.shape
    valid = sk._valid_rows(lengths, Tmax)
    ma_b = valid[:, :, None].to(torch.float32) * ma_neuron
    return get_loglikelihood_ma_all(
        y_b.reshape(E * Tmax, N), tuning, hyperparam,
        ma_b.reshape(E * Tmax, N), ma_latent,
        observation_model=observation_model,
    ).view(E, Tmax, tuning.shape[0])


def _scan_batch(ll, trans, lengths, likelihood_scale, cfg=None):
    """One launch of K1 (``filter_chunk_batch``) and one of K2
    (``smoother_chunk_batch``) over a batch of log-likelihoods ll
    (E, Tmax, L) under one transition, or, with a ``TransitionStack`` and
    ``cfg`` (E,) int32, each sequence under its own configuration; each
    sequence from the uniform initial state.  Returns ``(filter
    posteriors, ratios, smoothed posteriors of the steps before each
    sequence's last, K2's r, last step's filter posterior (E, n_dyn,
    L))`` in probability space."""
    tlat, tdyn = _transition_stack(trans)
    E, _, L = ll.shape
    n_dyn = tlat.shape[-3]
    band = _cached_band(trans, tlat)
    p_init = torch.exp(trans.uniform_log_init()).reshape(1, n_dyn, L)
    post, prior, ratios = sk.filter_chunk_batch(
        ll, tlat, tdyn, p_init.expand(E, n_dyn, L), lengths, likelihood_scale,
        uniform_rows=trans.uniform_rows, band=band, cfg=cfg)
    # the last step's smoothed posterior is its filter posterior; the
    # smoother runs over the rows before it against the +1-shifted priors
    last = post[torch.arange(E, device=post.device),
                (lengths - 1).long()]
    smooth, r = sk.smoother_chunk_batch(
        post[:, :-1], prior[:, 1:], tlat, tdyn, last, lengths - 1,
        uniform_rows=trans.uniform_rows, band=band, cfg=cfg)
    return post, ratios, smooth, r, last


def sequence_lml(ratios, n_time_per_chunk):
    """(E,) log marginals of ratios (E, T): each sequence's ratios summed
    chunk by chunk, each chunk from a fresh copy, as ``decode_latent``
    sums its own (a reduction's order depends on the alignment of its
    input), so that each equals the decode of that sequence alone."""
    E, T = ratios.shape
    lml = torch.zeros((E,), dtype=torch.float32, device=ratios.device)
    for n in range(-(-T // n_time_per_chunk)):
        lml = lml + torch.stack([
            ratios[e, n * n_time_per_chunk:(n + 1) * n_time_per_chunk]
            .clone().sum() for e in range(E)])
    return lml


def filter_lml_batch(ll, trans, likelihood_scale=1.0, cfg=None,
                     n_time_per_chunk=None):
    """(E,) forward-filter log marginals of a batch of log-likelihoods ll
    (E, T, L): one launch of the norm-only K1 (``filter_chunk_batch
    (norm_only=True)``), no row stored; ``trans`` one transition, or a
    ``TransitionStack`` with ``cfg`` (E,) int32.  Each equals the
    ``log_marginal_final`` of ``smooth_combined_chunked`` on the
    sequential engine for that sequence alone when its ll are the
    decode's (``n_time_per_chunk``: the decode's chunk, None its
    ``auto_chunk_size``).  On CPU tensors K1 runs its plain version."""
    E, T, L = ll.shape
    tlat, tdyn = _transition_stack(trans)
    n_dyn = tlat.shape[-3]
    if n_time_per_chunk is None:
        n_time_per_chunk = auto_chunk_size(T, n_dyn * L, L, ll.device)
    p_init = torch.exp(trans.uniform_log_init()).reshape(1, n_dyn, L)
    _, _, ratios = sk.filter_chunk_batch(
        ll, tlat, tdyn, p_init.expand(E, n_dyn, L),
        torch.full((E,), T, dtype=torch.int32, device=ll.device),
        likelihood_scale, uniform_rows=trans.uniform_rows,
        band=_cached_band(trans, tlat), cfg=cfg, norm_only=True)
    return sequence_lml(ratios, n_time_per_chunk)


def filter_lmls(y, tunings, hyper, trans, ma_neuron, ma_latent,
                likelihood_scale=1.0, observation_model="poisson",
                n_time_per_chunk=None, latent_masks=None):
    """(E,) forward-filter log marginals of y, each the
    ``log_marginal_final`` of ``decode_latent`` (the smoother does not
    change it): one for each tuning (L, N) of ``tunings``, or, with
    ``latent_masks`` (E, L), one for each mask over the single tuning.
    The emissions are formed as the decode forms them (``ma_neuron`` (N,)
    or (T, N)), a mask's dropped bins set to ``MASK_NEG``, then one
    launch of the norm-only K1 (``filter_lml_batch``).  The one path of
    the downsampled-LML metric and the LML history of tuning snapshots
    (``selection``)."""
    device = tunings[0].device
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    L = tunings[0].shape[0]
    if n_time_per_chunk is None:
        n_time_per_chunk = auto_chunk_size(
            y.shape[0], trans.uniform_log_init().numel(), L, device)
    ma_neuron = torch.as_tensor(ma_neuron, dtype=torch.float32,
                                device=device)
    ma_latent = torch.as_tensor(ma_latent, dtype=torch.float32,
                                device=device)
    ll = torch.cat([sequence_loglikelihoods(
        y[None], tun, hyper, ma_neuron, ma_latent, n_time_per_chunk,
        observation_model) for tun in tunings])
    if latent_masks is not None:
        if ll.shape[0] != 1:
            raise ValueError("latent_masks take a single tuning")
        keep = torch.as_tensor(latent_masks, device=device).bool()
        ll = torch.where(keep[:, None, :], ll, MASK_NEG)
    return filter_lml_batch(ll, trans, likelihood_scale,
                            n_time_per_chunk=n_time_per_chunk)


def forward_filter_lml(y, tuning, hyper, trans, ma_neuron, ma_latent,
                       likelihood_scale=1.0, observation_model="poisson",
                       n_time_per_chunk=None):
    """Forward-filter log marginal, the ``log_marginal_final`` of
    ``decode_latent``, as a 0-dim tensor (``filter_lmls`` of one
    tuning)."""
    return filter_lmls(y, [tuning], hyper, trans, ma_neuron, ma_latent,
                       likelihood_scale, observation_model,
                       n_time_per_chunk)[0]


def smooth_epochs(y_b, lengths, tuning, hyperparam, trans, ma_neuron,
                  ma_latent=None, likelihood_scale=1.0,
                  observation_model="poisson", engine="prob"):
    """Smooth a batch of short sequences, each on its own.

    y_b (E, Tmax, N): the epochs' spikes, right-padded to the longest;
    lengths (E,): each epoch's number of bins (an int32 tensor on the
    tuning's device, or anything ``torch.as_tensor`` takes), every entry in
    [1, Tmax]; ma_neuron (N,).  Returns ``(latent marginal (E, Tmax, L) of
    the smoothed posterior, log marginal (E,))`` in probability space; the
    rows past an epoch's length are unspecified.

    ``'cuda'`` and ``'cuda_parallel'``: the sequential kernels over the
    whole batch, whatever the epochs' lengths (no upgrade to the parallel
    engine: epochs are short, and a batch fills the card with one thread
    block per epoch).  The emissions of all epochs are one (E * Tmax, N) @
    (N, L) product with the padding mask (padded rows carry an all-zero
    neuron mask); then one launch of K1 (``filter_chunk_batch``), each
    epoch's +1-shifted priors and its last filter posterior read in place,
    one launch of K2 (``smoother_chunk_batch``), and the sum over the
    dynamics.  On CPU tensors the wrappers run their plain versions.
    ``'prob'`` and ``'log'``: the per-epoch loop of
    ``smooth_combined_chunked`` on that engine."""
    check_engine(engine)
    device = tuning.device
    y_b = torch.as_tensor(y_b, dtype=torch.float32, device=device)
    E, Tmax = y_b.shape[:2]
    L = tuning.shape[0]
    lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
    ma_neuron = torch.as_tensor(ma_neuron, dtype=torch.float32, device=device)
    if ma_neuron.ndim != 1:
        raise ValueError("smooth_epochs takes a 1-D ma_neuron (the 2-D slot "
                         "carries the padding mask)")
    if ma_latent is None:
        ma_latent = torch.ones(L, dtype=torch.float32, device=device)
    if engine in ("prob", "log"):
        lat = torch.zeros((E, Tmax, L), dtype=torch.float32, device=device)
        lml = torch.zeros((E,), dtype=torch.float32, device=device)
        for e, n in enumerate(lengths.tolist()):
            if not 1 <= n <= Tmax:
                raise ValueError(f"every length must be in [1, {Tmax}], got "
                                 f"{n}")
            (lat_e, _), lml[e] = smooth_combined_chunked(
                y_b[e, :n], tuning, hyperparam, trans, ma_neuron, ma_latent,
                likelihood_scale=likelihood_scale,
                observation_model=observation_model, engine=engine,
                marginal_smooth=True, want_acc=False)[:2]
            lat[e, :n] = torch.exp(lat_e)
        return lat, lml

    _, ratios, smooth, _, last = _scan_batch(
        epoch_loglikelihoods(y_b, lengths, tuning, hyperparam, ma_neuron,
                             ma_latent, observation_model),
        trans, lengths, likelihood_scale)
    each = torch.arange(E, device=device)
    lat = torch.empty((E, Tmax, L), dtype=torch.float32, device=device)
    torch.sum(smooth, dim=2, out=lat[:, :-1])
    lat[each, (lengths - 1).long()] = last.sum(dim=1)
    return lat, ratios.sum(dim=1)


def _full_store(memory_mode, n_time, state_size, n_latent):
    """Whether a decode in ``memory_mode`` keeps the log-likelihoods (and
    the causal posteriors): 'full', or 'auto' while the full working set
    of one sequence takes at most 4 GB (the JAX package's resolution of
    'auto', and the parallel driver's ``want_post``)."""
    est_bytes = n_time * (3 * state_size + n_latent) * 4
    return memory_mode == "full" or (memory_mode == "auto"
                                     and est_bytes <= 4e9)


def sequence_loglikelihoods(y_b, tuning, hyperparam, ma_neuron, ma_latent,
                            n_time_per_chunk, observation_model="poisson"):
    """Log-likelihoods (E, T, L) of E sequences y_b (E, T, N), each formed
    on its own in the chunks of ``n_time_per_chunk`` rows, with the (N,)
    neuron mask broadcast to each chunk: the products
    ``smooth_combined_chunked`` forms for one sequence, so each row has
    their bits."""
    E, T = y_b.shape[:2]
    ll = torch.empty((E, T, tuning.shape[0]), dtype=torch.float32,
                     device=tuning.device)
    for e in range(E):
        for n in range(-(-T // n_time_per_chunk)):
            y_c, ma_c = _chunk_inputs(y_b[e], ma_neuron, n, n_time_per_chunk)
            ll[e, n * n_time_per_chunk:(n + 1) * n_time_per_chunk] = \
                get_loglikelihood_ma_all(
                    y_c, tuning, hyperparam, ma_c, ma_latent,
                    observation_model=observation_model)
    return ll


def smooth_batch_full(y_b, tuning, hyperparam, trans, ma_neuron,
                      ma_latent=None, likelihood_scale=1.0,
                      n_time_per_chunk=None, observation_model="poisson",
                      engine="prob", memory_mode="auto"):
    """Smooth a batch of E equal-length sequences y_b (E, T, N) that share
    one transition, each on its own, with what ``smooth_combined_chunked``
    returns for each: ``(log posterior (E, T, *state), log marginal (E,),
    None, log one-step predictive marginals (E, T), log pairwise joint
    (E, *joint), log-likelihoods (E, T, L) or None)``.  The causal
    posteriors (third slot) are not formed: no decode reads them.  The
    log-likelihoods are None where ``smooth_combined_chunked`` would
    return None for one sequence ('checkpoint', 'filter' and
    'filter_bf16'; 'auto' past 4 GB of working set); every memory mode is
    computed exactly.

    ``'cuda'`` and ``'cuda_parallel'``: one launch of K1
    (``filter_chunk_batch``) and one of K2 (``smoother_chunk_batch``) for
    the batch, one thread block per sequence, never the parallel-in-time
    kernels.  Each sequence's emission product is formed on its own in
    the chunks of ``n_time_per_chunk`` (None: ``auto_chunk_size`` of one
    sequence) that ``smooth_combined_chunked`` forms
    (``sequence_loglikelihoods``), and its pairwise
    joint is its own ``trans.outer_acc`` over K2's ratios, so that where a
    decode runs one chunk each sequence equals the sequential ``'cuda'``
    decode of it alone bit for bit (a batched product would sum in another
    order).  On CPU tensors the wrappers run their plain versions.
    ``'prob'`` and ``'log'``: ``smooth_combined_chunked`` per sequence."""
    check_engine(engine)
    if memory_mode not in MEMORY_MODES:
        raise ValueError(
            f"memory_mode must be one of {MEMORY_MODES}, got {memory_mode!r}"
        )
    device = tuning.device
    y_b = torch.as_tensor(y_b, dtype=torch.float32, device=device)
    E, T = y_b.shape[:2]
    L = tuning.shape[0]
    ma_neuron = torch.as_tensor(ma_neuron, dtype=torch.float32, device=device)
    if ma_latent is None:
        ma_latent = torch.ones(L, dtype=torch.float32, device=device)
    if engine in ("prob", "log"):
        outs = [smooth_combined_chunked(
            y_b[e], tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk,
            observation_model=observation_model, engine=engine,
            memory_mode=memory_mode) for e in range(E)]
        return tuple(
            None if j == 2 or outs[0][j] is None
            else torch.stack([o[j] for o in outs]) for j in range(6))

    state_size = trans.uniform_log_init().numel()
    if n_time_per_chunk is None:
        n_time_per_chunk = auto_chunk_size(T, state_size, L, device)
    ll = sequence_loglikelihoods(y_b, tuning, hyperparam, ma_neuron,
                                 ma_latent, n_time_per_chunk,
                                 observation_model)
    post, ratios, smooth, r, last = _scan_batch(
        ll, trans, torch.full((E,), T, dtype=torch.int32, device=device),
        likelihood_scale)
    is_joint = hasattr(trans, "Tdyn")
    acc = torch.stack([
        trans.outer_acc(post[e, :-1], r[e]) if is_joint
        else trans.outer_acc(post[e, :-1, 0], r[e, :, 0])
        for e in range(E)])
    del r
    lml = sequence_lml(ratios, n_time_per_chunk)
    smooth = torch.cat([smooth, last[:, None]], dim=1)
    del post, last
    smooth_log = prob_to_log(smooth if is_joint else smooth[:, :, 0])
    del smooth
    keep_ll = _full_store(memory_mode, T, state_size, L)
    return (smooth_log, lml, None, ratios, prob_to_log(acc),
            ll if keep_ll else None)


def _marginalize_log(smooth_log):
    """(latent marginal, dynamics marginal or None) of a log posterior,
    by logsumexp (the JAX package's full-mode ``_full_out``)."""
    if smooth_log.ndim == 3:
        return (torch.logsumexp(smooth_log, dim=1),
                torch.logsumexp(smooth_log, dim=2))
    return (smooth_log, None)


# ---------------------------------------------------------------------------
# parallel-in-time engine
# ---------------------------------------------------------------------------

#: 'cuda' -> 'cuda_parallel' auto-upgrade floor on a CUDA device.  Decode
#: on an H100 (700 W), sequential vs parallel: N = L = 100, T=1,000 3.46 vs
#: 4.46 ms, T=2,000 5.79 vs 4.89 ms, T=10,000 23.7 vs 4.1 ms; N = L = 500,
#: T=1,000 4.60 vs 4.87 ms, T=2,000 7.90 vs 4.98 ms (PERF.md).  The JAX
#: package's 20,000 was measured on a TPU v5e.
_PARALLEL_UPGRADE_MIN_T = 2_000


def _parallel_upgrade_ok(n_time, n_latent, n_dyn, device):
    """Whether the parallel engine's full-sequence buffers fit the card.
    It holds, at its peak, the log-likelihoods and weights (2 x (T, L))
    and five (T, n_dyn, L) f32 arrays (filter posteriors, smoothed
    posteriors, ratios, and the two log-space outputs), with no O(chunk)
    fallback; the upgrade is allowed while they take at most 3/4 of what
    the card has free (the caching allocator's unused blocks count as
    free).  An explicit engine='cuda_parallel' bypasses this."""
    est_bytes = 4.0 * n_time * n_latent * (2 + 5 * max(1, n_dyn))
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return est_bytes <= 0.75 * (free + cached)


def engine_resolves_parallel(n_time, trans, engine, device):
    """Whether ``smooth_combined_chunked`` with this engine runs the
    parallel-in-time driver for ``n_time`` steps on ``device``: always for
    'cuda_parallel', and for 'cuda' on a CUDA device from
    ``_PARALLEL_UPGRADE_MIN_T`` steps on while the buffers fit."""
    if engine == "cuda_parallel":
        return True
    device = torch.device(device)
    return (
        engine == "cuda"
        and device.type == "cuda"
        and n_time >= _PARALLEL_UPGRADE_MIN_T
        and _parallel_upgrade_ok(n_time, trans.n_latent,
                                 getattr(trans, "n_dyn", 1), device)
    )


def parallel_scan_carry_spec(n_time, trans, engine, force=False,
                             memory_mode="auto"):
    """Warm-start carry spec, (C, n_dyn, L), when ``smooth_combined_chunked``
    with this engine would run the parallel-in-time engine for ``n_time``
    steps on the transition's device, else None.  ``force=True`` skips the
    engine check (for tests).  The same predicate as the engine choice, so
    no carries are requested for a solve that will not upgrade."""
    del memory_mode  # the buffer bound applies to every mode
    device = _trans_device(trans)
    if not (force or engine_resolves_parallel(n_time, trans, engine,
                                              device)):
        return None
    return ps.carry_spec(n_time, trans.n_latent, getattr(trans, "n_dyn", 1))


def _trans_device(trans):
    return (trans.Tlat if hasattr(trans, "Tdyn") else trans.T).device


def _smooth_parallel_driver(
    y, tuning, hyperparam, trans, ma_neuron, ma_latent, likelihood_scale,
    observation_model, memory_mode, marginal_smooth, n_time_per_chunk,
    scan_carry_in, want_scan_carry, scan_fast, lgamma_term, want_acc,
    diag_out, dt_l=None,
):
    """engine='cuda_parallel': the fixed-point parallel-in-time scans
    (``ops/parallel_scan.py``).  Falls back to the sequential 'cuda' engine
    when the sequence is too short to chunk (a problem-size rule of the
    JAX package)."""
    T = y.shape[0]
    is_joint = hasattr(trans, "Tdyn")
    n_dyn = trans.n_dyn if is_joint else 1
    L = trans.n_latent
    cfg = ps.choose_parallel_config(T, L, n_dyn)
    if cfg is None:
        if want_scan_carry:
            raise ValueError(
                "want_scan_carry requested but the problem is too small "
                "for the parallel engine"
            )
        return smooth_combined_chunked(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk,
            observation_model=observation_model, engine="cuda",
            memory_mode=memory_mode, marginal_smooth=marginal_smooth,
            dt_l=dt_l,
        )
    device = tuning.device
    if ma_latent is None:
        ma_latent = torch.ones(L, dtype=torch.float32, device=device)
    # the emissions are formed exactly as the sequential chunk loop forms
    # them (a 1-D neuron mask broadcast to (T, N)), so that the two engines
    # differ only in the scan.  (The JAX package folds a 1-D mask into one
    # matmul instead; the per-bin rounding of that fold moved sharp L=500
    # posteriors by 3e-4 against the sequential engine on the H100.)  A
    # precomputed lgamma term gives the same values as the one formed here.
    y, ma_t = _chunk_inputs(
        y, torch.as_tensor(ma_neuron, dtype=torch.float32, device=device),
        0, T)
    ll = _loglik(y, tuning, hyperparam, ma_t, ma_latent, observation_model,
                 dt_l, lgamma_term)
    tlat, tdyn = _transition_stack(trans)
    p_init = torch.exp(trans.uniform_log_init())
    if not is_joint:
        p_init = p_init[None]
    want_post = _full_store(memory_mode, T, n_dyn * L, L)
    # fast mode (fused mid-EM iterations): a 1e-4 boundary-carry tolerance
    # bounds the posterior error at chunk-start bins by 1e-4 and the
    # log-marginal error far below the fit's needs; strict mode keeps 1e-6
    smooth, log_marginal, post, ratios, acc, diag, carries = (
        ps.smooth_parallel(
            ll, tlat, tdyn, p_init, likelihood_scale,
            uniform_rows=trans.uniform_rows, marginal=marginal_smooth,
            want_post=want_post, config=cfg, warm_start=scan_carry_in,
            fast=scan_fast, tol=1e-4 if scan_fast else 1e-6,
            want_carry=want_scan_carry, want_acc=want_acc,
        ))
    if diag_out is not None:
        diag_out.append(diag)
    if marginal_smooth:
        lat_m, dyn_m = smooth
        smooth_all = (prob_to_log(lat_m),
                      prob_to_log(dyn_m) if is_joint else None)
    else:
        smooth_all = prob_to_log(smooth if is_joint else smooth[:, 0])
    post_all = None
    if want_post:
        post_all = prob_to_log(post if is_joint else post[:, 0])
    acc_log = None
    if acc is not None:
        acc_log = prob_to_log(acc if is_joint else acc[0, 0])
    out = (smooth_all, log_marginal, post_all, ratios, acc_log,
           ll if want_post else None)
    if want_scan_carry:
        return out + ((carries[0], carries[1], carries[2],
                       (diag[0], diag[1], diag[4], diag[5])),)
    return out


# ---------------------------------------------------------------------------
# transition posterior extraction
# ---------------------------------------------------------------------------


def _lse(x, dims, keepdim=False):
    return torch.logsumexp(x, dim=dims, keepdim=keepdim)


def compute_transition_posterior_prob(log_accumulated_joint_total):
    """12-key dict of joint/conditional transition posteriors for the joint
    model."""
    acc = log_accumulated_joint_total
    log_joint_full = acc - _lse(acc, tuple(range(acc.ndim)))
    log_joint_latent = _lse(log_joint_full, (0, 1))
    log_joint_dynamics = _lse(log_joint_full, (2, 3))
    log_transition_latent = log_joint_latent - _lse(log_joint_latent, 1, True)
    log_transition_dynamics = log_joint_dynamics - _lse(
        log_joint_dynamics, 1, True
    )
    log_transition_full = log_joint_full - _lse(log_joint_full, (1, 3), True)
    return {
        "p_joint_full": torch.exp(log_joint_full),
        "p_joint_latent": torch.exp(log_joint_latent),
        "p_joint_dynamics": torch.exp(log_joint_dynamics),
        "p_transition_full": torch.exp(log_transition_full),
        "p_transition_latent": torch.exp(log_transition_latent),
        "p_transition_dynamics": torch.exp(log_transition_dynamics),
        "log_joint_full": log_joint_full,
        "log_joint_latent": log_joint_latent,
        "log_joint_dynamics": log_joint_dynamics,
        "log_transition_full": log_transition_full,
        "log_transition_latent": log_transition_latent,
        "log_transition_dynamics": log_transition_dynamics,
    }


def compute_transition_posterior_prob_latent(log_accumulated_joint_total):
    """4-key dict for the latent-only model."""
    acc = log_accumulated_joint_total
    log_joint_latent = acc - _lse(acc, (0, 1))
    log_transition_latent = log_joint_latent - _lse(log_joint_latent, 1, True)
    return {
        "p_joint_latent": torch.exp(log_joint_latent),
        "p_transition_latent": torch.exp(log_transition_latent),
        "log_joint_latent": log_joint_latent,
        "log_transition_latent": log_transition_latent,
    }
