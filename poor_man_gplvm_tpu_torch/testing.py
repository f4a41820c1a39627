"""Seeded inputs for holding the scan kernels against their plain versions.

K1/K2 (sequential) are compared by ``kernel_vs_plain``, K3/K4
(parallel-in-time passes, every mode, each scan precision) by
``pscan_vs_plain`` (whole passes and the one-step check
``pfilter_step_check``/``psmooth_step_check``), K2, K3 and K4 on the band
against the same kernel forced dense by ``band_vs_dense``, ``joint_acc`` by
``joint_acc_vs_plain``; the batched full decode of ``hmm.
smooth_batch_full`` (K1/K2 batched) by ``batch_full_vs_plain`` and, bit
for bit against each sequence alone, by ``batch_full_vs_single``; K1/K2
with a configuration per sequence and the norm-only K1 by
``config_batch_vs_single``; ``bf16_gemm`` (the emission and statistics
products at the lower matmul precisions) by ``bf16_gemm_vs_plain`` and,
bit for bit against a slice of its rows or one entry of its batch alone,
by ``bf16_gemm_rows_alone``.

``kilosort_session`` writes a seeded multi-probe Kilosort session (spike
times, clusters, labels, ``params.py``) sampled from a
``PoissonGPLVMJump1D``, with population bursts and units that fail the
session pipeline's filters, for the ingestion layer's end-to-end runs.
``tmaze_session`` and ``ach_session`` make the seeded recordings of the
post-fit workflows (``workflows.tmaze_dataset``, ``workflows.ach_dataset``)
with the effects those workflows look for planted in them.

Shared by the CPU tests, the card tests and ``chip_smoke.py``.  Everything
is built with numpy from a seed, so the same case can be fed to the JAX
package, the plain PyTorch versions and the CUDA kernels.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import band as bd
from poor_man_gplvm_tpu_torch.ops import hmm
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
from poor_man_gplvm_tpu_torch.ops import precision
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
from poor_man_gplvm_tpu_torch.ops.emissions import MASK_NEG

__all__ = [
    "SCAN_CASES", "SCAN_TOLERANCES", "PSCAN_TOLERANCES",
    "PSCAN_TOLERANCES_BF16X3", "PSCAN_TOLERANCES_BF16", "pscan_tolerances",
    "scan_case", "smoother_push_vs", "memory_mode_peaks",
    "kernel_vs_plain", "batch_vs_single", "BATCH_LENGTHS", "pscan_inputs",
    "BATCH_FULL_TOLERANCES", "batch_full_vs_plain", "batch_full_vs_single",
    "pscan_vs_plain", "bwd_guess",
    "joint_acc_vs_plain", "JOINT_ACC_ENTRY_RTOL", "JOINT_ACC_FLOOR",
    "band_vs_dense", "BAND_K2_ROWS", "STEP_RTOL", "STEP_TOLERANCES",
    "pfilter_step_check", "psmooth_step_check", "pscan_failures",
    "pscan_nvalid_vs_plain", "pscan_nvalid_failures",
    "subnormal_prior_smoothers", "CONFIG_MOVEMENT", "config_stack",
    "config_batch_vs_single", "kilosort_session", "SESSION_LABELS",
    "tmaze_session", "ach_session", "place_field_tuning",
    "bf16_gemm_case", "bf16_gemm_rtol", "bf16_gemm_vs_plain",
    "bf16_gemm_rows_alone",
]

#: kernel vs plain version (and port vs JAX): posteriors/priors/smoothed
#: values absolute, r relative where the prior and the smoothed numerator
#: are > 1e-30 (below that the numerator may be subnormal), summed log
#: ratios relative.  Sums run in another order on each side, so they agree
#: to f32 rounding, not bit for bit.
SCAN_TOLERANCES = {
    "post_abs": 1e-4, "prior_abs": 1e-4, "smooth_abs": 1e-4,
    "r_rel": 1e-4, "log_ratio_sum_rel": 1e-5,
}

#: constant (jump) channel / identical but non-constant rows / masked bins
SCAN_CASES = ("jump", "identical", "masked")
N_MASKED = 7


def _rbf(L, ls=1.0):
    x = np.arange(L, dtype=np.float32)
    g = np.exp(-((x[:, None] - x[None, :]) ** 2) / ls**2).astype(np.float32)
    return g / g.sum(axis=1, keepdims=True)


def _uniform(L):
    return np.full((L, L), 1.0 / L, dtype=np.float32)


def _identical(rng, L):
    row = rng.uniform(0.1, 1.0, L).astype(np.float32)
    return np.broadcast_to(row / row.sum(), (L, L)).copy()


def scan_case(seed, T, L, n_dyn, case):
    """One filter/smoother input set as float32 numpy arrays.

    ``case``: 'jump' holds a constant channel ([RBF, uniform] for n_dyn=2,
    [uniform] for n_dyn=1); 'identical' holds identical but non-constant
    rows in channel 0 (which must NOT take the constant shortcut);
    'masked' is the jump case with ``N_MASKED`` latent bins at
    ``MASK_NEG`` log-likelihood.  Returns a dict with ll (T, L), tlat
    (n_dyn, L, L), tdyn (n_dyn, n_dyn), p_init (n_dyn, L) and ``masked``
    (indices of masked bins)."""
    if case not in SCAN_CASES:
        raise ValueError(f"case must be one of {SCAN_CASES}, got {case!r}")
    rng = np.random.default_rng(seed)
    if case == "identical":
        mats = [_identical(rng, L), _rbf(L)]
    elif n_dyn == 1:
        mats = [_uniform(L)] if case == "jump" else [_rbf(L)]
    else:
        mats = [_rbf(L), _uniform(L)]
    tlat = np.stack(mats[:n_dyn])
    tdyn = (np.array([[0.98, 0.02], [0.05, 0.95]], dtype=np.float32)
            if n_dyn == 2 else np.ones((1, 1), dtype=np.float32))
    ll = (rng.normal(size=(T, L)) * 4.0 - 50.0).astype(np.float32)
    masked = np.array([], dtype=np.int64)
    if case == "masked":
        masked = np.sort(rng.choice(L, N_MASKED, replace=False))
        ll[:, masked] = MASK_NEG
    p_init = np.full((n_dyn, L), 1.0 / (n_dyn * L), dtype=np.float32)
    return {"ll": ll, "tlat": tlat, "tdyn": tdyn, "p_init": p_init,
            "masked": masked}


def _max_rel(a, b, where):
    """max |a - b| / |b| over ``where``; a nonzero a where b == 0 is inf."""
    a, b = a[where], b[where]
    diff = (a - b).abs()
    rel = torch.where(b != 0, diff / b.abs().clamp_min(1e-38),
                      torch.where(diff == 0, 0.0, float("inf")))
    return float(rel.max()) if rel.numel() else 0.0


def kernel_vs_plain(case, device):
    """Run K1 and K2 and their plain versions on the same inputs on
    ``device`` and return their largest disagreements: post/prior/smooth
    absolute, r relative (see ``SCAN_TOLERANCES``), the summed log ratios
    relative, and whether the masked bins came out as exact zeros."""
    t = {k: torch.as_tensor(v, device=device) for k, v in case.items()
         if k != "masked"}
    flags = sk._detect_uniform_rows(t["tlat"])
    m = t["ll"].amax(dim=1)
    w = torch.exp(t["ll"] - m[:, None]).contiguous()
    post_p, prior_p, s_p = sk.filter_scan_plain(w, t["tlat"], t["tdyn"],
                                                t["p_init"], flags)
    post_k, prior_k, s_k = sk.filter_scan(w, t["tlat"], t["tdyn"],
                                          t["p_init"], flags)
    lr_p = float((torch.log(s_p) + m).double().sum())
    lr_k = float((torch.log(s_k) + m).double().sum())

    filt, prior, init = (post_p[:-1].contiguous(), prior_p[1:].contiguous(),
                         post_p[-1].contiguous())
    tlat_t = t["tlat"].transpose(-1, -2).contiguous()
    sm_p, r_p = sk.smoother_scan_plain(filt, prior, tlat_t, t["tdyn"], init,
                                       flags)
    sm_k, r_k = sk.smoother_scan(filt, prior, tlat_t, t["tdyn"], init, flags)
    # r = smooth_{t+1} / prior_{t+1}; a subnormal numerator holds fewer
    # than 24 significant bits, so r is compared where both are > 1e-30
    nxt = torch.cat([sm_p[1:], init[None]])
    masked = torch.as_tensor(case["masked"], device=device)
    outs_k = (post_k, prior_k, s_k, sm_k, r_k)
    return {
        "post_abs": float((post_k - post_p).abs().max()),
        "prior_abs": float((prior_k - prior_p).abs().max()),
        "log_ratio_sum_rel": abs(lr_k - lr_p) / abs(lr_p),
        "smooth_abs": float((sm_k - sm_p).abs().max()),
        "r_rel": _max_rel(r_k, r_p, (prior > 1e-30) & (nxt > 1e-30)),
        "finite": all(bool(torch.isfinite(x).all()) for x in outs_k),
        "masked_exact_zero": bool(
            (post_k[..., masked] == 0).all() and (sm_k[..., masked] == 0).all()
        ),
    }


#: ragged lengths of a batch: a 1-bin sequence, a 2-bin one (one row to
#: smooth over), an odd longest length, and two sequences of equal length
BATCH_LENGTHS = (37, 1, 64, 2, 101, 64, 5)

#: ``hmm.smooth_batch_full`` through the kernels against the same through
#: their plain versions: posteriors absolute, log marginals relative, the
#: one-step log ratios, the pairwise joint and the log-likelihoods relative
#: to their largest magnitude
BATCH_FULL_TOLERANCES = {"post_abs": 1e-4, "lml_rel": 1e-5, "pred_rel": 1e-5,
                         "acc_rel": 1e-4, "ll_rel": 1e-5}


def _batch_full(model, y_b, device, trans):
    hyper = model._emission_hyper({})
    return hmm.smooth_batch_full(
        torch.as_tensor(y_b, dtype=torch.float32, device=device),
        model.tuning.to(device), hyper, trans,
        model.ma_neuron_default.to(device), model.ma_latent_default.to(device),
        observation_model=model.observation_model, engine="cuda")


def batch_full_vs_plain(model, y_b):
    """``hmm.smooth_batch_full`` of the sequences y_b (E, T, N) under the
    model's transition on its device (the kernels K1/K2 batched) against
    the same on CPU copies (their plain versions); the largest
    disagreements, keyed as ``BATCH_FULL_TOLERANCES``."""
    trans, _ = model._make_transition(model._emission_hyper({}))
    cpu = torch.device("cpu")
    trans_cpu = dataclasses.replace(trans, _band=None, **{
        f.name: getattr(trans, f.name).to(cpu)
        for f in dataclasses.fields(trans)
        if torch.is_tensor(getattr(trans, f.name))})
    got = [None if x is None else x.cpu()
           for x in _batch_full(model, y_b, model.device, trans)]
    want = _batch_full(model, y_b, cpu, trans_cpu)

    def norm_rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    return {
        "post_abs": float((torch.exp(got[0]) - torch.exp(want[0]))
                          .abs().max()),
        "lml_rel": float(((got[1] - want[1]).abs() / want[1].abs()).max()),
        "pred_rel": norm_rel(got[3], want[3]),
        "acc_rel": norm_rel(torch.exp(got[4]), torch.exp(want[4])),
        "ll_rel": norm_rel(got[5], want[5]),
    }


def batch_full_vs_single(model, y_b):
    """The outputs of ``hmm.smooth_batch_full`` (slots 0, 1, 3, 4, 5) on the
    model's device that differ from ``hmm.smooth_combined_chunked`` on each
    sequence alone through the sequential engine ('cuda' below
    ``hmm._PARALLEL_UPGRADE_MIN_T`` steps), as (sequence, slot, max
    |difference|) triples; empty when every sequence's rows are
    bit-equal."""
    trans, _ = model._make_transition(model._emission_hyper({}))
    dev = model.device
    got = _batch_full(model, y_b, dev, trans)
    diff = []
    for e in range(len(y_b)):
        alone = hmm.smooth_combined_chunked(
            torch.as_tensor(y_b[e], dtype=torch.float32, device=dev),
            model.tuning, model._emission_hyper({}), trans,
            model.ma_neuron_default, model.ma_latent_default,
            observation_model=model.observation_model, engine="cuda")
        diff += [(e, j, float((got[j][e] - alone[j]).abs().max()))
                 for j in (0, 1, 3, 4, 5)
                 if not torch.equal(got[j][e], alone[j])]
    return diff


def batch_vs_single(case, device, lengths=BATCH_LENGTHS):
    """Run K1 and K2 over a batch of sequences cut from ``case`` (sequence
    e takes the next ``lengths[e]`` rows of its log-likelihoods, and its
    own initial state) on ``device``, K2 in place on the slices of the
    plain filter's outputs, as ``hmm.smooth_epochs`` calls it.  Returns the
    largest disagreements with ``*_batch_plain`` over each sequence's own
    rows (as ``kernel_vs_plain``), whether each sequence's rows equal the
    unbatched wrapper's on that sequence alone bit for bit
    (``equal_single``), whether the own rows are finite, and whether the
    masked bins came out as exact zeros."""
    t = {k: torch.as_tensor(v, device=device) for k, v in case.items()
         if k != "masked"}
    flags = sk._detect_uniform_rows(t["tlat"])
    tlat_t = t["tlat"].transpose(-1, -2).contiguous()
    n_dyn, L = t["p_init"].shape
    E, Tmax = len(lengths), max(lengths)
    m = t["ll"].amax(dim=1)
    w = torch.exp(t["ll"] - m[:, None])
    w_b = torch.zeros((E, Tmax, L), device=device)
    init_b = torch.empty((E, n_dyn, L), device=device)
    off = 0
    for e, n in enumerate(lengths):
        w_b[e, :n] = w[off:off + n]
        head = w[off] + 1e-3  # an initial state of its own per sequence
        init_b[e] = (head / (n_dyn * head.sum())).expand(n_dyn, L)
        off += n
    init_b[:, :, torch.as_tensor(case["masked"], device=device)] = 0.0
    len_t = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    args_f = (w_b, t["tlat"], t["tdyn"], init_b, len_t, flags)
    post_p, prior_p, s_p = sk.filter_scan_batch_plain(*args_f)
    post_k, prior_k, s_k = sk.filter_scan_batch(*args_f)

    each = torch.arange(E, device=device)
    last = post_p[each, (len_t - 1).long()].contiguous()
    args_s = (post_p[:, :-1], prior_p[:, 1:], tlat_t, t["tdyn"], last,
              len_t - 1, flags)
    sm_p, r_p = sk.smoother_scan_batch_plain(*args_s)
    sm_k, r_k = sk.smoother_scan_batch(*args_s)

    masked = torch.as_tensor(case["masked"], device=device)
    err = {"post_abs": 0.0, "prior_abs": 0.0, "norm_rel": 0.0,
           "smooth_abs": 0.0, "r_rel": 0.0}
    equal = finite = zeros = True
    for e, n in enumerate(lengths):
        own = (post_k[e, :n], prior_k[e, :n], s_k[e, :n], sm_k[e, :n - 1],
               r_k[e, :n - 1])
        single = sk.filter_scan(w_b[e, :n].contiguous(), t["tlat"], t["tdyn"],
                                init_b[e].contiguous(), flags)
        single += sk.smoother_scan(
            post_p[e, :n - 1].contiguous(), prior_p[e, 1:n].contiguous(),
            tlat_t, t["tdyn"], last[e].contiguous(), flags)
        equal &= _all_equal(own, single)
        finite &= all(bool(torch.isfinite(x).all()) for x in own)
        zeros &= bool((own[0][..., masked] == 0).all()
                      and (own[3][..., masked] == 0).all())
        nxt = torch.cat([sm_p[e, 1:n - 1], last[e][None]])[:n - 1]
        prior_n = prior_p[e, 1:n]
        for key, got, want in (("post_abs", own[0], post_p[e, :n]),
                               ("prior_abs", own[1], prior_p[e, :n]),
                               ("smooth_abs", own[3], sm_p[e, :n - 1])):
            if want.numel():
                err[key] = max(err[key], float((got - want).abs().max()))
        err["norm_rel"] = max(err["norm_rel"], float(
            ((own[2] - s_p[e, :n]).abs() / s_p[e, :n]).max()))
        err["r_rel"] = max(err["r_rel"], _max_rel(
            own[4], r_p[e, :n - 1], (prior_n > 1e-30) & (nxt > 1e-30)))
    return {**err, "equal_single": bool(equal), "finite": bool(finite),
            "masked_exact_zero": bool(zeros)}


#: the one-step check (``pfilter_step_check``, ``psmooth_step_check``):
#: each row of a kernel's output recomputed by the plain arithmetic from
#: the kernel's own state of the step before, so that no difference is
#: carried from step to step.  ``step_*_frac`` is the share of entries more
#: than STEP_RTOL apart (relative): f32 sums in another order stay far
#: below it, while a dot in another precision moves nearly every entry
#: past it (bf16 against f32: ~2^-9).  ``step_*_rel`` is the largest
#: relative gap.
STEP_RTOL = 1e-5
STEP_TOLERANCES = {
    "step_post_frac": 1e-3, "step_r_frac": 1e-3, "step_smooth_frac": 1e-3,
    "step_post_rel": 1e-4, "step_r_rel": 1e-4, "step_smooth_rel": 1e-4,
}
#: K3/K4 vs their plain versions over whole passes: posteriors, smoothed
#: values, marginals and boundary carries absolute; r relative where the
#: prior and the numerator r*prior are > 1e-30 (as for K2); summed log
#: normalisers relative; the pairwise joint relative to its largest entry;
#: and the one-step check.
PSCAN_TOLERANCES = {
    "fwd_finals_abs": 1e-4, "post_abs": 1e-4, "log_norm_sum_rel": 1e-5,
    "bwd_finals_abs": 1e-4, "smooth_abs": 1e-4, "r_rel": 1e-4,
    "lat_abs": 1e-4, "dyn_abs": 1e-4, "acc_rel": 1e-4, **STEP_TOLERANCES,
}
#: "bf16x3": a dot is exact to the hi + lo split of its operands, 2^-17 of
#: each, not to f32 rounding.  The two versions form a vector operand in
#: another f32 order; 1 ulp apart, its lo part rounds to another bf16 about
#: once in 2^7, which moves that element by 2^-17 relative, and the
#: recursion carries such steps into the tails of r and of the smoothed
#: posterior (1.6e-4 relative at worst on the H100, where f32 gives 3e-6)
PSCAN_TOLERANCES_BF16X3 = dict(PSCAN_TOLERANCES, r_rel=1e-3, acc_rel=5e-4)
#: "bf16": one flipped rounding of a vector operand (an f32 sum in another
#: order, 1 ulp apart) moves that element by one bf16 ulp, 2^-8, and from
#: there the two versions round independently, so over a whole pass they
#: differ by the mode's own error wherever the chain mixes slowly (on the
#: H100 at T = 20,001: smoothed posterior 2.1e-3 and r 6.1e-2 for one
#: RBF channel at L = 100, 4e-6 with the jump channel; posterior 4.5e-4 at
#: T = 1e5).  Those whole-pass limits hold the kernel only to the mode's
#: error.  The one-step check holds its arithmetic: a step differs only
#: where its own operand's rounding flips (at most 2^-7 of the row; none
#: in the H100 runs), so the share limit stays and the largest gap of the
#: push rows (post, r) is 1e-2; the pull takes the kernel's own r, so it
#: keeps 1e-4.
PSCAN_TOLERANCES_BF16 = dict(
    PSCAN_TOLERANCES, post_abs=2e-3, smooth_abs=5e-3, lat_abs=5e-3,
    r_rel=1e-1, step_post_rel=1e-2, step_r_rel=1e-2)


def pscan_tolerances(scan_prec):
    """The kernel-vs-plain tolerances of K3/K4 in ``scan_prec``."""
    return {"highest": PSCAN_TOLERANCES, "bf16x3": PSCAN_TOLERANCES_BF16X3,
            "bf16": PSCAN_TOLERANCES_BF16}[scan_prec]


def pscan_inputs(case, device, C=None, scan_prec="highest"):
    """K3/K4 inputs of a ``scan_case`` on ``device``: C chunks (default:
    ``choose_parallel_config``'s), the likelihood weights, the transition
    stacks, and forward boundary carries converged by the plain K3 passes
    in ``scan_prec`` as ``smooth_parallel`` converges them.  (Emitting from
    unconverged carries would hand K4 chunk-first posteriors inconsistent
    with its recomputed priors, whose subnormal tails then overflow r.)"""
    t = {k: torch.as_tensor(v, device=device) for k, v in case.items()
         if k != "masked"}
    T, L = t["ll"].shape
    n_dyn = t["tlat"].shape[0]
    if C is None:
        C = ps.choose_parallel_config(T, L, n_dyn)[0]
    m = t["ll"].amax(dim=1)
    w = torch.exp(t["ll"] - m[:, None]).contiguous()
    tc = -(-T // C)
    flags = sk._detect_uniform_rows(t["tlat"])
    ins0 = torch.full((C, n_dyn, L), 1.0 / (n_dyn * L), device=device)
    ins0[0] = t["p_init"]
    ins, _, _ = ps._solve(
        lambda ins: ps.pfilter_pass_plain(w, t["tlat"], t["tdyn"], ins, tc,
                                          flags, False, scan_prec)[2],
        lambda fin: torch.cat([ins0[:1], fin[:-1]]), ins0, 1e-6, C)
    return {
        "w": w, "m": m, "tlat": t["tlat"],
        "tlat_t": t["tlat"].transpose(-1, -2).contiguous(),
        "tdyn": t["tdyn"], "ins": ins, "tc": tc, "flags": flags,
    }


def bwd_guess(post, tc, C):
    """The backward boundary carries ``smooth_parallel`` starts from."""
    T = post.shape[0]
    rows = torch.arange(1, C + 1, device=post.device) * tc
    guess = post[torch.clamp(rows, max=T - 1)].contiguous()
    guess[(T - 1) // tc:] = post[T - 1]
    return guess


class _StepStats:
    """Largest relative gap and count of entries more than STEP_RTOL
    apart, summed over slices of rows."""

    def __init__(self):
        self.rel, self.over, self.n = 0.0, 0, 0

    def add(self, got, want, where):
        a, b = got[where], want[where]
        if b.numel():
            rel = (a - b).abs() / b.abs()
            self.rel = max(self.rel, float(rel.max()))
            self.over += int((rel > STEP_RTOL).sum())
            self.n += b.numel()

    def out(self, name):
        return {f"step_{name}_rel": self.rel,
                f"step_{name}_frac": self.over / max(self.n, 1)}


def _slices(T, rows):
    for lo in range(0, T, rows):
        yield torch.arange(lo, min(T, lo + rows))


def pfilter_step_check(a, post, scan_prec, rows=1 << 16, n_valid=None):
    """The one-step check of K3's emitted posteriors ``post`` (T, n_dyn,
    L) on the inputs ``a`` of ``pscan_inputs``: row t recomputed by the
    plain arithmetic in ``scan_prec`` from the kernel's own row t-1 (the
    boundary carry at a chunk's first row), over entries > 1e-30, on the
    rows that are steps (t < ``n_valid``, default T).  Returns
    ``step_post_rel`` and ``step_post_frac`` (see ``STEP_TOLERANCES``)."""
    tc, tdyn, flags = a["tc"], a["tdyn"], a["flags"]
    nv = post.shape[0] if n_valid is None else n_valid
    splits = ps._splits(a["tlat"], scan_prec, None)
    stats = _StepStats()
    for idx in _slices(post.shape[0], rows):
        idx = idx.to(post.device)
        prev = torch.where((idx % tc == 0)[:, None, None], a["ins"][idx // tc],
                           post[(idx - 1).clamp(min=0)])
        u = ps._matvec(torch.einsum("tpl,pd->tdl", prev, tdyn), a["tlat"],
                       flags, scan_prec, splits) * a["w"][idx][:, None, :]
        want = u / torch.clamp(u.sum(dim=(1, 2), keepdim=True),
                               min=ps.NORM_FLOOR)
        stats.add(post[idx], want, (want > 1e-30)
                  & (idx < nv)[:, None, None])
    return stats.out("post")


def psmooth_step_check(a, post, ins_b, smooth, r, scan_prec, rows=1 << 16,
                       n_valid=None):
    """The one-step check of K4's full-mode outputs ``smooth`` and ``r``
    (T, n_dyn, L), run on the filter posteriors ``post`` from the boundary
    carries ``ins_b`` (``a`` as in ``pfilter_step_check``), in
    ``scan_prec``: at each step row t (< T-1), r recomputed from the
    kernel's smoothed posterior of row t+1 (the carry at a chunk's last
    row), and the smoothed posterior of row t pulled from the kernel's own
    r, so that no operand rounds differently in the pull; the steps are
    the rows t < ``n_valid`` - 1 (default T).  r is compared where the
    prior and the numerator are > 1e-30, smooth where > 1e-30.  Returns
    ``step_{r,smooth}_{rel,frac}``."""
    T = post.shape[0]
    nv = T if n_valid is None else n_valid
    tc, tdyn, flags = a["tc"], a["tdyn"], a["flags"]
    sp_f = ps._splits(a["tlat"], scan_prec, None)
    sp_b = ps._splits(a["tlat_t"], scan_prec, None)
    st_r, st_s = _StepStats(), _StepStats()
    for idx in _slices(T, rows):
        idx = idx.to(post.device)
        step = (idx < nv - 1)[:, None, None]
        # a chunk's last row (and the sequence's) reads the chunk's carry
        last = (idx % tc == tc - 1) | (idx == T - 1)
        carry = torch.where(last[:, None, None], ins_b[idx // tc],
                            smooth[(idx + 1).clamp(max=T - 1)])
        filt = post[idx]
        prior = ps._matvec(torch.einsum("tpl,pd->tdl", filt, tdyn),
                           a["tlat"], flags, scan_prec, sp_f)
        r_want = sk.smoother_ratio(carry, prior)
        st_r.add(r[idx], r_want, step & (prior > 1e-30)
                 & (r_want * prior > 1e-30))
        sm = filt * torch.einsum("de,tel->tdl", tdyn, ps._matvec(
            r[idx], a["tlat_t"], flags, scan_prec, sp_b))
        want = sm / torch.clamp(sm.sum(dim=(1, 2), keepdim=True),
                                min=ps.NORM_FLOOR)
        st_s.add(smooth[idx], want, step & (want > 1e-30))
    return {**st_r.out("r"), **st_s.out("smooth")}


def pscan_vs_plain(case, device, C=None, scan_prec="highest",
                   plain_prec=None, lean=False):
    """Run K3 (finals-only and emit) and K4 (finals-only, full, marginal
    and marginal+acc, the last through ``joint_acc``) in ``scan_prec`` and
    their plain versions in ``plain_prec`` (default: the same) on the same
    inputs on ``device`` (C chunks, see ``pscan_inputs``), K4 on the plain
    K3's posteriors, and return their largest disagreements (see
    ``pscan_tolerances``) with the one-step check of K3 emit and K4 full,
    whether every output is finite, whether masked bins came out as exact
    zeros, whether the finals of every mode of each kernel agree bit for
    bit, and whether the kernel's latent marginal equals the sum of its
    full-mode smoothed posterior bit for bit (the same recursion, other
    stores).  ``lean``: K3 emit and K4 full and marginal only (the modes
    of the fits' E-steps), held on the posteriors, marginals, finals and
    the one-step check, for the longest shapes."""
    plain_prec = plain_prec or scan_prec
    a = pscan_inputs(case, device, C, scan_prec)
    fwd = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
    post_p, norm_p, fin_p = ps.pfilter_pass_plain(*fwd, True, plain_prec)
    post_k, norm_k, fin_k = ps.pfilter_pass(*fwd, True, scan_prec)
    lr_p = float((torch.log(norm_p) + a["m"]).double().sum())
    lr_k = float((torch.log(norm_k) + a["m"]).double().sum())
    del norm_p, norm_k
    err = {
        "fwd_finals_abs": float((fin_k - fin_p).abs().max()),
        "post_abs": float((post_k - post_p).abs().max()),
        "log_norm_sum_rel": abs(lr_k - lr_p) / abs(lr_p),
        **pfilter_step_check(a, post_k, plain_prec),
    }
    finite = bool(torch.isfinite(post_k).all() and torch.isfinite(fin_k).all())
    masked = torch.as_tensor(case["masked"], device=device)
    zeros = bool((post_k[..., masked] == 0).all())
    del post_k

    C = a["ins"].shape[0]
    ins_b = bwd_guess(post_p, a["tc"], C)
    bwd = (post_p, a["tlat"], a["tlat_t"], a["tdyn"], ins_b, a["tc"],
           a["flags"])
    sm_k, r_k, bfin_k = ps.psmooth_pass(*bwd, "full", scan_prec)
    err.update(psmooth_step_check(a, post_p, ins_b, sm_k, r_k, plain_prec))
    lat_k, dyn_k, bfin_km = ps.psmooth_pass(*bwd, "marginal", scan_prec)
    finite &= all(bool(torch.isfinite(x).all())
                  for x in (sm_k, r_k, bfin_k, lat_k, dyn_k))
    zeros &= bool((sm_k[..., masked] == 0).all()
                  and (lat_k[..., masked] == 0).all())
    exact = torch.equal(lat_k, sm_k.sum(dim=1))
    agree = torch.equal(bfin_km, bfin_k)
    if lean:
        del r_k, sm_k
        lat_p, dyn_p, bfin_p = ps.psmooth_pass_plain(*bwd, "marginal",
                                                     plain_prec)
    else:
        sm_p, r_p, bfin_p = ps.psmooth_pass_plain(*bwd, "full", plain_prec)
        lat_p, dyn_p, acc_p, _ = ps.psmooth_pass_plain(*bwd, "marginal_acc",
                                                       plain_prec)
        _, _, fin_k0 = ps.pfilter_pass(*fwd, False, scan_prec)
        _, _, bfin_k0 = ps.psmooth_pass(*bwd, "finals", scan_prec)
        lat_ka, dyn_ka, acc_k, bfin_ka = ps.psmooth_pass(
            *bwd, "marginal_acc", scan_prec)
        prior = ps._matvec(torch.einsum("tpl,pd->tdl", post_p, a["tdyn"]),
                           a["tlat"], a["flags"], plain_prec)
        where = (prior > 1e-30) & ((r_p * prior) > 1e-30)
        err.update({
            "smooth_abs": float((sm_k - sm_p).abs().max()),
            "r_rel": _max_rel(r_k, r_p, where),
            "acc_rel": float((acc_k - acc_p).abs().max()
                             / acc_p.abs().max()),
        })
        finite &= bool(torch.isfinite(acc_k).all())
        agree &= bool(torch.equal(fin_k0, fin_k) and torch.equal(bfin_k0,
                                                                 bfin_k)
                      and torch.equal(bfin_ka, bfin_k))
        exact &= bool(torch.equal(lat_ka, lat_k) and torch.equal(dyn_ka,
                                                                 dyn_k))
        # the marginals of both marginal modes are held below
        lat_k = torch.stack([lat_k, lat_ka])
        dyn_k = torch.stack([dyn_k, dyn_ka])
    err.update({
        "bwd_finals_abs": float((bfin_k - bfin_p).abs().max()),
        "lat_abs": float((lat_k - lat_p).abs().max()),
        "dyn_abs": float((dyn_k - dyn_p).abs().max()),
        "finite": finite, "masked_exact_zero": zeros,
        "modes_agree": bool(agree), "marginal_exact": bool(exact),
    })
    return err


def _passed_through(a, out, ins, first, rows_nv):
    """Whether every row of ``out`` (T, n_dyn, L) at or past ``rows_nv``
    holds, bit for bit, the row a pass-through gives: the row before it in
    its chunk (``first``: K3, from the chunk's first row on) or after it
    (K4), or the chunk's carry ``ins`` at the chunk's edge."""
    T, tc = out.shape[0], a["tc"]
    idx = torch.arange(T, device=out.device)
    if first:
        edge = idx % tc == 0
        nb = out[(idx - 1).clamp(min=0)]
    else:
        edge = (idx % tc == tc - 1) | (idx == T - 1)
        nb = out[(idx + 1).clamp(max=T - 1)]
    want = torch.where(edge[:, None, None], ins[idx // tc], nb)
    past = idx >= rows_nv
    return bool(torch.equal(out[past], want[past]))


def pscan_nvalid_vs_plain(case, device, n_valid, scan_prec="highest",
                          plain_n_valid=None):
    """K3 (finals-only and emit) with the validity bound min(``n_valid``,
    T) and K4 (finals-only and full) with ``n_valid`` (up to T + 1: every
    row recurses, the last from its chunk's carry), in ``scan_prec``,
    against their plain versions at ``plain_n_valid`` (default the same;
    another bound is the failing control) on the inputs of
    ``pscan_inputs``.  Returns the disagreements of ``pscan_vs_plain``'s
    keys that these modes give, the one-step check over the steps, and
    ``passthrough_exact``: whether the kernel's rows past the steps hold
    the passed-through carry bit for bit, with norm 1 (K3) and r = 0
    (K4)."""
    plain_nv = n_valid if plain_n_valid is None else plain_n_valid
    a = pscan_inputs(case, device, None, scan_prec)
    T = a["w"].shape[0]
    nv_f, pnv_f = min(n_valid, T), min(plain_nv, T)
    fwd = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
    post_p, norm_p, fin_p = ps.pfilter_pass_plain(*fwd, True, scan_prec,
                                                  n_valid=pnv_f)
    post_k, norm_k, fin_k = ps.pfilter_pass(*fwd, True, scan_prec,
                                            n_valid=nv_f)
    _, _, fin_k0 = ps.pfilter_pass(*fwd, False, scan_prec, n_valid=nv_f)
    lr_p = float((torch.log(norm_p) + a["m"]).double().sum())
    lr_k = float((torch.log(norm_k) + a["m"]).double().sum())
    err = {
        "fwd_finals_abs": float((fin_k - fin_p).abs().max()),
        "post_abs": float((post_k - post_p).abs().max()),
        "log_norm_sum_rel": abs(lr_k - lr_p) / abs(lr_p),
        **pfilter_step_check(a, post_k, scan_prec, n_valid=nv_f),
    }
    idx = torch.arange(T, device=post_k.device)
    through = (_passed_through(a, post_k, a["ins"], True, nv_f)
               and bool((norm_k[idx >= nv_f] == 1.0).all()))
    C = a["ins"].shape[0]
    ins_b = bwd_guess(post_p, a["tc"], C)
    bwd = (post_p, a["tlat"], a["tlat_t"], a["tdyn"], ins_b, a["tc"],
           a["flags"])
    sm_k, r_k, bfin_k = ps.psmooth_pass(*bwd, "full", scan_prec,
                                        n_valid=n_valid)
    _, _, bfin_k0 = ps.psmooth_pass(*bwd, "finals", scan_prec,
                                    n_valid=n_valid)
    sm_p, r_p, bfin_p = ps.psmooth_pass_plain(*bwd, "full", scan_prec,
                                              n_valid=plain_nv)
    err.update(psmooth_step_check(a, post_p, ins_b, sm_k, r_k, scan_prec,
                                  n_valid=n_valid))
    prior = ps._matvec(torch.einsum("tpl,pd->tdl", post_p, a["tdyn"]),
                       a["tlat"], a["flags"], scan_prec)
    where = (prior > 1e-30) & ((r_p * prior) > 1e-30)
    err.update({
        "bwd_finals_abs": float((bfin_k - bfin_p).abs().max()),
        "smooth_abs": float((sm_k - sm_p).abs().max()),
        "r_rel": _max_rel(r_k, r_p, where),
    })
    through &= (_passed_through(a, sm_k, ins_b, False, n_valid - 1)
                and bool((r_k[idx >= n_valid - 1] == 0).all()))
    finite = all(bool(torch.isfinite(x).all())
                 for x in (post_k, norm_k, fin_k, sm_k, r_k, bfin_k))
    return {**err, "finite": finite, "passthrough_exact": through,
            "modes_agree": bool(torch.equal(fin_k0, fin_k)
                                and torch.equal(bfin_k0, bfin_k))}


def pscan_nvalid_failures(err, scan_prec):
    """The keys of ``pscan_nvalid_vs_plain``'s result that break the
    tolerances of ``scan_prec`` or its boolean checks."""
    bad = [k for k, tol in pscan_tolerances(scan_prec).items()
           if k in err and not err[k] <= tol]
    return bad + [k for k in ("finite", "passthrough_exact", "modes_agree")
                  if not err[k]]


def pscan_failures(err, scan_prec):
    """The keys of ``pscan_vs_plain``'s result that break the tolerances
    of ``scan_prec`` (keys a lean run does not report are skipped) or its
    boolean checks."""
    bad = [k for k, tol in pscan_tolerances(scan_prec).items()
           if k in err and not err[k] <= tol]
    return bad + [k for k in ("finite", "masked_exact_zero", "modes_agree",
                              "marginal_exact") if not err[k]]


#: joint_acc against its plain version (the f32 einsum), per entry,
#: relative, over entries above JOINT_ACC_FLOOR of the largest.  3xTF32
#: drops only lo.lo (2^-22 of a product), so both sides are f32 sums in
#: another order: 0.76-1.78e-6 on the H100 at T = 20,001 (L = 100, 500;
#: n_dyn = 1, 2).  One TF32 product (hi.hi, the control) rounds each
#: operand to 11 bits: 1.49-1.83e-5 there.  The limit sits between, 2.2x
#: above the worst 3xTF32 reading and 3.7x below the best control reading.
JOINT_ACC_ENTRY_RTOL = 4e-6
JOINT_ACC_FLOOR = 1e-6


def joint_acc_vs_plain(seed, T, L, n_dyn, device, passes=3):
    """``joint_acc`` and its plain version on seeded (T, n_dyn, L) inputs
    shaped like K4's (posterior rows summing to 1, ratios around 1 with
    exact zeros): the largest difference relative to the largest entry
    (``acc_rel``), the largest per-entry relative difference over entries
    above ``JOINT_ACC_FLOOR`` of the largest (``acc_entry_rel``), and
    whether two runs agree bit for bit (no atomics).  ``passes=1`` runs the
    kernel's one-pass control (hi.hi only) in place of the wrapper."""
    rng = np.random.default_rng(seed)
    post = rng.dirichlet(np.ones(n_dyn * L), T).reshape(T, n_dyn, L)
    r = rng.gamma(2.0, 0.5, size=(T, n_dyn, L)) * (rng.random(
        (T, n_dyn, L)) > 0.1)
    post = torch.as_tensor(post.astype(np.float32), device=device)
    r = torch.as_tensor(r.astype(np.float32), device=device)
    want = ps.joint_acc_plain(post, r)

    def run():
        return ps.joint_acc(post, r) if passes == 3 \
            else ps._joint_acc_run(post, r, passes)

    got = run()
    again = run()
    big = want.abs().max()
    where = want.abs() > JOINT_ACC_FLOOR * big
    return {
        "acc_rel": float((got - want).abs().max() / big),
        "acc_entry_rel": _max_rel(got, want, where),
        "repeatable": bool(torch.equal(got, again)),
    }


def _present(outs):
    return [x for x in outs if x is not None]


def _all_equal(got, want):
    return len(got) == len(want) and all(
        torch.equal(g, w) for g, w in zip(got, want))


#: rows of the sequential kernels' band-vs-dense runs (forced dense they
#: stream a whole channel per step at L = 500)
BAND_K2_ROWS = 4000


def band_vs_dense(case, device, scan_prec="highest"):
    """K3 (finals-only, emit), K4 (every mode) and, in "highest" (their only
    precision), K1 and K2, each on the band and forced dense
    (``set_band_override(True)``), on the same inputs (the converged
    forward carries of ``case``, K3's plain posteriors,
    ``smooth_parallel``'s first backward guess; K1 on the first
    ``BAND_K2_ROWS`` weight rows, K2 on the first ``BAND_K2_ROWS``
    posteriors and their pushed priors): whether every output is bit-equal
    (``equal_by_mode``: "k3_finals", "k3_emit", K4's modes, "k1", "k2"),
    whether every output is finite, masked bins exact zeros and K2's r
    zero where the prior is below ``PRIOR_FLOOR``, and the heights W of the two bands."""
    a = pscan_inputs(case, device, None, scan_prec)
    fwd = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
    post = ps.pfilter_pass_plain(*fwd, True, scan_prec)[0]
    bwd = (post, a["tlat"], a["tlat_t"], a["tdyn"],
           bwd_guess(post, a["tc"], a["ins"].shape[0]), a["tc"], a["flags"])
    masked = torch.as_tensor(case["masked"], device=device)
    band = ps.transition_band(a["tlat"], a["tlat_t"], a["flags"], scan_prec)
    ps.set_band_override(True)
    try:
        dense = ps.transition_band(a["tlat"], a["tlat_t"], a["flags"],
                                   scan_prec)
    finally:
        ps.set_band_override(False)
    equal, finite, zeros = {}, True, True

    def hold(name, run, zero_in=None):
        nonlocal finite, zeros
        got, want = _present(run(band)), _present(run(dense))
        equal[name] = _all_equal(got, want)
        finite &= all(bool(torch.isfinite(g).all()) for g in got)
        if zero_in is not None:
            zeros &= bool((got[zero_in][..., masked] == 0).all())
        return got

    hold("k3_finals", lambda b: ps.pfilter_pass(*fwd, False, scan_prec,
                                                band=b))
    hold("k3_emit", lambda b: ps.pfilter_pass(*fwd, True, scan_prec, band=b),
         zero_in=0)
    for mode in ps.PSMOOTH_MODES:
        hold(mode, lambda b, mode=mode: ps.psmooth_pass(*bwd, mode,
                                                        scan_prec, band=b),
             zero_in=0 if mode in ("full", "marginal") else None)
    if scan_prec == "highest":
        n = min(BAND_K2_ROWS, post.shape[0] - 1)
        hold("k1", lambda b: sk.filter_scan(
            a["w"][:n].contiguous(), a["tlat"], a["tdyn"],
            a["ins"][0].contiguous(), a["flags"], band=b), zero_in=0)
        filt = post[:n].contiguous()
        prior = ps._matvec(torch.einsum("tpl,pd->tdl", filt, a["tdyn"]),
                           a["tlat"], a["flags"]).contiguous()
        init = post[n].contiguous()
        _, r = hold("k2", lambda b: sk.smoother_scan(
            filt, prior, a["tlat_t"], a["tdyn"], init, a["flags"], band=b),
            zero_in=0)
        zeros &= bool((r[prior < sk.PRIOR_FLOOR] == 0).all())
    return {"band_equal_dense": all(equal.values()), "equal_by_mode": equal,
            "finite": finite, "masked_exact_zero": zeros, "W": band.W,
            "W_dense": dense.W}


def smoother_push_vs(case, device, filt_dtype=torch.float32):
    """K2 with the prior recomputed (``sk.smoother_push_scan``) on the
    filter posteriors that K1 gives for ``case`` on ``device``, stored in
    ``filt_dtype`` (float32: 'filter'; bfloat16: 'filter_bf16'): against
    its plain version on the same inputs (``SCAN_TOLERANCES``' smooth_abs
    and r_rel), against K2 on the priors K1 wrote (``equal_k2``: bit for
    bit, f32 only), and on the band against the same kernel forced dense
    (``band_equal_dense``: bit for bit).  Also whether every output is
    finite and the masked bins exact zeros."""
    t = {k: torch.as_tensor(v, device=device) for k, v in case.items()
         if k != "masked"}
    flags = sk._detect_uniform_rows(t["tlat"])
    m = t["ll"].amax(dim=1)
    w = torch.exp(t["ll"] - m[:, None]).contiguous()
    post, prior, _ = sk.filter_scan(w, t["tlat"], t["tdyn"], t["p_init"],
                                    flags)
    filt = post[:-1].to(filt_dtype).contiguous()
    init = post[-1].contiguous()
    tlat, tdyn = t["tlat"], t["tdyn"]
    tlat_t = tlat.transpose(-1, -2).contiguous()
    args = (filt, tlat, tlat_t, tdyn, init, flags)
    sm_p, r_p = sk.smoother_push_scan_plain(*args)
    band = bd.transition_band(tlat, tlat_t, flags)
    bd.set_band_override(True)
    try:
        dense = bd.transition_band(tlat, tlat_t, flags)
    finally:
        bd.set_band_override(False)
    sm_k, r_k = sk.smoother_push_scan(*args, band=band)
    sm_d, r_d = sk.smoother_push_scan(*args, band=dense)
    nxt = torch.cat([sm_p[1:], init[None]])
    masked = torch.as_tensor(case["masked"], device=device)
    out = {
        "smooth_abs": float((sm_k - sm_p).abs().max()),
        "r_rel": _max_rel(r_k, r_p, (prior[1:] > 1e-30) & (nxt > 1e-30)),
        "band_equal_dense": _all_equal([sm_k, r_k], [sm_d, r_d]),
        "finite": bool(torch.isfinite(sm_k).all() and torch.isfinite(r_k).all()),
        "masked_exact_zero": bool((sm_k[..., masked] == 0).all()),
    }
    if filt_dtype == torch.float32:
        sm_2, r_2 = sk.smoother_scan(post[:-1].contiguous(),
                                     prior[1:].contiguous(), tlat_t, tdyn,
                                     init, flags, band=band)
        out["equal_k2"] = _all_equal([sm_k, r_k], [sm_2, r_2])
    return out


def memory_mode_peaks(run, modes):
    """``run(mode)`` for each memory mode in turn on the sequential kernels
    K1/K2 (the parallel engine's upgrade off) on the current CUDA card:
    the peak allocation above what was live before each call, the call's
    seconds and its result.  Returns {mode: (peak_bytes, seconds, out)};
    each result stays live, so later peaks are measured above it."""
    saved = hmm._PARALLEL_UPGRADE_MIN_T
    hmm._PARALLEL_UPGRADE_MIN_T = float("inf")
    res = {}
    try:
        for mode in modes:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = run(mode)
            torch.cuda.synchronize()
            res[mode] = (torch.cuda.max_memory_allocated() - base,
                         time.perf_counter() - t0, out)
    finally:
        hmm._PARALLEL_UPGRADE_MIN_T = saved
    return res


def subnormal_prior_smoothers(device):
    """One backward step whose prior has a subnormal entry under a carry of
    normal size, through K2 (``smoother_scan``), K4 (``psmooth_pass``,
    "full") and the 'prob' engine's scan, on ``device`` (on the CPU the
    wrappers run their plain versions): L = 6, n_dyn = 1, the filter
    posterior on bin 0, a transition from bin 0 to bin 5 of 1e-41 (so the
    prior there is 1e-41), the carry 0.5 on bin 5.  Without
    ``PRIOR_FLOOR`` the ratio there is inf and the row NaN; with it r = 0
    there.  Returns {name: (smoothed row (L,), r (L,))} and the inputs
    (filt (L,), prior (L,), carry (L,), tlat (L, L))."""
    L = 6
    tlat = torch.eye(L, device=device)
    tlat[0] = torch.tensor([0.6, 0.4, 0.0, 0.0, 0.0, 1e-41], device=device)
    filt = torch.zeros(L, device=device)
    filt[0] = 1.0
    carry = torch.tensor([0.2, 0.3, 0.0, 0.0, 0.0, 0.5], device=device)
    prior = tlat[0].clone()  # push(filt) = row 0
    tlat3, tlat_t = tlat[None], tlat.T.contiguous()[None]
    tdyn, flags = torch.ones((1, 1), device=device), (False,)
    sm2, r2 = sk.smoother_scan(filt[None, None], prior[None, None], tlat_t,
                               tdyn, carry[None], flags)
    # K4 on one chunk of two rows: row 0 is a step from the carry ins,
    # row 1 (the last) passes it through
    sm4, r4, _ = ps.psmooth_pass(torch.stack([filt, carry])[:, None],
                                 tlat3, tlat_t, tdyn, carry[None, None], 2,
                                 flags, "full")
    trans = hmm.LatentTransition(T=tlat, logT=torch.log(tlat))
    smp, rp = hmm._backward_scan_prob_ratios(filt[None], prior[None], trans,
                                             carry)
    outs = {"K2": (sm2[0, 0], r2[0, 0]), "K4": (sm4[0, 0], r4[0, 0]),
            "prob": (smp[0], rp[0])}
    return outs, (filt, prior, carry, tlat)


#: movement channel lengthscales of a mixed-band launch: the RBF's band is
#: W = 11, 21, 41, 81 rows (``bench.py``'s sweep grid, 0.5 ... 4)
CONFIG_MOVEMENT = (0.5, 1.0, 2.0, 4.0)


def config_stack(L, device, movement=CONFIG_MOVEMENT,
                 p_move_to_jump=(0.005, 0.01, 0.02, 0.05)):
    """The transition stacks of the jump model over ``movement`` and
    ``p_move_to_jump`` (paired in order): tlat (G, 2, L, L) and tdyn (G,
    2, 2) on ``device``."""
    from poor_man_gplvm_tpu_torch.ops import kernels as gpk

    lats, dyns = [], []
    for mv, pj in zip(movement, p_move_to_jump):
        lat, _, dyn, _ = gpk.create_transition_prob_1d(
            torch.arange(L, device=device), torch.arange(2, device=device),
            mv, pj, 0.01)
        lats.append(lat)
        dyns.append(dyn)
    return torch.stack(lats).contiguous(), torch.stack(dyns).contiguous()


def config_batch_vs_single(device, L=500, lengths=(301, 37, 301, 2, 299,
                                                   301, 1, 150),
                           seed=0, movement=CONFIG_MOVEMENT):
    """K1 and K2 over a batch whose sequences each run under their own
    transition configuration (sequence e under configuration e mod G of
    ``config_stack``, the bands padded to the widest) on ``device``:
    held against ``*_batch_plain`` with the same index (as
    ``kernel_vs_plain``), each sequence's rows bit for bit against the
    unbatched kernel under its own configuration alone (on its own,
    narrower band: ``equal_single``), the norm-only K1's normalisers
    against the full K1's (``norm_only_equal``), and a launch without a
    configuration index against the same launch through a stack of one
    (``shared_equal``).  Also finite rows and the band heights W of each
    configuration alone and of the stack."""
    rng = np.random.default_rng(seed)
    tlat, tdyn = config_stack(L, device, movement)
    G = tlat.shape[0]
    flags = sk._detect_uniform_rows(tlat[0])
    tlat_t = tlat.transpose(-1, -2).contiguous()
    E, Tmax = len(lengths), max(lengths)
    ll = torch.as_tensor(
        (rng.normal(size=(E, Tmax, L)) * 4.0 - 50.0).astype(np.float32),
        device=device)
    w = torch.exp(ll - ll.amax(dim=2, keepdim=True))
    len_t = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    cfg = torch.arange(E, dtype=torch.int32, device=device) % G
    init = torch.full((E, 2, L), 1.0 / (2 * L), device=device)
    band = bd.transition_band(tlat, tlat_t, flags)
    args_f = (w, tlat, tdyn, init, len_t, flags)
    post_p, prior_p, s_p = sk.filter_scan_batch_plain(*args_f, cfg=cfg)
    post_k, prior_k, s_k = sk.filter_scan_batch(*args_f, band=band, cfg=cfg)
    s_n = sk.filter_scan_batch(*args_f, band=band, cfg=cfg,
                               norm_only=True)[2]
    each = torch.arange(E, device=device)
    last = post_p[each, (len_t - 1).long()].contiguous()
    args_s = (post_p[:, :-1], prior_p[:, 1:], tlat_t, tdyn, last, len_t - 1,
              flags)
    sm_p, r_p = sk.smoother_scan_batch_plain(*args_s, cfg=cfg)
    sm_k, r_k = sk.smoother_scan_batch(*args_s, band=band, cfg=cfg)

    err = {"post_abs": 0.0, "prior_abs": 0.0, "norm_rel": 0.0,
           "smooth_abs": 0.0, "r_rel": 0.0}
    equal = finite = norm_equal = True
    W_single = []
    for g in range(G):
        W_single.append(bd.transition_band(tlat[g], tlat_t[g], flags).W)
    for e, n in enumerate(lengths):
        g = int(cfg[e])
        own = (post_k[e, :n], prior_k[e, :n], s_k[e, :n], sm_k[e, :n - 1],
               r_k[e, :n - 1])
        alone = bd.transition_band(tlat[g], tlat_t[g], flags)
        single = sk.filter_scan(w[e, :n].contiguous(), tlat[g], tdyn[g],
                                init[e].contiguous(), flags, band=alone)
        single += sk.smoother_scan(
            post_p[e, :n - 1].contiguous(), prior_p[e, 1:n].contiguous(),
            tlat_t[g], tdyn[g], last[e].contiguous(), flags, band=alone)
        equal &= _all_equal(own, single)
        norm_equal &= bool(torch.equal(s_n[e, :n], s_k[e, :n]))
        finite &= all(bool(torch.isfinite(x).all()) for x in own)
        nxt = torch.cat([sm_p[e, 1:n - 1], last[e][None]])[:n - 1]
        for key, got, want in (("post_abs", own[0], post_p[e, :n]),
                               ("prior_abs", own[1], prior_p[e, :n]),
                               ("smooth_abs", own[3], sm_p[e, :n - 1])):
            if want.numel():
                err[key] = max(err[key], float((got - want).abs().max()))
        err["norm_rel"] = max(err["norm_rel"], float(
            ((own[2] - s_p[e, :n]).abs() / s_p[e, :n]).max()))
        err["r_rel"] = max(err["r_rel"], _max_rel(
            own[4], r_p[e, :n - 1], (prior_p[e, 1:n] > 1e-30) & (nxt > 1e-30)))

    # no index against a stack of one under index 0
    zero = torch.zeros(E, dtype=torch.int32, device=device)
    shared = sk.filter_scan_batch(w, tlat[1], tdyn[1], init, len_t, flags)
    stacked = sk.filter_scan_batch(w, tlat[1:2], tdyn[1:2], init, len_t,
                                   flags, cfg=zero)
    shared += sk.smoother_scan_batch(post_p[:, :-1], prior_p[:, 1:],
                                     tlat_t[1], tdyn[1], last, len_t - 1,
                                     flags)
    stacked += sk.smoother_scan_batch(post_p[:, :-1], prior_p[:, 1:],
                                      tlat_t[1:2], tdyn[1:2], last,
                                      len_t - 1, flags, cfg=zero)
    shared_equal = all(
        torch.equal(a[e, :n - (i >= 3)], b[e, :n - (i >= 3)])
        for i, (a, b) in enumerate(zip(shared, stacked))
        for e, n in enumerate(lengths))
    return {**err, "equal_single": bool(equal),
            "norm_only_equal": bool(norm_equal), "finite": bool(finite),
            "shared_equal": bool(shared_equal), "W": band.W,
            "W_single": W_single}


#: probe-local unit index -> Kilosort label; every other unit is "good"
SESSION_LABELS = {2: "mua", 3: "mua", 4: "noise"}


def kilosort_session(root, n_probes=2, n_units=250, duration_s=1200.0,
                     dt=0.01, n_latent_bin=101, rate_hz=5.0,
                     burst_every_s=4.0, burst_bins=12, burst_gain=5.0,
                     seed=0, fs=30000.0):
    """Write a seeded Kilosort session of ``n_probes`` probes of
    ``n_units`` units each under ``root/probe{p}`` and return what made it.

    One ``PoissonGPLVMJump1D(n_probes * n_units, n_latent_bin,
    tuning_lengthscale=5)`` on the CPU samples the (dynamics, latent) path
    over T = duration_s / dt bins; each unit's rate is its tuning curve
    along the path scaled to a mean of ``rate_hz``, times ``burst_gain``
    for ``burst_bins`` bins every ``burst_every_s`` seconds (population
    bursts; probe p's lag p bins, as ``examples/10`` puts them in).  Spike
    counts are Poisson, spike times uniform within their bin, stored as
    samples at ``fs`` (``spike_times.npy``, int64) with their cluster ids
    (``spike_clusters.npy``, int32), labels in ``cluster_KSLabel.tsv``
    (``SESSION_LABELS``), ``params.py`` with ``sample_rate``.  On every
    probe unit 0 fires only in the first fifth of the session (presence
    ratio 0.2) and unit 1 at 1 % of ``rate_hz`` (below the pipeline's 500
    spikes); unit 5 fires once in the middle of the last bin, so every
    probe bins to the same T - 1 windows.

    Returns a dict: ``dirs`` (one per probe), ``latent`` (T, 2) int64,
    ``position`` (T,) float (the latent bin), ``burst_starts`` (bin
    indices), ``n_spikes``, ``T``, ``dt``."""
    from poor_man_gplvm_tpu_torch.models.jump1d import PoissonGPLVMJump1D

    T = int(round(duration_s / dt))
    model = PoissonGPLVMJump1D(n_probes * n_units, n_latent_bin=n_latent_bin,
                               tuning_lengthscale=5.0, device="cpu")
    latent = model.sample_latent(
        T, torch.Generator().manual_seed(seed)).numpy()
    tuning = model.tuning.double().numpy()
    rng = np.random.default_rng(seed)
    every = int(round(burst_every_s / dt))
    starts = np.arange(every // 2, T - burst_bins - n_probes, every)
    starts = starts + rng.integers(0, every // 4, starts.size)
    dirs, n_spikes = [], 0
    for p in range(n_probes):
        cols = slice(p * n_units, (p + 1) * n_units)
        rate = tuning[latent[:, 1], cols]
        rate *= rate_hz * dt / rate.mean(axis=0)
        rate[:, 1] *= 0.01
        rate[T // 5:, 0] = 0.0
        gain = np.ones(T)
        for s in starts + p:
            gain[s:s + burst_bins] = burst_gain
        counts = rng.poisson(rate * gain[:, None])
        counts[-1, 5] = 0
        t_idx, unit = np.nonzero(counts)
        reps = counts[t_idx, unit]
        t_idx, unit = np.repeat(t_idx, reps), np.repeat(unit, reps)
        times = (t_idx + rng.random(t_idx.size)) * dt
        times = np.append(times, (T - 0.5) * dt)
        unit = np.append(unit, 5)
        order = np.argsort(times, kind="stable")
        d = os.path.join(root, f"probe{p}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "spike_times.npy"),
                np.round(times[order] * fs).astype(np.int64))
        np.save(os.path.join(d, "spike_clusters.npy"),
                unit[order].astype(np.int32))
        with open(os.path.join(d, "params.py"), "w") as f:
            f.write(f"dat_path = 'probe{p}.bin'\nn_channels_dat = 384\n"
                    f"sample_rate = {fs}\n")
        with open(os.path.join(d, "cluster_KSLabel.tsv"), "w") as f:
            f.write("cluster_id\tKSLabel\n" + "".join(
                f"{u}\t{SESSION_LABELS.get(u, 'good')}\n"
                for u in range(n_units)))
        dirs.append(d)
        n_spikes += times.size
    return {"dirs": dirs, "latent": latent,
            "position": latent[:, 1].astype(float), "burst_starts": starts,
            "n_spikes": n_spikes, "T": T, "dt": dt}


def place_field_tuning(n_neuron, n_latent_bin, rng, peak_hz=15.0,
                       base_hz=0.3, width_bins=None):
    """(L, N) firing rates in Hz: one Gaussian place field per neuron on
    the latent axis (centres uniform over the bins, width ``width_bins``,
    3 % of L by default) over a baseline."""
    width = max(1.0, 0.03 * n_latent_bin) if width_bins is None \
        else width_bins
    centres = rng.uniform(0, n_latent_bin, n_neuron)
    bins = np.arange(n_latent_bin)[:, None]
    return base_hz + peak_hz * np.exp(-0.5 * ((bins - centres) / width) ** 2)


#: the linearised T-maze of the reference's helpers (``plotting.backup``
#: sections): home 0-15, central 15-74, T 74-111, return side 111-185,
#: return central 185-222; the reward zone 109-113 is the end of the T arm
TMAZE_LENGTH = 222.0
TMAZE_STEM = 74.0
TMAZE_REWARD = (109.0, 113.0)


def _tmaze_xy(lin, arm):
    """2-D position of linearised position ``lin`` on arm 0 (left) or 1
    (right): up the stem, out along the T, down the return side, back
    along the bottom to home."""
    side = np.where(arm == 1, 1.0, -1.0)
    arm_len = TMAZE_REWARD[1] - TMAZE_STEM + 2.0  # 41: along the T
    x = np.zeros_like(lin)
    y = np.zeros_like(lin)
    stem = lin < TMAZE_STEM
    y[stem] = lin[stem]
    t_arm = (lin >= TMAZE_STEM) & (lin < TMAZE_STEM + arm_len)
    x[t_arm] = side[t_arm] * (lin[t_arm] - TMAZE_STEM)
    y[t_arm] = TMAZE_STEM
    down = (lin >= TMAZE_STEM + arm_len) & (lin < TMAZE_STEM + arm_len
                                            + TMAZE_STEM)
    x[down] = side[down] * arm_len
    y[down] = TMAZE_STEM - (lin[down] - TMAZE_STEM - arm_len)
    back = lin >= TMAZE_STEM + arm_len + TMAZE_STEM
    x[back] = side[back] * np.maximum(
        arm_len - (lin[back] - 2 * TMAZE_STEM - arm_len), 0.0)
    return x, y


def tmaze_session(n_neuron=500, n_latent_bin=100, T=72_000, dt=0.025,
                  n_trials=40, run_speed=25.0, reward_stop_s=6.0,
                  jump_bins=20, seed=0):
    """A seeded T-maze recording for ``workflows.tmaze_dataset``, sampled
    as a ``PoissonGPLVMJump1D`` samples: Poisson counts of a tuning
    (``place_field_tuning``, rates in Hz times ``dt``) at a (dynamics,
    latent) path.

    Behaviour: ``n_trials`` trials of equal length over the T bins; in
    each the animal runs the linearised maze (``TMAZE_*``) at
    ``run_speed`` units/s from home to the reward zone, stops there
    ``reward_stop_s`` s (speed 0, inside [109, 113]), runs on to the end
    of the return (222) and waits at home for the rest of the trial.
    Trials alternate arms (``visitedArm`` 0/1); every fifth is an error
    (``choice`` 0).  The continuous latent is the position along a track
    that joins the stem to a copy of the rest of the maze per arm (370
    units over the L bins).

    Planted effect: at each reward arrival (the first bin at or past
    lin 109) the path enters the jump state for ``jump_bins`` bins, in
    which the latent is drawn uniformly each bin; nowhere else is it in
    the jump state.  ``find_transition_times(..., lin_pt=108.5)`` finds
    those arrivals, so the jump consensus around them sits far above its
    circular-shift null.

    Returns a dict of numpy arrays: ``spikes`` (T, N) float32 counts,
    ``t`` (T,), ``lin``, ``x``, ``y``, ``speed`` (|d lin / dt|),
    ``latent`` (T,) int64, ``dynamics`` (T,) int64 (1 = jump),
    ``tuning_hz`` (L, N), ``trials`` (a dict of columns ``start``,
    ``end``, ``choice``, ``visitedArm``), ``arrival_t`` (the planted
    arrival times), ``maze_xy`` (the sampled maze outline, both arms)."""
    rng = np.random.default_rng(seed)
    trial_bins = T // n_trials
    run1 = int(round(TMAZE_REWARD[0] / run_speed / dt)) + 1
    stop = int(round(reward_stop_s / dt))
    run2 = int(round((TMAZE_LENGTH - TMAZE_REWARD[0]) / run_speed / dt))
    if run1 + stop + run2 > trial_bins:
        raise ValueError(f"a trial of {trial_bins} bins cannot hold the run "
                         f"({run1 + stop + run2} bins)")
    lin = np.zeros(T)
    arm = np.zeros(T, dtype=np.int64)
    dynamics = np.zeros(T, dtype=np.int64)
    arrival = []
    trials = {"start": [], "end": [], "choice": [], "visitedArm": []}
    for k in range(n_trials):
        b0 = k * trial_bins
        b1 = T if k == n_trials - 1 else b0 + trial_bins
        a = k % 2
        one = np.zeros(b1 - b0)
        one[:run1] = np.linspace(0.0, TMAZE_REWARD[0] + 2.0, run1)
        one[run1:run1 + stop] = TMAZE_REWARD[0] + 2.0
        one[run1 + stop:run1 + stop + run2] = np.linspace(
            TMAZE_REWARD[0] + 2.0, TMAZE_LENGTH - 1e-6, run2)
        lin[b0:b1] = one
        arm[b0:b1] = a
        hit = b0 + int(np.argmax(one >= TMAZE_REWARD[0]))
        dynamics[hit:hit + jump_bins] = 1
        arrival.append(hit * dt)
        trials["start"].append(b0 * dt)
        trials["end"].append((b1 - 1) * dt)
        trials["choice"].append(0 if k % 5 == 4 else 1)
        trials["visitedArm"].append(a)
    track = np.where((arm == 1) & (lin >= TMAZE_STEM),
                     TMAZE_LENGTH + lin - TMAZE_STEM, lin)
    span = 2 * TMAZE_LENGTH - TMAZE_STEM
    latent = np.minimum((track / span * n_latent_bin).astype(np.int64),
                        n_latent_bin - 1)
    jumped = dynamics == 1
    latent[jumped] = rng.integers(0, n_latent_bin, int(jumped.sum()))
    tuning = place_field_tuning(n_neuron, n_latent_bin, rng)
    spikes = rng.poisson(tuning[latent] * dt).astype(np.float32)
    x, y = _tmaze_xy(lin, arm)
    speed = np.abs(np.gradient(lin, dt))
    grid = np.linspace(0.0, TMAZE_LENGTH - 1e-6, 400)
    maze = [np.column_stack(_tmaze_xy(grid, np.full(grid.size, a)))
            for a in (0, 1)]
    return {"spikes": spikes, "t": np.arange(T) * dt, "lin": lin, "x": x,
            "y": y, "speed": speed, "latent": latent, "dynamics": dynamics,
            "tuning_hz": tuning,
            "trials": {k: np.asarray(v) for k, v in trials.items()},
            "arrival_t": np.asarray(arrival), "maze_xy": np.vstack(maze)}


#: the ACh session's sleep states, as ``sleep_state_index`` codes them
ACH_STATES = {"Awake": 0, "NREM": 2, "REM": 4}
#: (state, fraction of the session where it ends)
ACH_STATE_BLOCKS = (("Awake", 0.05), ("NREM", 0.42), ("REM", 0.52),
                    ("NREM", 0.83), ("REM", 0.90), ("Awake", 1.0))


def ach_session(n_neuron=500, n_latent_bin=100, T=120_000, dt=0.01,
                onset_every_s=(15.0, 25.0), ramp_s=1.0, hold_s=2.0,
                decay_s=4.0, jump_window_s=2.0, p_enter_jump=0.1,
                p_leave_jump=0.02, p_enter_jump_base=2e-4,
                stim_s=10.0, n_stim=3, state_blocks=ACH_STATE_BLOCKS,
                seed=0):
    """A seeded sleep recording with ACh photometry for
    ``workflows.ach_dataset``, sampled as a ``PoissonGPLVMJump1D``
    samples (Poisson counts of ``place_field_tuning`` at a (dynamics,
    latent) path), with the jump state's entry probability raised after
    each ACh ramp.

    ACh (one value per bin): ramps planted every ``onset_every_s`` s
    (uniform in the range): a linear rise of 1 over ``ramp_s``, held
    ``hold_s``, then an exponential decay (``decay_s``), summed, plus
    Gaussian noise of 0.05.  ``sleep_state_index``: Awake 0 / NREM 2 /
    REM 4 in ``state_blocks`` ((state, fraction of the session where its
    block ends), ``ACH_STATE_BLOCKS`` by default: every state has a block
    in the first 80 %, the part a held-out split fits on).  ``is_stim``: ``n_stim``
    epochs of ``stim_s`` s (1 inside, 0 outside), spread over the session
    between ramps.

    The path: in the continuous state the latent takes Gaussian steps of
    one bin's std (rounded, reflected at the ends); in the jump state it
    is drawn uniformly each bin.  The jump state is entered with
    probability ``p_enter_jump`` per bin in the ``jump_window_s`` s after
    each ramp onset and ``p_enter_jump_base`` elsewhere, and left with
    ``p_leave_jump`` per bin (a jump episode lasts 0.5 s on average at
    10 ms bins).  So the posterior probability of the continuous state
    falls after ACh onsets: ``test_pre_post_against_shuffle`` on its
    peri-onset table sees a post-minus-pre difference below its shuffles.

    Returns a dict of numpy arrays: ``spikes`` (T, N) float32, ``t``,
    ``ach``, ``sleep_state_index`` (T,) int64, ``is_stim`` (T,) float,
    ``latent``, ``dynamics`` (T,) int64, ``tuning_hz`` (L, N),
    ``onset_t`` (the planted ramp onsets, those inside stim epochs
    included)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) * dt
    duration = T * dt
    onsets, t0 = [], 0.5 * onset_every_s[0]
    while t0 < duration - (ramp_s + hold_s):
        onsets.append(t0)
        t0 += rng.uniform(*onset_every_s)
    onsets = np.asarray(onsets)
    ach = np.zeros(T)
    for o in onsets:
        rel = t - o
        rise = np.clip(rel / ramp_s, 0.0, 1.0)
        fall = np.exp(-np.maximum(rel - ramp_s - hold_s, 0.0) / decay_s)
        ach += np.where(rel >= 0, rise * fall, 0.0)
    ach += rng.normal(0.0, 0.05, T)
    state = np.zeros(T, dtype=np.int64)
    lo = 0
    for name, frac in state_blocks:
        hi = int(round(frac * T))
        state[lo:hi] = ACH_STATES[name]
        lo = hi
    is_stim = np.zeros(T)
    for k in range(n_stim):
        # midway between two ramps, in the middle of the session's k-th
        # part
        mid = duration * (k + 1) / (n_stim + 1)
        j = int(np.searchsorted(onsets, mid))
        start = onsets[j - 1] + ramp_s + hold_s + 1.0 if j > 0 else mid
        is_stim[(t >= start) & (t < start + stim_s)] = 1.0
    p_enter = np.full(T, p_enter_jump_base)
    for o in onsets:
        p_enter[(t >= o) & (t < o + jump_window_s)] = p_enter_jump
    u = rng.random(T)
    steps = np.rint(rng.normal(0.0, 1.0, T)).astype(np.int64)
    uniform = rng.integers(0, n_latent_bin, T)
    latent = np.zeros(T, dtype=np.int64)
    dynamics = np.zeros(T, dtype=np.int64)
    z, lat = 0, n_latent_bin // 2
    for i in range(T):
        z = (1 if u[i] < p_enter[i] else 0) if z == 0 else (
            0 if u[i] < p_leave_jump else 1)
        if z:
            lat = uniform[i]
        else:
            lat += steps[i]
            if lat < 0:
                lat = -lat
            if lat > n_latent_bin - 1:
                lat = 2 * (n_latent_bin - 1) - lat
        latent[i], dynamics[i] = lat, z
    tuning = place_field_tuning(n_neuron, n_latent_bin, rng)
    spikes = rng.poisson(tuning[latent] * dt).astype(np.float32)
    return {"spikes": spikes, "t": t, "ach": ach,
            "sleep_state_index": state, "is_stim": is_stim,
            "latent": latent, "dynamics": dynamics, "tuning_hz": tuning,
            "onset_t": onsets}


# ---------------------------------------------------------------------------
# bf16_gemm: the emission and statistics products at 'high' and 'default'
# ---------------------------------------------------------------------------


def bf16_gemm_rtol(K):
    """The limit of ``bf16_gemm_vs_plain``'s error over a reduction of
    length K: the kernel and its plain version add the same exact bf16
    products in f32 in other orders, 2e-6 of |a| @ |b| over the emissions'
    K = N = 500, 2e-5 over the statistics' long K (time rows)."""
    return 2e-6 if K <= 1000 else 2e-5


def bf16_gemm_case(kind, rows, N, L, device, seed, batch=None):
    """(a, b) of one product of the main path, made on ``device`` from a
    seeded generator: ``'emission'`` y (rows, N) spike counts @ (log
    lam).T (N, L), a transposed view; ``'statistics'`` post.T (L, rows),
    a transposed view of softmax rows, @ y (rows, N); ``'batched'`` the
    statistics of ``batch`` runs' posteriors against one y."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.rand(shape, generator=gen, device=device)

    tuning = 0.05 + 3.0 * draw(L, N)
    lat = (draw(rows) * L).long().clamp_max(L - 1)
    y = torch.poisson(tuning[lat], generator=gen)
    if kind == "emission":
        return y, torch.log(tuning + 1e-20).T
    lead = () if kind == "statistics" else (batch,)
    post = torch.softmax(6.0 * draw(*lead, rows, L), dim=-1)
    return post.transpose(-1, -2), y


def bf16_gemm_vs_plain(a, b, level, passes=None):
    """max |k - p| / max(|a| @ |b|) of ``bf16_gemm`` at ``level`` against
    ``precision.matmul_plain`` on the same operands; ``passes`` runs the
    kernel with that many bf16 products instead (the one-pass control
    where three were asked must fail ``bf16_gemm_rtol``)."""
    want = precision.matmul_plain(a, b, level)
    got = (precision.bf16_gemm(a, b, precision.PASSES[level])
           if passes is None else precision._gemm_run(a, b, passes))
    scale = torch.matmul(a.abs(), b.abs()).max()
    return float((got - want).abs().max() / scale)


def bf16_gemm_rows_alone(a, b, level, rows=None, entry=None):
    """Whether ``bf16_gemm`` gives ``rows`` (a slice) of a 2-D product, or
    entry ``entry`` of a batched one, the same bits alone as in the whole
    call."""
    passes = precision.PASSES[level]
    whole = precision._gemm_run(a, b, passes)
    if entry is not None:
        alone = precision._gemm_run(a[entry], b, passes)
        return bool(torch.equal(alone, whole[entry]))
    alone = precision._gemm_run(a[rows], b, passes)
    return bool(torch.equal(alone, whole[rows]))
