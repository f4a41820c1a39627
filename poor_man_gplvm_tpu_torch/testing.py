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
``config_batch_vs_single``.

Shared by the CPU tests, the card tests and ``chip_smoke.py``.  Everything
is built with numpy from a seed, so the same case can be fed to the JAX
package, the plain PyTorch versions and the CUDA kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import band as bd
from poor_man_gplvm_tpu_torch.ops import hmm
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
from poor_man_gplvm_tpu_torch.ops.emissions import MASK_NEG

__all__ = [
    "SCAN_CASES", "SCAN_TOLERANCES", "PSCAN_TOLERANCES",
    "PSCAN_TOLERANCES_BF16X3", "PSCAN_TOLERANCES_BF16", "pscan_tolerances",
    "scan_case",
    "kernel_vs_plain", "batch_vs_single", "BATCH_LENGTHS", "pscan_inputs",
    "BATCH_FULL_TOLERANCES", "batch_full_vs_plain", "batch_full_vs_single",
    "pscan_vs_plain", "bwd_guess",
    "joint_acc_vs_plain", "JOINT_ACC_ENTRY_RTOL", "JOINT_ACC_FLOOR",
    "band_vs_dense", "BAND_K2_ROWS", "STEP_RTOL", "STEP_TOLERANCES",
    "pfilter_step_check", "psmooth_step_check", "pscan_failures",
    "subnormal_prior_smoothers", "CONFIG_MOVEMENT", "config_stack",
    "config_batch_vs_single",
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


def pfilter_step_check(a, post, scan_prec, rows=1 << 16):
    """The one-step check of K3's emitted posteriors ``post`` (T, n_dyn,
    L) on the inputs ``a`` of ``pscan_inputs``: row t recomputed by the
    plain arithmetic in ``scan_prec`` from the kernel's own row t-1 (the
    boundary carry at a chunk's first row), over entries > 1e-30.  Returns
    ``step_post_rel`` and ``step_post_frac`` (see ``STEP_TOLERANCES``)."""
    tc, tdyn, flags = a["tc"], a["tdyn"], a["flags"]
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
        stats.add(post[idx], want, want > 1e-30)
    return stats.out("post")


def psmooth_step_check(a, post, ins_b, smooth, r, scan_prec, rows=1 << 16):
    """The one-step check of K4's full-mode outputs ``smooth`` and ``r``
    (T, n_dyn, L), run on the filter posteriors ``post`` from the boundary
    carries ``ins_b`` (``a`` as in ``pfilter_step_check``), in
    ``scan_prec``: at each step row t (< T-1), r recomputed from the
    kernel's smoothed posterior of row t+1 (the carry at a chunk's last
    row), and the smoothed posterior of row t pulled from the kernel's own
    r, so that no operand rounds differently in the pull.  r is compared
    where the prior and the numerator are > 1e-30, smooth where > 1e-30.
    Returns ``step_{r,smooth}_{rel,frac}``."""
    T = post.shape[0]
    tc, tdyn, flags = a["tc"], a["tdyn"], a["flags"]
    sp_f = ps._splits(a["tlat"], scan_prec, None)
    sp_b = ps._splits(a["tlat_t"], scan_prec, None)
    st_r, st_s = _StepStats(), _StepStats()
    for idx in _slices(T, rows):
        idx = idx.to(post.device)
        step = (idx < T - 1)[:, None, None]
        carry = torch.where((idx % tc == tc - 1)[:, None, None],
                            ins_b[idx // tc], smooth[(idx + 1).clamp(max=T - 1)])
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
