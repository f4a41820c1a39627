"""Seeded inputs for holding the scan kernels against their plain versions.

K1/K2 (sequential) are compared by ``kernel_vs_plain``, K3/K4
(parallel-in-time passes) by ``pscan_vs_plain``.

Shared by the CPU tests, the card tests and ``chip_smoke.py``.  Everything
is built with numpy from a seed, so the same case can be fed to the JAX
package, the plain PyTorch versions and the CUDA kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
from poor_man_gplvm_tpu_torch.ops.emissions import MASK_NEG

__all__ = [
    "SCAN_CASES", "SCAN_TOLERANCES", "PSCAN_TOLERANCES", "scan_case",
    "kernel_vs_plain", "pscan_inputs", "pscan_vs_plain", "bwd_guess",
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


#: K3/K4 vs their plain versions: posteriors, smoothed values and boundary
#: carries absolute; r relative where the prior and the numerator r*prior
#: are > 1e-30 (as for K2); summed log normalisers relative
PSCAN_TOLERANCES = {
    "fwd_finals_abs": 1e-4, "post_abs": 1e-4, "log_norm_sum_rel": 1e-5,
    "bwd_finals_abs": 1e-4, "smooth_abs": 1e-4, "r_rel": 1e-4,
}


def pscan_inputs(case, device, C=None):
    """K3/K4 inputs of a ``scan_case`` on ``device``: C chunks (default:
    ``choose_parallel_config``'s), the likelihood weights, the transition
    stacks, and forward boundary carries converged by the plain K3 passes
    as ``smooth_parallel`` converges them.  (Emitting from unconverged
    carries would hand K4 chunk-first posteriors inconsistent with its
    recomputed priors, whose subnormal tails then overflow r.)"""
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
                                          flags, emit=False)[2],
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


def pscan_vs_plain(case, device, C=None):
    """Run K3 (finals-only and emit) and K4 (finals-only and full) and
    their plain versions on the same inputs on ``device`` (C chunks, see
    ``pscan_inputs``), K4 on the plain K3's posteriors, and return their
    largest disagreements (see ``PSCAN_TOLERANCES``), whether every output
    is finite, whether masked bins came out as exact zeros, and whether the
    finals of both modes of each kernel agree bit for bit."""
    a = pscan_inputs(case, device, C)
    fwd = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
    post_p, norm_p, fin_p = ps.pfilter_pass_plain(*fwd, emit=True)
    _, _, fin_k0 = ps.pfilter_pass(*fwd, emit=False)
    post_k, norm_k, fin_k = ps.pfilter_pass(*fwd, emit=True)
    lr_p = float((torch.log(norm_p) + a["m"]).double().sum())
    lr_k = float((torch.log(norm_k) + a["m"]).double().sum())

    C = a["ins"].shape[0]
    bwd = (post_p, a["tlat"], a["tlat_t"], a["tdyn"],
           bwd_guess(post_p, a["tc"], C), a["tc"], a["flags"])
    sm_p, r_p, bfin_p = ps.psmooth_pass_plain(*bwd, emit=True)
    _, _, bfin_k0 = ps.psmooth_pass(*bwd, emit=False)
    sm_k, r_k, bfin_k = ps.psmooth_pass(*bwd, emit=True)
    prior = ps._matvec(torch.einsum("tpl,pd->tdl", post_p, a["tdyn"]),
                       a["tlat"], a["flags"])
    where = (prior > 1e-30) & ((r_p * prior) > 1e-30)
    masked = torch.as_tensor(case["masked"], device=device)
    outs_k = (post_k, norm_k, fin_k, sm_k, r_k, bfin_k)
    return {
        "fwd_finals_abs": float((fin_k - fin_p).abs().max()),
        "post_abs": float((post_k - post_p).abs().max()),
        "log_norm_sum_rel": abs(lr_k - lr_p) / abs(lr_p),
        "bwd_finals_abs": float((bfin_k - bfin_p).abs().max()),
        "smooth_abs": float((sm_k - sm_p).abs().max()),
        "r_rel": _max_rel(r_k, r_p, where),
        "finite": all(bool(torch.isfinite(x).all()) for x in outs_k),
        "masked_exact_zero": bool(
            (post_k[..., masked] == 0).all() and (sm_k[..., masked] == 0).all()
        ),
        "modes_agree": bool(torch.equal(fin_k0, fin_k)
                            and torch.equal(bfin_k0, bfin_k)),
    }
