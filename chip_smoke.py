#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which checks its results (any failure exits non-zero):

1. preamble: the card (``nvidia-smi`` name and power limit), versions,
   and float32 matmuls pinned to full precision (TF32 off);
2. build: the hand-written CUDA scan kernels, compiled with nvcc from
   ``poor_man_gplvm_tpu_torch/csrc``;
3. kernels: K1 (filter) and K2 (smoother) against their plain PyTorch
   versions on the same inputs on the card, at L in {100, 500}, n_dyn in
   {1, 2}, three cases (constant channel, identical non-constant rows,
   masked bins) and at the decode shape, with the per-step times;
4. slice: ``PoissonGPLVMJump1D.decode_latent`` at T=10,000 for (N, L) =
   (100, 100) and (500, 500) through the kernels, held against the plain
   ``'prob'`` engine on the card, chunk invariance, naive Bayes, and the
   decode rate.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports torch, numpy and the port only.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

T_GRID = 2001  # odd, so no power-of-two blocking hides a ragged tail
T_DECODE = 10_000  # the repo's decode workload (bench.py decode cell)
SLICE_SHAPES = ((100, 100), (500, 500))  # (N, L)
DECODE_LMF_RTOL = 1e-5
DECODE_POST_ATOL = 1e-4
SOURCE = "poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu"
REPLACES = {
    "filter_scan": "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:80",
    "smoother_scan": "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:200",
}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """Fail the run (exit code 1, no result line) unless ``ok``."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_preamble():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, compute capability "
        f"{torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")


def phase_build():
    from poor_man_gplvm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load_scan_kernels()
    sec = time.perf_counter() - t0
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"build: {sec:.2f} s (Tlat resident in shared memory: "
        f"L=100 {bool(lib.pmg_scan_tlat_resident(2, 100))}, "
        f"L=500 {bool(lib.pmg_scan_tlat_resident(2, 500))})")


def phase_kernels():
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.testing import (
        SCAN_CASES, SCAN_TOLERANCES, kernel_vs_plain, scan_case,
    )

    dev = torch.device("cuda")
    worst = {"filter_scan": 0.0, "smoother_scan": 0.0}
    grid = [(L, nd, c, T_GRID) for L in (100, 500) for nd in (1, 2)
            for c in SCAN_CASES]
    grid += [(L, 2, "jump", T_DECODE) for L in (100, 500)]
    for L, n_dyn, case, T in grid:
        err = kernel_vs_plain(scan_case(L * 10 + n_dyn, T, L, n_dyn, case),
                              dev)
        torch.cuda.synchronize()
        log(f"kernel vs plain T={T} L={L} n_dyn={n_dyn} {case}: " + ", ".join(
            f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
            for k, v in err.items()))
        for key, tol in SCAN_TOLERANCES.items():
            check(err[key] <= tol,
                  f"{key}={err[key]} > {tol} ({L}, {n_dyn}, {case})")
        check(err["finite"] and err["masked_exact_zero"], err)
        worst["filter_scan"] = max(worst["filter_scan"], err["post_abs"],
                                   err["prior_abs"])
        worst["smoother_scan"] = max(worst["smoother_scan"],
                                     err["smooth_abs"])

    # per-step times at the decode shape (n_dyn=2 with the jump channel)
    times = {}
    for L in (100, 500):
        c = scan_case(L, T_DECODE, L, 2, "jump")
        t = {k: torch.as_tensor(v, device=dev) for k, v in c.items()
             if k != "masked"}
        flags = sk._detect_uniform_rows(t["tlat"])
        w = torch.exp(t["ll"] - t["ll"].amax(dim=1, keepdim=True)).contiguous()
        args_f = (w, t["tlat"], t["tdyn"], t["p_init"], flags)
        post, prior, _ = sk.filter_scan(*args_f)
        args_s = (post[:-1].contiguous(), prior[1:].contiguous(),
                  t["tlat"].transpose(-1, -2).contiguous(), t["tdyn"],
                  post[-1].contiguous(), flags)
        times[L] = {
            "filter_scan": (cuda_ms(lambda: sk.filter_scan(*args_f), 5),
                            cuda_ms(lambda: sk.filter_scan_plain(*args_f), 1)),
            "smoother_scan": (
                cuda_ms(lambda: sk.smoother_scan(*args_s), 5),
                cuda_ms(lambda: sk.smoother_scan_plain(*args_s), 1)),
        }
        for name, (ms, plain_ms) in times[L].items():
            log(f"time {name} L={L} T={T_DECODE}: kernel {ms:.3f} ms "
                f"({1e3 * ms / T_DECODE:.3f} us/step), plain {plain_ms:.1f} ms "
                f"({1e3 * plain_ms / T_DECODE:.2f} us/step)")
    return worst, times


def _spikes(seed, tuning, T):
    """Poisson counts along a random-walk latent path with rare jumps."""
    rng = np.random.default_rng(seed)
    L = tuning.shape[0]
    lat = np.empty(T, dtype=np.int64)
    x = int(rng.integers(L))
    steps = rng.integers(-1, 2, size=T)
    jumps = rng.random(T) < 0.01
    targets = rng.integers(L, size=T)
    for t in range(T):
        x = int(targets[t]) if jumps[t] else min(max(x + steps[t], 0), L - 1)
        lat[t] = x
    return rng.poisson(tuning[lat]).astype(np.float32)


def _model(N, L, engine):
    from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D

    return PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                              tuning_lengthscale=10.0, device="cuda",
                              inference_engine=engine)


def phase_slice():
    from poor_man_gplvm_tpu_torch import convert
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk

    setups = []
    for N, L in SLICE_SHAPES:
        m_cuda, m_prob = _model(N, L, "auto"), _model(N, L, "prob")
        check(m_cuda.inference_engine == "cuda", m_cuda.inference_engine)
        # random weights from a numpy seed, carried in as the JAX model's
        # state would be
        basis = m_cuda.tuning_basis.cpu().numpy()
        params = np.random.default_rng(N + L).normal(
            size=(basis.shape[1], N)).astype(np.float32)
        for m in (m_cuda, m_prob):
            convert.load_jax_state(m, params, basis)
        y = torch.as_tensor(
            _spikes(N * L, m_cuda.tuning.cpu().numpy(), T_DECODE),
            device="cuda")
        setups.append((N, L, m_cuda, m_prob, y))

    # the main path: reset the launch counts, decode, read them
    sk.filter_scan.launches = 0
    sk.smoother_scan.launches = 0
    results = [m_cuda.decode_latent(y) for _, _, m_cuda, _, y in setups]
    torch.cuda.synchronize()
    launches = {"filter_scan": sk.filter_scan.launches,
                "smoother_scan": sk.smoother_scan.launches}
    log(f"main-path launches: {launches}")
    check(all(n > 0 for n in launches.values()), launches)

    for (N, L, m_cuda, m_prob, y), res in zip(setups, results):
        check(len(res) == 19, sorted(res))
        post = res["posterior_all"]
        check(post.shape == (T_DECODE, 2, L), post.shape)
        check(all(bool(torch.isfinite(v).all()) for v in res.values()
                  if torch.is_tensor(v)), "non-finite decode output")
        row_err = float((post.sum(dim=(1, 2)) - 1).abs().max())
        ptl = res["p_transition_latent"]
        ptl_err = float((ptl.sum(dim=1) - 1).abs().max())
        check(row_err < 1e-4 and ptl_err < 1e-4, (row_err, ptl_err))

        ref = m_prob.decode_latent(y)
        lmf, lmf_ref = res["log_marginal_final"], ref["log_marginal_final"]
        lmf_rel = abs(lmf - lmf_ref) / abs(lmf_ref)
        post_err = float((post - ref["posterior_all"]).abs().max())
        lmf_chunk = m_cuda.decode_latent(
            y, n_time_per_chunk=3337)["log_marginal_final"]
        chunk_rel = abs(lmf_chunk - lmf) / abs(lmf)
        nb = m_cuda.decode_latent_naive_bayes(y)
        check(nb["posterior_latent"].shape == (T_DECODE, L)
              and np.isfinite(nb["log_marginal_total"]), "naive Bayes")
        log(f"decode N={N} L={L}: log_marginal_final {lmf!r} vs prob "
            f"{lmf_ref!r} (rel {lmf_rel:.2e}), max |post - prob| "
            f"{post_err:.2e}, chunked(3337) rel {chunk_rel:.2e}, row-sum err "
            f"{row_err:.1e}, p_transition_latent row-sum err {ptl_err:.1e}, "
            f"naive-Bayes log marginal {nb['log_marginal_total']!r}")
        check(lmf_rel <= DECODE_LMF_RTOL, lmf_rel)
        check(post_err <= DECODE_POST_ATOL, post_err)
        check(chunk_rel <= DECODE_LMF_RTOL, chunk_rel)

        for name, model, reps in (("cuda", m_cuda, 5), ("prob", m_prob, 1)):
            def run():
                model.decode_latent(y)["posterior_all"]
            ms = cuda_ms(run, reps)  # ends in a device synchronise
            log(f"decode_latent N={N} L={L} T={T_DECODE} engine={name}: "
                f"{ms:.1f} ms/call, {T_DECODE / (ms / 1e3):.0f} timesteps/s")
    return launches


def main():
    phase_preamble()
    phase_build()
    worst, times = phase_kernels()
    launches = phase_slice()
    card = card_line()
    kernels = []
    for name in ("filter_scan", "smoother_scan"):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": times[100][name][0], "plain_ms": times[100][name][1],
            "shape": f"T={T_DECODE} n_dyn=2 L=100",
            "ms_L500": times[500][name][0],
            "plain_ms_L500": times[500][name][1],
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
