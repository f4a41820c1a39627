#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which checks its results (any failure exits non-zero):

1. preamble: the card (``nvidia-smi`` name and power limit), versions,
   and float32 matmuls pinned to full precision (TF32 off);
2. build: the hand-written CUDA kernels, one nvcc per source in
   ``poor_man_gplvm_tpu_torch/csrc``, all started together;
3. kernels: K1 (filter) and K2 (smoother) against their plain PyTorch
   versions on the same inputs on the card, at L in {100, 500}, n_dyn in
   {1, 2}, three cases (constant channel, identical non-constant rows,
   masked bins) and at the decode shape, with the per-step times;
4. parallel kernels: K3 (filter pass, finals-only and emit) and K4
   (smoother pass, finals-only and full) against their plain versions over
   the same grid at an odd T (ragged last chunk, T-1 mid-chunk), with the
   pass times at T=100,000;
5. slice: ``PoissonGPLVMJump1D.decode_latent`` at T=10,000 for (N, L) =
   (100, 100) and (500, 500) through the engine 'auto' resolves to (the
   parallel one above its threshold), held against the plain ``'prob'``
   engine on the card, chunk invariance, naive Bayes, and the decode rate;
   and a decode below the threshold, through K1/K2;
6. crossover: decode time of the sequential ('cuda', K1/K2) and the
   parallel ('cuda_parallel', K3/K4) engine over T, at N = L = 100 and
   500;
7. long decode: ``decode_latent`` at T=100,000 for both shapes through the
   engine 'auto' resolves to (the parallel one), held against the
   sequential engine on the card;
8. fit: ``fit_em`` at T=100,000, L = N = 100 (the repo's headline fit
   cell), its s/EM-iteration with the M-step/E-step split, and its first
   iterations held against a sequential-engine fit.

Each main path (phases 5, 7, 8) runs with the kernels' launch counts set to
0 just before it and read just after; comparison runs are not counted.
The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports torch, numpy and the port only.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

T_GRID = 2001  # odd, so no power-of-two blocking hides a ragged tail
T_PSCAN = 20_001  # odd: the last chunk is ragged and T-1 falls inside it
T_DECODE = 10_000  # the repo's decode workload (bench.py decode cell)
T_LONG = 100_000  # the repo's headline fit cell (bench.py fit cell)
SLICE_SHAPES = ((100, 100), (500, 500))  # (N, L)
CROSSOVER_T = {100: (1000, 2000, 5000, 10_000, 20_000, 50_000, 100_000),
               500: (1000, 2000, 5000, 10_000)}  # L = N: decode lengths
FIT_ITERS = 10
FIT_CMP_ITERS = 3
# the engine comparison fits cap the Adam loop: its relative-change stop
# flips under 1-ulp loss differences, which would compare stopping
# iterations rather than engines
FIT_CMP_MAXITER = 20
DECODE_LMF_RTOL = 1e-5
DECODE_POST_ATOL = 1e-4
FIT_LML_RTOL = 1e-5
KERNELS = {  # wrapper name: (source, the TPU kernel it replaces)
    "filter_scan": ("poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
                    "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:80"),
    "smoother_scan": ("poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
                      "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:200"),
    "pfilter_pass": ("poor_man_gplvm_tpu_torch/csrc/parallel_scan.cu",
                     "poor_man_gplvm_tpu/ops/pallas/parallel_scan.py:334"),
    "psmooth_pass": ("poor_man_gplvm_tpu_torch/csrc/parallel_scan.cu",
                     "poor_man_gplvm_tpu/ops/pallas/parallel_scan.py:474"),
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


def _wrappers():
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk

    return {"filter_scan": sk.filter_scan, "smoother_scan": sk.smoother_scan,
            "pfilter_pass": ps.pfilter_pass, "psmooth_pass": ps.psmooth_pass}


@contextlib.contextmanager
def counted(launches):
    """Run a main path with every launch count set to 0 just before it;
    add the counts read just after it to ``launches``."""
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    yield
    torch.cuda.synchronize()
    for name, fn in wrappers.items():
        launches[name] += fn.launches


@contextlib.contextmanager
def sequential_engine():
    """Keep 'cuda' on the sequential kernels K1/K2 at every T (the
    reference runs the parallel engine is held against)."""
    from poor_man_gplvm_tpu_torch.ops import hmm

    saved = hmm._PARALLEL_UPGRADE_MIN_T
    hmm._PARALLEL_UPGRADE_MIN_T = float("inf")
    try:
        yield
    finally:
        hmm._PARALLEL_UPGRADE_MIN_T = saved


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
    _build.build_all()
    sec = time.perf_counter() - t0
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    seq = _build.load_scan_kernels()
    par = _build.load_parallel_scan()
    log(f"build: {sec:.2f} s, one nvcc per source in parallel (transitions "
        "resident in shared memory, n_dyn=2: K1/K2 L=100 "
        f"{bool(seq.pmg_scan_tlat_resident(2, 100))}, L=500 "
        f"{bool(seq.pmg_scan_tlat_resident(2, 500))}; K3 L=100 "
        f"{bool(par.pmg_pscan_tlat_resident(0, 2, 100))}; K4 L=100 "
        f"{bool(par.pmg_pscan_tlat_resident(1, 2, 100))}, L=500 "
        f"{bool(par.pmg_pscan_tlat_resident(1, 2, 500))})")


def _fmt(err):
    return ", ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in err.items())


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
        log(f"kernel vs plain T={T} L={L} n_dyn={n_dyn} {case}: {_fmt(err)}")
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


def phase_pscan_kernels():
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
    from poor_man_gplvm_tpu_torch.testing import (
        PSCAN_TOLERANCES, SCAN_CASES, bwd_guess, pscan_inputs,
        pscan_vs_plain, scan_case,
    )

    dev = torch.device("cuda")
    worst = {"pfilter_pass": 0.0, "psmooth_pass": 0.0}
    for L in (100, 500):
        for n_dyn in (1, 2):
            for case in SCAN_CASES:
                err = pscan_vs_plain(
                    scan_case(L * 10 + n_dyn, T_PSCAN, L, n_dyn, case), dev)
                torch.cuda.synchronize()
                log(f"K3/K4 vs plain T={T_PSCAN} L={L} n_dyn={n_dyn} {case}: "
                    f"{_fmt(err)}")
                for key, tol in PSCAN_TOLERANCES.items():
                    check(err[key] <= tol,
                          f"{key}={err[key]} > {tol} ({L}, {n_dyn}, {case})")
                check(err["finite"] and err["masked_exact_zero"]
                      and err["modes_agree"], err)
                worst["pfilter_pass"] = max(worst["pfilter_pass"],
                                            err["post_abs"],
                                            err["fwd_finals_abs"])
                worst["psmooth_pass"] = max(worst["psmooth_pass"],
                                            err["smooth_abs"],
                                            err["bwd_finals_abs"])

    # one pass of each kernel at the long shape (n_dyn=2, jump channel)
    times = {}
    for L in (100, 500):
        a = pscan_inputs(scan_case(L, T_LONG, L, 2, "jump"), dev)
        fwd = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
        post = ps.pfilter_pass(*fwd, emit=True)[0]
        C = a["ins"].shape[0]
        bwd = (post, a["tlat"], a["tlat_t"], a["tdyn"],
               bwd_guess(post, a["tc"], C), a["tc"], a["flags"])
        times[L] = {
            "pfilter_pass": (
                cuda_ms(lambda: ps.pfilter_pass(*fwd, emit=True), 5),
                cuda_ms(lambda: ps.pfilter_pass_plain(*fwd, emit=True), 1)),
            "psmooth_pass": (
                cuda_ms(lambda: ps.psmooth_pass(*bwd, emit=True), 5),
                cuda_ms(lambda: ps.psmooth_pass_plain(*bwd, emit=True), 1)),
        }
        fin_ms = (cuda_ms(lambda: ps.pfilter_pass(*fwd, emit=False), 5),
                  cuda_ms(lambda: ps.psmooth_pass(*bwd, emit=False), 5))
        for name, (ms, plain_ms) in times[L].items():
            log(f"time {name} (emit) L={L} T={T_LONG} C={C} tc={a['tc']}: "
                f"kernel {ms:.3f} ms ({1e3 * ms / a['tc']:.3f} us/step), "
                f"plain {plain_ms:.1f} ms")
        log(f"time finals-only L={L}: pfilter_pass {fin_ms[0]:.3f} ms, "
            f"psmooth_pass {fin_ms[1]:.3f} ms")
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


def _model(N, L, engine, params=None):
    """The bench model on the card; ``params`` (numpy, from a seed) are
    carried in as a JAX model's state would be."""
    from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D, convert

    m = PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                           tuning_lengthscale=10.0, device="cuda",
                           inference_engine=engine)
    if params is not None:
        convert.load_jax_state(m, params, m.tuning_basis.cpu().numpy())
    return m


def _decode_setup(N, L, T):
    basis_rank = _model(N, L, "prob").tuning_basis.shape[1]
    params = np.random.default_rng(N + L).normal(
        size=(basis_rank, N)).astype(np.float32)
    m = _model(N, L, "auto", params)
    y = torch.as_tensor(_spikes(N * L, m.tuning.cpu().numpy(), T),
                        device="cuda")
    return m, params, y


def _check_decode(res, T, L):
    check(len(res) == 19, sorted(res))
    post = res["posterior_all"]
    check(post.shape == (T, 2, L), post.shape)
    check(all(bool(torch.isfinite(v).all()) for v in res.values()
              if torch.is_tensor(v)), "non-finite decode output")
    row_err = float((post.sum(dim=(1, 2)) - 1).abs().max())
    ptl_err = float((res["p_transition_latent"].sum(dim=1) - 1).abs().max())
    check(row_err < 1e-4 and ptl_err < 1e-4, (row_err, ptl_err))
    return row_err, ptl_err


def phase_slice(launches):
    from poor_man_gplvm_tpu_torch.ops import hmm

    setups = []
    for N, L in SLICE_SHAPES:
        m_auto, params, y = _decode_setup(N, L, T_DECODE)
        check(m_auto.inference_engine == "cuda", m_auto.inference_engine)
        setups.append((N, L, m_auto, _model(N, L, "prob", params), y))

    # the main path: the repo's decode workload through 'auto'
    with counted(launches):
        results = [m.decode_latent(y) for _, _, m, _, y in setups]
    log(f"decode T={T_DECODE} launches: {launches}")

    for (N, L, m_auto, m_prob, y), res in zip(setups, results):
        row_err, ptl_err = _check_decode(res, T_DECODE, L)
        ref = m_prob.decode_latent(y)
        lmf, lmf_ref = res["log_marginal_final"], ref["log_marginal_final"]
        lmf_rel = abs(lmf - lmf_ref) / abs(lmf_ref)
        post_err = float((res["posterior_all"]
                          - ref["posterior_all"]).abs().max())
        lmf_chunk = m_auto.decode_latent(
            y, n_time_per_chunk=3337)["log_marginal_final"]
        chunk_rel = abs(lmf_chunk - lmf) / abs(lmf)
        nb = m_auto.decode_latent_naive_bayes(y)
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

        for name, model, reps in (("auto", m_auto, 5), ("prob", m_prob, 1)):
            def run():
                model.decode_latent(y)["posterior_all"]
            ms = cuda_ms(run, reps)  # ends in a device synchronise
            log(f"decode_latent N={N} L={L} T={T_DECODE} engine={name}: "
                f"{ms:.1f} ms/call, {T_DECODE / (ms / 1e3):.0f} timesteps/s")

    # below the parallel engine's threshold 'auto' stays on K1/K2
    T_short = min(T_DECODE, hmm._PARALLEL_UPGRADE_MIN_T) - 1
    _, _, m_auto, m_prob, y = setups[0]
    with counted(launches):
        res = m_auto.decode_latent(y[:T_short])
    ref = m_prob.decode_latent(y[:T_short])
    rel = abs(res["log_marginal_final"] - ref["log_marginal_final"]) / abs(
        ref["log_marginal_final"])
    log(f"decode T={T_short} (below the threshold): rel {rel:.2e} vs prob; "
        f"launches so far {launches}")
    check(rel <= DECODE_LMF_RTOL, rel)


def phase_crossover():
    """Decode time of the two engines over T at N = L (the measurement
    behind hmm._PARALLEL_UPGRADE_MIN_T)."""
    for L, lengths in CROSSOVER_T.items():
        m, params, y = _decode_setup(L, L, max(lengths))
        m_par = _model(L, L, "cuda_parallel", params)
        for T in lengths:
            yt = y[:T]
            with sequential_engine():
                seq = cuda_ms(lambda: m.decode_latent(yt)["posterior_all"], 3)
            par = cuda_ms(lambda: m_par.decode_latent(yt)["posterior_all"], 3)
            log(f"crossover N=L={L} T={T}: sequential {seq:.2f} ms, parallel "
                f"{par:.2f} ms ({seq / par:.2f}x)")


def phase_long_decode(launches):
    from poor_man_gplvm_tpu_torch.ops import hmm

    for N, L in SLICE_SHAPES:
        m, params, y = _decode_setup(N, L, T_LONG)
        trans = m._make_transition({})[0]
        check(hmm.engine_resolves_parallel(T_LONG, trans, "cuda", "cuda"),
              "the long decode does not resolve to the parallel engine")
        with counted(launches):
            res = m.decode_latent(y)
        log(f"decode T={T_LONG} N={N} L={L} launches so far: {launches}")
        _check_decode(res, T_LONG, L)
        with sequential_engine():
            ref = m.decode_latent(y)
        lmf, lmf_ref = res["log_marginal_final"], ref["log_marginal_final"]
        lmf_rel = abs(lmf - lmf_ref) / abs(lmf_ref)
        post_err = float((res["posterior_all"]
                          - ref["posterior_all"]).abs().max())
        diag = []
        m._smooth(y, m.tuning, {}, trans, m.ma_neuron_default,
                  m.ma_latent_default, 1.0, None, diag_out=diag)
        log(f"decode T={T_LONG} N={N} L={L}: log_marginal_final {lmf!r} vs "
            f"sequential {lmf_ref!r} (rel {lmf_rel:.2e}), max |post - seq| "
            f"{post_err:.2e}, fixed-point passes (fwd, bwd, fwd_delta, "
            f"bwd_delta) {diag[0]}")
        check(lmf_rel <= DECODE_LMF_RTOL, lmf_rel)
        check(post_err <= DECODE_POST_ATOL, post_err)
        par_ms = cuda_ms(lambda: m.decode_latent(y)["posterior_all"], 3)
        with sequential_engine():
            seq_ms = cuda_ms(lambda: m.decode_latent(y)["posterior_all"], 1)
        log(f"decode_latent N={N} L={L} T={T_LONG}: parallel {par_ms:.1f} "
            f"ms/call ({T_LONG / (par_ms / 1e3):.0f} timesteps/s), "
            f"sequential {seq_ms:.1f} ms/call "
            f"({T_LONG / (seq_ms / 1e3):.0f} timesteps/s)")


def phase_fit(launches):
    """fit_em on the bench model: Poisson(1) spikes and the initial log
    posterior from numpy seeds, random weights from the model's seed."""
    N = L = 100
    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.poisson(1.0, size=(T_LONG, N)).astype(np.float32),
                        device="cuda")
    init = rng.random((T_LONG, L)) * 0.1
    lpi = np.log(init / init.sum(axis=1, keepdims=True)).astype(np.float32)

    def fit(n_iter, **kw):
        em = _model(N, L, "auto").fit_em(y, n_iter=n_iter,
                                         log_posterior_init=lpi,
                                         verboase=False, **kw)
        torch.cuda.synchronize()
        return em

    t0 = time.perf_counter()
    fit(2)
    log(f"fit warm-up (2 EM iterations): {time.perf_counter() - t0:.2f} s")
    with counted(launches):
        t0 = time.perf_counter()
        em = fit(FIT_ITERS, profile=True)
        wall = time.perf_counter() - t0
    log(f"fit T={T_LONG} launches so far: {launches}")
    lml = [float(v) for v in em["log_marginal_l"]]
    check(all(np.isfinite(lml)), lml)
    drops = [(a - b) / abs(a) for a, b in zip(lml, lml[1:])]
    check(all(d <= 1e-6 for d in drops), f"log_marginal_l decreased: {lml}")
    prof = em["profile"]
    m_s, e_s = np.mean(prof["m_step"]), np.mean(prof["e_step"])
    adam = em["m_step_res_l"]["n_iter"]
    adam_ms = 1e3 * sum(prof["m_step"]) / sum(adam)
    check(em["posterior"].shape == (T_LONG, 2, L)
          and bool(torch.isfinite(em["posterior"]).all()), "fit posterior")
    log(f"fit_em T={T_LONG} L={L} N={N}: {wall / FIT_ITERS:.4f} s/EM-iter "
        f"over {FIT_ITERS} iterations (profile on): M-step {m_s:.4f} s, "
        f"E-step {e_s:.4f} s, collect {np.mean(prof['collect']):.6f} s; "
        f"Adam iterations per M-step {adam} ({adam_ms:.3f} ms each); "
        f"fixed-point passes (fwd, bwd) {prof['scan_passes']}")
    log(f"fit log_marginal_l {lml}")

    par = fit(FIT_CMP_ITERS, m_step_maxiter=FIT_CMP_MAXITER)
    with sequential_engine():
        seq = fit(FIT_CMP_ITERS, m_step_maxiter=FIT_CMP_MAXITER)
    a = np.array([float(v) for v in par["log_marginal_l"]])
    b = np.array([float(v) for v in seq["log_marginal_l"]])
    rel = np.abs(a - b) / np.abs(b)
    post_err = float((par["posterior"] - seq["posterior"]).abs().max())
    log(f"fit parallel vs sequential engine, {FIT_CMP_ITERS} iterations, "
        f"m_step_maxiter={FIT_CMP_MAXITER}: log_marginal_l rel {rel.tolist()}, "
        f"max |posterior diff| {post_err:.2e}")
    check(float(rel.max()) <= FIT_LML_RTOL, rel)
    return wall / FIT_ITERS, m_s, e_s


def main():
    phase_preamble()
    phase_build()
    worst, times = phase_kernels()
    pworst, ptimes = phase_pscan_kernels()
    worst.update(pworst)
    for L in times:
        times[L].update(ptimes[L])
    launches = dict.fromkeys(KERNELS, 0)
    phase_slice(launches)
    phase_crossover()
    phase_long_decode(launches)
    phase_fit(launches)
    log(f"main-path launches: {launches}")
    check(all(n > 0 for n in launches.values()), launches)
    card = card_line()
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        shape_T = T_DECODE if name in ("filter_scan", "smoother_scan") \
            else T_LONG
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": times[100][name][0], "plain_ms": times[100][name][1],
            "shape": f"T={shape_T} n_dyn=2 L=100",
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
