#!/usr/bin/env python3
"""Time K2 with the prior recomputed and ``joint_acc``, each against
versions of itself with a part cut out, on one CUDA card.

    python3 scripts/scan_push_probe.py [--check]
    PYTHONPATH=<checkout of another commit> python3 scripts/scan_push_probe.py

K2 with the prior recomputed (``ops/scan_kernels.py::smoother_push_scan``)
runs on a 50,000-row chunk of K1's filter posteriors at N = L = 500,
n_dyn = 2 (one RBF channel, lengthscale 1, W = 21, and the jump channel;
``testing.scan_case``), stored in f32 and in bf16, the shape the 'filter'
memory modes launch; beside it K2 on K1's stored priors (what the push
costs on top), and whether the f32 store's rows equal K2's on the priors
K1 stored.  ``joint_acc`` runs at T = 100,000, n_dyn = 2, L = 100 and
500 (K4's marginal+acc shapes) with its one-TF32-product control, the
einsum that computes the same sum, and its bound (three TF32 products at
the card's peak).

Each variant is the package's source with one edit, built by nvcc with the
package's flags into ``build/scan_push_probe/``:

* ``no_producer_work``: the producer block neither sums the push windows
  nor forms reciprocals (it still mixes, copies and signals): the
  consumer's chain with the producer's pace;
* ``k2_ratio``: the ring carries the prior itself and the consumer forms
  its reciprocal, K2's ratio verbatim (the same bits);
* ``no_bulk_copies``: the producer issues no bulk copies and waits for
  none (it reads whatever its stages held);
* ``acc_no_mma``: joint_acc's consumers issue no wgmma;
* ``acc_no_convert``: joint_acc's B tiles are not transposed and split;
* ``acc_no_loads``: joint_acc's producer loads nothing and the consumers
  wait for nothing;
* ``cp_async_shifted``: joint_acc on the same values at a 4-byte offset,
  where its ring is filled by cp.async in place of TMA (the same bits).

The cut variants compute wrong values; only their times are read.  Every
time is the CUDA-event mean over 5 calls, in turns (committed, variants,
then the same in reverse), and the card's name and power limit are printed
first and last.  The package is imported from ``sys.path``, so
``PYTHONPATH=<other checkout>`` times another checkout's kernels the same
way (the variants need this checkout's sources; an older package skips
them).  ``--check`` applies every edit and writes the sources, without
nvcc or a card (the edits' anchors are checked on the CPU).
"""

import argparse
import ctypes
import subprocess

import torch

from poor_man_gplvm_tpu_torch import testing as tt
from poor_man_gplvm_tpu_torch.ops import _build
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk

OUT = _build.BUILD_DIR.parent / "scan_push_probe"
PUSH_T, NL = 50_000, 500
ACC_T, ACC_LS = 100_000, (100, 500)
TF32_FLOP_PER_S = 495e12  # NVIDIA's data sheet, H100 SXM, dense

WINDOW = ("          pr = live ? window_matvec<kUnroll>(q + d * L, band + "
          "off[d], i0[d],\n"
          "                                             W, L, j)\n"
          "                    : 0.f;\n")
CODES = "        code[d] = prior_code(pr);\n"
VARIANTS = {
    "no_producer_work": ("scan_kernels", [
        (WINDOW, "          pr = 1.f;\n", 1),
        (CODES, "        code[d] = 1.0;\n", 1)]),
    "k2_ratio": ("scan_kernels", [
        (CODES, "        code[d] = (double)pr;\n", 1),
        ("      r[e] = rc > 0.0 ? div_by_rcp(carry[e], rc)\n"
         "                      : (rc < 0.0 ? carry[e] / (float)(-rc) : 0.f);\n",
         "      const float pn = (float)rc;\n"
         "      r[e] = pn >= kPriorFloor ? (pn < kRcpDivisorMax\n"
         "          ? div_by_rcp(carry[e], rcp_f64(pn)) : carry[e] / pn) : 0.f;\n",
         1)]),
    "no_bulk_copies": ("scan_kernels", [
        ("      mbar_wait(loaded + 8 * s, k & 1);\n", "", 1),
        ("    if (j == 0) {\n      // the 16-byte-aligned span",
         "    if (false) {\n      // the 16-byte-aligned span", 1),
        ("      if (j == 0 && i + S < T) {\n", "      if (false) {\n", 1)]),
    "acc_no_mma": ("parallel_scan", [
        ("                                           uint64_t desc, int "
         "scale_d) {\n",
         "                                           uint64_t desc, int "
         "scale_d) {\n  if (scale_d >= 0) return;\n", 1)]),
    "acc_no_convert": ("parallel_scan", [
        ("  auto convert = [&](int st, int buf) {\n",
         "  auto convert = [&](int st, int buf) {\n    if (st >= 0) return;\n",
         1)]),
    "acc_no_loads": ("parallel_scan", [
        ("    for (int st = 0; st < nst; ++st) {\n      const int s = st % S;\n"
         "      if (st >= S)",
         "    for (int st = 0; st < 0; ++st) {\n      const int s = st % S;\n"
         "      if (st >= S)", 1),
        ("    mbar_wait(full(0), 0);\n", "", 1),
        ("      mbar_wait(full((st + 1) % S), ((st + 1) / S) & 1);\n", "", 1)]),
}


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def edited(name):
    """(library, source path) of variant ``name`` written under OUT."""
    lib, edits = VARIANTS[name]
    src = _build.SOURCES[lib].read_text()
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f"{name}: the edit's anchor is not in the "
                               f"source {count} time(s): {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    return lib, cu


def build(names):
    """{name: (library, ctypes library)} of the variants ``names``, one
    nvcc each, all started together."""
    procs = {}
    for name in names:
        lib, cu = edited(name)
        so = OUT / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(so), str(cu)]
        procs[name] = (lib, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        dll = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES[lib].items():
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = ctypes.c_int
        out[name] = (lib, dll)
    return out


def ms(fn, reps=5):
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


def in_turns(runs):
    """{name: mean ms} of ``runs`` {name: fn}, timed in turns (forward,
    then backward)."""
    times = {}
    order = list(runs) + list(runs)[::-1]
    for name in order:
        times.setdefault(name, []).append(ms(runs[name]))
    return {k: sum(v) / len(v) for k, v in times.items()}


def push_inputs(dev):
    """K1's filter posteriors and priors for a PUSH_T-row chunk at NL."""
    case = tt.scan_case(17, PUSH_T + 1, NL, 2, "jump")
    t = {k: torch.as_tensor(v, device=dev) for k, v in case.items()
         if k != "masked"}
    flags = sk._detect_uniform_rows(t["tlat"])
    w = torch.exp(t["ll"] - t["ll"].amax(dim=1, keepdim=True)).contiguous()
    post, prior, _ = sk.filter_scan(w, t["tlat"], t["tdyn"], t["p_init"],
                                    flags)
    tlat_t = t["tlat"].transpose(-1, -2).contiguous()
    band = sk.transition_band(t["tlat"], tlat_t, flags)
    return post, prior, t["tlat"], tlat_t, t["tdyn"], flags, band


def probe_push(dev, libs):
    post, prior, tlat, tlat_t, tdyn, flags, band = push_inputs(dev)
    init = post[-1].contiguous()
    k2 = ms(lambda: sk.smoother_scan(post[:-1].contiguous(),
                                     prior[1:].contiguous(), tlat_t, tdyn,
                                     init, flags, band=band))
    print(f"K2 on stored priors T={PUSH_T} L={NL} n_dyn=2 W={band.W}: "
          f"{k2:.3f} ms ({1e3 * k2 / PUSH_T:.3f} us a step)", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        filt = post[:-1].to(dtype).contiguous()
        args = (filt, tlat, tlat_t, tdyn, init, flags)
        ref = sk.smoother_push_scan(*args, band=band)
        run = lambda: sk.smoother_push_scan(*args, band=band)  # noqa: E731
        runs = {"committed": run}
        lib0 = sk._lib
        for name, (lib, dll) in libs.items():
            if lib == "scan_kernels":
                def variant(dll=dll):
                    sk._lib = lambda: dll
                    try:
                        return run()
                    finally:
                        sk._lib = lib0
                runs[name] = variant
        if hasattr(sk, "push_plan"):
            bf16 = dtype == torch.bfloat16
            print(f"  plan: {sk.push_plan(2, 1, NL, band.W, bf16)}")
        same = all(torch.equal(a, b) for a, b in zip(
            ref, sk.smoother_scan(post[:-1].contiguous(),
                                  prior[1:].contiguous(), tlat_t, tdyn, init,
                                  flags, band=band)))
        if dtype == torch.float32:
            print(f"  bit-equal to K2 on the stored priors: {same}")
        times = in_turns(runs)
        print(f"K2 with the prior recomputed [{str(dtype)[6:]}] T={PUSH_T}: "
              + "; ".join(f"{k} {v:.3f} ms ({1e3 * v / PUSH_T:.3f} us a "
                          f"step)" for k, v in times.items()), flush=True)
        del filt, args, ref


def shifted(x):
    """A copy of ``x`` whose data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def probe_acc(dev, libs):
    for L in ACC_LS:
        rng = torch.Generator(device=dev).manual_seed(L)
        n_dyn = 2
        post = torch.rand((ACC_T, n_dyn, L), generator=rng, device=dev)
        post /= post.sum(dim=(1, 2), keepdim=True)
        r = torch.rand((ACC_T, n_dyn, L), generator=rng, device=dev) * 2
        want = ps.joint_acc_plain(post, r)
        got = ps.joint_acc(post, r)
        err = float((got - want).abs().max() / want.abs().max())
        runs = {"committed": lambda: ps._joint_acc_run(post, r, 3),
                "one_product": lambda: ps._joint_acc_run(post, r, 1),
                "einsum": lambda: ps.joint_acc_plain(post, r)}
        post_s, r_s = shifted(post), shifted(r)
        runs["cp_async_shifted"] = lambda: ps._joint_acc_run(post_s, r_s, 3)
        lib0 = ps._lib
        for name, (lib, dll) in libs.items():
            if lib == "parallel_scan":
                def run(dll=dll):
                    ps._lib = lambda: dll
                    try:
                        return ps._joint_acc_run(post, r, 3)
                    finally:
                        ps._lib = lib0
                runs[name] = run
        times = in_turns(runs)
        M = n_dyn * L
        bound = 1e3 * 3 * 2.0 * ACC_T * M * M / TF32_FLOP_PER_S
        print(f"joint_acc T={ACC_T} n_dyn=2 L={L} (M={M}): bound {bound:.3f}"
              f" ms (three TF32 products at peak); max |kernel - einsum| "
              f"{err:.2e} of max; " + "; ".join(
                  f"{k} {v:.3f} ms" for k, v in times.items()), flush=True)
        del post, r, want, got, post_s, r_s


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="apply the edits and write the sources only")
    args = ap.parse_args()
    if args.check:
        for name in VARIANTS:
            print(name, edited(name)[1])
        return
    print(card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # the committed kernels first, then beside their variants
    probe_push(dev, {})
    probe_acc(dev, {})
    if not hasattr(sk, "push_plan"):
        print("an older package: its kernels alone, no variants")
    else:
        libs = build(VARIANTS)
        probe_push(dev, libs)
        probe_acc(dev, libs)
    print(card())


if __name__ == "__main__":
    main()
