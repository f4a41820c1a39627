#!/usr/bin/env python3
"""Time ``bf16_gemm`` (the emission and statistics products at the matmul
precisions 'high' and 'default') against its plain version, its bound, the
f32 product and the library's bf16 product, on one CUDA card.

    python3 scripts/bf16_gemm_probe.py [--save FILE] [--compare FILE]
    PYTHONPATH=<checkout of another commit> python3 scripts/bf16_gemm_probe.py

Builds ``csrc/bf16_gemm.cu`` (printing ptxas' registers and spills), then
for the north-star emission y (1e6, 500) @ (log lam).T (500, 500), one
statistics chunk post.T (500, 2e5) @ y and the sweep's batched statistics
(64 runs of 1e4 rows), at N = L = 500 (``testing.bf16_gemm_case``):
the kernel's error against ``precision.matmul_plain`` (of max |a| @ |b|),
CUDA-event means of the kernel, of its cp.async variant (A through
``testing.padded_copy``, bit for bit against the TMA variant), of the
plain version, of ``torch.matmul`` in f32 and of ``torch.mm`` on bf16
copies with f32 output; the bound (operands read once, the f32 output
written once, against the bf16 tensor-core peak); and whether rows (or a
batch entry) and a block of columns called alone give the same bits;
and, under ``torch.profiler``, each CUDA kernel's device time in one call
(B's split, the product, the sum of the K segments).  Prints the card's
name and power limit first.  The package is imported
from ``sys.path``, so ``PYTHONPATH=<other checkout>`` measures another
checkout's kernel the same way (the variant and column checks need this
one's ``testing``; an older one skips them).  Each product's error
against a float64 product is printed too (``F64_ROWS`` rows of the
emission).  ``--save FILE`` writes the products (the emission's first
``F64_ROWS`` rows) to FILE; ``--compare FILE`` prints how far this
checkout's products are from those saved by another: so two runs, the
first with ``--save`` under the other checkout's ``PYTHONPATH``, show which
bits a change moved.
"""

import argparse
import subprocess
import time

import torch

from poor_man_gplvm_tpu_torch import testing as tt
from poor_man_gplvm_tpu_torch.ops import _build, precision

CASES = (("emission", 1_000_000, None), ("statistics", 200_000, None),
         ("batched", 10_000, 64))
F64_ROWS = 65_536
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def ms(fn, reps=5):
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


def kernel_ms(fn):
    """{kernel name: device ms} of one call of ``fn`` under
    ``torch.profiler`` (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        if t is None:
            t = getattr(evt, "cuda_time_total", 0.0)
        if t > 0:
            name = evt.key.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + t / 1e3
    return out


def bound_ms(a, b, passes):
    """(ms, 'bytes' or 'operations') of a @ b with ``passes`` bf16
    products."""
    B = a.shape[0] if a.ndim == 3 else 1
    M, K = a.shape[-2:]
    N = b.shape[-1]
    t_bytes = 4.0 * (B * M * K + b.numel() + B * M * N) / HBM_BYTES_PER_S
    t_ops = passes * 2.0 * B * M * N * K / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def f64_err(a, b, got):
    """max |got - a @ b in float64| / max(|a| @ |b|), on the emission's
    first F64_ROWS rows."""
    if a.ndim == 2 and a.shape[0] > F64_ROWS:
        a, got = a[:F64_ROWS], got[:F64_ROWS]
    ref = torch.matmul(a.double(), b.double())
    scale = float(torch.matmul(a.abs(), b.abs()).max())
    return float((got.double() - ref).abs().max()) / scale


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--save", help="write the products to this file")
    parser.add_argument("--compare", help="compare with the products saved "
                        "in this file")
    args = parser.parse_args()
    saved = {}
    other = torch.load(args.compare) if args.compare else None
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; package "
          f"{precision.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(["bf16_gemm"])
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.get("bf16_gemm", "").splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    new = hasattr(tt, "padded_copy")
    dev = torch.device("cuda")
    for kind, rows, batch in CASES:
        a, b = tt.bf16_gemm_case(kind, rows, 500, 500, dev, 1, batch=batch)
        for lvl in ("high", "default"):
            passes = precision.PASSES[lvl]
            err = tt.bf16_gemm_vs_plain(a, b, lvl)
            k_ms = ms(lambda: precision._gemm_run(a, b, passes))
            p_ms = ms(lambda: precision.matmul_plain(a, b, lvl), 2)
            alone = (tt.bf16_gemm_rows_alone(a, b, lvl, entry=7) if batch
                     else tt.bf16_gemm_rows_alone(a, b, lvl,
                                                  rows=slice(100, 150)))
            b_ms, b_by = bound_ms(a, b, passes)
            extra = ""
            if new:
                cols = tt.bf16_gemm_cols_alone(a, b, lvl, slice(130, 300))
                equal, variants = tt.bf16_gemm_variants_equal(a, b, lvl)
                padded = tt.padded_copy(a)
                c_ms = ms(lambda: precision._gemm_run(padded, b, passes))
                del padded
                extra = (f", columns alone bit-equal {cols}; variants "
                         f"{variants} bit-equal {equal}, cp.async "
                         f"{c_ms:.3f} ms")
            parts = ", ".join(f"{k} {v:.3f}" for k, v in kernel_ms(
                lambda: precision._gemm_run(a, b, passes)).items())
            got = precision._gemm_run(a, b, passes)
            extra += f"; vs float64 {f64_err(a, b, got):.3e}"
            keep = (got[:F64_ROWS] if kind == "emission" else got).cpu()
            del got
            saved[f"{kind}/{lvl}"] = keep
            if other is not None:
                prev = other[f"{kind}/{lvl}"]
                scale = float(torch.matmul(a.abs(), b.abs()).max())
                diff = (keep - prev).abs()
                extra += (f"; vs the saved products: max |diff| "
                          f"{float(diff.max()) / scale:.3e} of max |a|@|b|, "
                          f"{int((diff > 0).sum())} of {diff.numel()} "
                          f"elements differ")
            print(f"{kind} {lvl}: err {err:.3e} (limit "
                  f"{tt.bf16_gemm_rtol(a.shape[-1]):.0e}), kernel "
                  f"{k_ms:.3f} ms (bound {b_ms:.4f} by {b_by}), plain "
                  f"{p_ms:.3f} ms, alone bit-equal {alone}{extra}; profiler: "
                  f"{parts}",
                  flush=True)
            torch.cuda.empty_cache()
        f32 = ms(lambda: torch.matmul(a, b))
        lib = None
        if a.ndim == 2:
            ab, bb = a.bfloat16(), b.bfloat16()
            lib = ms(lambda: torch.mm(ab, bb, out_dtype=torch.float32))
            del ab, bb
        print(f"{kind}: f32 torch.matmul {f32:.3f} ms, torch.mm bf16 with "
              f"f32 output {lib if lib is None else round(lib, 3)} ms",
              flush=True)
        del a, b
        torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)


if __name__ == "__main__":
    main()
