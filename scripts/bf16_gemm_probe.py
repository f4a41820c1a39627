#!/usr/bin/env python3
"""Time ``bf16_gemm`` (the emission and statistics products at the matmul
precisions 'high' and 'default') against its plain version, the f32
product and the library's bf16 product, on one CUDA card.

    python3 scripts/bf16_gemm_probe.py

Builds ``csrc/bf16_gemm.cu`` (printing ptxas' registers and spills), then
for the north-star emission y (1e6, 500) @ (log lam).T (500, 500), one
statistics chunk post.T (500, 2e5) @ y and the sweep's batched statistics
(64 runs of 1e4 rows), at N = L = 500 (``testing.bf16_gemm_case``):
the kernel's error against ``precision.matmul_plain`` (of max |a| @ |b|),
CUDA-event means of the kernel, the plain version, ``torch.matmul`` in f32
and ``torch.mm`` on bf16 copies with f32 output, and whether rows (or a
batch entry) called alone give the same bits.  Prints the card's name and
power limit first.  The package is imported from ``sys.path``, so
``PYTHONPATH=<other checkout>`` measures another checkout the same way.
"""

import subprocess
import time

import torch

from poor_man_gplvm_tpu_torch import testing as tt
from poor_man_gplvm_tpu_torch.ops import _build, precision

CASES = (("emission", 1_000_000, None), ("statistics", 200_000, None),
         ("batched", 10_000, 64))


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


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(["bf16_gemm"])
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.get("bf16_gemm", "").splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
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
            print(f"{kind} {lvl}: err {err:.3e} (limit "
                  f"{tt.bf16_gemm_rtol(a.shape[-1]):.0e}), kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, alone bit-equal "
                  f"{alone}", flush=True)
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


if __name__ == "__main__":
    main()
