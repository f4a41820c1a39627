#!/usr/bin/env python3
"""Time ``bf16_gemm`` against variants of itself, to see what bounds it, on
one CUDA card.

    python3 scripts/bf16_gemm_variants.py [VARIANT ...]

Each variant is ``csrc/bf16_gemm.cu`` with one edit (or a launch plan with
one change), built by nvcc with the package's flags into
``build/bf16_gemm_variants/``:

* ``no_loads``: the producer loads nothing and the consumers wait for
  nothing (the products run on whatever the ring holds): the time of the
  consumers and the stores;
* ``no_mma``: the consumers skip every slice (no split, no wgmma, no f32
  add): the time of the loads and the stores;
* ``no_store``: the output tile is not stored (its sums still are all
  formed);
* ``no_mma_no_store``: the loads alone;
* ``stages_more`` / ``stages_fewer``: one stage more or fewer in the ring
  (more: the output is stored by the threads, its staging room given to
  the ring);
* ``direct_store``: the output stored by the threads, not by TMA;
* ``cluster_1``: no cluster: each block loads all of A's stage itself.

The variants that change no arithmetic (the last four) are held bit for bit
against the committed kernel.  For the north-star emission y (1e6, 500) @
(log lam).T, one statistics chunk post.T (500, 2e5) @ y and the sweep's
batched statistics (64 x 1e4 rows) at 'high' and 'default', prints each
variant's CUDA-event mean over 5 calls, in turns (committed first, then the
variants, then the same in reverse), beside the card's name and power
limit.  Default: every variant.
"""

import ctypes
import subprocess
import sys

import torch

from poor_man_gplvm_tpu_torch import testing as tt
from poor_man_gplvm_tpu_torch.ops import _build, precision

CASES = (("emission", 1_000_000, None), ("statistics", 200_000, None),
         ("batched", 10_000, 64))
OUT = _build.BUILD_DIR.parent / "bf16_gemm_variants"

PRODUCER = ("    if (warp == kConsumerWarps) {\n"
            "      uint32_t it = 0;\n")
WAIT = ("__device__ __forceinline__ void mbar_wait(uint32_t bar, "
        "uint32_t parity) {\n")
READY = ("__device__ __forceinline__ bool mbar_ready(uint32_t bar, "
         "uint32_t parity) {\n")
RELEASE = "        if ((warp & 3) == 0 && lane < CS) {\n"
A_FRAG = "                                       uint32_t (&lo)[2][4]) {\n"
MMA = "                                          uint32_t sb, int sl) {\n"
ADD = ("__device__ __forceinline__ void slice_add(float (&acc)[64], "
       "float (&d)[64]) {\n")
NO_MMA = [(A_FRAG, A_FRAG + "  return;\n"), (MMA, MMA + "  return;\n"),
          (ADD, ADD + "  return;\n")]
EPILOGUE = "      if (g.c_tma) {\n"
NO_STORE = (EPILOGUE, "      if (g.K > 0) continue;\n" + EPILOGUE)
STAGES = "  static constexpr int kStages = PASSES == 3 ? 2 : 3;\n"
C_TMA = "  g.c_tma = (segs > 1 || sc_n == 1) &&\n"
C_STAGE = "constexpr uint32_t kCBytes = kBM * kBN * 4;"

#: name: (source edits (old, new), launch-plan changes, bit-equal)
VARIANTS = {
    # the producer idles and every wait returns at once
    "no_loads": ([(PRODUCER, PRODUCER + "      if (false)\n"),
                  (WAIT, WAIT + "  return;\n"),
                  (READY, READY + "  return true;\n"),
                  (RELEASE, "        if (false) {\n")], {}, False),
    "no_mma": (NO_MMA, {}, False),
    # the condition is true at run time, but the compiler cannot know it,
    # so every sum is still formed
    "no_store": ([NO_STORE], {}, False),
    "no_mma_no_store": (NO_MMA + [NO_STORE], {}, False),
    "stages_more": ([(STAGES, STAGES.replace("? 2 : 3", "? 3 : 4")),
                     (C_STAGE, "constexpr uint32_t kCBytes = 0;"),
                     (C_TMA, "  g.c_tma = false &&\n")], {}, True),
    "stages_fewer": ([(STAGES, STAGES.replace("? 2 : 3", "? 1 : 2"))], {},
                     True),
    "direct_store": ([(C_TMA, "  g.c_tma = false &&\n")], {}, True),
    "cluster_1": ([], {"cluster": 1}, True),
}


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build(name, edits):
    """The ctypes library of the kernel source with ``edits`` applied."""
    src = _build.SOURCES["bf16_gemm"].read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's anchor is not in the "
                               f"source once: {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(so), str(cu)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.pmg_bf16_gemm.argtypes = _build._SIGNATURES["bf16_gemm"][
        "pmg_bf16_gemm"]
    lib.pmg_bf16_gemm.restype = ctypes.c_int
    return lib


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


def main(names):
    print(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"committed": (_build.load("bf16_gemm"), {}, True)}
    for name in names:
        edits, plan, same = VARIANTS[name]
        libs[name] = (build(name, edits), plan, same)
    plan0, lib0 = precision.gemm_plan, precision._lib
    dev = torch.device("cuda")
    try:
        for kind, rows, batch in CASES:
            a, b = tt.bf16_gemm_case(kind, rows, 500, 500, dev, 1,
                                     batch=batch)
            for lvl in ("high", "default"):
                passes = precision.PASSES[lvl]
                times, ref, bits = {}, None, {}
                order = list(libs) + list(libs)[::-1]
                for name in order:
                    lib, change, same = libs[name]
                    precision._lib = lambda lib=lib: lib
                    precision.gemm_plan = (
                        lambda *args, change=change: {**plan0(*args),
                                                      **change})
                    times.setdefault(name, []).append(
                        ms(lambda: precision._gemm_run(a, b, passes)))
                    if same and name not in bits:
                        got = precision._gemm_run(a, b, passes)
                        ref = got if ref is None else ref
                        bits[name] = bool(torch.equal(got, ref))
                        del got
                print(f"{kind} {lvl}: " + "; ".join(
                    f"{name} {sum(t) / len(t):.3f} ms"
                    + ("" if name not in bits or name == "committed" else
                       f" (bit-equal {bits[name]})")
                    for name, t in times.items()), flush=True)
                del ref
                torch.cuda.empty_cache()
            del a, b
            torch.cuda.empty_cache()
    finally:
        precision.gemm_plan, precision._lib = plan0, lib0
    print(card())


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
