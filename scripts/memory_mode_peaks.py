#!/usr/bin/env python3
"""Peak device memory and seconds of the port's sequential smoother in each
memory mode, on one CUDA card.

    python3 scripts/memory_mode_peaks.py [--T 200000] [--chunk 50000]

``smooth_combined_chunked`` at N = L = 500 (the jump model, random weights
from a seed, Poisson spikes along a random walk) on the sequential kernels
K1/K2, in 'full', 'checkpoint', 'filter' and 'filter_bf16', each after a
warm-up call: ``torch.cuda.max_memory_allocated`` above what was live
before the call (the spikes), and the host seconds of the call.  The
package is imported from ``sys.path``, so ``PYTHONPATH=<other checkout>``
measures another checkout of the repository the same way (the script
needs nothing of it but ``poor_man_gplvm_tpu_torch``; so it keeps its own
copy of ``testing.memory_mode_peaks``' loop, which checkouts older than
that helper lack).  Prints one JSON line per mode and the card's name and
power limit.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=200_000)
    ap.add_argument("--chunk", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("memory_mode_peaks: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False

    import poor_man_gplvm_tpu_torch as pmt
    from poor_man_gplvm_tpu_torch.ops import hmm

    NL = 500
    m = pmt.PoissonGPLVMJump1D(NL, n_latent_bin=NL, movement_variance=1,
                               tuning_lengthscale=10.0, device="cuda")
    rng = np.random.default_rng(args.seed)
    walk = np.clip(np.cumsum(rng.integers(-1, 2, size=args.T)) + NL // 2,
                   0, NL - 1)
    y = torch.poisson(m.tuning[torch.as_tensor(walk, device="cuda")] * 0.1,
                      generator=torch.Generator(device="cuda").manual_seed(
                          args.seed))
    trans = m._make_transition({})[0]
    hmm._PARALLEL_UPGRADE_MIN_T = float("inf")  # K1/K2 at every length

    def run(mode):
        return hmm.smooth_combined_chunked(
            y, m.tuning, {}, trans, m.ma_neuron_default, None,
            n_time_per_chunk=args.chunk, engine="cuda", memory_mode=mode)

    run("full")  # warm-up: the kernels' libraries and the band
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for mode in ("full", "checkpoint", "filter", "filter_bf16"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run(mode)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        print(json.dumps({"mode": mode, "T": args.T, "chunk": args.chunk,
                          "N": NL, "L": NL, "peak_GB": peak / 1e9,
                          "seconds": sec,
                          "log_marginal": float(out[1])}), flush=True)
        del out
    print(card)


if __name__ == "__main__":
    main()
