"""Check the program's spans and counters on the card, and what tracing
costs.

    python3 scripts/tracing_probe.py [completeness] [cost] [--pairs N]

Run from the repository root on a machine with a CUDA card.  The inputs
are the benchmark's cells ``ns-decode`` (a T = 1e6 decode) and
``gauss-fit`` (20-iteration lean fits of a T = 1e5 recording, each from a
new model), drawn by ``benchmark/sampler.py``, with the benchmark's one
host thread.

``completeness``: one decode call and one fit under
``torch.cuda.set_sync_debug_mode("warn")`` and ``torch.profiler``, inside
``utils.profiling.recording()``.  Prints every synchronising operation the
card's runtime reports, grouped by the innermost frame of the program
that made it, beside the counters ``host_syncs.<site>``, ``h2d_copies``
and ``h2d_bytes`` over the same call, and the trace's count of
``Memcpy HtoD`` operations.

``cost``: alternating pairs of whole fits and of decode calls outside and
inside ``utils.profiling.recording()`` (off, on, on, off, ...), each timed
on the host clock to a ``torch.cuda.synchronize()``; prints every time,
the medians and the median of the pairs' ratios.
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

import torch  # noqa: E402

from benchmark import run, sampler  # noqa: E402
from benchmark.config import Cell, load_manifest  # noqa: E402
from benchmark.timing import card_line, host_line  # noqa: E402

PKG = str(ROOT / "poor_man_gplvm_tpu_torch")
SEED = 2_718_281_828


def cells():
    """(decode call, fit call, fit iterations) on the cells' inputs."""
    man = load_manifest()
    pm = run.import_program()
    dec, fit = Cell.load("ns-decode", man), Cell.load("gauss-fit", man)
    run.set_precisions(pm, dec.config)
    dev = torch.device("cuda")
    dd = sampler.sample(dec.config, dec.traffic["T"], SEED, dev)
    fd = sampler.sample(fit.config, fit.traffic["T"], SEED + 1, dev)
    model = getattr(pm, dec.config.model)(**dec.config.args, device=dev)
    n_iter = fit.traffic["n_iter"]

    def decode():
        return model.decode_latent(dd["y"], tuning=dd["tuning"])

    def one_fit(seed=0):
        m = getattr(pm, fit.config.model)(**fit.config.args, device=dev)
        return m.fit_em(fd["y"], generator=torch.Generator().manual_seed(seed),
                        n_iter=n_iter, output_mode="lean", verboase=False,
                        save_every=10**9)

    return decode, one_fit, n_iter


def _site(stack):
    """The innermost frame of the program in ``stack``."""
    for fr in reversed(stack):
        if fr.filename.startswith(PKG):
            return (f"{fr.filename[len(str(ROOT)) + 1:]}:{fr.lineno} "
                    f"({fr.name}): {fr.line}")
    return "outside the program: " + "; ".join(
        f"{Path(f.filename).name}:{f.lineno}" for f in stack[-3:])


def completeness(what, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from poor_man_gplvm_tpu_torch.utils import profiling

    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            sites[_site(traceback.extract_stack()[:-2])] += 1

    saved = warnings.showwarning
    warnings.showwarning = show
    profiling.reset()
    before = profiling.counters()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with profiling.recording():
                        fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
    finally:
        warnings.showwarning = saved
    delta = {k: v - before.get(k, 0) for k, v in profiling.counters().items()
             if v != before.get(k, 0)}
    htod = sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and e.name().startswith("Memcpy HtoD"))
    tops = [(s.name, s.attrs) for s in profiling.spans() if s.parent is None]
    print(f"== {what}: {sum(sites.values())} synchronising operations "
          f"reported", flush=True)
    for site, n in sorted(sites.items(), key=lambda kv: -kv[1]):
        print(f"   {n:4d}  {site}")
    print(f"   counters over the call: {delta}")
    print(f"   Memcpy HtoD in the trace: {htod}; h2d_copies "
          f"{delta.get('h2d_copies', 0)}")
    print(f"   top-level spans: {tops}")
    spans = collections.defaultdict(list)
    for s in profiling.spans():
        spans[s.name].append(s.seconds * 1e3)
    print("   spans (name: n, total ms): " + ", ".join(
        f"{k}: {len(v)}, {sum(v):.3f}" for k, v in sorted(spans.items())),
        flush=True)


def cost(what, fn, pairs):
    from poor_man_gplvm_tpu_torch.utils import profiling

    def timed(on):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if on:
            with profiling.recording():
                fn()
        else:
            fn()
        torch.cuda.synchronize()
        profiling.reset()
        return time.perf_counter() - t0

    off, on = [], []
    for k in range(pairs):
        order = (False, True) if k % 2 == 0 else (True, False)
        got = {o: timed(o) for o in order}
        off.append(got[False])
        on.append(got[True])
    ratio = [b / a for a, b in zip(off, on)]
    print(f"== tracing cost, {what}: off {[round(x, 5) for x in off]}, on "
          f"{[round(x, 5) for x in on]}; medians off "
          f"{statistics.median(off)!r} s, on {statistics.median(on)!r} s; "
          f"median of on / off {statistics.median(ratio)!r}; on slower in "
          f"{sum(r > 1 for r in ratio)} of {pairs} pairs", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("phases", nargs="*", default=["completeness", "cost"])
    p.add_argument("--pairs", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"card: {card_line()}; {host_line()}; torch {torch.__version__}",
          flush=True)
    decode, one_fit, n_iter = cells()
    t0 = time.perf_counter()
    decode()
    one_fit()
    torch.cuda.synchronize()
    print(f"warm-up (with the kernels' build) {time.perf_counter() - t0:.1f} s",
          flush=True)
    if "completeness" in args.phases:
        completeness("ns-decode, one decode_latent call", decode)
        completeness(f"gauss-fit, one model and its {n_iter}-iteration fit",
                     one_fit)
    if "cost" in args.phases:
        cost("gauss-fit fits (a new model each)", one_fit, args.pairs)
        cost("ns-decode calls", decode, 3 * args.pairs)


if __name__ == "__main__":
    main()
