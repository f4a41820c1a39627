"""Run one cell of the benchmark once, and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The run loads the program (``poor_man_gplvm_tpu_torch`` from this
checkout), draws the cell's inputs on the card from the seed, warms up the
cell's own shapes (set-up, timed from the process's start), runs the
cell's calls back to back until one ends at or past ``--seconds``, checks
the outputs of the window against the plain reference, and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit.
A traced run profiles the window's first ``trace_calls`` calls.

Without a CUDA card, with fewer cards than the cell asks for, without the
program in the checkout, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits with a code other
than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PROGRAM = "poor_man_gplvm_tpu_torch"
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "poor_man_gplvm_tpu")
#: the host thread pools a run caps (set before torch loads)
HOST_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS")


class NoCard(RuntimeError):
    """The run needs CUDA cards it does not have."""


def cap_host_threads(n):
    """Give the host's thread pools ``n`` threads; 0 leaves them as the
    environment sets them.  The card's host is shared, and multithreaded
    host work there (the basis SVD, the initial posterior's normalisation)
    swings from run to run with the neighbours' load, so a run takes one."""
    if n:
        for var in HOST_THREAD_VARS:
            os.environ[var] = str(n)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


def import_program():
    """The program package of this checkout; raises if it is missing or is
    imported from elsewhere."""
    pm = importlib.import_module(PROGRAM)
    where = Path(pm.__file__).resolve()
    if ROOT not in where.parents:
        raise ImportError(f"{PROGRAM} comes from {where}, not from the "
                          f"checkout at {ROOT}")
    return pm


def set_precisions(pm, cfg):
    import torch

    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pm.set_matmul_precision(cfg.matmul_precision)
    ps.set_scan_precision(cfg.scan_precision)


def scan_launches():
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk

    fns = (ps.pfilter_pass, ps.psmooth_pass, ps.joint_acc, sk.filter_scan,
           sk.smoother_scan, sk.smoother_push_scan)
    return {f.__name__: int(getattr(f, "launches", 0)) for f in fns}


def entry_class(name):
    return importlib.import_module(f"benchmark.entries.{name}").Entry


def window(entry, seconds, trace_calls, device):
    """Calls back to back until one ends at or past ``seconds``; with
    ``trace_calls`` the first that many run under the profiler.  Returns
    (records of (seconds, work), window seconds, trace summary or None,
    failures)."""
    import torch

    from benchmark import trace as tr

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    records, failed, summary = [], 0, None
    traced = tr.Traced() if trace_calls else None
    if traced is not None:  # the profiler's start is not the window's
        traced.__enter__()
    sync()
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        try:
            work = entry.call(i)
        except Exception as exc:  # a failed call ends the window
            print(f"call {i} raised {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            failed += 1
            break
        sync()
        b = time.perf_counter()
        records.append((b - a, work))
        i += 1
        if traced is not None and i == trace_calls:
            traced.__exit__(None, None, None)
            summary = traced.summary()
            traced = None
        if b - t0 >= seconds:
            break
    if traced is not None:
        traced.__exit__(None, None, None)
        summary = traced.summary()
    window_s = time.perf_counter() - t0
    return records, window_s, summary, failed


def run_cell(cell, manifest, seed, seconds, trace, device, t_start,
             bench_dir=None):
    """Run ``cell`` once on ``device`` and return the result dict (without
    the device's name, which ``main`` adds)."""
    import torch

    from benchmark import roofline, sampler
    from benchmark.config import BENCH_DIR, metric_reader

    device = torch.device(device)
    pm = import_program()
    cfg = cell.config
    set_precisions(pm, cfg)
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps

    T = cell.traffic["T"]
    data = sampler.sample(cfg, T, seed, device)
    entry = entry_class(cell.traffic["entry"])(pm, cell, data, seed, device)
    entry.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    ps.reset_launches()
    before = scan_launches()
    trace_calls = cell.traffic["trace_calls"] if trace else 0
    records, window_s, summary, failed = window(entry, seconds, trace_calls,
                                                device)
    launches = {k: v - before[k] for k, v in scan_launches().items()}
    print(f"window: {window_s!r} s, {len(records)} calls of "
          f"{[round(c, 4) for c, _ in records]} s", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    entry.window_closed()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = cell.limits
    numbers = entry.compare(entry.kept) if not failed and records else {}
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": limits[k]}
              for k in limits}
    correct = (not failed and bool(records) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))

    N, L, n_dyn = cfg.n_neuron, cfg.n_latent, cfg.n_dyn
    mv = cfg.movement_variance
    traced = records[:trace_calls] if trace else []
    ctx = types.SimpleNamespace(
        cell=cell, config=cfg, records=records, window_s=window_s,
        setup_s=setup_s, trace=summary, launches=launches, info=entry.info,
        traced_calls=len(traced), traced_work=sum(w for _, w in traced),
        decode_work=roofline.decode_work(T, N, L, n_dyn, mv),
        em_iter_work=roofline.em_iter_work(T, N, L, n_dyn, mv))
    metrics = {}
    for m in cell.metrics(manifest, trace):
        value = metric_reader(m["name"], bench_dir or BENCH_DIR)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    result = {"correct": correct, "attempted": len(records) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--host-threads", type=int, default=1,
                   help="threads of the host's pools (default 1, the "
                        "benchmark's setting; 0: the environment's)")
    args = p.parse_args(argv)
    cap_host_threads(args.host_threads)

    from benchmark.config import Cell, load_manifest

    manifest = load_manifest()
    cell = Cell.load(args.workload, manifest)

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        raise NoCard(f"cell {cell.name} needs {cell.chips} CUDA card(s); "
                     f"torch.cuda.is_available() is "
                     f"{torch.cuda.is_available()}, {cards} card(s)")
    from benchmark.timing import card_line, host_line

    print(f"card: {card_line()}; {host_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    result = run_cell(cell, manifest, args.seed, args.seconds, args.trace,
                      "cuda", T_START)
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        sys.exit(2)
