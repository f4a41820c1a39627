"""Readings from which the ``sweep`` cell's limits are set, at its own size.

    python3 benchmark/calibrate_sweep.py [--seeds 1,2,3] \
        [--control-seeds 4,5,6] [--faults 7,8,9] [--fault-names a,b]

As ``calibrate.py`` does for the other cells, in one process: for each
seed, the cell's inputs, one call as a run makes it and the check's
numbers; for each control seed, the reference computed in TF32 put in the
program's place; for each fault seed, every fault of ``faults_sweep.py``
(or those named) planted in the program, over the call and the
one-iteration call after it.  Each reading is one JSON line on standard
output.  The benchmark's runs never call this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
from contextlib import nullcontext  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402

run.cap_host_threads(1)  # before torch loads, as a run does

from benchmark import faults_sweep, sampler  # noqa: E402
from benchmark.config import Cell, load_manifest  # noqa: E402
from benchmark.reference import model as rm  # noqa: E402

CELL = "sweep"


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def reading(cell, pm, seed, device, kind, fault=None):
    import torch

    t0 = time.perf_counter()
    data = sampler.sample(cell.config, cell.traffic["T"], seed, device)
    entry = run.entry_class(cell.traffic["entry"])(pm, cell, data, seed,
                                                   device)
    if kind == "control":
        kept = entry.control(rm.TF32)
    else:
        with faults_sweep.planted(fault, pm) if fault else nullcontext():
            run.window(entry, 0.0, 0, device)
            entry.window_closed()
        kept = entry.kept
    t1 = time.perf_counter()
    numbers = entry.compare(kept)
    t2 = time.perf_counter()
    out = {"workload": cell.name, "seed": seed, "kind": fault or kind,
           "numbers": numbers, "detail": entry.info.get("check_detail"),
           "program_s": t1 - t0, "check_s": t2 - t1}
    del entry, data, kept
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-names", default=",".join(faults_sweep.FAULTS))
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("calibrate_sweep: needs a CUDA card")
    cell = Cell.load(CELL, load_manifest())
    pm = run.import_program()
    run.set_precisions(pm, cell.config)
    dev = torch.device("cuda")
    jobs = ([(s, "program", None) for s in _seeds(args.seeds)]
            + [(s, "control", None) for s in _seeds(args.control_seeds)]
            + [(s, "fault", f) for s in _seeds(args.faults)
               for f in args.fault_names.split(",") if f])
    for seed, kind, fault in jobs:
        print(json.dumps(reading(cell, pm, seed, dev, kind, fault)),
              flush=True)
    print(f"calibrate_sweep: {time.perf_counter() - T_START:.1f} s in all",
          file=sys.stderr)


if __name__ == "__main__":
    main()
