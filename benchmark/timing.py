"""What a run prints about its machine: the host's probe, copied from the
repository's ``chip_smoke.py::host_line`` so that the yardstick does not
move with the program, and the card's name and power limit."""

from __future__ import annotations

import os
import platform
import subprocess
import time

import numpy as np
import torch


def host_line():
    """The host's CPU, the cores this process may use, and the best of
    three timings of 1e7 numpy uniform draws."""
    model = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.lower().startswith("model name")), model)
    except OSError:
        pass
    rng, probe = np.random.default_rng(0), float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        rng.random(10_000_000)
        probe = min(probe, time.perf_counter() - t0)
    return (f"host: {model}, {len(os.sched_getaffinity(0))} cores for this "
            f"process, 1e7 numpy draws {1e3 * probe:.1f} ms (best of 3)")


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(0)
