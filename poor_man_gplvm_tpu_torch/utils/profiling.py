"""Profiling helpers: device traces and wall-clock phase timers.

Counterpart of ``poor_man_gplvm_tpu/utils/profiling.py``: ``trace``
writes a chrome trace through ``torch.profiler`` (CPU and, with a card,
CUDA activities) in place of ``jax.profiler``, and ``PhaseTimer`` syncs
the card with ``torch.cuda.synchronize()``.

The JAX module's ``enable_compilation_cache`` has no counterpart: the
port compiles no programs at run time but its CUDA kernels, which
``ops/_build.py`` builds once per source into ``build/torch_kernels/``
(listed in ``.gitignore``) and reuses while the source is unchanged.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "PhaseTimer"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block with ``torch.profiler`` and write its chrome trace
    to ``log_dir/trace.json`` (viewable in ``chrome://tracing`` or
    Perfetto).  Yields ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class PhaseTimer:
    """Accumulate wall-clock times per named phase.

    with timer("e_step"): ...   # waits for the card's queued work if sync
    """

    def __init__(self, sync=True):
        self.sync = sync
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.time()
        yield
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.setdefault(name, []).append(time.time() - t0)

    def summary(self):
        return {
            k: {"total": sum(v), "mean": sum(v) / len(v), "n": len(v)}
            for k, v in self.times.items()
        }
