"""The traced run's device trace: ``torch.profiler`` over a bounded number
of calls inside the window, reduced to what the per-layer readers and the
result line's ``breakdown`` take.

A device interval is a kernel, a copy or a fill; ``busy_s`` is the length
of their union inside the traced window, ``window_s`` the window's length
(the benchmark's own ``bench.window`` span).  An idle gap is named by the
innermost host operation running at its middle.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW_SPAN = "bench.window"
#: the profiler's own host events, which name no work of the host
PROFILER_EVENTS = ("Activity Buffer Request",)


class Traced:
    """Profile the calls made inside ``with`` (the window's first calls)."""

    def __init__(self):
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self._span = None

    def __enter__(self):
        self.prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def summary(self):
        return summarise(self.prof)


class Summary:
    """Device operations by name, busy and window seconds, and the longest
    idle gaps by host operation."""

    def __init__(self, kernels, busy_s, window_s, gaps):
        self.kernels = kernels  # name -> [seconds, launches]
        self.busy_s = busy_s
        self.window_s = window_s
        self.gaps = gaps  # host op -> idle seconds, the longest gaps

    def kernel_seconds(self, pattern):
        """Seconds of the device operations whose name matches
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        return sum(s for name, (s, _) in self.kernels.items()
                   if rx.search(name))

    def breakdown(self, n=10):
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v[0]] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def summarise(prof, n_gaps=20_000):
    events = list(prof.profiler.kineto_results.events())
    window = next(e for e in events if e.name() == WINDOW_SPAN
                  and e.device_type() == torch._C._autograd.DeviceType.CPU)
    w0, w1 = window.start_ns(), window.end_ns()
    kernels, spans, cpu = {}, [], []
    cuda = torch._C._autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type() != cuda]
    # a host span (record_function) is mirrored on the device under its
    # own name; no kernel, copy or fill shares a name with a host event
    host_names = {e.name() for e in host}
    for e in events:
        if e.device_type() != cuda or e.name() in host_names:
            continue
        s, t = e.start_ns(), e.end_ns()
        if t <= s:
            continue
        spans.append((s, t))
        name = e.name()
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) * 1e-9
        k[1] += 1
    for e in host:
        if e.name() not in (WINDOW_SPAN, *PROFILER_EVENTS) and \
                e.end_ns() > e.start_ns():
            cpu.append((e.start_ns(), e.end_ns(), e.name()))
    # the union of the device intervals inside the window
    spans.sort()
    busy, merged, cur = 0, [], None
    for s, t in spans:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if cur is None or s > cur[1]:
            if cur is not None:
                merged.append(cur)
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        merged.append(cur)
    busy = sum(t - s for s, t in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    named = {}
    if cpu:
        cpu.sort()
        cs = np.array([c[0] for c in cpu], dtype=np.int64)
        ce = np.array([c[1] for c in cpu], dtype=np.int64)
        for length, a, b in gaps[:n_gaps]:
            mid = (a + b) // 2
            # the innermost host event over the middle: the latest started
            # of those that have not ended (host events nest)
            i = int(np.searchsorted(cs, mid, side="right")) - 1
            name = "host"
            for j in range(i, max(i - 256, -1), -1):
                if ce[j] >= mid:
                    name = cpu[j][2]
                    break
            named[name] = named.get(name, 0.0) + length * 1e-9
    return Summary(kernels, busy * 1e-9, (w1 - w0) * 1e-9, named)
