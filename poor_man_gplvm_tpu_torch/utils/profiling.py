"""Profiling: device traces, the program's spans and counters, and phase
timers.

Counterpart of ``poor_man_gplvm_tpu/utils/profiling.py``: ``trace``
writes a chrome trace through ``torch.profiler`` (CPU and, with a card,
CUDA activities) in place of ``jax.profiler``, and ``PhaseTimer`` syncs
the card with ``torch.cuda.synchronize()``.

The port adds one recorder of spans and counters at its layer boundaries:

* ``span(name, **attrs)`` records a ``Span`` (name, start and end in ns,
  its id, its parent's, the id of its top-level span, attrs) while tracing
  is on: while a ``torch.profiler`` session is active in the process, or
  inside ``recording()``.  Off, it returns one shared no-op context after
  a check of those two flags, and enters no ``record_function``.  Under a
  profiler each span also enters ``torch.profiler.record_function(name)``,
  so it shows in the trace, and its timestamps come from the profiler's
  clock, ``time.time_ns()``.  Inside ``recording(sync=True)`` a span's
  end waits for the card's queued work.  A span opened outside any other
  is top-level (``fit_em``, ``decode_latent``): it stores as attrs the
  deltas of every counter over its extent (``attrs['counters']``) and, on
  a card, of the caching allocator's cudaMalloc calls and retries
  (``attrs['cuda_mallocs']``, ``attrs['cuda_alloc_retries']``).
* ``count(name, n)`` adds to an always-on integer counter (``counters()``
  reads them all): ``h2d_bytes`` / ``h2d_copies`` (``to_device``, every
  host-to-card copy of the fit's and the decode's paths) and
  ``host_syncs`` / ``host_syncs.<site>`` (``host_sync``, every read of a
  device value by the host on those paths), and ``adam_steps`` /
  ``adam_run_steps`` (``ops/mstep.py::make_adam_runner_batch``: its loop's
  trips, and the runs still moving summed over them).
* ``spans()`` returns the recorded spans (at most ``MAX_SPANS``; those
  past it are counted in ``spans_dropped``), ``reset()`` clears them.

The JAX module's ``enable_compilation_cache`` has no counterpart: the
port compiles no programs at run time but its CUDA kernels, which
``ops/_build.py`` builds once per source into ``build/torch_kernels/``
(listed in ``.gitignore``) and reuses while the source is unchanged.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
import torch.autograd.profiler as _tprof

__all__ = ["trace", "PhaseTimer", "span", "recording", "count", "counters",
           "spans", "reset", "host_sync", "to_device", "counts_as_h2d",
           "Span"]

TRACE_FILE = "trace.json"
#: the most spans kept in memory
MAX_SPANS = 100_000

_COUNTS = {}
_SPANS = []
_IDS = itertools.count(1)
_LOCAL = threading.local()  # the open spans of each thread
_DEPTH = 0  # nesting of recording()
_SYNC = False


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


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


def count(name, n=1):
    """Add ``n`` to the counter ``name`` (always on)."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters():
    """A copy of every counter."""
    return dict(_COUNTS)


def host_sync(site, n=1):
    """Count ``n`` reads of a device value by the host at ``site``: the
    counters ``host_syncs`` and ``host_syncs.<site>``."""
    _COUNTS["host_syncs"] = _COUNTS.get("host_syncs", 0) + n
    key = "host_syncs." + site
    _COUNTS[key] = _COUNTS.get(key, 0) + n


def counts_as_h2d(x, device):
    """Whether ``torch.as_tensor(x, device=device)`` copies from the host
    to a card: a CUDA target and a source that is not a CUDA tensor."""
    return torch.device(device).type == "cuda" and not (
        torch.is_tensor(x) and x.device.type == "cuda")


def to_device(x, device, dtype=None):
    """``torch.as_tensor(x, dtype=dtype, device=device)``, counting a copy
    from the host to a card in ``h2d_copies`` and its bytes (the tensor
    made on the card) in ``h2d_bytes``."""
    out = torch.as_tensor(x, dtype=dtype, device=device)
    if counts_as_h2d(x, device):
        count("h2d_copies")
        count("h2d_bytes", out.numel() * out.element_size())
    return out


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Span:
    """One recorded span: ``name``, ``start_ns`` / ``end_ns``
    (``time.time_ns()``, the profiler's clock), ``id``, ``parent`` (the
    enclosing span's id, None at top level), ``top`` (the top-level span's
    id, its own at top level) and ``attrs``."""

    __slots__ = ("name", "id", "parent", "top", "start_ns", "end_ns",
                 "attrs")

    def __init__(self, name, id, parent, top, attrs):
        self.name, self.id, self.parent, self.top = name, id, parent, top
        self.attrs = attrs
        self.start_ns = self.end_ns = None

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"top={self.top}, start_ns={self.start_ns}, "
                f"end_ns={self.end_ns}, attrs={self.attrs!r})")


class _Off:
    """The shared context ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ALLOC_KEYS = (("segment.all.allocated", "cuda_mallocs"),
               ("num_alloc_retries", "cuda_alloc_retries"))


def _alloc_stats():
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    return [stats.get(k, 0) for k, _ in _ALLOC_KEYS]


class _On:
    __slots__ = ("name", "attrs", "rec", "fn", "counts", "allocs")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.rec = self.fn = self.counts = self.allocs = None

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        sid = next(_IDS)
        parent = stack[-1] if stack else None
        rec = self.rec = Span(self.name, sid,
                              None if parent is None else parent.id,
                              sid if parent is None else parent.top,
                              self.attrs)
        if parent is None:
            self.counts = dict(_COUNTS)
            self.allocs = _alloc_stats()
        stack.append(rec)
        rec.start_ns = time.time_ns()  # where the profiler's event starts
        if _tprof._is_profiler_enabled:
            self.fn = _tprof.record_function(rec.name)
            self.fn.__enter__()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        try:
            if _SYNC and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        finally:
            rec.end_ns = time.time_ns()
            if self.fn is not None:
                self.fn.__exit__(*exc)
            _LOCAL.stack.pop()
            if self.counts is not None:
                before = self.counts
                rec.attrs["counters"] = {
                    k: v - before.get(k, 0) for k, v in _COUNTS.items()
                    if v != before.get(k, 0)}
                if self.allocs is not None:
                    now = _alloc_stats()
                    for (_, key), a, b in zip(_ALLOC_KEYS, self.allocs, now):
                        rec.attrs[key] = b - a
            if len(_SPANS) < MAX_SPANS:
                _SPANS.append(rec)
            else:
                count("spans_dropped")
        return False


def span(name, **attrs):
    """A context that records the span ``name`` (with ``attrs``) while
    tracing is on, and yields its ``Span``; off, the shared no-op context,
    which yields None."""
    if not (_tprof._is_profiler_enabled or _DEPTH):
        return _OFF
    return _On(name, attrs)


@contextlib.contextmanager
def recording(sync=False):
    """Turn tracing on inside the block, with no profiler needed.
    ``sync``: every span's end waits for the card's queued work, so that
    its length holds the device time of what it launched."""
    global _DEPTH, _SYNC
    saved = _SYNC
    _DEPTH += 1
    _SYNC = sync
    try:
        yield
    finally:
        _DEPTH -= 1
        _SYNC = saved


def spans():
    """The recorded spans, in the order they ended."""
    return list(_SPANS)


def reset():
    """Forget the recorded spans."""
    _SPANS.clear()


# ---------------------------------------------------------------------------
# phase timer
# ---------------------------------------------------------------------------


class PhaseTimer:
    """Accumulate wall-clock times per named phase: each phase is a
    ``span`` recorded inside ``recording(sync=self.sync)``.

    with timer("e_step"): ...   # waits for the card's queued work if sync
    """

    def __init__(self, sync=True):
        self.sync = sync
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name):
        with recording(sync=self.sync), span(name) as rec:
            yield
        self.times.setdefault(name, []).append(rec.seconds)

    def summary(self):
        return {
            k: {"total": sum(v), "mean": sum(v) / len(v), "n": len(v)}
            for k, v in self.times.items()
        }
