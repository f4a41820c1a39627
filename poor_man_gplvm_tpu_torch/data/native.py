"""The native (C++) spike binner, built at first use and loaded via ctypes.

Counterpart of ``poor_man_gplvm_tpu/data/native``: the ingestion layer's
host-side hot path, binning 1e7+ spikes.  The source is the port's own
``csrc/binning.cpp``; ``ops/_build.py`` compiles it with the host's C++
compiler (``g++ -O3 -shared -fPIC``, or ``$CXX``) into
``build/torch_kernels/binning_<source hash>.so`` at the repository root, as
it builds the CUDA kernels with nvcc.  Nothing is built at import.

Unlike the JAX module, there is no silent fallback: where the library
cannot be built or loaded, ``bin_sliding_native`` and
``bin_overlapping_native`` raise ``RuntimeError`` and the binning entry
points name ``use_native=False``, the numpy version, which is the plain
version.  ``available()`` says whether the build succeeds.  Each function
counts its calls in ``.calls``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["available", "bin_sliding_native", "bin_overlapping_native"]


def _lib():
    """The loaded binner library; raises ``RuntimeError`` naming
    ``use_native=False`` where it cannot be built or loaded."""
    from poor_man_gplvm_tpu_torch.ops import _build

    try:
        return _build.load("binning")
    except (OSError, RuntimeError) as exc:
        raise RuntimeError(
            "the native spike binner could not be built or loaded "
            f"({exc}); pass use_native=False to bin in numpy") from exc


def available():
    """Whether the native binner builds and loads here (it is built now
    when it is not built yet)."""
    try:
        _lib()
    except RuntimeError:
        return False
    return True


def _as_args(spike_times, rows):
    st = np.ascontiguousarray(spike_times, dtype=np.float64)
    rw = np.ascontiguousarray(rows, dtype=np.int64)
    if st.shape != rw.shape or st.ndim != 1:
        raise ValueError("spike_times and rows must be 1-D of one length")
    return st, rw


def bin_sliding_native(spike_times, rows, window, step, n_windows, n_units):
    """Start-aligned sliding-window counts; returns (n_units, n_windows)
    float64."""
    lib = _lib()
    st, rw = _as_args(spike_times, rows)
    out = np.zeros((int(n_units), int(n_windows)), dtype=np.float64)
    lib.bin_sliding(st.ctypes.data, rw.ctypes.data, len(st), float(window),
                    float(step), int(n_windows), int(n_units),
                    out.ctypes.data)
    bin_sliding_native.calls += 1
    return out


def bin_overlapping_native(spike_times, rows, t_start, window, step,
                           n_windows, n_units):
    """Overlapping-window counts; returns (n_units, n_windows) float64."""
    lib = _lib()
    st, rw = _as_args(spike_times, rows)
    out = np.zeros((int(n_units), int(n_windows)), dtype=np.float64)
    lib.bin_overlapping(st.ctypes.data, rw.ctypes.data, len(st),
                        float(t_start), float(window), float(step),
                        int(n_windows), int(n_units), out.ctypes.data)
    bin_overlapping_native.calls += 1
    return out


bin_sliding_native.calls = 0
bin_overlapping_native.calls = 0
