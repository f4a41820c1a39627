"""Spike binning: sliding-window counts/rates from spike times.

The port's own copy of ``poor_man_gplvm_tpu/data/binning.py`` (the fork's
``compute_spike_rates``, ``compute_spike_counts_old`` and
``compute_spike_counts`` conventions, each kept exactly).  Above 100,000
spikes (``use_native=None``), or with ``use_native=True``, the counts come
from the native binner (``data/native.py``); where it cannot be built this
raises, naming ``use_native=False``, where the JAX package falls back to
numpy without a word.  ``use_native=False`` bins in numpy (the plain
version).  Host code: the model layer moves the counts to the card.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter1d

__all__ = [
    "bin_spikes_sliding",
    "compute_spike_counts",
    "smooth_and_zscore",
]


def smooth_and_zscore(matrix, sigma=0.0, zscore=False):
    """Optional per-unit Gaussian smoothing (sigma in window steps,
    mode='nearest') and z-scoring across time."""
    matrix = np.asarray(matrix, dtype=np.float64)
    if sigma and sigma > 0:
        matrix = gaussian_filter1d(matrix, sigma=sigma, axis=1, mode="nearest")
    if zscore:
        mean = matrix.mean(axis=1, keepdims=True)
        std = matrix.std(axis=1, keepdims=True)
        std[std == 0] = 1.0
        matrix = (matrix - mean) / std
    return matrix


def bin_spikes_sliding(
    spike_times, spike_clusters, window_size=1.0, step_size=0.5,
    rates=False, sigma=0.0, zscore=False, t_origin=0.0, use_native=None,
):
    """Start-aligned sliding-window binning (each spike counted once, in the
    window whose start index is ``floor(t / step)``), the convention of
    ``compute_spike_rates``/``compute_spike_counts_old``.

    Returns (matrix (n_units, n_windows), time_bins (window starts), units).
    """
    spike_times = np.asarray(spike_times, dtype=np.float64) - t_origin
    spike_clusters = np.asarray(spike_clusters)
    if spike_times.size == 0:
        return (
            np.zeros((0, 0)), np.zeros((0,)), np.array([], dtype=int),
        )

    recording_duration = float(spike_times.max())
    if recording_duration < window_size:
        units = np.unique(spike_clusters)
        return np.zeros((len(units), 0)), np.zeros((0,)), units

    num_windows = 1 + int(np.floor((recording_duration - window_size) / step_size))
    time_bins = np.arange(num_windows, dtype=np.float64) * step_size

    units, rows = np.unique(spike_clusters, return_inverse=True)
    if use_native is None:
        use_native = spike_times.size > 100_000
    if use_native:
        from poor_man_gplvm_tpu_torch.data import native

        matrix = native.bin_sliding_native(
            spike_times, rows, window_size, step_size, num_windows,
            units.size,
        )
        # unlike the numpy path, units without surviving spikes keep their
        # (all-zero) row; drop them, as the numpy path's np.unique over the
        # surviving spikes does
        keep = matrix.sum(axis=1) > 0
        if not keep.all():
            matrix, units = matrix[keep], units[keep]
        if rates:
            matrix = matrix / float(window_size)
        matrix = smooth_and_zscore(matrix, sigma=sigma, zscore=zscore)
        return matrix, time_bins, units

    start_idx = np.floor(spike_times / step_size).astype(np.int64)
    valid = (start_idx >= 0) & (start_idx < num_windows)
    start_idx, st_v, clu_v = (
        start_idx[valid], spike_times[valid], spike_clusters[valid],
    )
    # spikes past their start-window's end are dropped (float edge guard)
    in_window = st_v < start_idx * step_size + window_size
    start_idx, clu_v = start_idx[in_window], clu_v[in_window]

    units, rows = np.unique(clu_v, return_inverse=True)
    matrix = np.zeros((units.size, num_windows), dtype=np.float64)
    np.add.at(matrix, (rows, start_idx), 1.0)

    if rates:
        matrix = matrix / float(window_size)
    matrix = smooth_and_zscore(matrix, sigma=sigma, zscore=zscore)
    return matrix, time_bins, units


def compute_spike_counts(
    spike_times, spike_clusters, window_size=1.0, step_size=1.0,
    sigma=0.0, zscore=False, use_native=None,
):
    """Overlapping-window counting: each spike is added to EVERY window
    containing it (window k covers [t0 + k*step, t0 + k*step + window)).
    Time bins are anchored at the first spike time (absolute coordinates
    preserved).

    Vectorized: for overlap factor W = ceil(window/step), each spike lands in
    at most W consecutive windows; we scatter once per offset.
    """
    spike_times = np.asarray(spike_times, dtype=np.float64)
    spike_clusters = np.asarray(spike_clusters)

    if spike_times.size == 0:
        return np.zeros((0, 0)), np.zeros((0,)), np.array([], dtype=int)
    if spike_times.shape != spike_clusters.shape:
        raise ValueError("spike_times and spike_clusters must have the same shape")
    if window_size <= 0 or step_size <= 0:
        raise ValueError("window_size and step_size must be positive")

    t_start = float(spike_times.min())
    t_end = float(spike_times.max())
    if (t_end - t_start) < window_size:
        units = np.unique(spike_clusters)
        return np.zeros((len(units), 0)), np.zeros((0,)), units

    num_windows = 1 + int(np.floor(((t_end - t_start) - window_size) / step_size))
    time_bins = t_start + np.arange(num_windows, dtype=np.float64) * step_size

    units, rows = np.unique(spike_clusters, return_inverse=True)
    if use_native is None:
        use_native = spike_times.size > 100_000
    if use_native:
        from poor_man_gplvm_tpu_torch.data import native

        matrix = native.bin_overlapping_native(
            spike_times, rows, t_start, window_size, step_size,
            num_windows, units.size,
        )
        matrix = smooth_and_zscore(matrix, sigma=sigma, zscore=zscore)
        return matrix, time_bins, units
    matrix = np.zeros((units.size, num_windows), dtype=np.float64)

    rel = spike_times - t_start
    k_max = np.clip(np.floor(rel / step_size).astype(np.int64), 0, num_windows - 1)
    k_min = np.clip(
        np.ceil((rel - window_size) / step_size).astype(np.int64), 0,
        num_windows - 1,
    )

    max_span = int((k_max - k_min).max()) + 1 if rel.size else 0
    for offset in range(max_span):
        k = k_min + offset
        sel = k <= k_max
        np.add.at(matrix, (rows[sel], k[sel]), 1.0)

    matrix = smooth_and_zscore(matrix, sigma=sigma, zscore=zscore)
    return matrix, time_bins, units
