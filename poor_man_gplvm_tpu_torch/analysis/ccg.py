"""Spike-train correlograms (cross- and auto-), including the theta
cycle-skipping index.

The port's own copy of ``poor_man_gplvm_tpu/analysis/ccg.py`` (numpy, on
the host): pairwise lags gathered by a sliding searchsorted window, as the
JAX package does.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compute_ccg_counts", "compute_acg_counts", "theta_skipping_index"]


def compute_ccg_counts(spk_ref, spk_tgt, bin_s=0.001, half_window_s=0.25,
                       t0=None, t1=None):
    """Cross-correlogram counts of lags tau = t_tgt - t_ref within
    [-half_window, +half_window].

    Returns (tau bin centers, counts)."""
    spk_ref = np.sort(np.asarray(spk_ref, dtype=float))
    spk_tgt = np.sort(np.asarray(spk_tgt, dtype=float))
    if t0 is not None:
        spk_ref = spk_ref[spk_ref >= t0]
        spk_tgt = spk_tgt[spk_tgt >= t0]
    if t1 is not None:
        spk_ref = spk_ref[spk_ref <= t1]
        spk_tgt = spk_tgt[spk_tgt <= t1]

    n_bins = int(round(2 * half_window_s / bin_s))
    edges = -half_window_s + np.arange(n_bins + 1) * bin_s
    tau = 0.5 * (edges[:-1] + edges[1:])
    counts = np.zeros(n_bins)
    if spk_ref.size == 0 or spk_tgt.size == 0:
        return tau, counts

    lo = np.searchsorted(spk_tgt, spk_ref - half_window_s, side="left")
    hi = np.searchsorted(spk_tgt, spk_ref + half_window_s, side="right")
    # gather all in-window lags (total pairs = sum(hi - lo))
    reps = hi - lo
    ref_rep = np.repeat(spk_ref, reps)
    tgt_idx = np.concatenate(
        [np.arange(a, b) for a, b in zip(lo, hi)]
    ) if reps.sum() else np.array([], dtype=int)
    lags = spk_tgt[tgt_idx] - ref_rep
    counts, _ = np.histogram(lags, bins=edges)
    return tau, counts.astype(float)


def compute_acg_counts(spk, bin_s=0.001, half_window_s=0.25, t0=None,
                       t1=None, exclude_zero=True):
    """Autocorrelogram counts (optionally dropping the zero-lag
    self-pairs)."""
    tau, counts = compute_ccg_counts(
        spk, spk, bin_s=bin_s, half_window_s=half_window_s, t0=t0, t1=t1
    )
    if exclude_zero:
        spk_arr = np.asarray(spk, dtype=float)
        if t0 is not None:
            spk_arr = spk_arr[spk_arr >= t0]
        if t1 is not None:
            spk_arr = spk_arr[spk_arr <= t1]
        # zero-lag self-pairs land in the bin whose LEFT edge is 0
        # (np.histogram bins are [left, right)); argmin(|tau|) would
        # tie-break to the bin centered at -bin_s/2 and leave negative
        # counts there plus uncorrected phantom pairs at +bin_s/2
        edges = -half_window_s + np.arange(len(tau) + 1) * bin_s
        zero_bin = int(np.searchsorted(edges, 0.0, side="right")) - 1
        zero_bin = min(max(zero_bin, 0), len(counts) - 1)
        counts[zero_bin] -= len(spk_arr)
    return tau, counts


def theta_skipping_index(tau, counts, theta_period_s=0.125, peak_win_frac=0.3,
                         smooth_bins=3):
    """Theta cycle-skipping index from a correlogram:
    (p2 - p1) / max(p1, p2) where p1/p2 are the (smoothed) correlogram peaks
    near lags of one and two theta periods.  Positive values indicate
    cycle skipping."""
    counts = np.asarray(counts, dtype=float)
    if smooth_bins > 1:
        kernel = np.ones(smooth_bins) / smooth_bins
        counts = np.convolve(counts, kernel, mode="same")

    def peak_near(lag):
        win = peak_win_frac * theta_period_s
        sel = (np.abs(tau) >= lag - win) & (np.abs(tau) <= lag + win)
        return counts[sel].max() if sel.any() else np.nan

    p1 = peak_near(theta_period_s)
    p2 = peak_near(2 * theta_period_s)
    denom = max(p1, p2)
    if not np.isfinite(denom) or denom == 0:
        return np.nan
    return (p2 - p1) / denom
