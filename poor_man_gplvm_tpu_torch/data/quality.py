"""Unit quality metrics.

The port's own copy of ``poor_man_gplvm_tpu/data/quality.py``: the
presence ratio as the fork defines it last (its coarse-bin edges extend
one fine step past the last bin, so the final fine bin maps inside the
last coarse bin).  Counts on the card are copied to the host.
"""

from __future__ import annotations

import numpy as np

from poor_man_gplvm_tpu_torch.utils.compat import to_numpy

__all__ = ["get_presence_ratio"]


def get_presence_ratio(est_counts_per_bin, time_bins, n_coarse_bins):
    """Fraction of coarse time bins in which each unit has any spikes.

    est_counts_per_bin: (n_units, n_time); time_bins: (n_time,) monotonic.
    """
    est_counts_per_bin = to_numpy(est_counts_per_bin)
    time_bins = to_numpy(time_bins)
    if time_bins.ndim != 1:
        raise ValueError("time_bins must be 1D (monotonic increasing).")
    if est_counts_per_bin.shape[1] != time_bins.size:
        raise ValueError("est_counts_per_bin columns must match len(time_bins).")

    t0 = time_bins[0]
    t1 = time_bins[-1] + (
        time_bins[1] - time_bins[0] if len(time_bins) > 1 else 1.0
    )
    edges = np.linspace(t0, t1, n_coarse_bins + 1)
    bin_idx = np.clip(
        np.digitize(time_bins, edges, right=False) - 1, 0, n_coarse_bins - 1
    )

    coarse_sums = np.zeros((est_counts_per_bin.shape[0], n_coarse_bins))
    np.add.at(coarse_sums.T, bin_idx, est_counts_per_bin.T)
    return (coarse_sums > 0).mean(axis=1)
