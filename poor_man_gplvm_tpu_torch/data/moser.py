"""Moser-lab navigation session preprocessing.

The port's own copy of ``poor_man_gplvm_tpu/data/moser.py``: a MAT
``Dsession`` struct (``scipy.io.loadmat``) to sliding-window spike counts
and 3-D tracking interpolated at the window centres.  Returns seven values,
as the JAX function does.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import loadmat

from poor_man_gplvm_tpu_torch.data.binning import smooth_and_zscore

__all__ = ["preprocess_moser_data"]


def _flatten_units(field):
    if field is None:
        return []
    if isinstance(field, np.ndarray):
        return list(field.ravel()) if field.size else []
    return [field]


def _label_filter(units_info, use_units):
    use_units = use_units.lower()
    if use_units == "all":
        return units_info
    if use_units == "good":
        return [u for u in units_info if u["label"] == "good"]
    if use_units == "mua":
        return [u for u in units_info if u["label"] == "mua"]
    if use_units in ("good/mua", "good+mua", "goodmua"):
        return [u for u in units_info if u["label"] in ("good", "mua")]
    if use_units == "noise":
        return [u for u in units_info if u["label"] == "noise"]
    raise ValueError(f"Unknown use_units='{use_units}'")


def preprocess_moser_data(
    mat_path, window_size=1.0, step_size=0.5, use_units="all", sigma=0,
    zscore=False, locations="both",
):
    """Returns (spike_count_matrix (U, W), mean_rates (U,), time_bins (W,),
    units (U,) str ids, x_win, y_win, z_win) — window starts in seconds
    relative to the first tracking sample; positions interpolated at window
    centers; spikes clipped to the tracked period."""
    if not os.path.exists(mat_path):
        raise FileNotFoundError(f"MAT-file not found: {mat_path}")

    mat = loadmat(mat_path, squeeze_me=True, struct_as_record=False)
    dsession = mat.get("Dsession", None)
    if dsession is None:
        raise ValueError(
            f"{mat_path} does not contain a 'Dsession' struct. "
            "This function currently supports navigation sessions only."
        )

    t = np.asarray(dsession.t, dtype=float).ravel()
    x = np.asarray(dsession.x, dtype=float).ravel()
    y = np.asarray(dsession.y, dtype=float).ravel()
    z = np.asarray(dsession.z, dtype=float).ravel()
    if not (t.size == x.size == y.size == z.size):
        raise ValueError(
            "Dsession.t, x, y, z must have the same length; "
            f"got t={t.size}, x={x.size}, y={y.size}, z={z.size}."
        )

    t0 = float(t[0])
    t_rel = t - t0
    recording_duration = float(t_rel[-1])
    if recording_duration < window_size:
        num_windows = 0
        time_bins = np.zeros((0,))
    else:
        num_windows = 1 + int(
            np.floor((recording_duration - window_size) / step_size)
        )
        time_bins = np.arange(num_windows, dtype=float) * step_size

    units_struct = getattr(dsession, "units", None)
    if units_struct is None:
        raise ValueError("Dsession.units is missing; cannot extract spike data.")

    locations = locations.lower()
    all_units = []
    if locations in ("both", "mec") and hasattr(units_struct, "mec"):
        all_units += [("mec", u) for u in _flatten_units(units_struct.mec)]
    if locations in ("both", "hc") and hasattr(units_struct, "hc"):
        all_units += [("hc", u) for u in _flatten_units(units_struct.hc)]

    def _interp_positions():
        if num_windows == 0:
            e = np.zeros((0,))
            return e, e.copy(), e.copy()
        centers = time_bins + window_size / 2.0
        return (
            np.interp(centers, t_rel, x),
            np.interp(centers, t_rel, y),
            np.interp(centers, t_rel, z),
        )

    if not all_units:
        x_w, y_w, z_w = _interp_positions()
        return (
            np.zeros((0, num_windows)), np.array([], dtype=float), time_bins,
            np.array([], dtype=str), x_w, y_w, z_w,
        )

    units_info = []
    for loc, u in all_units:
        label_raw = getattr(u, "ks2Label", None)
        spike_times = np.asarray(
            getattr(u, "spikeTimes", []), dtype=float
        ).ravel()
        if spike_times.size:
            mask = (spike_times >= t0) & (spike_times <= t[-1])
            spike_times = spike_times[mask] - t0
        units_info.append(
            {
                "id": str(getattr(u, "id", "")),
                "label": "mua" if label_raw is None else str(label_raw).lower(),
                "location": loc,
                "spike_times": spike_times,
                "mean_rate": getattr(u, "meanRate", None),
            }
        )

    kept = _label_filter(units_info, use_units)
    if not kept:
        x_w, y_w, z_w = _interp_positions()
        return (
            np.zeros((0, num_windows)), np.array([], dtype=float), time_bins,
            np.array([], dtype=str), x_w, y_w, z_w,
        )

    matrix = np.zeros((len(kept), num_windows))
    if num_windows > 0:
        for i, u in enumerate(kept):
            st = u["spike_times"]
            if st.size == 0:
                continue
            start_idx = np.floor(st / step_size).astype(np.int64)
            valid = (start_idx >= 0) & (start_idx < num_windows)
            start_idx, st_v = start_idx[valid], st[valid]
            in_window = st_v < start_idx * step_size + window_size
            start_idx = start_idx[in_window]
            matrix[i] = np.bincount(start_idx, minlength=num_windows)
        matrix = smooth_and_zscore(matrix, sigma=sigma or 0, zscore=zscore)

    x_w, y_w, z_w = _interp_positions()
    units = np.array([u["id"] for u in kept], dtype=str)
    mean_rates = np.array([u["mean_rate"] for u in kept], dtype=float)
    return matrix, mean_rates, time_bins, units, x_w, y_w, z_w
