"""Behavior loading and brain-behavior alignment.

The port's own copy of ``poor_man_gplvm_tpu/data/behavior.py``:
``load_behavior`` reads ``events.csv`` without pandas
(``utils.table.read_csv``) and, with a SLEAP ``analysis.h5`` tracking
file, the nose track through h5py (imported at the call);
``align_brain_and_behavior`` joins each neural bin with the nearest
behavioral sample, removes speed outliers, fills the gaps and segments
trials.  Both return a ``ResultTable`` whose ``to_dataframe()`` is the JAX
function's DataFrame; ``events`` may be such a table or a DataFrame.  The
gaps are filled in numpy for ``interp_method="linear"`` (pandas'
``interpolate`` rule: linear in row position, leading gaps kept, trailing
gaps take the last value); any other method goes through pandas'
``DataFrame.interpolate``, which needs pandas.
"""

from __future__ import annotations

import os

import numpy as np

from poor_man_gplvm_tpu_torch.utils.table import ResultTable, read_csv

__all__ = ["load_behavior", "align_brain_and_behavior"]

POSITION_CONVERSION = 5.1  # px -> cm (the fork's conversion)
_COLUMNS = ("position_x", "position_y", "velocity_x", "velocity_y",
            "reward_state", "speed", "timestamp_ms")


def load_behavior(behavior_file, tracking_file=None):
    """Load events.csv (+ optional SLEAP analysis.h5 nose tracking),
    zero-center positions, derive velocity/speed by first differences."""
    events = read_csv(os.path.join(behavior_file, "events.csv")).to_dict()
    n_rows = len(next(iter(events.values()))) if events else 0

    if tracking_file:
        import h5py

        with h5py.File(tracking_file, "r") as f:
            nose = f["tracks"][:].T[:, 0, :]
        nose = nose[:n_rows, :]
        events["position_x"] = nose[:, 0] - np.nanmean(nose[:, 0])
        events["position_y"] = nose[:, 1] - np.nanmean(nose[:, 1])
    else:
        for axis in ("x", "y"):
            c = events[f"centroid_{axis}"]
            events[f"position_{axis}"] = c - np.nanmean(c)

    for axis in ("x", "y"):
        pos = events[f"position_{axis}"]
        events[f"velocity_{axis}"] = np.diff(pos, prepend=pos[0])
    events["speed"] = np.sqrt(events["velocity_x"] ** 2
                              + events["velocity_y"] ** 2)
    return ResultTable({name: events[name] for name in _COLUMNS})


def _interpolate_linear(col):
    """pandas' ``Series.interpolate(method="linear")``: NaNs after the
    first value filled linearly in row position (the last value carried
    past the end), leading NaNs kept."""
    col = np.array(col, dtype=float)
    valid = ~np.isnan(col)
    if valid.all() or not valid.any():
        return col
    idx = np.arange(len(col))
    fill = ~valid & (idx > np.argmax(valid))
    col[fill] = np.interp(idx[fill], idx[valid], col[valid])
    return col


def align_brain_and_behavior(
    events, spike_rates, units, time_bins, window_size=0.1,
    speed_threshold=4.0, interp_method="linear", order=None,
):
    """Join neural bins with the nearest behavioral sample (to each bin
    center), remove speed outliers (> threshold x std), interpolate gaps,
    and segment trials at reward-state offsets."""
    time_bins = np.asarray(time_bins, dtype=float)
    event_times = np.asarray(events["timestamp_ms"]) / 1000.0
    middles = time_bins + window_size / 2.0

    # nearest behavioral sample to each bin middle; NaN where no sample
    # precedes the middle
    idx = np.searchsorted(event_times, middles)
    idx = np.clip(idx, 1, len(event_times) - 1)
    left, right = event_times[idx - 1], event_times[idx]
    nearest = np.where(
        np.abs(middles - left) <= np.abs(middles - right), idx - 1, idx
    )
    has_prior = (
        middles > event_times.min() if len(event_times)
        else np.zeros(len(middles), dtype=bool)
    )

    def col(name):
        vals = np.asarray(events[name])[nearest].astype(float)
        return np.where(has_prior, vals, np.nan)

    rates = np.asarray(spike_rates).T
    data = {f"Unit {i}": rates[:, j] for j, i in enumerate(units)}
    data["x"] = col("position_x") / POSITION_CONVERSION
    data["y"] = col("position_y") / POSITION_CONVERSION
    data["v_x"] = col("velocity_x") / POSITION_CONVERSION
    data["v_y"] = col("velocity_y") / POSITION_CONVERSION
    data["speed"] = col("speed") / POSITION_CONVERSION
    data["time"] = time_bins
    data["reward_state"] = col("reward_state")

    speed_std = np.nanstd(data["speed"])
    if speed_std == 0:
        speed_std = 1
    outliers = data["speed"] > speed_threshold * speed_std
    for name in ("x", "y", "v_x", "v_y", "speed"):
        data[name] = np.where(outliers, np.nan, data[name])

    if interp_method == "linear":
        data = {name: _interpolate_linear(c) for name, c in data.items()}
    else:
        frame = ResultTable(data).to_dataframe()
        frame.interpolate(method=interp_method, inplace=True, order=order)
        data = {name: frame[name].to_numpy() for name in frame.columns}

    # trial segmentation: a trial increments (and a click fires) on each
    # reward_state falling edge
    rw = data["reward_state"]
    prev = np.concatenate([[0.0], rw[:-1]])
    # float truthiness as in the fork's python-level check (NaN is truthy):
    # trial boundary where prev is truthy and curr is not
    prev_truthy = (prev != 0) | np.isnan(prev)
    curr_falsy = (rw == 0) & ~np.isnan(rw)
    click = (prev_truthy & curr_falsy).astype(float)
    click[0] = 0.0
    data["trial_id"] = np.cumsum(click)
    data["click"] = click
    return ResultTable(data)
