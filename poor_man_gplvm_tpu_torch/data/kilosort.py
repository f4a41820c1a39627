"""Kilosort/Phy output loading.

The port's own copy of ``poor_man_gplvm_tpu/data/kilosort.py``: the
cluster-label TSV, the ``params.py`` sampling rate, unit-label filtering
and sliding-window rates/counts.  The label file is read without pandas
(``utils.table.read_csv``), and ``load_cluster_labels`` returns a
``ResultTable`` whose ``to_dataframe()`` is the JAX function's DataFrame
(the same rows, index, numeric coercion of ``cluster_id`` and lower-cased
labels).  As in the JAX package, ``adj=None`` reads
``spike_times{adj}.npy`` literally; pass ``adj=""`` for ``spike_times.npy``.
"""

from __future__ import annotations

import math
import os

import numpy as np

from poor_man_gplvm_tpu_torch.data.binning import bin_spikes_sliding
from poor_man_gplvm_tpu_torch.utils.table import ResultTable, read_csv

__all__ = [
    "load_cluster_labels",
    "load_kilosort_spikes",
    "filter_units_by_label",
    "compute_spike_rates",
    "compute_spike_counts_old",
]


def _numeric_ids(col):
    """``pd.to_numeric(col, errors="coerce").astype("Int64")`` then the
    missing dropped: (int64 ids, the rows kept).  A number that is not an
    integer raises ``TypeError``, as the cast to Int64 does."""
    vals = np.empty(len(col), dtype=np.float64)
    for i, v in enumerate(col):
        if isinstance(v, str):
            try:
                v = float(v) if "_" not in v else math.nan
            except ValueError:
                v = math.nan
        vals[i] = math.nan if v is None else float(v)
    keep = ~np.isnan(vals)
    if np.any(vals[keep] != np.round(vals[keep])):
        raise TypeError("cannot safely cast non-equivalent float64 to int64")
    if col.dtype.kind in "iu":
        return col.astype(np.int64), keep
    return vals[keep].astype(np.int64), keep


def load_cluster_labels(kilosort_dir):
    """Load cluster_group.tsv / cluster_KSLabel.tsv into a normalized
    (cluster_id, label) ``ResultTable``."""
    candidates = ["cluster_group.tsv", "cluster_KSLabel.tsv"]
    path = None
    for fn in candidates:
        p = os.path.join(kilosort_dir, fn)
        if os.path.exists(p):
            path = p
            break
    if path is None:
        raise FileNotFoundError(
            f"Could not find cluster label file in {kilosort_dir}. "
            f"Tried: {', '.join(candidates)}"
        )

    tab = read_csv(path, sep="\t")
    cols = {c.lower(): c for c in tab.columns}
    id_col = cols.get("cluster_id") or cols.get("id")
    lbl_col = cols.get("kslabel") or cols.get("group")
    if id_col is None or lbl_col is None:
        raise ValueError(
            f"Expected columns like cluster_id and KSLabel/group in {path}; "
            f"found {list(tab.columns)}"
        )
    ids, keep = _numeric_ids(tab[id_col])
    # a missing label stays missing (None), as pandas' str dtype keeps it
    labels = np.array([None if v is None else str(v).lower()
                       for v in tab[lbl_col][keep]], dtype=object)
    return ResultTable({"cluster_id": ids, "label": labels},
                       index=[np.flatnonzero(keep)])


def _read_sampling_rate(kilosort_dir):
    params_path = os.path.join(kilosort_dir, "params.py")
    if not os.path.exists(params_path):
        raise FileNotFoundError(f"params.py not found in {kilosort_dir}")
    with open(params_path) as f:
        lines = [ln for ln in f.read().splitlines() if "sample_rate" in ln]
    if not lines:
        raise ValueError("sample_rate not found in params.py")
    return float(lines[0].split("=")[1].strip())


def keep_ids_for_label(info, use_units):
    """The cluster ids of ``info`` (a table of cluster_id and label, the
    port's or a DataFrame) that ``use_units`` selects."""
    ids = np.asarray(info["cluster_id"])
    labels = np.asarray(info["label"])
    use_units = use_units.lower()
    if use_units == "all":
        return ids
    if use_units == "good":
        return ids[labels == "good"]
    if use_units == "mua":
        return ids[labels == "mua"]
    if use_units in ("good/mua", "good+mua", "goodmua"):
        return ids[np.isin(labels, ["good", "mua"])]
    if use_units == "noise":
        return ids[labels == "noise"]
    raise ValueError(f"Unknown use_units='{use_units}'")


def filter_units_by_label(spike_times, spike_clusters, info, use_units):
    keep_ids = keep_ids_for_label(info, use_units)
    mask = np.isin(spike_clusters, keep_ids)
    return spike_times[mask], spike_clusters[mask]


def load_kilosort_spikes(kilosort_dir, use_units="all", adj=None):
    """Load spike times (seconds) + cluster IDs, filtered by unit label.

    ``adj='_sec_adj'`` selects the seconds-adjusted spike_times file
    (already in seconds); otherwise samples are divided by the params.py
    sample_rate."""
    spike_times_path = os.path.join(kilosort_dir, f"spike_times{adj}.npy")
    spike_clusters_path = os.path.join(kilosort_dir, "spike_clusters.npy")
    if not all(os.path.exists(p) for p in [spike_times_path, spike_clusters_path]):
        raise FileNotFoundError("Missing required Kilosort output files.")

    sampling_rate = _read_sampling_rate(kilosort_dir)
    spike_times = np.load(spike_times_path).astype(np.float64).ravel()
    if adj != "_sec_adj":
        spike_times = spike_times / sampling_rate
    spike_clusters = np.load(spike_clusters_path).ravel()

    info = load_cluster_labels(kilosort_dir)
    return filter_units_by_label(spike_times, spike_clusters, info, use_units)


def compute_spike_rates(
    kilosort_dir, window_size=1.0, step_size=0.5, use_units="all", sigma=2.5,
    zscore=True, adj=None,
):
    """Smoothed sliding-window firing rates in Hz from Kilosort output."""
    spike_times, spike_clusters = load_kilosort_spikes(
        kilosort_dir, use_units=use_units, adj=adj
    )
    return bin_spikes_sliding(
        spike_times, spike_clusters, window_size=window_size,
        step_size=step_size, rates=True, sigma=sigma, zscore=zscore,
    )


def compute_spike_counts_old(
    kilosort_dir, window_size=1.0, step_size=0.5, use_units="all", sigma=2.5,
    zscore=True, adj=None,
):
    """Sliding-window spike counts from Kilosort output (the windowing of
    ``compute_spike_rates`` without the rate conversion)."""
    spike_times, spike_clusters = load_kilosort_spikes(
        kilosort_dir, use_units=use_units, adj=adj
    )
    return bin_spikes_sliding(
        spike_times, spike_clusters, window_size=window_size,
        step_size=step_size, rates=False, sigma=sigma, zscore=zscore,
    )
