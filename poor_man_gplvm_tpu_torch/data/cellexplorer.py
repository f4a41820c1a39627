"""CellExplorer cell_metrics loading.

The port's own copy of ``poor_man_gplvm_tpu/data/cellexplorer.py``: the
``cell_metrics.cellinfo.mat`` struct read with ``scipy.io.loadmat``, as in
the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import loadmat

__all__ = ["mat_struct_to_dict", "load_cell_metrics"]


def mat_struct_to_dict(s):
    """Convert a scipy mat_struct (struct_as_record=False, squeeze_me=True)
    to a plain dict (reference core.py:911-913)."""
    return {name: getattr(s, name) for name in getattr(s, "_fieldnames", [])}


def load_cell_metrics(cell_metrics_file, verbose=False, **kwargs):
    """Parse a CellExplorer ``cell_metrics.cellinfo.mat`` file.

    Returns a dict with cellIDs (1-indexed), cluIDs (0-indexed Kilosort),
    tags (region -> cellIDs), spikeCount, refractoryPeriodViolations,
    putativeCellType, spikes (per-cell spike time arrays), shankID, and
    SleepState (state -> (n_episodes, 2) [start, end] array, or None)
    (reference core.py:1074-1218)."""
    verbose = kwargs.get("verbose", verbose)
    if not os.path.exists(cell_metrics_file):
        raise FileNotFoundError(
            f"Cell metrics file not found: {cell_metrics_file}"
        )

    raw = loadmat(cell_metrics_file, struct_as_record=False, squeeze_me=True)
    if "cell_metrics" not in raw:
        raise KeyError("`cell_metrics` structure not found in .mat file.")
    cm = mat_struct_to_dict(raw["cell_metrics"])

    general = cm.get("general")
    states = mat_struct_to_dict(general).get("states") if general is not None else None
    sleep_state = (
        mat_struct_to_dict(mat_struct_to_dict(states).get("SleepState"))
        if states is not None
        else None
    )

    tags_raw = cm.get("tags")
    tags = mat_struct_to_dict(tags_raw) if tags_raw is not None else {}

    spikes_raw = cm.get("spikes")
    spikes = (
        mat_struct_to_dict(spikes_raw).get("times") if spikes_raw is not None
        else None
    )

    result = {
        "cellIDs": cm.get("cellID"),
        "cluIDs": cm.get("cluID"),
        "tags": tags,
        "spikeCount": cm.get("spikeCount"),
        "refractoryPeriodViolations": cm.get("refractoryPeriodViolation"),
        "putativeCellType": cm.get("putativeCellType"),
        "spikes": spikes,
        "shankID": cm.get("shankID"),
        "SleepState": sleep_state,
    }

    if verbose:
        n_cells = len(result["cellIDs"]) if result["cellIDs"] is not None else 0
        print("=" * 60)
        print(f"Cell Metrics Summary: {cell_metrics_file}")
        print(f"Total cells: {n_cells}")
        for region, ids in tags.items():
            try:
                count = len(ids)
            except TypeError:
                count = 1
            print(f"  region {region}: {count} cells")
        if sleep_state is not None:
            for state, arr in sleep_state.items():
                print(f"  sleep state {state}: {np.shape(arr)}")
        if result["putativeCellType"] is not None:
            types, counts = np.unique(
                result["putativeCellType"], return_counts=True
            )
            for t, c in zip(types, counts):
                print(f"  cell type {t}: {c}")
        print("=" * 60)

    return result
