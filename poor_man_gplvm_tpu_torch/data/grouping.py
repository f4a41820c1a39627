"""Unit collection across probes/regions and within-panel unit ordering.

The port's own copy of ``poor_man_gplvm_tpu/data/grouping.py`` (numpy and
scipy, on the host): ``sort_units(mode="corr")`` orders units by
average-linkage clustering of their correlation distances with optimal
leaf ordering, flat units last.
"""

from __future__ import annotations

import numpy as np
from scipy.cluster.hierarchy import leaves_list, linkage, optimal_leaf_ordering
from scipy.spatial.distance import squareform

__all__ = ["collect_matrix_for", "collect_matrix_for_bilat", "sort_units"]


def collect_matrix_for(
    spike_rate_matrices, region_name, regions, cell_type_key, cell_types,
    probes, cell_type_groups,
):
    """Stack rate matrices for units matching (region, cell-type group)
    across probes (reference core.py:1423-1437)."""
    labels = set(cell_type_groups[cell_type_key])
    collected = []
    for p in probes:
        mat, _, _ = spike_rate_matrices[p]
        mask = (regions[p] == region_name) & np.isin(
            cell_types[p], list(labels)
        )
        if np.any(mask):
            collected.append(mat[mask, :])
    return np.vstack(collected) if collected else None


def collect_matrix_for_bilat(
    spike_rate_matrices, region_name, regions, cell_type_key, cell_types,
    probes, cell_type_groups, hemi, hemisphere_dict,
):
    """As collect_matrix_for, additionally filtered by hemisphere
    (reference core.py:1440-1455)."""
    labels = set(cell_type_groups[cell_type_key])
    collected = []
    for p in probes:
        mat, _, _ = spike_rate_matrices[p]
        mask = (
            (regions[p] == region_name)
            & np.isin(cell_types[p], list(labels))
            & (hemisphere_dict[p] == hemi)
        )
        if np.any(mask):
            collected.append(mat[mask, :])
    return np.vstack(collected) if collected else None


def sort_units(matrix, mode="corr"):
    """Order units by mean rate, peak time, or correlation-linkage with
    optimal leaf ordering (flat units last) (reference core.py:1459-1516)."""
    if matrix is None or matrix.shape[0] == 0:
        return matrix

    if mode == "mean":
        return matrix[np.argsort(matrix.mean(axis=1))]
    if mode == "peak":
        return matrix[np.argsort(np.argmax(matrix, axis=1))]
    if mode == "corr":
        if matrix.shape[0] <= 1:
            return matrix
        X = matrix.astype(float, copy=True)
        X -= X.mean(axis=1, keepdims=True)
        std = X.std(axis=1, keepdims=True)
        nonzero = std.squeeze() > 0
        valid_idx = np.where(nonzero)[0]
        invalid_idx = np.where(~nonzero)[0]
        if valid_idx.size <= 1:
            return matrix[np.r_[valid_idx, invalid_idx]]
        X[valid_idx] /= std[valid_idx]
        C = np.corrcoef(X[valid_idx])
        C = np.nan_to_num(C, nan=0.0, posinf=0.0, neginf=0.0)
        D = np.clip(1.0 - C, 0.0, 2.0)
        dvec = squareform(D, checks=False)
        Z = optimal_leaf_ordering(linkage(dvec, method="average"), dvec)
        order = np.r_[valid_idx[leaves_list(Z)], invalid_idx]
        return matrix[order]
    return matrix
