"""Population-burst detection and cross-probe burst merging.

The port's own copy of ``poor_man_gplvm_tpu/data/bursts.py`` (numpy, on
the host): threshold a z-scored MUA trace into burst epochs, and merge
bursts that overlap in time across two probes.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "detect_population_bursts",
    "merge_overlapping_bursts_two_probes",
]


def detect_population_bursts(zsmoothed_mua, **kwargs):
    """Threshold z-scored MUA -> burst epochs: merge close bursts, expand
    boundaries down to a lower threshold, filter by duration.  Returns a
    list of (start_idx, end_idx) with INCLUSIVE ends
    (reference core.py:1375-1420)."""
    burst_threshold = kwargs.get("BURST_THRESHOLD", 3)
    boundary_threshold = kwargs.get("BURST_BOUNDARY_THRESHOLD", 0)
    min_duration = kwargs.get("MIN_BURST_DURATION", 0.05)
    min_interburst = kwargs.get("MIN_INTERBURST_INTERVAL", 0.25)
    step_size = kwargs.get("STEP_SIZE", 0.01)

    zsmoothed_mua = np.asarray(zsmoothed_mua)
    mask = np.concatenate(([False], zsmoothed_mua > burst_threshold, [False]))
    diff = np.diff(mask.astype(int))
    starts = np.where(diff == 1)[0]
    ends = np.where(diff == -1)[0]  # index one past last above-threshold bin

    # merge bursts separated by short gaps (reference core.py:1392-1397)
    if len(starts) >= 2:
        gap_bins = starts[1:] - ends[:-1] - 1
        merge = (gap_bins * step_size) < min_interburst
        starts = np.delete(starts, np.where(merge)[0] + 1)
        ends = np.delete(ends, np.where(merge)[0])

    # expand boundaries while the signal stays above the boundary threshold
    n = len(zsmoothed_mua)
    boundaries = []
    for start, end in zip(starts, ends):
        while start > 0 and zsmoothed_mua[start - 1] > boundary_threshold:
            start -= 1
        while end < n - 1 and zsmoothed_mua[end + 1] > boundary_threshold:
            end += 1
        boundaries.append((start, end))

    # duration filter (inclusive ends)
    out = []
    for s, e in boundaries:
        if (e - s + 1) * step_size >= min_duration:
            out.append((s, e))
    return out


def _intervals_from_boundaries(time_bins, boundaries, end_inclusive=True):
    """(start_idx, end_idx) pairs -> sorted interval dicts with times
    (reference core.py:1221-1242)."""
    tb = np.asarray(time_bins)
    out = []
    for k, (s, e) in enumerate(boundaries):
        if not end_inclusive:
            e = e - 1
        if e < s:
            continue
        out.append(
            {
                "orig_k": k, "s_idx": s, "e_idx": e,
                "s_t": float(tb[s]), "e_t": float(tb[e]),
            }
        )
    out.sort(key=lambda d: d["s_t"])
    return out


def _to_indices(time_bins, s_t, e_t, end_inclusive=True):
    """Times -> index boundaries on a probe's own time grid
    (reference core.py:1244-1264)."""
    tb = np.asarray(time_bins)
    s_idx = int(np.searchsorted(tb, s_t, side="left"))
    e_idx_inclusive = int(np.searchsorted(tb, e_t, side="right") - 1)
    s_idx = max(0, min(s_idx, len(tb) - 1))
    e_idx_inclusive = max(0, min(e_idx_inclusive, len(tb) - 1))
    if e_idx_inclusive < s_idx:
        e_idx_inclusive = s_idx
    if end_inclusive:
        return s_idx, e_idx_inclusive
    return s_idx, min(e_idx_inclusive + 1, len(tb))


def merge_overlapping_bursts_two_probes(
    data_dict, probeA, probeB, end_inclusive=True, strict_overlap=True
):
    """Form time-connected overlap groups of bursts across two probes; merge
    each probe's members within a group into one interval
    (reference core.py:1266-1372).

    Returns (mergedA_boundaries, mergedB_boundaries, merged_groups)."""
    A = _intervals_from_boundaries(
        data_dict[probeA]["time_bins"],
        data_dict[probeA].get("burst_boundaries", []),
        end_inclusive=end_inclusive,
    )
    B = _intervals_from_boundaries(
        data_dict[probeB]["time_bins"],
        data_dict[probeB].get("burst_boundaries", []),
        end_inclusive=end_inclusive,
    )

    combined = [(d["s_t"], d["e_t"], "A", d) for d in A] + [
        (d["s_t"], d["e_t"], "B", d) for d in B
    ]
    combined.sort(key=lambda x: x[0])

    groups = []
    k = 0
    while k < len(combined):
        g_end = combined[k][1]
        members = {"A": [], "B": []}
        kk = k
        while kk < len(combined):
            s_t, e_t, side, d = combined[kk]
            if strict_overlap:
                if s_t >= g_end:
                    break
            elif s_t > g_end:
                break
            members[side].append(d)
            g_end = max(g_end, e_t)
            kk += 1
        groups.append(members)
        k = kk

    mergedA, mergedB, merged_groups = [], [], []
    for g in groups:
        a_merged = b_merged = None
        if g["A"]:
            a_merged = (
                min(d["s_t"] for d in g["A"]), max(d["e_t"] for d in g["A"]),
            )
            mergedA.append(a_merged)
        if g["B"]:
            b_merged = (
                min(d["s_t"] for d in g["B"]), max(d["e_t"] for d in g["B"]),
            )
            mergedB.append(b_merged)
        merged_groups.append(
            {
                "A_time": a_merged,
                "B_time": b_merged,
                "A_orig_indices": [d["orig_k"] for d in g["A"]],
                "B_orig_indices": [d["orig_k"] for d in g["B"]],
            }
        )

    mergedA_boundaries = [
        _to_indices(data_dict[probeA]["time_bins"], s, e, end_inclusive)
        for s, e in mergedA
    ]
    mergedB_boundaries = [
        _to_indices(data_dict[probeB]["time_bins"], s, e, end_inclusive)
        for s, e in mergedB
    ]
    return mergedA_boundaries, mergedB_boundaries, merged_groups
