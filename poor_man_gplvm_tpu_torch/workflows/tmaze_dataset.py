"""Post-fit workflow for the T-maze dataset.

The port's own copy of ``poor_man_gplvm_tpu/workflows/tmaze_dataset.py``
(reference poor_man_gplvm/post_fit_workflow/post_fit_tmaze_dataset.py):
latent classification against position/speed (spatial / immobility /
off-maze via DBSCAN), latent-field properties (incl. circular statistics
on a wrapped linear coordinate), reward-latent selection, transition-time
detection, peri-transition jump-consensus analysis with circular-shift
nulls, and latent-jump-triggered contrastive-projection analyses.

The inputs are what the port's fit and decode give: its ``Tsd``/
``TsdFrame``s (or pynapple's, where it is installed), numpy arrays, or
tensors on the card (the MAP latent, the jump probabilities, the fitted
``tuning``), which are copied to the host (``compat.to_numpy``); the
numbers are computed in numpy on the host, as in the JAX package.  Trial
tables are a ``ResultTable``, a pandas DataFrame (``start``/``end``
columns, plus ``choice``/``visitedArm`` where needed) or an IntervalSet.
Where the JAX function returns a Series or DataFrame this returns a
``ResultTable`` (``to_series()``/``to_dataframe()`` give the JAX object)
and a pandas Index as a numpy array.  No progress bars (``verbose`` is
accepted and prints nothing).  sklearn (``classify_latent``) and
matplotlib (the ``plot_*`` functions) are imported at the call.
Dataset-tailored by design (reference post_fit_workflow/readme.md).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.distance import cdist

from poor_man_gplvm_tpu_torch import analysis as ah
from poor_man_gplvm_tpu_torch import validation as vlj
from poor_man_gplvm_tpu_torch.utils import compat
from poor_man_gplvm_tpu_torch.utils.table import (
    ResultTable,
    concat_tables,
    cut_codes,
)

__all__ = [
    "get_latent_occurance_index_per_speed_level",
    "get_dist_to_maze",
    "classify_latent",
    "get_latent_field_properties",
    "get_latent_in_position_range",
    "get_single_reward_latent",
    "get_both_reward_latent",
    "find_all_index_per_latent_pair",
    "find_transition_times",
    "compute_consensus_fractions_by_window",
    "compute_shuffle_consensus_fractions",
    "analyze_peri_transition_jump_consensus",
    "latent_jump_triggered_analysis",
    "get_null_contrastive_projection",
    "plot_latent_list_vs_position",
    "plot_multiple_latent_spatial_map",
    "plot_multiple_latent_posterior_in_time",
    "get_time_of_arrival_based_one_position",
]


def _data(x):
    """The values of a Tsd/TsdFrame, an array or a tensor, on the host."""
    return compat.to_numpy(x.d if hasattr(x, "d") else x)


def _times(x, default=None):
    """The timestamps of a time-series container, else ``default`` (a
    tensor's ``.t`` is its transpose, not times)."""
    return default if torch.is_tensor(x) else getattr(x, "t", default)


def _is_table(x):
    """A ``ResultTable`` or a pandas DataFrame (read by column name)."""
    return isinstance(x, ResultTable) or hasattr(x, "iterrows")


def _column(table, name):
    col = table[name]
    return col.to_numpy() if hasattr(col, "to_numpy") else np.asarray(col)


def _trial_bounds(trials):
    """(starts, ends) of a trial table or an IntervalSet, as floats."""
    if _is_table(trials):
        return (_column(trials, "start").astype(float),
                _column(trials, "end").astype(float))
    return (np.asarray(trials.start, dtype=float),
            np.asarray(trials.end, dtype=float))


def _in_trials(t, starts, ends):
    mask = np.zeros(len(t), dtype=bool)
    for s, e in zip(starts, ends):
        mask |= (t >= s) & (t <= e)
    return mask


def _rows(trials, keep):
    """The trials where ``keep`` holds (a mask over the rows)."""
    if isinstance(trials, ResultTable):
        return trials.take(keep)
    return trials[keep]


def _series(values, index):
    """A one-column ``ResultTable`` standing for a pandas Series."""
    return ResultTable({None: np.asarray(values)}, index=[np.asarray(index)])


def get_latent_occurance_index_per_speed_level(map_latent, speed_tsd,
                                               speed_thresh_bins=(5,)):
    """Indices where each latent is the MAP, split by speed level
    (reference post_fit_tmaze_dataset.py:18-37)."""
    map_d = _data(map_latent)
    speed_d = _data(speed_tsd)
    bins = np.concatenate([[0], list(speed_thresh_bins), [np.inf]])
    out = {}
    for latent_i in np.unique(map_d):
        latent_ma = map_d == latent_i
        out[latent_i] = {}
        for i in range(len(bins) - 1):
            speed_ma = (speed_d >= bins[i]) & (speed_d < bins[i + 1])
            out[latent_i][i] = np.nonzero(latent_ma & speed_ma)[0]
    return out


def get_dist_to_maze(xy_l, xy_sampled_all):
    """Distance of each point to the closest maze sample point
    (reference post_fit_tmaze_dataset.py:39-47)."""
    return np.min(cdist(compat.to_numpy(xy_l),
                        compat.to_numpy(xy_sampled_all)), axis=1)


def classify_latent(map_latent, position_tsdf, speed_tsd, tmaze_xy_sampled_all,
                    speed_thresh=5, dist_to_maze_thresh=5, min_total_time=30,
                    min_run_time=10, min_off_maze_time=10, eps=3):
    """Classify each latent into spatial-running / immobility / off-maze and
    DBSCAN-cluster the spatial ones' run positions
    (reference post_fit_tmaze_dataset.py:49-122).  The per-latent Series
    of the JAX result are one-column ``ResultTable``s indexed by latent,
    its Index entries numpy arrays of latents."""
    from sklearn.cluster import dbscan

    speed_tsd = speed_tsd.interpolate(map_latent)
    position_tsdf = position_tsdf.interpolate(map_latent)
    # select the x/y columns BY NAME like the reference (the frame may
    # carry extra columns, e.g. a leading linearized coordinate, whose
    # silent inclusion would corrupt dist-to-maze and DBSCAN)
    cols_attr = getattr(position_tsdf, "columns", None)
    cols = [] if cols_attr is None else [str(c) for c in list(cols_attr)]
    if "x" in cols and "y" in cols:
        xy = np.column_stack(
            [np.asarray(position_tsdf["x"].d),
             np.asarray(position_tsdf["y"].d)]
        )
    else:
        xy = np.asarray(position_tsdf.d)[:, :2]

    occ = get_latent_occurance_index_per_speed_level(
        map_latent, speed_tsd, [speed_thresh]
    )
    is_spatial, is_immobility, is_off_maze = {}, {}, {}
    cluster_label_per_time = {}
    latent_total_time = {}
    for latent_i, per_level in occ.items():
        run_idx, still_idx = per_level[1], per_level[0]
        latent_total_time[latent_i] = len(run_idx) + len(still_idx)
        is_immobility[latent_i] = False
        is_off_maze[latent_i] = False
        if len(run_idx) > min_run_time:
            is_spatial[latent_i] = True
        else:
            is_spatial[latent_i] = False
            is_immobility[latent_i] = True
        if len(run_idx) > 0:
            dist = get_dist_to_maze(xy[run_idx], tmaze_xy_sampled_all)
            if (dist > dist_to_maze_thresh).sum() > min_off_maze_time:
                is_off_maze[latent_i] = True
                is_spatial[latent_i] = False
        if is_spatial[latent_i]:
            _, labels = dbscan(xy[run_idx], eps=eps, metric="euclidean")
            cluster_label_per_time[latent_i] = labels

    latents = np.array(list(occ))
    spatial = np.array([is_spatial[k] for k in occ], dtype=bool)
    immobility = np.array([is_immobility[k] for k in occ], dtype=bool)
    off_maze = np.array([is_off_maze[k] for k in occ], dtype=bool)
    category = np.zeros(len(spatial), dtype=object)
    category[spatial] = "spatial"
    category[immobility] = "immobility"
    category[off_maze] = "off_maze"
    return {
        "spatial_latent": latents[spatial],
        "nonspatial_latent": latents[~spatial],
        "immobility_latent": latents[immobility],
        "off_maze_latent": latents[off_maze],
        "is_spatial_all_latent": _series(spatial, latents),
        "is_immobility_all_latent": _series(immobility, latents),
        "is_off_maze_all_latent": _series(off_maze, latents),
        "latent_occurance_index_per_speed_level": occ,
        "cateogry_all_latent": category,
        "latent_total_time_all_latent": latent_total_time,
        "cluster_label_per_time_all_latent": cluster_label_per_time,
    }


# --- circular statistics on a wrapped linear coordinate
# (reference post_fit_tmaze_dataset.py:359-419) ---


def _extract_values_1d(obj):
    return np.ravel(_data(obj))


def _circular_mean(values_1d, a, b):
    vals = _extract_values_1d(values_1d)
    period = b - a
    if vals.size == 0 or not np.isfinite(period) or period == 0:
        return np.nan
    theta = 2 * np.pi * (vals - a) / period
    C, S = np.nanmean(np.cos(theta)), np.nanmean(np.sin(theta))
    if not (np.isfinite(C) and np.isfinite(S)):
        return np.nan
    return a + period * (np.arctan2(S, C) % (2 * np.pi)) / (2 * np.pi)


def _circular_std(values_1d, a, b):
    vals = _extract_values_1d(values_1d)
    period = b - a
    if vals.size == 0 or not np.isfinite(period) or period == 0:
        return np.nan
    theta = 2 * np.pi * (vals - a) / period
    R = np.hypot(np.nanmean(np.cos(theta)), np.nanmean(np.sin(theta)))
    if R <= 0 or not np.isfinite(R):
        return np.nan
    return np.sqrt(-2 * np.log(R)) * period / (2 * np.pi)


def _circular_diff(late_val, early_val, a, b):
    period = b - a
    if not np.isfinite(period) or period == 0:
        return np.nan
    d_ang = (
        2 * np.pi * (late_val - early_val) / period + np.pi
    ) % (2 * np.pi) - np.pi
    return d_ang * period / (2 * np.pi)


def get_latent_field_properties(
    latent_occurance_index_per_speed_level, cluster_label_per_time_all_latent,
    position_label, trial_intervals=None,
    trial_range_to_compare=None, do_circular_stat=False,
):
    """Field center/width per (latent, DBSCAN cluster) + early/late trial
    drift (reference post_fit_tmaze_dataset.py:291-356).  A
    ``ResultTable`` indexed by (latent, cluster), float columns ``mean``,
    ``std``, ``n_occurance`` (and ``early_mean``, ``late_mean``,
    ``diff`` with trials)."""
    trial_range_to_compare = trial_range_to_compare or {
        "early": (2, 12), "late": (-11, -1),
    }
    pos_vals = _extract_values_1d(position_label)
    pos_t = _times(position_label, np.arange(len(pos_vals)))
    if do_circular_stat:
        a, b = np.nanmin(pos_vals), np.nanmax(pos_vals)

    trials_sub_k = {}
    if trial_intervals is not None:
        starts, ends = _trial_bounds(trial_intervals)
        for k, (lo, hi) in trial_range_to_compare.items():
            trials_sub_k[k] = (starts[lo:hi], ends[lo:hi])

    props_all = {}
    for latent_i, per_level in latent_occurance_index_per_speed_level.items():
        if latent_i not in cluster_label_per_time_all_latent:
            continue
        labels = cluster_label_per_time_all_latent[latent_i]
        for cluster_i in np.unique(labels):
            if cluster_i == -1:
                continue
            props = {}
            time_sel = per_level[1][labels == cluster_i]
            sub_vals = pos_vals[time_sel]
            sub_t = pos_t[time_sel]
            if do_circular_stat:
                props["mean"] = _circular_mean(sub_vals, a, b)
                props["std"] = _circular_std(sub_vals, a, b)
            else:
                props["mean"] = np.nanmean(sub_vals)
                props["std"] = np.nanstd(sub_vals)
            props["n_occurance"] = len(time_sel)

            if trial_intervals is not None:
                means = {}
                for k, (s_k, e_k) in trials_sub_k.items():
                    vals_k = sub_vals[_in_trials(sub_t, s_k, e_k)]
                    means[k] = (
                        _circular_mean(vals_k, a, b) if do_circular_stat
                        else (np.nanmean(vals_k) if len(vals_k) else np.nan)
                    )
                    props[f"{k}_mean"] = means[k]
                props["diff"] = (
                    _circular_diff(means["late"], means["early"], a, b)
                    if do_circular_stat else means["late"] - means["early"]
                )
            props_all[latent_i, cluster_i] = props
    if not props_all:
        return ResultTable()
    keys = list(props_all)
    names = list(next(iter(props_all.values())))
    return ResultTable(
        {c: np.array([props_all[k][c] for k in keys], dtype=float)
         for c in names},
        index=[np.array([k[0] for k in keys]), np.array([k[1] for k in keys])],
        index_names=(None, None))


def get_latent_in_position_range(
    latent_occurance_index_per_speed_level, position_label, trial_intervals,
    reward_lin_range=(109, 113), speed_level=0, correct_only=True,
):
    """Per-latent occupancy fraction inside a position range during low-speed
    bins, split by visited arm (reference post_fit_tmaze_dataset.py:422-460).

    trial_intervals: a table with start/end/choice/visitedArm columns.
    Returns a ``ResultTable`` indexed by (latent, arm) with columns
    ``frac``, ``total``, ``frac_lr_total`` (the JAX ``pd.concat``)."""
    tdf = trial_intervals
    if correct_only:
        tdf = _rows(tdf, _column(tdf, "choice") == 1)
    pos_vals = _extract_values_1d(position_label)
    pos_t = _times(position_label, np.arange(len(pos_vals)))
    arms = _column(tdf, "visitedArm")
    starts, ends = _trial_bounds(tdf)

    out = {}
    for li, per_level in latent_occurance_index_per_speed_level.items():
        idx = per_level[speed_level]
        sub_vals, sub_t = pos_vals[idx], pos_t[idx]
        frac_d, total_d = {}, {}
        for lr in (0, 1):
            on_arm = arms == lr
            mask = _in_trials(sub_t, starts[on_arm], ends[on_arm])
            vals_lr = sub_vals[mask]
            if len(vals_lr):
                in_range = (vals_lr >= reward_lin_range[0]) & (
                    vals_lr <= reward_lin_range[1]
                )
                frac_d[lr] = in_range.mean()
                total_d[lr] = in_range.sum()
            else:
                frac_d[lr], total_d[lr] = 0, 0
        total = np.array([total_d[0], total_d[1]], dtype=np.int64)
        out[li] = ResultTable(
            {"frac": np.array([frac_d[0], frac_d[1]]), "total": total,
             "frac_lr_total": total / max(total.sum(), 1)},
            index=[np.array([0, 1])])
    return concat_tables(out)


def _level0_groups(occurance_in_range_alllatent):
    """(key, frac, total) of each outer index key in sorted order, as
    ``groupby(level=0)`` gives them (a ``ResultTable`` or a DataFrame)."""
    tbl = occurance_in_range_alllatent
    if isinstance(tbl, ResultTable):
        keys = tbl.index[0]
    else:
        keys = tbl.index.get_level_values(0).to_numpy()
    frac, total = _column(tbl, "frac"), _column(tbl, "total")
    for k in np.unique(keys):
        sel = keys == k
        yield k, frac[sel], total[sel]


def get_single_reward_latent(occurance_in_range_alllatent, frac_thresh=0.7,
                             total_thresh=10):
    """Latents tuned to exactly one arm's reward location
    (reference post_fit_tmaze_dataset.py:462-475)."""
    tuned = []
    for k, frac, total in _level0_groups(occurance_in_range_alllatent):
        majority = (frac > frac_thresh).sum() == 1
        enough = (total[frac > frac_thresh] > total_thresh).all()
        if majority and enough:
            tuned.append(k)
    return tuned


def get_both_reward_latent(occurance_in_range_alllatent, frac_thresh=0.7,
                           total_thresh=10):
    """Latents tuned to both arms' reward locations
    (reference post_fit_tmaze_dataset.py:477-489)."""
    tuned = []
    for k, frac, total in _level0_groups(occurance_in_range_alllatent):
        majority = (frac > frac_thresh).sum() == 2
        enough = (total[frac > frac_thresh] > total_thresh).all()
        if majority and enough:
            tuned.append(k)
    return tuned


def find_all_index_per_latent_pair(latent_pair_l, posterior_latent_map,
                                   merge_latent_threshold=1):
    """Indices where the MAP transitions pair[0] -> pair[1] (with wiggle
    room) (reference post_fit_tmaze_dataset.py:538-562)."""
    nap = compat.timeseries_module()
    t_l = _times(posterior_latent_map)
    d = _data(posterior_latent_map)
    ind_l = []
    for pair in latent_pair_l:
        pre_ok = np.abs(d[:-1] - pair[0]) <= merge_latent_threshold
        post_ok = np.abs(d[1:] - pair[1]) <= merge_latent_threshold
        ind_l.append(np.nonzero(pre_ok & post_ok)[0] + 1)
    ind_arr = np.array(ind_l, dtype=object)
    if t_l is not None:
        ts_arr = np.array(
            [nap.Ts(t_l[ind.astype(int)]) for ind in ind_l], dtype=object
        )
    else:
        ts_arr = None
    return ind_arr, ts_arr


def find_transition_times(behavior_tsdf_aligned, trial_intervals, lin_pt=115,
                          transition_type="arrival", tolerance=10):
    """Per-trial times when the linearized position crosses ``lin_pt``
    (reference post_fit_tmaze_dataset.py:566-589)."""
    nap = compat.timeseries_module()
    lin = behavior_tsdf_aligned["lin"] if not hasattr(
        behavior_tsdf_aligned, "d"
    ) else behavior_tsdf_aligned
    lin_d = _extract_values_1d(lin)
    lin_t = _times(lin, np.arange(len(lin_d)))

    times = []
    for s, e in zip(*_trial_bounds(trial_intervals)):
        mask = (lin_t >= s) & (lin_t <= e)
        d, t = lin_d[mask], lin_t[mask]
        pre = (d <= lin_pt) & (d >= lin_pt - tolerance)
        post = (d > lin_pt) & (d <= lin_pt + tolerance)
        crossings = np.nonzero(pre[:-1] & post[1:])[0]
        if len(crossings) == 0:
            continue
        ind = crossings[0] if transition_type == "arrival" else crossings[-1]
        times.append(t[ind])
    return nap.Ts(np.asarray(times))


def compute_consensus_fractions_by_window(peri_transition_matrix,
                                          max_window_size=10):
    """Fraction of transitions with any consensus, by window half-width
    (reference post_fit_tmaze_dataset.py:592-601); a one-column
    ``ResultTable`` indexed by the half-width."""
    mat = _data(peri_transition_matrix)
    mid = mat.shape[0] // 2
    windows = np.arange(1, max_window_size + 1)
    return _series([mat[mid - w : mid + w].any(axis=0).mean()
                    for w in windows], windows)


def compute_shuffle_consensus_fractions(jump_binary_consensus, transition_ts,
                                        win=1, win_size_int=1, n_shuffle=1000,
                                        rng=None, verbose=False):
    """Circular-shift null for the peri-transition consensus fraction
    (reference post_fit_tmaze_dataset.py:604-619)."""
    nap = compat.timeseries_module()
    rng = np.random.default_rng(rng)
    d = _data(jump_binary_consensus)
    t = jump_binary_consensus.t
    frac_sh_l = []
    for _ in range(n_shuffle):
        shift = rng.integers(0, len(d))
        sh = nap.Tsd(d=np.roll(d, shift), t=t)
        peri = nap.compute_perievent_continuous(sh, transition_ts, win)
        mat = np.asarray(peri.d if hasattr(peri, "d") else peri)
        mid = mat.shape[0] // 2
        frac_sh_l.append(
            mat[mid - win_size_int : mid + win_size_int].any(axis=0).mean()
        )
    return frac_sh_l


def analyze_peri_transition_jump_consensus(
    behavior_tsdf_aligned, trial_intervals, jump_binary_consensus, lin_pt=115,
    transition_type="arrival", win=1, max_window_size=10, n_shuffle=100,
    rng=None, verbose=False,
):
    """Jump consensus around behavioral transitions + shuffle controls
    (reference post_fit_tmaze_dataset.py:622-654); ``shuffle_fractions``
    a ``ResultTable`` of one column per window half-width."""
    nap = compat.timeseries_module()
    transition_ts = find_transition_times(
        behavior_tsdf_aligned, trial_intervals, lin_pt, transition_type
    )
    peri = nap.compute_perievent_continuous(
        jump_binary_consensus, transition_ts, win
    )
    frac_d = compute_consensus_fractions_by_window(peri, max_window_size)
    shuffle_fractions = {
        w: compute_shuffle_consensus_fractions(
            jump_binary_consensus, transition_ts, win, w, n_shuffle, rng=rng,
            verbose=verbose,
        )
        for w in range(1, max_window_size + 1)
    }
    return {
        "transition_ts": transition_ts,
        "peri_transition_matrix": peri,
        "consensus_fractions": frac_d,
        "shuffle_fractions": ResultTable(shuffle_fractions),
    }


def latent_jump_triggered_analysis(
    posterior_latent_map, behavior_tsdf, spk_mat, tuning_fit, t=None, seq=None,
    latent_distance_thresh=1, peri_event_win=2, cols=None,
    contrast_axis_latent_window=0,
):
    """Peri-event behavior + contrastive-axis projection around every
    occurrence of a latent jump sequence
    (reference post_fit_tmaze_dataset.py:657-688).  ``tuning_fit`` may be
    the fitted ``tuning`` tensor on the card."""
    nap = compat.timeseries_module()
    if t is None:
        assert seq is not None
    else:
        post_ind = int(np.searchsorted(posterior_latent_map.t, t))
        seq = _data(posterior_latent_map)[post_ind - 1 : post_ind + 1]

    occ_t, _ = ah.get_sequence_occurence(
        seq, posterior_latent_map, latent_distance_thresh=latent_distance_thresh
    )

    if cols is None:
        cols = list(getattr(behavior_tsdf, "columns", []))
    peri_event_d = {}
    for col in cols:
        peri_event_d[col] = nap.compute_perievent_continuous(
            behavior_tsdf[:, list(behavior_tsdf.columns).index(col)]
            if not compat.HAS_PYNAPPLE else behavior_tsdf[col],
            occ_t, peri_event_win,
        )

    proj, _ = vlj.get_contrast_axis_and_proj(
        _data(spk_mat), compat.to_numpy(tuning_fit), int(seq[0]),
        int(seq[1]), map_state_win=contrast_axis_latent_window,
    )
    proj_tsd = nap.Tsd(d=proj, t=spk_mat.t)
    peri_event_d["contrastive_projection"] = nap.compute_perievent_continuous(
        proj_tsd, occ_t, peri_event_win
    )
    return peri_event_d, occ_t


def get_null_contrastive_projection(
    spk_mat, tuning_fit, posterior_latent_map, jump_p_all_chain,
    jump_p_thresh=0.1, contrast_axis_latent_window=0, n_shuffle=100,
    peri_event_win=2, latent_distance_thresh=1, rng=None, verbose=False,
):
    """Null distribution for the contrastive projection: random MAP changes
    at non-jump times (reference post_fit_tmaze_dataset.py:690-744).
    ``tuning_fit`` and ``jump_p_all_chain`` may be tensors on the card."""
    nap = compat.timeseries_module()
    rng = np.random.default_rng(rng)
    jump_p = compat.to_numpy(jump_p_all_chain)
    if jump_p.ndim == 1:
        jump_p = jump_p[:, None]
    non_jump = (jump_p < jump_p_thresh).all(axis=1)

    map_d = _data(posterior_latent_map)
    map_t = posterior_latent_map.t
    consec_diff = np.zeros(len(map_d), dtype=bool)
    consec_diff[1:] = map_d[:-1] != map_d[1:]
    candidates = np.arange(len(map_d))[consec_diff & non_jump]
    sh_ind = rng.choice(
        candidates, min(n_shuffle, len(candidates)), replace=False
    )

    proj_sh_l, sh_seq_l = [], []
    spk_d = _data(spk_mat)
    tuning = compat.to_numpy(tuning_fit)
    for si in sh_ind:
        sh_seq = (map_d[si - 1], map_d[si])
        sh_seq_l.append(sh_seq)
        proj_sh, _ = vlj.get_contrast_axis_and_proj(
            spk_d, tuning, int(sh_seq[0]), int(sh_seq[1]),
            map_state_win=contrast_axis_latent_window,
        )
        proj_tsd = nap.Tsd(d=proj_sh, t=spk_mat.t)
        interior = (map_t > map_t[0] + peri_event_win) & (
            map_t < map_t[-1] - peri_event_win
        )
        interior_map = nap.Tsd(d=map_d[interior], t=map_t[interior])
        occ_t, _ = ah.get_sequence_occurence(
            sh_seq, interior_map, latent_distance_thresh=latent_distance_thresh
        )
        if len(occ_t.t) == 0:
            continue
        peri = nap.compute_perievent_continuous(
            proj_tsd, occ_t, peri_event_win
        )
        proj_sh_l.append(
            np.asarray(peri.d if hasattr(peri, "d") else peri).mean(axis=1)
        )
    return np.stack(proj_sh_l, axis=1), np.array(sh_seq_l)


def plot_latent_list_vs_position(
    latent_l, map_latent, behavior_tsdf, pos_col=("x", "y"), fig=None,
    ax=None, speed_col="speed_gauss", speed_category_thresh=(5,),
    cmap_name="Spectral_r", kwargs_scatter=None,
    marker_per_speed_category=("^", "o"), do_plot_maze=False,
    position_tsdf=None, ds=5, maze_c="grey", maze_alpha=0.3, hide_box=True,
    seperate_colorbar=True, colorbar=False, background_mode="line",
    color_time=True, color="red",
):
    """Scatter the 2-D positions of the times when each latent in
    ``latent_l`` is the MAP latent, with marker shape split by speed
    category (running vs immobility) and color by latent index — or, for a
    single latent, by time (reference post_fit_tmaze_dataset.py:184-289).

    Returns ``(fig, ax)`` or ``(fig, ax, fig_cbar, cb)`` when
    ``seperate_colorbar``."""
    import matplotlib
    from matplotlib.colors import Normalize

    from poor_man_gplvm_tpu_torch.plotting import plot_maze_background
    from poor_man_gplvm_tpu_torch.plotting.core import _pyplot

    plt = _pyplot()
    if kwargs_scatter is None:
        kwargs_scatter = dict(s=20, alpha=1)
    map_latent = _data(map_latent)
    latent_l = np.atleast_1d(compat.to_numpy(latent_l))

    cmap = plt.get_cmap(cmap_name)
    if ax is None:
        fig, ax = plt.subplots()
    if do_plot_maze:
        assert position_tsdf is not None
        plot_maze_background(position_tsdf, ds=ds, fig=fig, ax=ax, c=maze_c,
                             alpha=maze_alpha, mode=background_mode)

    speed = np.asarray(behavior_tsdf[speed_col])
    speed_category = np.asarray(cut_codes(
        speed, [0, *speed_category_thresh, np.inf]), dtype=float)
    cat_unique = np.unique(speed_category)
    cat_unique = cat_unique[~np.isnan(cat_unique)].astype(int)

    t_all = np.asarray(behavior_tsdf.t)
    x_all = np.asarray(behavior_tsdf[pos_col[0]])
    y_all = np.asarray(behavior_tsdf[pos_col[1]])

    norm = Normalize(vmin=0, vmax=len(latent_l))
    if color is None and len(latent_l) > 1:
        colors = cmap(norm(np.arange(len(latent_l))))
    else:
        colors = color
    # one latent: color each MAP time point by absolute session time so the
    # temporal evolution is comparable across latents
    if len(latent_l) == 1 and color_time:
        mask = map_latent == latent_l[0]
        norm = Normalize(vmin=t_all.min(), vmax=t_all.max())
        colors = cmap(norm(t_all[mask]))

    for cat_i in cat_unique:
        cat_mask = speed_category == cat_i
        marker = marker_per_speed_category[cat_i]
        for ii, latent_i in enumerate(latent_l):
            mask = (map_latent == latent_i) & cat_mask
            if not mask.any():
                continue
            if (len(latent_l) == 1 and color_time
                    and not isinstance(colors, str)):
                # per-time colors were built over ALL MAP times of this
                # latent; subset to this speed category
                ec = colors[cat_mask[map_latent == latent_l[0]]]
            elif colors is not None and np.ndim(colors) == 2:
                ec = colors[ii]
            else:
                ec = colors
            ax.scatter(x_all[mask], y_all[mask], edgecolors=ec,
                       facecolors="none", marker=marker, **kwargs_scatter)
    if hide_box:
        ax.axis("off")
    if color_time and colorbar:
        plt.colorbar(plt.cm.ScalarMappable(norm=norm, cmap=cmap), ax=ax)
    to_return = (fig, ax)
    if seperate_colorbar:
        fig_cbar = plt.figure()
        ax_cbar = fig_cbar.add_axes([0.05, 0.80, 0.05, 0.9])
        cb = matplotlib.colorbar.ColorbarBase(
            ax_cbar, orientation="vertical", cmap="Spectral_r"
        )
        cb.set_ticks([0, 1])
        if color_time:
            cb.set_ticklabels(["Start", "End"])
        to_return = (fig, ax, fig_cbar, cb)
    return to_return


def plot_multiple_latent_spatial_map(
    latent_ind_l, posterior_latent_map, behavior_tsdf, position_tsdf=None,
    speed_thresh=5, color_time=True, kwargs_scatter=None, color=None,
    speed_col="speed_gauss",
):
    """One spatial-map subplot per latent in ``latent_ind_l``
    (reference post_fit_tmaze_dataset.py:491-514)."""
    from poor_man_gplvm_tpu_torch.plotting import subplots_wrapper

    if kwargs_scatter is None:
        kwargs_scatter = dict(s=10, alpha=0.5)
    fig, axs = subplots_wrapper(len(latent_ind_l))
    if position_tsdf is None:
        position_tsdf = behavior_tsdf[["x", "y"]]
    for ii, i in enumerate(latent_ind_l):
        ax = np.ravel(axs)[ii]
        to_return = plot_latent_list_vs_position(
            [i], posterior_latent_map, behavior_tsdf, pos_col=("x", "y"),
            fig=fig, ax=ax, speed_col=speed_col,
            speed_category_thresh=[speed_thresh], cmap_name="Spectral_r",
            kwargs_scatter=kwargs_scatter,
            marker_per_speed_category=["^", "o"], do_plot_maze=True,
            position_tsdf=position_tsdf, ds=5, seperate_colorbar=False,
            color_time=color_time, color=color,
        )
        to_return[1].set_title(f"latent {i}")
    return fig, axs


def plot_multiple_latent_posterior_in_time(posterior_latent, **kwargs):
    """One posterior-vs-time subplot per latent bin
    (reference post_fit_tmaze_dataset.py:516-526)."""
    from poor_man_gplvm_tpu_torch.plotting import subplots_wrapper
    from poor_man_gplvm_tpu_torch.plotting.core import _pyplot

    posterior_latent = _data(posterior_latent)
    nplots = posterior_latent.shape[1]
    fig, axs = subplots_wrapper(nplots, **kwargs)
    for latent_ind in range(nplots):
        ax = np.ravel(axs)[latent_ind]
        ax.plot(posterior_latent[:, latent_ind])
        ax.set_title(f"latent {latent_ind}")
    _pyplot().tight_layout()
    return fig, axs


def get_time_of_arrival_based_one_position(position_tsdf,
                                           lin_range=(109, 113)):
    """Arrival timestamps: the starts of the intervals where the linearized
    position enters ``lin_range`` (reference
    post_fit_tmaze_dataset.py:529-532)."""
    nap = compat.timeseries_module()
    lin_sub = (position_tsdf["lin"]
               .threshold(lin_range[0], method="aboveequal")
               .threshold(lin_range[1], method="belowequal"))
    return nap.Ts(t=np.asarray(lin_sub.time_support.start))
