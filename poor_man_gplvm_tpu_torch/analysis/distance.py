"""Distance-structure analyses: distance-vs-lag, Wasserstein-1 matrices,
distance-vs-label regression with permutation nulls, trajectory
interpolation, and label transition matrices.

The port's own copy of ``poor_man_gplvm_tpu/analysis/distance.py``
(numpy and scipy on the host, ``utils.stats`` for the regressions).  Where
the JAX function returns a DataFrame this returns a ``ResultTable`` whose
``to_dataframe()`` is that frame, with two differences that follow from
pandas-free code: the grouped means and standard deviations of
``compute_distance_lag`` sum in numpy's order, where pandas' groupby adds
with Kahan compensation and Welford's update (they agree to ~1e-15
relative), and its ``label_lag_bin`` column holds each bin's
``(left, right)`` edges as ``pandas.cut`` labels them, where the JAX frame
holds ``pandas.Interval`` categories.  ``do_plot`` imports matplotlib at
the call.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist, pdist, squareform

from poor_man_gplvm_tpu_torch.utils.stats import add_constant, ols_fit
from poor_man_gplvm_tpu_torch.utils.table import ResultTable

__all__ = [
    "compute_distance_lag",
    "w1_cdf_distance_matrix",
    "distance_vs_label_regression",
    "shuffle_test_distance_vs_label",
    "interpolate_stacks",
    "interpolate_compute_dist_mat",
    "labels_to_transition_matrix",
    "get_transmat_and_shuffle",
]


def _group_stats(codes, values, n_groups):
    """Per group 0..n_groups-1 of ``codes``: the count of non-NaN
    ``values``, their mean and their sample standard deviation (ddof 1;
    NaN below two values), as ``groupby(...).agg(count, mean, std)``."""
    ok = ~np.isnan(values)
    codes, values = codes[ok], values[ok]
    n = np.bincount(codes, minlength=n_groups)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.bincount(codes, weights=values, minlength=n_groups) / n
        dev = values - mean[codes]
        var = np.bincount(codes, weights=dev * dev, minlength=n_groups) / (
            n - 1)
    std = np.where(n > 1, np.sqrt(np.where(n > 1, var, 0.0)), np.nan)
    return n.astype(np.int64), np.where(n > 0, mean, np.nan), std


def _grouped(keys, dist, key_name):
    """``groupby(key)["dist"].agg(n, mean, std).reset_index()`` plus
    ``sem``: one row per sorted non-NaN key."""
    keep = ~(np.isnan(keys) if keys.dtype.kind == "f" else
             np.zeros(len(keys), dtype=bool))
    uniq, codes = np.unique(keys[keep], return_inverse=True)
    n, mean, std = _group_stats(codes, dist[keep].astype(float), len(uniq))
    return {key_name: uniq, "n": n, "mean": mean, "std": std}


def _with_sem(cols):
    n = cols["n"]
    cols["sem"] = cols["std"] / np.sqrt(np.where(n > 0, n, np.nan))
    return ResultTable(cols)


def _round_frac(x, precision):
    """pandas' label rounding of a bin edge (``pandas.cut``)."""
    if not np.isfinite(x) or x == 0:
        return x
    frac, whole = np.modf(x)
    digits = (-int(np.floor(np.log10(abs(frac)))) - 1 + precision
              if whole == 0 else precision)
    return np.around(x, digits)


def _cut_labels(bins, precision=3):
    """The (left, right) edges of each bin as ``pandas.cut(...,
    include_lowest=True)`` labels them: the edges rounded at the least
    precision from 3 that keeps them apart, the first lowered by one unit
    of it."""
    for prec in range(precision, 20):
        if np.unique([_round_frac(b, prec) for b in bins]).size == bins.size:
            precision = prec
            break
    breaks = [_round_frac(b, precision) for b in bins]
    breaks[0] = breaks[0] - 10 ** (-precision)
    return list(zip(breaks[:-1], breaks[1:]))


def _cut_codes(x, bins):
    """``pandas.cut(x, bins, include_lowest=True)``'s bin of each value
    (right-closed; -1 outside the bins or NaN)."""
    if np.any(np.diff(bins) < 0):
        raise ValueError("bins must increase monotonically.")
    if np.unique(bins).size != bins.size:
        raise ValueError(f"Bin edges must be unique: {bins!r}.")
    ids = np.searchsorted(bins, x, side="left")
    ids[x == bins[0]] = 1
    bad = np.isnan(x) | (ids == len(bins)) | (ids == 0)
    return np.where(bad, -1, ids - 1)


def compute_distance_lag(
    X, *, metric="euclidean", label_d=None, do_plot=False, max_index_lag=None,
    label_bins=None, bin_count=20, random_state=None, ax=None,
):
    """Pairwise distances over time, summarized by index lag and (optional)
    label lag.

    Returns dict(D, pairs_df, by_index_lag, by_label_lag, figs)."""
    X = np.asarray(X, dtype=float)
    if X.ndim != 2:
        raise ValueError("X must be 2D (n_time, n_feature)")

    D = squareform(pdist(X, metric=metric))
    n_time = X.shape[0]
    iu, ju = np.triu_indices(n_time, k=1)
    data = {
        "i": iu, "j": ju, "dist": D[iu, ju],
        "index_lag": (ju - iu).astype(int),
    }
    if label_d is not None:
        label_vals = np.asarray(label_d)
        if label_vals.shape[0] != n_time:
            raise ValueError("label_d must have length n_time")
        data["label_lag"] = np.abs(label_vals[ju] - label_vals[iu])

    index = None
    if max_index_lag is not None:
        rows = np.flatnonzero(data["index_lag"] <= int(max_index_lag))
        data = {k: v[rows] for k, v in data.items()}
        index = [rows]
    pairs_df = ResultTable(data, index=index)

    by_index = _with_sem(_grouped(data["index_lag"], data["dist"],
                                  "index_lag"))

    by_label_lag = None
    if label_d is not None:
        ll = data["label_lag"]
        unique_vals = np.unique(ll[np.isfinite(ll)])
        if label_bins is not None:
            bins = np.asarray(label_bins, dtype=float)
        elif unique_vals.size <= 50:
            bins = None
        else:
            qs = np.linspace(0, 1, bin_count + 1)
            bins = np.unique(np.quantile(ll, qs))
            if bins.size < 2:
                bins = None
        if bins is None:
            cols = _grouped(ll, data["dist"], "label_lag")
        else:
            codes = _cut_codes(np.asarray(ll, dtype=float), bins)
            keep = codes >= 0
            labels = _cut_labels(bins)
            n, mean, std = _group_stats(codes[keep],
                                        data["dist"][keep].astype(float),
                                        len(labels))
            edges = np.empty(len(labels), dtype=object)
            edges[:] = labels
            cols = {
                "label_lag_bin": edges,
                "label_lag": np.array([0.5 * (lo + hi) for lo, hi in labels],
                                      dtype=float),
                "n": n, "mean": mean, "std": std,
            }
        by_label_lag = _with_sem(cols)

    figs = {}
    if do_plot:
        import matplotlib.pyplot as plt

        if ax is None:
            fig_idx, ax_idx = plt.subplots(1, 1, figsize=(6, 4))
        else:
            fig_idx, ax_idx = ax.figure, ax
        x = by_index["index_lag"]
        m = by_index["mean"]
        e = by_index["sem"]
        ax_idx.plot(x, m, color="C0", label="Index lag")
        ax_idx.fill_between(x, m - e, m + e, color="C0", alpha=0.2)
        ax_idx.set_xlabel("Index lag")
        ax_idx.set_ylabel("Distance")
        figs["index"] = (fig_idx, ax_idx)
        if by_label_lag is not None:
            fig_lab, ax_lab = plt.subplots(1, 1, figsize=(6, 4))
            x2 = by_label_lag["label_lag"]
            m2 = by_label_lag["mean"]
            e2 = by_label_lag["sem"]
            ax_lab.plot(x2, m2, color="C1", label="Label lag")
            ax_lab.fill_between(x2, m2 - e2, m2 + e2, color="C1", alpha=0.2)
            figs["label"] = (fig_lab, ax_lab)

    return {
        "D": D, "pairs_df": pairs_df, "by_index_lag": by_index,
        "by_label_lag": by_label_lag, "figs": figs,
    }


def w1_cdf_distance_matrix(prob_mat, bin_edges=None, normalize=False):
    """Pairwise Wasserstein-1 between distribution rows via the CDF trick:
    W1(p, q) = sum_i w_i |CDF_p[i] - CDF_q[i]|.  Returns (D, C)."""
    P = np.asarray(prob_mat, dtype=float)
    if normalize:
        row_sums = P.sum(axis=1, keepdims=True)
        row_sums[row_sums == 0.0] = 1.0
        P = np.clip(P, 0.0, None) / row_sums
    C = np.cumsum(P, axis=1)
    if bin_edges is None:
        w = np.ones(P.shape[1], dtype=float)
    else:
        edges = np.asarray(bin_edges, dtype=float)
        if edges.ndim != 1 or edges.size != P.shape[1] + 1:
            raise ValueError("bin_edges must have shape (n_feat+1,)")
        w = np.diff(edges)
    D = cdist(C * w[None, :], C * w[None, :], metric="cityblock")
    return D, C


def _upper_triangle_pairs(D, labels):
    """Upper-tri pairs after dropping NaN labels."""
    D = np.asarray(D, dtype=float)
    labels = np.asarray(labels, dtype=float)
    assert D.ndim == 2 and D.shape[0] == D.shape[1], "D must be square"
    assert labels.shape[0] == D.shape[0], "labels length must match D"
    idx = np.where(np.isfinite(labels))[0]
    Dv = D[np.ix_(idx, idx)]
    lv = labels[idx]
    iu, ju = np.triu_indices(len(idx), 1)
    x = np.abs(lv[ju] - lv[iu])
    y = Dv[iu, ju]
    m = np.isfinite(y)
    iu, ju, x, y = iu[m], ju[m], x[m], y[m]
    return Dv, lv, iu, ju, x, y, idx[iu], idx[ju], idx


def _bin_stats(x, y, *, bin_edges=None, nbins=50, binning="uniform", z=1.96):
    """Bin x; mean/std/CI of y per bin."""
    x = np.asarray(x)
    y = np.asarray(y)
    if bin_edges is None:
        if binning == "uniform":
            lo, hi = np.nanmin(x), np.nanmax(x)
            if not np.isfinite(lo) or not np.isfinite(hi) or lo == hi:
                bin_edges = np.array([lo, hi])
            else:
                bin_edges = np.linspace(lo, hi, nbins + 1)
        elif binning == "quantile":
            bin_edges = np.unique(np.quantile(x, np.linspace(0, 1, nbins + 1)))
            if bin_edges.size < 2:
                bin_edges = np.array([x.min(), x.max()])
        else:
            raise ValueError("binning must be 'uniform' or 'quantile'")

    bins = np.digitize(x, bin_edges, right=False) - 1
    nb = len(bin_edges) - 1
    means = np.full(nb, np.nan)
    stds = np.full(nb, np.nan)
    ns = np.zeros(nb, dtype=int)
    for b in range(nb):
        sel = bins == b
        if np.any(sel):
            ys = y[sel]
            means[b] = ys.mean()
            stds[b] = ys.std(ddof=1) if ys.size > 1 else 0.0
            ns[b] = ys.size
    sem = np.where(ns > 1, stds / np.sqrt(ns), np.nan)
    out = ResultTable(
        {
            "bin_left": bin_edges[:-1],
            "bin_right": bin_edges[1:],
            "bin_center": 0.5 * (bin_edges[:-1] + bin_edges[1:]),
            "n": ns,
            "mean": means,
            "std": stds,
            "ci_low": means - z * sem,
            "ci_high": means + z * sem,
        }
    )
    return out, bin_edges


def distance_vs_label_regression(
    D, labels, *, bin_edges=None, nbins=50, binning="uniform", z=1.96,
    return_pairs_df=True, timestamps=None, label_distance_threshold=None,
):
    """OLS of pairwise distance on |dlabel| (optional |dtime| regressor,
    optional threshold binarization) + binned stats."""
    Dv, lv, iu, ju, x_cont, y, i_orig, j_orig, kept_idx = _upper_triangle_pairs(
        D, labels
    )
    labels = np.asarray(labels, dtype=float)

    if timestamps is not None:
        tv = np.asarray(timestamps, float)[kept_idx]
        t_pairs = np.abs(tv[ju] - tv[iu])
    else:
        t_pairs = None

    if label_distance_threshold is not None:
        x = (x_cont > float(label_distance_threshold)).astype(float)
        edges_eff = np.array([-0.5, 0.5, 1.5])
    else:
        x = x_cont
        edges_eff = bin_edges

    cols = {"label": x}
    if t_pairs is not None:
        cols["time"] = t_pairs
    X = add_constant(np.column_stack([cols[c] for c in cols]))

    mask = np.isfinite(y)
    for arr in cols.values():
        mask &= np.isfinite(arr)
    y_use, X_use = y[mask], X[mask]

    result = ols_fit(X_use, y_use)
    intercept = result.params[0]
    slope_label = result.params[1]
    r2 = float(result.rsquared)
    r = np.sign(slope_label) * np.sqrt(r2) if t_pairs is None else np.nan
    summary = dict(intercept=intercept, slope=slope_label, r=r, r2=r2)

    binned, edges_used = _bin_stats(
        x[mask], y_use, bin_edges=edges_eff, nbins=nbins, binning=binning, z=z
    )

    pairs_df = None
    if return_pairs_df:
        i_use, j_use = i_orig[mask], j_orig[mask]
        pairs_data = {
            "i": i_use, "j": j_use,
            "label_i": labels[i_use], "label_j": labels[j_use],
            "label_dist": x_cont[mask], "dist": y_use,
        }
        if t_pairs is not None:
            pairs_data["time_dist"] = t_pairs[mask]
        if label_distance_threshold is not None:
            pairs_data["label_dist_bin"] = x[mask]
        pairs_df = ResultTable(pairs_data)

    return dict(
        pairs_df=pairs_df, summary=summary, binned=binned, edges=edges_used,
        kept_idx=kept_idx,
    )


def shuffle_test_distance_vs_label(
    D, labels, *, n_shuffles=1000, rng=None, bin_edges=None, nbins=50,
    binning="uniform", timestamps=None, label_distance_threshold=None,
):
    """Permutation null for distance-vs-label regression: permute rows/cols
    of D (labels stay put) and refit.

    NOTE: like the reference (distance_analysis.py:521-523), the SHUFFLE
    regressor with a threshold is ``1[|dlabel| <= thr]`` while the observed
    one is ``1[|dlabel| > thr]`` — sign conventions differ; the two-sided
    p-value on |slope| is unaffected."""
    rng = np.random.default_rng(rng)
    obs = distance_vs_label_regression(
        D, labels, bin_edges=bin_edges, nbins=nbins, binning=binning,
        return_pairs_df=False, timestamps=timestamps,
        label_distance_threshold=label_distance_threshold,
    )
    summary_obs, binned_obs = obs["summary"], obs["binned"]
    edges, kept_idx = obs["edges"], obs["kept_idx"]

    Dv, lv, iu, ju, x_cont, y, *_ = _upper_triangle_pairs(D, labels)

    if timestamps is not None:
        tv = np.asarray(timestamps, float)[kept_idx]
        t_pairs = np.abs(tv[ju] - tv[iu])
    else:
        t_pairs = None

    if label_distance_threshold is not None:
        x_reg = (x_cont <= float(label_distance_threshold)).astype(float)
    else:
        x_reg = x_cont

    mask = np.isfinite(y) & np.isfinite(x_reg)
    if t_pairs is not None:
        mask &= np.isfinite(t_pairs)

    cols = {"label": x_reg[mask]}
    if t_pairs is not None:
        cols["time"] = t_pairs[mask]
    X = add_constant(np.column_stack([cols[c] for c in cols]))

    nb = len(edges) - 1
    slopes = np.empty(n_shuffles)
    intercepts = np.empty(n_shuffles)
    r2s = np.empty(n_shuffles)
    binned_means = np.full((n_shuffles, nb), np.nan)

    n = Dv.shape[0]
    for s in range(n_shuffles):
        perm = rng.permutation(n)
        y_use = Dv[perm[iu], perm[ju]][mask]
        result = ols_fit(X, y_use)
        intercepts[s] = result.params[0]
        slopes[s] = result.params[1] if X.shape[1] >= 2 else np.nan
        r2s[s] = float(result.rsquared)
        binned_s, _ = _bin_stats(cols["label"], y_use, bin_edges=edges)
        binned_means[s, :] = binned_s["mean"]

    slope_obs = summary_obs["slope"]
    p_two = (1 + np.sum(np.abs(slopes) >= np.abs(slope_obs))) / (n_shuffles + 1)

    return dict(
        slope_obs=slope_obs,
        intercept_obs=summary_obs["intercept"],
        r2_obs=summary_obs["r2"],
        slopes_shuf=slopes,
        intercepts_shuf=intercepts,
        r2_shuf=r2s,
        p_slope_two_sided=p_two,
        binned_obs=binned_obs,
        binned_mean_shuf=np.nanmean(binned_means, axis=0),
        binned_lo_shuf=np.nanpercentile(binned_means, 2.5, axis=0),
        binned_hi_shuf=np.nanpercentile(binned_means, 97.5, axis=0),
        bin_edges=edges,
    )


def interpolate_stacks(mats, *, n_point=10, ddof=0):
    """Interpolate (n_time_i, n_feature) matrices onto a common [0, 1] grid;
    NaN-tolerant; returns grid/stack/mean/std."""
    if not mats:
        raise ValueError("`mats` must be a non-empty list of 2D arrays.")
    first = np.asarray(mats[0])
    if first.ndim != 2:
        raise ValueError("Each item must be a 2D array (n_time x n_feature).")
    n_feature = first.shape[1]
    for i, M in enumerate(mats):
        M = np.asarray(M)
        if M.ndim != 2 or M.shape[1] != n_feature:
            raise ValueError(f"Item {i} has incompatible shape {M.shape}.")

    x_new = np.linspace(0.0, 1.0, n_point, endpoint=True)
    stack = np.empty((len(mats), n_point, n_feature))
    for i, M in enumerate(mats):
        M = np.asarray(M, dtype=float)
        x_old = np.linspace(0.0, 1.0, M.shape[0], endpoint=True)
        for j in range(n_feature):
            col = M[:, j]
            valid = np.isfinite(col)
            if not np.any(valid):
                stack[i, :, j] = np.nan
            else:
                stack[i, :, j] = np.interp(x_new, x_old[valid], col[valid])

    return {
        "grid": x_new,
        "stack": stack,
        "mean": np.nanmean(stack, axis=0),
        "std": np.nanstd(stack, axis=0, ddof=ddof),
    }


def interpolate_compute_dist_mat(mats, *, n_point=10, metric="euclidean",
                                 ddof=0):
    """Interpolate each matrix to a common grid, compute its over-time
    distance matrix, aggregate across the list."""
    interp = interpolate_stacks(mats, n_point=n_point, ddof=ddof)
    stack = interp["stack"]
    D_list = [
        compute_distance_lag(stack[i], metric=metric, do_plot=False)["D"]
        for i in range(stack.shape[0])
    ]
    D_stack = np.stack(D_list, axis=0)
    return {
        "D_list": D_list,
        "D_mean": np.nanmean(D_stack, axis=0),
        "D_std": np.nanstd(D_stack, axis=0, ddof=ddof),
    }


def labels_to_transition_matrix(
    labels, mode="frame", exclude=None, smoothing=0.0, state_order="sorted",
):
    """Empirical transition matrix P[i, j] = Pr(next=j | curr=i) from a
    label sequence.  Returns
    (P, states)."""
    arr = np.asarray(labels)
    if exclude is not None:
        arr = arr[~np.isin(arr, list(exclude))]
    if arr.size == 0:
        return np.zeros((0, 0), dtype=float), []
    if mode not in {"frame", "segment"}:
        raise ValueError("mode must be 'frame' or 'segment'")
    if mode == "segment":
        arr = arr[np.r_[True, arr[1:] != arr[:-1]]]

    if state_order == "appearance":
        seen, states = set(), []
        for s in arr:
            if s not in seen:
                seen.add(s)
                states.append(s)
    else:
        states = sorted(set(arr.tolist()))
    idx = {s: i for i, s in enumerate(states)}
    K = len(states)

    counts = np.zeros((K, K))
    if arr.size > 1:
        np.add.at(
            counts,
            (
                np.array([idx[a] for a in arr[:-1]]),
                np.array([idx[b] for b in arr[1:]]),
            ),
            1.0,
        )
    if smoothing > 0.0:
        counts = counts + smoothing
    row_sums = counts.sum(axis=1, keepdims=True)
    P = np.divide(
        counts, row_sums, out=np.zeros_like(counts), where=row_sums > 0
    )
    return P, states


def get_transmat_and_shuffle(labels_hd, n_shuffle=100, quantile=0.99, rng=None):
    """Transition matrix + full-permutation null threshold."""
    rng = np.random.default_rng(rng)
    labels_hd = np.asarray(labels_hd)
    trans_mat, _ = labels_to_transition_matrix(labels_hd)
    trans_mat_sh_l = []
    for _ in range(n_shuffle):
        reind = rng.permutation(len(labels_hd))
        trans_mat_sh, _ = labels_to_transition_matrix(labels_hd[reind])
        trans_mat_sh_l.append(trans_mat_sh)
    trans_mat_sh_l = np.array(trans_mat_sh_l)
    trans_mat_sh_l_up = np.quantile(trans_mat_sh_l, quantile, axis=0)
    return {
        "trans_mat": trans_mat,
        "trans_mat_sh_l": trans_mat_sh_l,
        "trans_mat_sh_l_up": trans_mat_sh_l_up,
        "is_sig": trans_mat > trans_mat_sh_l_up,
    }
