"""Post-fit workflow for the ACh photometry dataset.

The port's own copy of ``poor_man_gplvm_tpu/workflows/ach_dataset.py``
(reference poor_man_gplvm/post_fit_workflow/post_fit_ach_dataset.py): ACh
ramp-onset detection, event-triggered analyses with circular-shift nulls,
peri-event clustering, feature preparation, sleep-state segregation,
distance-vs-label representational analysis, session aggregation, and the
cluster-vs-timing multinomial regression (sklearn multinomial logistic in
place of statsmodels mnlogit).

The inputs are what the port's fit, model selection and decode give: its
``Tsd``/``TsdFrame``s (or pynapple's), the ``em_res`` dicts of
``selection.fit_model_one_config`` with their tensors on the card (copied
to the host, ``compat.to_numpy``), and the port's peri-event tables
(``ResultTable``).  The numbers are computed in numpy on the host, as in
the JAX package.  Where a JAX function takes a DataFrame this takes a
``ResultTable``, a DataFrame or an array; where it returns a Series or a
DataFrame this returns a ``ResultTable`` (``to_series()``/
``to_dataframe()`` give the JAX object).  No pandas: the row and column
means skip NaN as pandas' do, ``pandas.qcut``/``pandas.cut`` are
``utils.table.qcut_codes``/``cut_codes``, and the session summary CSV of
``gather_feature_shuffle_across_sessions`` is written by the ``csv``
module.  sklearn (``cluster_peri_event``,
``latent_cluster_vs_timing_regression``), dill
(``load_data_and_fit_res``) and matplotlib (``do_plot=True``) are
imported at the call.  Dataset-tailored by design (reference
post_fit_workflow/readme.md); the one-function-per-session entry point is
:func:`main`.
"""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np
import scipy.signal
import scipy.special
import scipy.stats
from scipy.spatial.distance import pdist, squareform

from poor_man_gplvm_tpu_torch import analysis as ah
from poor_man_gplvm_tpu_torch import plotting as ph
from poor_man_gplvm_tpu_torch.utils import compat
from poor_man_gplvm_tpu_torch.utils.table import (
    ResultTable,
    cut_codes,
    qcut_codes,
)

__all__ = [
    "get_decode_res_l_from_em_res_l",
    "load_data_and_fit_res",
    "find_ach_ramp_onset",
    "find_ach_ramp_onset_old",
    "event_triggered_analysis",
    "event_triggered_analysis_multiple_feature_event",
    "cluster_peri_event",
    "manual_cluster_peri_event",
    "prep_feature_d",
    "turn_sleep_state_tsd_to_interval",
    "segregate_event_ts_by_sleep_state",
    "get_post_pre_diff",
    "test_pre_post_against_shuffle",
    "get_mean_feature_in_interval",
    "get_distance_matrix",
    "feature_distance_vs_label_distance_analysis",
    "main",
    "gather_feature_shuffle_across_sessions",
    "ach_vs_dynamics_tuning_all_sessions",
    "latent_cluster_vs_timing_regression",
]


# ---------------------------------------------------------------------------
# the pandas operations of the JAX module, on numpy
# ---------------------------------------------------------------------------


def _data(x):
    """The values of a Tsd/TsdFrame, an array or a tensor, on the host."""
    return compat.to_numpy(x.d if hasattr(x, "d") else x)


def _wide(x):
    """(values (rows, columns) float, column labels, row index levels,
    index names) of a ``ResultTable``, a DataFrame, or an array/tensor
    (columns and rows numbered, as ``pd.DataFrame(array)``)."""
    if isinstance(x, ResultTable):
        return (x.to_numpy().astype(float), np.asarray(x.columns),
                x.index, x.index_names)
    if hasattr(x, "iterrows"):  # a DataFrame
        return (x.to_numpy(dtype=float), x.columns.to_numpy(),
                [x.index.to_numpy()], (x.index.name,))
    values = np.asarray(compat.to_numpy(x), dtype=float)
    return (values, np.arange(values.shape[1]),
            [np.arange(values.shape[0])], (None,))


def _table(values, columns, index=None, index_names=None):
    return ResultTable({c: values[:, j] for j, c in enumerate(columns)},
                       index=index, index_names=index_names)


def _series(values, index, index_names=None):
    """A one-column ``ResultTable`` standing for a pandas Series."""
    return ResultTable({None: np.asarray(values)}, index=index,
                       index_names=index_names)


def _nanmean(values, axis):
    """``DataFrame.mean(axis)``: the mean of the non-NaN entries, NaN
    where there is none (no warning)."""
    valid = ~np.isnan(values)
    n = valid.sum(axis=axis)
    total = np.where(valid, values, 0.0).sum(axis=axis)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(n > 0, total / np.maximum(n, 1), np.nan)


def _nanstd(values, axis=0):
    """``DataFrame.std(axis)``/``Series.std()``: ddof 1 over the non-NaN
    entries, NaN where fewer than two."""
    valid = ~np.isnan(values)
    n = valid.sum(axis=axis)
    mean = _nanmean(values, axis)
    dev = np.where(valid, values - np.expand_dims(mean, axis), 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        var = (dev * dev).sum(axis=axis) / (n - 1)
    return np.where(n > 1, np.sqrt(np.maximum(var, 0.0)), np.nan)


def _summary(diff):
    """(median, effect size = mean / std, NaN where the std is 0) of a
    vector of per-event differences, NaN skipped as pandas skips it."""
    diff_std = float(_nanstd(diff))
    effect_size = (float(_nanmean(diff, 0)) / diff_std if diff_std > 0
                   else float("nan"))
    finite = diff[~np.isnan(diff)]
    median = float(np.median(finite)) if finite.size else float("nan")
    return median, effect_size


def _zscored(values):
    """(peri - column means) / column stds, as the JAX frame's
    ``do_zscore``."""
    return (values - _nanmean(values, 0)) / _nanstd(values, 0)


# ---------------------------------------------------------------------------
# the workflow
# ---------------------------------------------------------------------------


def get_decode_res_l_from_em_res_l(em_res_l, t_l=None, has_dynamics=True):
    """Posterior marginals (as time-indexed frames) from a list of em_res
    dicts (reference post_fit_ach_dataset.py:38-54).  ``em_res`` holds the
    fit's ``log_posterior_final`` as a tensor on the card or an array."""
    nap = compat.timeseries_module()
    decode_res_l = []
    for em_res in em_res_l:
        log_post = compat.to_numpy(em_res["log_posterior_final"])
        if has_dynamics:
            post_latent = np.exp(scipy.special.logsumexp(log_post, axis=1))
            post_dyn = np.exp(scipy.special.logsumexp(log_post, axis=2))
        else:
            post_latent = np.exp(log_post)
        tt = np.arange(post_latent.shape[0]) if t_l is None else t_l
        one = {"posterior_latent_marg": nap.TsdFrame(d=post_latent, t=tt)}
        if has_dynamics:
            one["posterior_dynamics_marg"] = nap.TsdFrame(d=post_dyn, t=tt)
        decode_res_l.append(one)
    return decode_res_l


def load_data_and_fit_res(data_path, fit_res_path):
    """Load pickled session data + fit results; select the best chain by the
    overall metric (reference post_fit_ach_dataset.py:56-69)."""
    import dill

    data_load_res = dill.load(open(data_path, "rb"))
    fit_res_load_res = dill.load(open(fit_res_path, "rb"))
    decode_res_l = get_decode_res_l_from_em_res_l(
        fit_res_load_res["em_res_l"], data_load_res["t_l"]
    )
    model_index = fit_res_load_res["metric_eval_result"]["metric_overall"][
        "best_index"
    ]
    return {
        **data_load_res,
        **decode_res_l[model_index],
        "model_fit": fit_res_load_res["model_fit_l"][model_index],
    }


def _detrended(nap, ach_data, detrend_cutoff):
    # same detrend as the reference (nap.apply_lowpass_filter, an order-4
    # zero-phase Butterworth) — a different filter order would remove a
    # different trend and shift the detected onsets
    if hasattr(nap, "apply_lowpass_filter"):
        trend = _data(nap.apply_lowpass_filter(ach_data, detrend_cutoff))
    else:  # pragma: no cover - pynapple<0.7 fallback
        from scipy.signal import butter, filtfilt

        fs = 1.0 / np.median(np.diff(ach_data.t))
        b, a = butter(4, detrend_cutoff / (fs / 2), btype="low")
        trend = filtfilt(b, a, _data(ach_data))
    return nap.Tsd(d=_data(ach_data) - trend, t=ach_data.t)


def find_ach_ramp_onset(ach_data, smooth_win=1, finite_diff_window_s=1,
                        height=0.05, do_zscore=True, detrend_cutoff=None):
    """ACh ramp onsets: z-score, (optional) low-pass detrend, forward finite-
    difference slope, smooth, peak detection
    (reference post_fit_ach_dataset.py:71-101)."""
    nap = compat.timeseries_module()
    if do_zscore:
        t_l = ach_data.t
        ach_data = nap.Tsd(d=scipy.stats.zscore(_data(ach_data)), t=t_l)
    if detrend_cutoff is not None:
        ach_data = _detrended(nap, ach_data, detrend_cutoff)

    dt = np.median(np.diff(ach_data.t))
    w = int(finite_diff_window_s / dt)
    d = _data(ach_data)
    extended = np.concatenate([d, np.full(w, d[-1])])
    slope = (extended[w:] - extended[:-w]) / finite_diff_window_s
    slope_tsd = nap.Tsd(d=slope[:-w] if w else slope, t=ach_data.t[: len(slope) - w] if w else ach_data.t)
    if smooth_win is not None:
        slope_tsd = slope_tsd.smooth(smooth_win)

    peaks, metadata = scipy.signal.find_peaks(_data(slope_tsd),
                                              height=height)
    peak_times = slope_tsd.t[peaks]
    return {
        "ach_ramp_onset": nap.Ts(peak_times),
        "slope": slope_tsd,
        "slope_peak_time": nap.Ts(peak_times),
        "peak_heights": nap.Tsd(d=metadata["peak_heights"], t=peak_times),
    }


def find_ach_ramp_onset_old(ach_data, smooth_win=1, height=0.05,
                            do_zscore=True, detrend_cutoff=None, shift=-1.0):
    """Older ACh ramp-onset detector: z-score, optional low-pass detrend,
    Gaussian smooth, central-difference slope, peak detection, then shift
    onsets by ``shift`` seconds to correct for the causal detection window
    (reference post_fit_ach_dataset.py:104-128)."""
    nap = compat.timeseries_module()
    if do_zscore:
        t_l = ach_data.t
        ach_data = nap.Tsd(d=scipy.stats.zscore(_data(ach_data)), t=t_l)
    if detrend_cutoff is not None:
        ach_data = _detrended(nap, ach_data, detrend_cutoff)
    if smooth_win is not None:
        ach_data_smth = ach_data.smooth(smooth_win)
    else:
        ach_data_smth = ach_data

    slope = ach_data_smth.derivative()
    peaks, metadata = scipy.signal.find_peaks(_data(slope), height=height)
    peak_heights = nap.Tsd(d=metadata["peak_heights"], t=slope.t[peaks])
    ach_ramp_onset = nap.Ts(slope.t[peaks] + shift)
    return {
        "ach_ramp_onset": ach_ramp_onset,
        "slope": slope,
        "ach_data_smth": ach_data_smth,
        "ach_data": ach_data,
        "peak_heights": peak_heights,
    }


def event_triggered_analysis(feature, event_ts, n_shuffle=10, minmax=4,
                             do_zscore=False, test_win=1, do_plot=False,
                             fig=None, ax=None, ylabel=None, title=None,
                             ylim=None, verbose=False):
    """Peri-event average + shuffle null + pre/post Wilcoxon, within-side
    correlations, and the pre/post interaction regression
    (reference post_fit_ach_dataset.py:130-203).  ``feature`` and
    ``shuffle`` of the result are ``ResultTable``s (rows the events /
    shuffles, columns the relative times)."""
    peri, peri_shuffle = ah.get_peri_event_with_shuffle(
        feature, event_ts, n_shuffle=n_shuffle, minmax=minmax,
        do_zscore=do_zscore, verbose=verbose,
    )
    values, labels, _, _ = _wide(peri)
    peri = _table(values, labels)
    analysis_res = {"feature": peri, "shuffle": peri_shuffle}

    cols = np.asarray(labels, dtype=float)
    pre = _nanmean(values[:, (cols < 0) & (cols > -test_win)], 1)
    post = _nanmean(values[:, (cols > 0) & (cols < test_win)], 1)
    diff = post - pre
    # degenerate samples (0/1 events, identical diffs) have no spread:
    # report NaN explicitly instead of raising a divide-by-zero warning
    analysis_res["diff_median"], analysis_res["effect_size"] = _summary(diff)
    analysis_res["wc_res"] = scipy.stats.wilcoxon(diff)

    corr_res = {}
    for side, sel in (("pre", cols < 0), ("post", cols > 0)):
        # DataFrame.melt: column by column, each column's label repeated
        corr_res[side] = scipy.stats.pearsonr(
            np.repeat(cols[sel], values.shape[0]), values[:, sel].T.ravel()
        )
    analysis_res["corr_res"] = corr_res

    analysis_res["reg_res"] = ah.fit_time_prepost_interaction(peri)
    has_shuffle = isinstance(peri_shuffle, ResultTable) and len(peri_shuffle)
    if has_shuffle:
        shuffle_df = _table(_wide(peri_shuffle)[0], cols)
        analysis_res["reg_res_shuffle"] = ah.fit_time_prepost_interaction(
            shuffle_df
        )

    if do_plot:
        plt = ph.core._pyplot()

        if ax is None:
            fig, ax = plt.subplots(figsize=(1, 1.5))
        fig, ax = ph.plot_mean_error_plot(values, ax=ax, fig=fig)
        if has_shuffle:
            fig, ax = ph.plot_mean_error_plot(
                _wide(peri_shuffle)[0], fig=fig, ax=ax, color="grey"
            )
        ax.set_xlabel("Time (s)")
        if ylabel:
            ax.set_ylabel(ylabel)
        if title:
            ax.set_title(title)
        if ylim:
            ax.set_ylim(ylim)
        return analysis_res, fig, ax
    return analysis_res


def event_triggered_analysis_multiple_feature_event(
    feature_d, event_ts_d, n_shuffle=10, minmax=4, do_zscore=False,
    test_win=1, do_plot=False, fig=None, ax=None, ylabel_d=None, title_d=None,
    ylim_d=None, verbose=False,
):
    """event_triggered_analysis over every (feature, event) pair
    (reference post_fit_ach_dataset.py:206-236)."""
    ylabel_d = {**{k: k for k in feature_d}, **(ylabel_d or {})}
    title_d = {**{k: k for k in event_ts_d}, **(title_d or {})}
    ylim_d = {**{k: None for k in feature_d}, **(ylim_d or {})}
    analysis_res_d, fig_d, ax_d = {}, {}, {}
    for feat_name, feat in feature_d.items():
        for event_name, event_ts in event_ts_d.items():
            if len(event_ts.t) < 2:
                continue
            out = event_triggered_analysis(
                feat, event_ts, n_shuffle=n_shuffle, minmax=minmax,
                do_zscore=do_zscore, test_win=test_win, do_plot=do_plot,
                ylabel=ylabel_d[feat_name], title=title_d[event_name],
                ylim=ylim_d[feat_name], verbose=verbose,
            )
            if do_plot:
                analysis_res_d[feat_name, event_name] = out[0]
                fig_d[feat_name, event_name] = out[1]
                ax_d[feat_name, event_name] = out[2]
            else:
                analysis_res_d[feat_name, event_name] = out
    if do_plot:
        return analysis_res_d, fig_d, ax_d
    return analysis_res_d


def _cluster_tables(values, labels, index, names, member, n_cluster):
    """Each cluster's rows (their index kept) and its column means."""
    table = _table(values, labels, index, names)
    per_cluster = {i: table.take(member == i) for i in range(n_cluster)}
    means = {i: _series(_nanmean(values[member == i], 0), [labels])
             for i in range(n_cluster)}
    return per_cluster, means


def cluster_peri_event(peri_event, n_cluster=2, do_plot=False, fig=None,
                       ax=None, do_zscore=False):
    """KMeans clustering of peri-event traces
    (reference post_fit_ach_dataset.py:239-264)."""
    from sklearn.cluster import KMeans

    values, labels, index, names = _wide(peri_event)
    z = _zscored(values) if do_zscore else values
    kmeans = KMeans(n_clusters=n_cluster, random_state=0, n_init=10).fit(z)
    per_cluster, means = _cluster_tables(values, labels, index, names,
                                         kmeans.labels_, n_cluster)
    out = {
        "peri_event_cluster_mean_d": means,
        "peri_event_per_cluster_d": per_cluster,
        "kmeans": kmeans,
    }
    if do_plot:
        for i in range(n_cluster):
            fig, ax = ph.plot_mean_error_plot(
                per_cluster[i].to_numpy(), fig=fig, ax=ax, color=f"C{i}"
            )
        return out, fig, ax
    return out


def manual_cluster_peri_event(peri_event, time_window=(-2, 0), bin=None,
                              n_cluster=2, do_plot=False, fig=None, ax=None,
                              do_zscore=False):
    """Quantile-based clustering on the mean within a time window
    (reference post_fit_ach_dataset.py:266-297)."""
    values, labels, index, names = _wide(peri_event)
    z = _zscored(values) if do_zscore else values
    cols = np.asarray(labels, dtype=float)
    sub = z[:, (cols >= time_window[0]) & (cols <= time_window[1])]
    temporal_mean = _nanmean(sub, 1)
    if bin is None:
        quantile = qcut_codes(temporal_mean, n_cluster)
    else:
        quantile = cut_codes(temporal_mean, bin)
        n_cluster = len(bin) - 1
    per_cluster, means = _cluster_tables(values, labels, index, names,
                                         quantile, n_cluster)
    out = {
        "temporal_mean_quantile": _series(quantile, index, names),
        "temporal_mean": _series(temporal_mean, index, names),
        "peri_event_per_cluster_d": per_cluster,
        "peri_event_per_cluster_mean_d": means,
    }
    if do_plot:
        for i in range(n_cluster):
            fig, ax = ph.plot_mean_error_plot(
                per_cluster[i].to_numpy(), fig=fig, ax=ax, color=f"C{i}"
            )
        return out, fig, ax
    return out


def prep_feature_d(prep_res, consec_pv_dist_metric="correlation",
                   continuous_dynamics_ind=0, jump_dynamics_ind=1,
                   feature_to_include=("ach", "pop_fr", "consec_pv_dist",
                                       "p_continuous", "p_jump"),
                   mask_d=None):
    """Assemble analysis features from a prepared session
    (reference post_fit_ach_dataset.py:300-335)."""
    nap = compat.timeseries_module()
    mask_d = mask_d or {}
    spike_mat_sub = prep_res["spike_mat_sub"]
    dt = np.median(np.diff(spike_mat_sub.t))
    pop_fr = nap.Tsd(d=_data(spike_mat_sub).mean(axis=1) / dt,
                     t=spike_mat_sub.t)
    feature_d = {}
    if "ach" in feature_to_include:
        feature_d["ach"] = prep_res["fluo_data"]["ACh"]
    if "pop_fr" in feature_to_include:
        feature_d["pop_fr"] = pop_fr
    if "pv" in feature_to_include:
        feature_d["pv"] = spike_mat_sub
    if "p_latent" in feature_to_include:
        ma = mask_d.get("p_latent", None)
        plm = prep_res["posterior_latent_marg"]
        feature_d["p_latent"] = plm if ma is None else plm[ma]
    if "consec_pv_dist" in feature_to_include:
        feature_d["consec_pv_dist"] = ah.get_consecutive_pv_distance(
            spike_mat_sub, metric=consec_pv_dist_metric
        )
    if "p_continuous" in feature_to_include:
        feature_d["p_continuous"] = prep_res["posterior_dynamics_marg"][
            :, continuous_dynamics_ind
        ]
    if "p_jump" in feature_to_include:
        feature_d["p_jump"] = prep_res["posterior_dynamics_marg"][
            :, jump_dynamics_ind
        ]
    return feature_d


def turn_sleep_state_tsd_to_interval(
    sleep_state_index, sleep_state_label_d=None
):
    """Numeric sleep-state Tsd -> per-state IntervalSet
    (reference post_fit_ach_dataset.py:337-346)."""
    nap = compat.timeseries_module()
    sleep_state_label_d = sleep_state_label_d or {
        "Awake": 0, "NREM": 2, "REM": 4,
    }
    out = {}
    for label, num in sleep_state_label_d.items():
        mask = nap.Tsd(
            d=(_data(sleep_state_index) == num).astype(float),
            t=sleep_state_index.t,
        )
        out[label] = mask.threshold(0.5).time_support
    return out


def segregate_event_ts_by_sleep_state(event_ts_d, sleep_state_label_d):
    """Split each event train by sleep state
    (reference post_fit_ach_dataset.py:348-359)."""
    out = {}
    for event_name, event_ts in event_ts_d.items():
        for label, intv in sleep_state_label_d.items():
            out[f"{event_name}_{label}"] = event_ts.restrict(intv)
    return out


def get_post_pre_diff(df, center=0, test_win=None):
    """Pre/post means around the event center
    (reference post_fit_ach_dataset.py:362-375); ``pre``, ``post`` and
    ``diff`` one-column ``ResultTable``s over the rows."""
    values, labels, index, names = _wide(df)
    cols = np.asarray(labels, dtype=float)
    if test_win is None:
        test_win = np.minimum(center - cols.min(), cols.max() - center)
    pre = _nanmean(
        values[:, (cols < center) & (cols >= center - test_win)], 1)
    post = _nanmean(
        values[:, (cols > center) & (cols <= center + test_win)], 1)
    diff = post - pre
    # a degenerate sample (0/1 events, or identical diffs) has no spread:
    # report NaN explicitly instead of raising a divide-by-zero warning
    diff_median, effect_size = _summary(diff)
    return {
        "pre": _series(pre, index, names),
        "post": _series(post, index, names),
        "diff": _series(diff, index, names),
        "diff_median": diff_median,
        "effect_size": effect_size,
    }


def test_pre_post_against_shuffle(df, df_shuffle, center=0, test_win=None):
    """Empirical p of the observed pre/post diff vs shuffle diffs
    (reference post_fit_ach_dataset.py:377-391)."""
    dres = get_post_pre_diff(df, center=center, test_win=test_win)
    dres_sh = get_post_pre_diff(df_shuffle, center=center, test_win=test_win)
    p = np.mean(dres["diff_median"] >= dres_sh["diff"][None])
    return {
        "diff": dres["diff_median"],
        "diff_shuffle": dres_sh["diff"],
        "p": p,
        "effect_size": dres["effect_size"],
    }


def get_mean_feature_in_interval(feature_d, interval_d):
    """Mean feature within each interval of each interval set
    (reference post_fit_ach_dataset.py:403-429)."""
    nap = compat.timeseries_module()
    out = {}
    for feat_name, feat in feature_d.items():
        for interval_name, interval in interval_d.items():
            if hasattr(interval, "start"):
                means, t_l = [], []
                for intv in interval:
                    sub = feat.restrict(intv)
                    if len(sub) > 0:
                        means.append(_data(sub).mean(axis=0))
                        t_l.append(sub.t[0])
                out[feat_name, interval_name] = nap.TsdFrame(
                    d=np.atleast_2d(np.asarray(means)), t=np.asarray(t_l)
                )
            else:
                out[feat_name, interval_name] = feat.interpolate(interval)
    return out


def get_distance_matrix(mean_feature_d, metric_d=None):
    """Pairwise distances between per-interval mean features: correlation for
    population vectors, Jensen-Shannon for posteriors
    (reference post_fit_ach_dataset.py:431-443)."""
    metric_d = metric_d or {"pv": "correlation"}
    dist_d = {}
    for k, val in mean_feature_d.items():
        d = _data(val)
        if "pv" in k:
            dist_d[k] = squareform(pdist(d, metric=metric_d["pv"]))
        else:
            dist_d[k] = squareform(pdist(d, metric="jensenshannon"))
    return dist_d


def feature_distance_vs_label_distance_analysis(
    prep_res, label_intv, ach_intv=None, ach_onset=None, ach_extend_win=1,
    feature_key_l=("p_latent", "pv"), interval_key_l=("ACh_onset", "ripple"),
    n_shuffles=200, label_distance_threshold=None, mask_d=None,
):
    """Representational analysis: per-interval mean features, pairwise
    distances, distance ~ |dlabel| regression with permutation null
    (reference post_fit_ach_dataset.py:446-493)."""
    nap = compat.timeseries_module()
    feature_d = prep_feature_d(
        prep_res, feature_to_include=list(feature_key_l), mask_d=mask_d
    )
    interval_d = {}
    if "ACh_onset" in interval_key_l:
        if ach_intv is None:
            assert ach_onset is not None
            onset_sub = ach_onset.restrict(label_intv)
            interval_d["ACh_onset"] = nap.IntervalSet(
                onset_sub.t, onset_sub.t + ach_extend_win
            )
        else:
            starts = nap.Ts(np.asarray(ach_intv.start))
            ma = ~np.isnan(label_intv.in_interval(starts.t).astype(float)) \
                if not hasattr(label_intv.in_interval(starts), "dtype") \
                else ~np.isnan(np.asarray(label_intv.in_interval(starts),
                                          dtype=float))
            keep = np.where(np.asarray(ma))[0]
            interval_d["ACh_onset"] = nap.IntervalSet(
                np.asarray(ach_intv.start)[keep], np.asarray(ach_intv.end)[keep]
            )
    if "ripple" in interval_key_l and "is_ripple" in prep_res:
        interval_d["ripple"] = prep_res["is_ripple"]

    mean_feature_d = get_mean_feature_in_interval(feature_d, interval_d)
    mean_feature_d = {
        k: v.restrict(label_intv) for k, v in mean_feature_d.items()
    }
    dist_d = get_distance_matrix(mean_feature_d)

    analysis_res_d, which_d, change_d = {}, {}, {}
    for key, feat in mean_feature_d.items():
        which = np.asarray(label_intv.in_interval(feat), dtype=float)
        which_d[key] = which
        change_d[key] = np.concatenate([[0], np.diff(which) > 0])
        analysis_res_d[key] = ah.shuffle_test_distance_vs_label(
            dist_d[key], which, n_shuffles=n_shuffles,
            label_distance_threshold=label_distance_threshold,
            timestamps=feat.t,
        )
    return {
        "dist_d": dist_d,
        "analysis_res_d": analysis_res_d,
        "mean_feature_d": mean_feature_d,
        "interval_d": interval_d,
        "which_interval_index_d": which_d,
        "when_label_change_d": change_d,
    }


def main(data_path=None, fit_res_path=None, prep_res=None,
         ach_ramp_kwargs=None, event_triggered_analysis_kwargs=None,
         res_data_save_path=None, res_fig_save_path=None):
    """One-session post-fit quantification: ACh/stim event detection,
    feature prep, sleep-state segregation, event-triggered analyses
    (reference post_fit_ach_dataset.py:502-568)."""
    nap = compat.timeseries_module()
    ach_ramp_kwargs = ach_ramp_kwargs or {
        "height": 0.05, "detrend_cutoff": None, "smooth_win": 1,
        "finite_diff_window_s": 1,
    }
    eta_kwargs = event_triggered_analysis_kwargs or {
        "n_shuffle": 100, "minmax": 4, "do_zscore": False, "test_win": 2,
        "do_plot": True,
    }
    if prep_res is None:
        assert data_path is not None and fit_res_path is not None
        prep_res = load_data_and_fit_res(data_path, fit_res_path)

    has_ach = "fluo_data" in prep_res
    has_stim = "is_stim" in prep_res
    event_ts_d = {}
    if has_ach:
        onset_res = find_ach_ramp_onset(
            prep_res["fluo_data"]["ACh"], **ach_ramp_kwargs
        )
        event_ts_d["ACh_onset"] = onset_res["ach_ramp_onset"]
    if has_stim:
        stim_intv = prep_res["is_stim"].threshold(0.5).time_support
        event_ts_d["stim_onset"] = nap.Ts(np.asarray(stim_intv.start))
    if has_ach and has_stim:
        not_stim = event_ts_d["ACh_onset"].time_support.set_diff(stim_intv)
        event_ts_d["ACh_onset"] = event_ts_d["ACh_onset"].restrict(not_stim)

    feature_to_include = (
        ["p_continuous", "ach", "pop_fr", "consec_pv_dist"]
        if has_ach else ["p_continuous", "pop_fr", "consec_pv_dist"]
    )
    feature_d = prep_feature_d(prep_res, feature_to_include=feature_to_include)

    sleep_state_intv = turn_sleep_state_tsd_to_interval(
        prep_res["sleep_state_index"]
    )
    event_ts_by_sleep = segregate_event_ts_by_sleep_state(
        event_ts_d, sleep_state_intv
    )

    out = event_triggered_analysis_multiple_feature_event(
        feature_d, event_ts_by_sleep, **eta_kwargs
    )
    analysis_res_d = out[0] if eta_kwargs.get("do_plot") else out

    if res_data_save_path is not None:
        os.makedirs(os.path.dirname(res_data_save_path), exist_ok=True)
        with open(res_data_save_path, "wb") as f:
            pickle.dump(analysis_res_d, f)
    if res_fig_save_path is not None and eta_kwargs.get("do_plot"):
        plt = ph.core._pyplot()
        os.makedirs(res_fig_save_path, exist_ok=True)
        fig_d = out[1]
        for feat_name, event_name in fig_d:
            ph.save_fig(
                fig_d[feat_name, event_name],
                f"{feat_name};{event_name}_peri_event", res_fig_save_path,
                fig_format=["png"],
            )
            plt.close(fig_d[feat_name, event_name])
    return analysis_res_d


def _write_test_csv(path, keys, rows, columns):
    """The summary table as ``DataFrame.to_csv`` lays it out: the index
    levels (unnamed) then the columns; an array cell as its list."""
    n_levels = len(keys[0]) if keys and isinstance(keys[0], tuple) else 1
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] * n_levels + list(columns))
        for key, row in zip(keys, rows):
            lead = list(key) if n_levels > 1 else [key]
            w.writerow(lead + [np.asarray(v).tolist() if np.ndim(v) else v
                               for v in row])


def gather_feature_shuffle_across_sessions(analysis_res_d_allsess,
                                           prep_fig_save_dir="./",
                                           ylim_d=None):
    """Aggregate peri-event features + shuffles across sessions (baseline-
    shifted), test pre/post against the shuffle, save the summary CSV
    (reference post_fit_ach_dataset.py:571-645).  ``test_res_d`` is a
    ``ResultTable`` indexed by the (feature, event) keys with columns
    ``diff``, ``diff_shuffle`` (each key's shuffle diffs, an array),
    ``p``, ``effect_size`` (the JAX frame's transpose); the CSV holds
    ``diff_shuffle`` as a list of numbers where pandas prints a Series."""
    ylim_d = ylim_d or {}
    key_l = sorted(
        {k for d in analysis_res_d_allsess for k in d.keys()}
    )
    all_feature, all_shuffle, to_shift_d = {}, {}, {}
    for kk in key_l:
        feats, shufs = [], []
        cols = None
        for d in analysis_res_d_allsess:
            if kk in d:
                values, cols, _, _ = _wide(d[kk]["feature"])
                feats.append(values.mean(axis=0))
                shufs.append(_wide(d[kk]["shuffle"])[0])
        shufs = np.array(shufs)  # (n_sess, n_shuffle, n_time)
        shift = shufs.mean(axis=(1, 2)) - shufs.mean()
        to_shift_d[kk] = shift
        all_shuffle[kk] = _table(
            (shufs - shift[:, None, None]).mean(axis=0), cols)
        all_feature[kk] = _table(np.array(feats) - shift[:, None], cols)

    test_res_d = {}
    for kk in key_l:
        test_res_d[kk] = test_pre_post_against_shuffle(
            all_feature[kk], all_shuffle[kk], center=0
        )
    columns = ["diff", "diff_shuffle", "p", "effect_size"]
    rows = [[test_res_d[kk][c] if c != "diff_shuffle"
             else test_res_d[kk][c][None] for c in columns] for kk in key_l]
    shuffle_col = np.empty(len(key_l), dtype=object)
    shuffle_col[:] = [r[1] for r in rows]
    tuple_keys = bool(key_l) and isinstance(key_l[0], tuple)
    index = ([np.array([k[j] for k in key_l]) for j in range(len(key_l[0]))]
             if tuple_keys else [np.array(key_l)])
    test_res_df = ResultTable(
        {"diff": np.array([r[0] for r in rows], dtype=float),
         "diff_shuffle": shuffle_col,
         "p": np.array([r[2] for r in rows], dtype=float),
         "effect_size": np.array([r[3] for r in rows], dtype=float)},
        index=index if key_l else None)
    os.makedirs(prep_fig_save_dir, exist_ok=True)
    csv_fn = os.path.join(
        prep_fig_save_dir, "peri_event_session_agg_test_res.csv"
    )
    _write_test_csv(csv_fn, key_l, rows, columns)
    return {
        "all_feature_allsess": all_feature,
        "all_shuffle_allsess": all_shuffle,
        "to_shift_d": to_shift_d,
        "test_res_d": test_res_df,
    }


def ach_vs_dynamics_tuning_all_sessions(prep_res_l,
                                        dynamics_label_l=("Continuous", "Jump"),
                                        do_plot=True, figfn="ACh_tuning",
                                        fig_save_dir=None, **kwargs):
    """Posterior-weighted ACh per dynamics state across sessions
    (reference post_fit_ach_dataset.py:649-674); a ``ResultTable`` of one
    row per session."""
    rows = []
    for prep_res in prep_res_l:
        pwa = ah.get_posterior_weighted_average(
            prep_res["fluo_data"]["ACh"], prep_res["posterior_dynamics_marg"]
        )
        values = pwa.to_numpy()
        rows.append(values[:, 0] if values.shape[1] == 1 else values)
    df = _table(np.array(rows), list(dynamics_label_l))
    if do_plot:
        fig, ax = ph.plot_paired_line_median(df.to_numpy())
        ax.set_ylabel("ACh (dF/F)")
        if fig_save_dir is not None:
            ph.save_fig(fig, figfn, fig_save_dir, fig_format=["png"])
        return df, fig, ax
    return df


def latent_cluster_vs_timing_regression(
    cluster_label_l, event_ts, nrem_intv, do_print=False, n_shuffle=100,
    quantile=0.99, alpha=0.01, include_previous_label=True,
    regularization_method="l1", rng=None,
):
    """Multinomial regression of the next latent-cluster label on event phase
    within its NREM interval, the interval's phase in the session, and the
    previous label; permutation null on the labels
    (reference post_fit_ach_dataset.py:679-765; sklearn multinomial
    logistic regression replaces statsmodels mnlogit)."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.preprocessing import OneHotEncoder

    rng = np.random.default_rng(rng)
    cluster_label_l = compat.to_numpy(cluster_label_l)
    which = np.asarray(nrem_intv.in_interval(event_ts), dtype=float)
    assert np.isnan(which).sum() == 0
    which = which.astype(int)
    starts = np.asarray(nrem_intv.start)
    ends = np.asarray(nrem_intv.end)
    duration = ends - starts
    phase_in_intv = (event_ts.t - starts[which]) / duration[which]
    intv_phase = which / len(nrem_intv)

    def build_X(labels):
        X = np.column_stack([phase_in_intv[1:], intv_phase[1:]])
        if include_previous_label:
            enc = OneHotEncoder(sparse_output=False, drop="first")
            prev = enc.fit_transform(labels[:-1][:, None])
            X = np.column_stack([X, prev])
        return X

    def fit(labels):
        X = build_X(labels)
        y = labels[1:]
        l1_ratio = 1.0 if regularization_method == "l1" else 0.0
        # sklearn >= 1.8: a float l1_ratio alone selects the elasticnet
        # path (passing penalty= as well is deprecated)
        clf = LogisticRegression(
            l1_ratio=l1_ratio,
            C=1.0 / max(alpha, 1e-8), solver="saga", max_iter=2000,
        ).fit(X, y)
        score = clf.score(X, y)
        return clf, score

    clf, score = fit(cluster_label_l)
    if do_print:
        print("coef:", clf.coef_, "score:", score)
    res = {
        "reg_res": clf,
        "score": score,
        "reg_df": ResultTable(
            {
                "event_phase_in_intv": phase_in_intv[1:],
                "intv_phase_in_session": intv_phase[1:],
                "previous_label": cluster_label_l[:-1],
                "to_predict": cluster_label_l[1:],
            }
        ),
    }
    if n_shuffle and n_shuffle > 0:
        scores, coefs = [], []
        for _ in range(n_shuffle):
            labels_sh = rng.permutation(cluster_label_l)
            try:
                clf_sh, score_sh = fit(labels_sh)
                scores.append(score_sh)
                coefs.append(clf_sh.coef_)
            except Exception:
                continue
        scores = np.asarray(scores)
        res["shuffle_res_d"] = {
            "score_l": scores,
            "score_high": np.nanquantile(scores, quantile),
            "coef_l": np.asarray(coefs),
        }
        res["p_score"] = float(np.mean(scores >= score))
    return res
