"""The port's post-fit analyses (``analysis.{ccg,distance,posterior,
regression,trial}``, ``utils.{stats,sorting}`` and the root modules
``analysis_helper``, ``distance_analysis``, ``trial_analysis``) against the
JAX package's on the same inputs.

These are host copies of the same numpy and scipy code: results are held
exactly (``np.array_equal``, or ``pandas.testing.assert_frame_equal`` on
``ResultTable.to_dataframe()`` where the JAX function returns a DataFrame,
``to_series()`` for a Series), except where pandas sums in another order
than the port's numpy: ``compute_distance_lag``'s grouped means and
standard deviations (pandas' groupby adds with Kahan compensation and
Welford's update) and the peri-event shuffles' frame means (pandas sums a
frame's columns pairwise) are held to 1e-12 relative.  The port's results
are computed from the port's own time-series containers, and from card
tensors on the CPU where a function takes a fit's results.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from poor_man_gplvm_tpu import analysis as janalysis  # noqa: E402
from poor_man_gplvm_tpu.utils import sorting as jsorting  # noqa: E402
from poor_man_gplvm_tpu.utils import stats as jstats  # noqa: E402
from poor_man_gplvm_tpu.utils import timeseries as jts  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import analysis as panalysis  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import sorting as psorting  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import stats as pstats  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import timeseries as pts  # noqa: E402
from poor_man_gplvm_tpu_torch.utils.table import ResultTable  # noqa: E402

torch.set_num_threads(1)


def _frame(got, want, rtol=None):
    """A port table against the JAX DataFrame (or Series): exact, or to
    ``rtol`` relative where pandas sums in another order."""
    if isinstance(want, pd.Series):
        got = got.to_series()
        kw = {} if rtol is None else dict(check_exact=False, rtol=rtol,
                                          atol=0)
        pd.testing.assert_series_equal(got, want, **kw)
        return
    got = got.to_dataframe()
    kw = dict(check_exact=True) if rtol is None else dict(
        check_exact=False, rtol=rtol, atol=0)
    pd.testing.assert_frame_equal(got, want, **kw)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")


def test_stats_match_jax():
    rng = np.random.default_rng(0)
    n = 240
    groups = np.repeat(np.arange(12), n // 12)
    x = rng.normal(size=(n, 2))
    y = 1.0 + x @ [0.5, -2.0] + rng.normal(0, 2.0, 12)[groups] + \
        rng.normal(0, 0.3, n)
    for X in (pstats.add_constant(x), pstats.add_constant(x[:, 0])):
        _same(X, jstats.add_constant(x if X.shape[1] == 3 else x[:, 0]))
        for cov in ("nonrobust", "HC1", "cluster"):
            g = groups if cov == "cluster" else None
            got = pstats.ols_fit(X, y, cov_type=cov, groups=g)
            want = jstats.ols_fit(X, y, cov_type=cov, groups=g)
            for name in ("params", "bse", "tvalues", "pvalues", "cov_params",
                         "resid", "rsquared", "rsquared_adj", "df_resid",
                         "f_pvalue"):
                _same(getattr(got, name), getattr(want, name))
            _same(got.conf_int(0.1), want.conf_int(0.1))
            assert got.t_test([0, 1] + [0] * (X.shape[1] - 2)) == \
                want.t_test([0, 1] + [0] * (X.shape[1] - 2))
            assert got.param_names == want.param_names
    for fn in (pstats.ols_fit, jstats.ols_fit):
        with pytest.raises(ValueError):
            fn(X, y, cov_type="cluster")
        with pytest.raises(ValueError):
            fn(X, y, cov_type="HC3")


def test_sorting_matches_jax():
    rng = np.random.default_rng(1)
    X, Y = rng.normal(size=(6, 3)), rng.normal(size=(4, 3))
    _same(psorting.rbf_kernel(X, Y, 2.0), jsorting.rbf_kernel(X, Y, 2.0))
    _same(psorting.rbf_kernel(torch.from_numpy(X)), jsorting.rbf_kernel(X))
    tuning = rng.uniform(0, 3, (20, 7))
    spk = rng.poisson(2.0, (50, 7)).astype(float)
    t_l = np.arange(50) * 0.1
    for do_norm in ("max", "zscore", None):
        for tl in (None, t_l):
            got = psorting.post_fit_sort_neuron(
                {"tuning": torch.from_numpy(tuning)}, torch.from_numpy(spk),
                do_norm=do_norm, t_l=tl)
            want = jsorting.post_fit_sort_neuron({"tuning": tuning}, spk,
                                                 do_norm=do_norm, t_l=tl)
            assert set(got) == set(want)
            for key in want:
                _same(getattr(got[key], "d", got[key]),
                      getattr(want[key], "d", want[key]))
    assert psorting.post_fit_sort_neurons is psorting.post_fit_sort_neuron
    for bad in (dict(do_norm="l1"), dict(method="rate")):
        with pytest.raises(ValueError):
            psorting.post_fit_sort_neuron({"tuning": tuning}, spk, **bad)
    _same(psorting.pca_init(torch.from_numpy(spk), 2),
          jsorting.pca_init(spk, 2))
    for name in ("pca_init", "post_fit_sort_neuron", "post_fit_sort_neurons",
                 "rbf_kernel"):
        assert getattr(pmt.utils, name) is getattr(psorting, name)


def _tsd_pair(mod_p, mod_j, cls, d, t, **kw):
    return getattr(mod_p, cls)(d=d, t=t, **kw), getattr(mod_j, cls)(d=d, t=t,
                                                                     **kw)


def test_posterior_analyses_match_jax():
    rng = np.random.default_rng(2)
    T, L = 300, 6
    t = np.arange(T) * 0.1
    post = rng.dirichlet(np.ones(L), T)
    post[:, 5] = 0.0  # a state never visited: NaN
    post /= post.sum(1, keepdims=True)
    post_p, post_j = _tsd_pair(pts, jts, "TsdFrame", post, t)
    feat_p, feat_j = _tsd_pair(pts, jts, "Tsd", np.sin(t), t + 0.05)
    _frame(panalysis.get_posterior_weighted_average(feat_p, post_p),
           janalysis.get_posterior_weighted_average(feat_j, post_j))
    two = np.column_stack([np.sin(t), np.cos(t)])
    f2_p, f2_j = _tsd_pair(pts, jts, "TsdFrame", two, t)
    _frame(panalysis.get_posterior_weighted_average(f2_p, post_p),
           janalysis.get_posterior_weighted_average(f2_j, post_j))
    # the port's decode results as card tensors, wrapped in its TsdFrame
    wrapped = pmt.utils.compat.tsdframe(torch.from_numpy(post), t)
    _frame(panalysis.get_posterior_weighted_average(feat_p, wrapped),
           janalysis.get_posterior_weighted_average(feat_j, post_j))

    p = np.zeros(400)
    p[20:80] = 0.95
    p[85:120] = 0.9
    p[200:205] = 0.99
    p_p, p_j = _tsd_pair(pts, jts, "Tsd", p, np.arange(400) * 0.1)
    for kw in (dict(), dict(p_thresh=0.5, merge_thresh=0.3,
                            duration_thresh=0.2)):
        got = panalysis.get_state_interval(p_p, **kw)
        want = janalysis.get_state_interval(p_j, **kw)
        _same(got.start, want.start)
        _same(got.end, want.end)

    ts_p, ts_j = pts.Ts(np.sort(rng.uniform(0, 30, 40))), jts.Ts(
        np.sort(rng.uniform(0, 30, 40)))
    ts_j = jts.Ts(ts_p.t)
    for support in (None, [2.0, 25.0]):
        _same(panalysis.shift_timestamp(ts_p, support, rng=3).t,
              janalysis.shift_timestamp(ts_j, support, rng=3).t)


@pytest.mark.parametrize("do_zscore", [True, False])
@pytest.mark.parametrize("full", [False, True])
def test_peri_event_with_shuffle_matches_jax(do_zscore, full):
    rng = np.random.default_rng(4)
    t = np.arange(3000) * 0.01
    x = rng.normal(size=3000)
    events = np.sort(rng.uniform(0.2, 29.8, 12))
    f_p, f_j = _tsd_pair(pts, jts, "Tsd", x, t)
    kw = dict(n_shuffle=4, minmax=0.5, do_zscore=do_zscore,
              return_full_shuffle=full, verbose=False, rng=5)
    peri_p, sh_p = panalysis.get_peri_event_with_shuffle(
        f_p, pts.Ts(events), **kw)
    peri_j, sh_j = janalysis.get_peri_event_with_shuffle(
        f_j, jts.Ts(events), **kw)
    if do_zscore:
        _same(peri_p, peri_j)
    else:
        _frame(peri_p, peri_j)
    if full:
        assert len(sh_p) == len(sh_j) == 4
        for a, b in zip(sh_p, sh_j):
            (_same if do_zscore else _frame)(a, b)
    else:
        # without z-scoring the JAX means are DataFrame.mean()s, which sum
        # each column pairwise; the port sums in numpy's order
        _frame(sh_p, sh_j, rtol=None if do_zscore else 1e-12)


def test_pv_distance_and_sequences_match_jax():
    rng = np.random.default_rng(6)
    X = rng.poisson(1.0, (80, 5)).astype(float)
    X[10] = 0.0
    X[11] = 0.0
    X[30] = 0.0
    t = np.arange(80) * 0.05
    for metric in ("cosine", "euclidean", "correlation"):
        for sw in (None, 1.5):
            _same(panalysis.get_consecutive_pv_distance(
                      torch.from_numpy(X), sw, metric),
                  janalysis.get_consecutive_pv_distance(X, sw, metric))
        x_p, x_j = _tsd_pair(pts, jts, "TsdFrame", X, t)
        got = panalysis.get_consecutive_pv_distance(x_p, 2.0, metric)
        want = janalysis.get_consecutive_pv_distance(x_j, 2.0, metric)
        _same(got.t, want.t)
        _same(got.d, want.d)
    with pytest.raises(ValueError):
        panalysis.get_consecutive_pv_distance(X, metric="l1")

    path = rng.integers(0, 6, 400)
    path[[50, 51, 52, 300, 301, 302]] = [1, 2, 3, 1, 2, 3]
    m_p, m_j = _tsd_pair(pts, jts, "Tsd", path.astype(float),
                         np.arange(400) * 0.02)
    for seq, thr in (([1, 2, 3], 0), ([1, 2, 4], 1), (list(range(500)), 0)):
        for a, b in ((torch.from_numpy(path), path), (m_p, m_j)):
            ts_got, idx_got = panalysis.get_sequence_occurence(seq, a, thr)
            ts_want, idx_want = janalysis.get_sequence_occurence(seq, b, thr)
            _same(idx_got, idx_want)
            _same(ts_got.t, ts_want.t)


def test_ccg_matches_jax():
    rng = np.random.default_rng(7)
    a = np.sort(rng.uniform(0, 50, 600))
    b = np.sort(np.concatenate([a[::3] + 0.125, rng.uniform(0, 50, 300)]))
    for kw in (dict(), dict(bin_s=0.005, half_window_s=0.4, t0=5.0, t1=45.0)):
        got = panalysis.compute_ccg_counts(a, b, **kw)
        want = janalysis.compute_ccg_counts(a, b, **kw)
        for x, y in zip(got, want):
            _same(x, y)
        for ez in (True, False):
            got = panalysis.compute_acg_counts(a, exclude_zero=ez, **kw)
            want = janalysis.compute_acg_counts(a, exclude_zero=ez, **kw)
            for x, y in zip(got, want):
                _same(x, y)
    for x, y in zip(panalysis.compute_ccg_counts([], b),
                    janalysis.compute_ccg_counts([], b)):
        _same(x, y)
    tau, counts = janalysis.compute_ccg_counts(a, b, bin_s=0.005,
                                               half_window_s=0.4)
    for kw in (dict(), dict(smooth_bins=1, theta_period_s=0.1)):
        assert panalysis.theta_skipping_index(tau, counts, **kw) == \
            janalysis.theta_skipping_index(tau, counts, **kw)
    assert np.isnan(panalysis.theta_skipping_index(tau, 0 * counts))


def _wide(rng, n_rep=9, times=np.linspace(-1, 1, 11)):
    resp = np.where(times[None] >= 0, 1.0 + 2.0 * times[None], 0.0)
    return resp + rng.normal(0, 0.2, (n_rep, len(times))), times


@pytest.mark.parametrize("cov", ["cluster", "HC1"])
def test_regression_matches_jax(cov):
    rng = np.random.default_rng(8)
    resp, times = _wide(rng)
    df = pd.DataFrame(resp, columns=times)
    table = ResultTable({c: resp[:, j] for j, c in enumerate(times)})
    want = janalysis.fit_time_prepost_interaction(df, cov=cov)
    for wide, time in ((df, None), (table, None), (table, times),
                       (pd.DataFrame(resp), times)):
        got = panalysis.fit_time_prepost_interaction(wide, time=time,
                                                     cov=cov)
        assert set(got) == set(want)
        for key in ("summary_df", "params", "bse", "pvalues", "conf_int",
                    "data_long"):
            _frame(got[key], want[key])
        for key in ("rsquared", "rsquared_adj", "f_pvalue", "nobs",
                    "cov_type", "coef_pre", "coef_post", "p_interaction",
                    "p_intercept_diff"):
            assert got[key] == want[key], key
        _same(got["model"].params, want["model"].params)
    for bad in (dict(time=times + 5), dict(time=times[:-1]),
                dict(cov="HC3")):
        with pytest.raises(ValueError):
            panalysis.fit_time_prepost_interaction(df, **bad)
    with pytest.raises(ValueError):
        panalysis.fit_time_prepost_interaction(
            ResultTable({"a": resp[:, 0]}))


def test_compute_distance_lag_matches_jax():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(70, 4))
    few = rng.integers(0, 6, 70).astype(float)  # <= 50 label lags: groupby
    many = rng.normal(size=70) * 10  # > 50: quantile bins
    for kw in (dict(), dict(metric="cosine", max_index_lag=12),
               dict(label_d=few), dict(label_d=few, max_index_lag=5),
               dict(label_d=many), dict(label_d=many, bin_count=7),
               dict(label_d=many, label_bins=[0.0, 1.5, 4.0, 9.0, 30.0])):
        got = panalysis.compute_distance_lag(X, **kw)
        want = janalysis.compute_distance_lag(X, **kw)
        _same(got["D"], want["D"])
        _frame(got["pairs_df"], want["pairs_df"])
        # grouped means/stds: pandas adds with Kahan and Welford
        _frame(got["by_index_lag"], want["by_index_lag"], rtol=1e-12)
        if want["by_label_lag"] is None:
            assert got["by_label_lag"] is None
            continue
        want_l = want["by_label_lag"]
        got_l = got["by_label_lag"].to_dataframe()
        if "label_lag_bin" in want_l:
            edges = [(iv.left, iv.right) for iv in want_l["label_lag_bin"]]
            assert list(got_l["label_lag_bin"]) == edges
            got_l = got_l.drop(columns="label_lag_bin")
            want_l = want_l.drop(columns="label_lag_bin")
        pd.testing.assert_frame_equal(got_l, want_l, check_exact=False,
                                      rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        panalysis.compute_distance_lag(X[0])
    with pytest.raises(ValueError):
        panalysis.compute_distance_lag(X, label_d=few[:-1])
    with pytest.raises(ValueError):
        panalysis.compute_distance_lag(X, label_d=many,
                                       label_bins=[0.0, 5.0, 2.0])


def test_distance_regressions_match_jax():
    rng = np.random.default_rng(10)
    P = rng.dirichlet(np.ones(8), 40)
    edges = np.linspace(0, 2, 9)
    for kw in (dict(), dict(bin_edges=edges), dict(normalize=True)):
        for x, y in zip(panalysis.w1_cdf_distance_matrix(P * 3, **kw),
                        janalysis.w1_cdf_distance_matrix(P * 3, **kw)):
            _same(x, y)
    with pytest.raises(ValueError):
        panalysis.w1_cdf_distance_matrix(P, bin_edges=edges[:-1])
    D = panalysis.w1_cdf_distance_matrix(P)[0]
    labels = rng.uniform(0, 10, 40)
    labels[[3, 17]] = np.nan
    stamps = np.arange(40) * 0.5
    for kw in (dict(), dict(timestamps=stamps), dict(binning="quantile",
                                                      nbins=6),
               dict(label_distance_threshold=3.0),
               dict(label_distance_threshold=3.0, timestamps=stamps)):
        got = panalysis.distance_vs_label_regression(D, labels, **kw)
        want = janalysis.distance_vs_label_regression(D, labels, **kw)
        assert got["summary"].keys() == want["summary"].keys()
        for k in want["summary"]:
            _same(got["summary"][k], want["summary"][k])
        _frame(got["pairs_df"], want["pairs_df"])
        _frame(got["binned"], want["binned"])
        _same(got["edges"], want["edges"])
        _same(got["kept_idx"], want["kept_idx"])
        got = panalysis.shuffle_test_distance_vs_label(D, labels,
                                                       n_shuffles=15,
                                                       rng=11, **kw)
        want = janalysis.shuffle_test_distance_vs_label(D, labels,
                                                        n_shuffles=15,
                                                        rng=11, **kw)
        assert set(got) == set(want)
        for k in want:
            if k == "binned_obs":
                _frame(got[k], want[k])
            else:
                _same(got[k], want[k])
    assert panalysis.distance_vs_label_regression(
        D, labels, return_pairs_df=False)["pairs_df"] is None


def test_distance_helpers_match_jax():
    rng = np.random.default_rng(12)
    mats = [rng.normal(size=(n, 3)) for n in (5, 9, 14)]
    mats[1][2, 0] = np.nan
    mats[2][:, 2] = np.nan
    for kw in (dict(), dict(n_point=7, ddof=1)):
        got = panalysis.interpolate_stacks(mats, **kw)
        want = janalysis.interpolate_stacks(mats, **kw)
        for k in want:
            _same(got[k], want[k])
        got = panalysis.interpolate_compute_dist_mat(mats, **kw)
        want = janalysis.interpolate_compute_dist_mat(mats, **kw)
        for k in ("D_mean", "D_std"):
            _same(got[k], want[k])
        for a, b in zip(got["D_list"], want["D_list"]):
            _same(a, b)
    for bad in ([], [np.zeros(3)], [np.zeros((3, 2)), np.zeros((3, 3))]):
        with pytest.raises(ValueError):
            panalysis.interpolate_stacks(bad)
    labels = rng.integers(0, 4, 200)
    labels[::7] = 9
    for kw in (dict(), dict(mode="segment", smoothing=0.5),
               dict(exclude=[9], state_order="appearance"),
               dict(exclude=list(range(10)))):
        got = panalysis.labels_to_transition_matrix(labels, **kw)
        want = janalysis.labels_to_transition_matrix(labels, **kw)
        _same(got[0], want[0])
        assert list(got[1]) == list(want[1])
    with pytest.raises(ValueError):
        panalysis.labels_to_transition_matrix(labels, mode="x")
    got = panalysis.get_transmat_and_shuffle(labels, n_shuffle=20, rng=13)
    want = janalysis.get_transmat_and_shuffle(labels, n_shuffle=20, rng=13)
    for k in want:
        _same(got[k], want[k])


def test_trial_helpers_match_jax():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(14)
    start = np.cumsum(rng.uniform(5, 8, 12))
    trials = pd.DataFrame({
        "start": start, "end": start + 4.0,
        "cue": start + rng.uniform(0, 1, 12),
        "reward": start + rng.uniform(2, 4, 12)},
        index=pd.Index(np.arange(12) * 3, name="trial"))
    keys = ("cue", "reward")
    want = janalysis.get_event_phase_in_trial(trials, keys)
    for given in (trials, ResultTable(
            {c: trials[c].to_numpy() for c in trials.columns},
            index=[trials.index.to_numpy()], index_names=("trial",))):
        _frame(panalysis.get_event_phase_in_trial(given, keys), want)
    got = panalysis.get_event_phase_in_trial(
        {c: trials[c].to_numpy() for c in trials.columns}, keys)
    pd.testing.assert_frame_equal(got.to_dataframe(),
                                  want.reset_index(drop=True))
    want.iloc[3, 0] = np.nan
    got = ResultTable({c: want[c].to_numpy() for c in want.columns})
    spans = []
    for fn, arg in ((panalysis.plot_event_range, got),
                    (janalysis.plot_event_range, want)):
        fig, ax = plt.subplots()
        fn(arg, xs=(0, 10), ax=ax)
        spans.append([np.asarray(p.get_xy()) for p in ax.patches])
        plt.close(fig)
    assert len(spans[0]) == len(spans[1]) == 2
    for a, b in zip(*spans):
        _same(a, b)


def test_root_modules_and_exports_match_jax():
    import poor_man_gplvm_tpu as jpmg

    for name in ("analysis_helper", "distance_analysis", "trial_analysis"):
        jm, pm = getattr(jpmg, name), getattr(pmt, name)
        public = {n for n, v in vars(jm).items()
                  if not n.startswith("_") and callable(v)}
        for n in public:
            assert getattr(pm, n) is getattr(panalysis, n), (name, n)
    assert set(janalysis.__all__) <= set(panalysis.__all__)
    for name in janalysis.__all__:
        assert getattr(panalysis, name).__module__.startswith(
            "poor_man_gplvm_tpu_torch.analysis"), name
