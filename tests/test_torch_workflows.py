"""The post-fit workflows, the port against the JAX package:
``poor_man_gplvm_tpu_torch.workflows.{tmaze,ach}_dataset`` against
``poor_man_gplvm_tpu/workflows/{tmaze,ach}_dataset.py`` on the CPU.

Every public function of both modules gets the same numpy inputs, made
from a seed, in each package's own time-series containers (the fitted
``tuning``, the jump probabilities and the fit's log posterior as torch
tensors on the port's side).  Results are held exactly, a port
``ResultTable`` against the JAX DataFrame or Series through
``to_dataframe()``/``to_series()``, but where pandas sums in another order
than the port's numpy: the pre/post means, medians and effect sizes of
``event_triggered_analysis``/``get_post_pre_diff`` (and what
``main``/``gather_feature_shuffle_across_sessions`` build from them), the
z-scored and per-cluster column means of ``cluster_peri_event``/
``manual_cluster_peri_event``, held to 1e-12 relative.  The sklearn
functions (``classify_latent``, ``cluster_peri_event``,
``latent_cluster_vs_timing_regression``) and dill
(``load_data_and_fit_res``) are held here, where both are installed.

The slice as a whole: ``testing.tmaze_session`` and
``testing.ach_session`` at N = 12, L = 16, T = 2,000, fitted by both
packages from the same weights and initial posterior (the JAX draws) and
decoded.  Fits agree within the fit tolerance of PARITY.json (log
marginals 1e-5 relative, posteriors 1e-2), decodes within 1e-4; the MAP
latents and the jump calls are asserted equal, so the T-maze workflows
then agree exactly on each package's own results, and the workflows that
read continuous results (the fitted tuning, the ACh session's posteriors)
are held exactly on the JAX fit's values given to both.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import jax  # noqa: E402
import jax.random as jr  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu import selection as jsel  # noqa: E402
from poor_man_gplvm_tpu.models.jump1d import _init_posterior_random  # noqa: E402
from poor_man_gplvm_tpu.utils import timeseries as jts  # noqa: E402
from poor_man_gplvm_tpu.workflows import ach_dataset as jach  # noqa: E402
from poor_man_gplvm_tpu.workflows import tmaze_dataset as jtmz  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import convert, selection, testing  # noqa: E402
from poor_man_gplvm_tpu_torch.parallel import sweep  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import timeseries as pts  # noqa: E402
from poor_man_gplvm_tpu_torch.utils.table import ResultTable  # noqa: E402
from poor_man_gplvm_tpu_torch.workflows import ach_dataset as pach  # noqa: E402
from poor_man_gplvm_tpu_torch.workflows import tmaze_dataset as ptmz  # noqa: E402

torch.set_num_threads(1)

#: pandas reductions against the port's numpy ones
SUM_ORDER_RTOL = 1e-12
TOL_LML, TOL_DECODE_POST, TOL_FIT_POST = 1e-5, 1e-4, 1e-2


# ---------------------------------------------------------------------------
# comparison of a port result with the JAX one
# ---------------------------------------------------------------------------


def _arrays(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if rtol is None or want.dtype.kind not in "fc":
        assert np.array_equal(got, want, equal_nan=want.dtype.kind in "fc")
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   equal_nan=True)


def same(got, want, rtol=None, path="result"):
    """``got`` (the port's) against ``want`` (the JAX package's), walking
    dicts, lists and tuples; a ``ResultTable`` against a DataFrame or
    Series, an array against a pandas Index, time-series containers by
    their times and values, scipy results by their fields, sklearn models
    by their fitted arrays.  Floats exactly, or to ``rtol`` relative."""
    if isinstance(want, pd.Series):
        assert isinstance(got, ResultTable), path
        kw = dict(check_exact=True) if rtol is None else dict(
            check_exact=False, rtol=rtol, atol=0)
        pd.testing.assert_series_equal(got.to_series(), want,
                                       check_index_type=False, **kw)
    elif isinstance(want, pd.DataFrame):
        assert isinstance(got, ResultTable), path
        kw = dict(check_exact=True) if rtol is None else dict(
            check_exact=False, rtol=rtol, atol=0)
        pd.testing.assert_frame_equal(got.to_dataframe(), want,
                                      check_index_type=False,
                                      check_column_type=False, **kw)
    elif isinstance(want, pd.Index):
        _arrays(got, want.to_numpy(), None)
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            same(got[k], want[k], rtol, f"{path}[{k!r}]")
    elif type(want).__name__ in ("Ts", "Tsd", "TsdFrame"):
        assert type(got).__name__ == type(want).__name__, path
        _arrays(got.t, want.t, None)
        if hasattr(want, "d"):
            _arrays(got.d, want.d, rtol)
    elif type(want).__name__ == "IntervalSet":
        _arrays(got.start, want.start, None)
        _arrays(got.end, want.end, None)
    elif type(want).__name__ == "_PeriEvent":
        _arrays(got.d, want.d, rtol)
        _arrays(got.rel_times, want.rel_times, None)
    elif hasattr(want, "statistic") and hasattr(want, "pvalue"):
        _arrays(got.statistic, want.statistic, rtol)
        _arrays(got.pvalue, want.pvalue, rtol)
    elif hasattr(want, "labels_"):  # KMeans
        _arrays(got.labels_, want.labels_, None)
        _arrays(got.cluster_centers_, want.cluster_centers_, rtol)
    elif hasattr(want, "coef_"):  # LogisticRegression
        _arrays(got.coef_, want.coef_, None)
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) and want.dtype == object:
        assert got.shape == want.shape, path
        for i, (g, w) in enumerate(zip(got.ravel(), want.ravel())):
            same(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, float, int, np.number, bool,
                           np.bool_)):
        _arrays(got, want, rtol)
    elif want is None or isinstance(want, str):
        assert got == want, path
    else:  # the regression result of analysis.fit_time_prepost_interaction
        raise AssertionError(f"{path}: no comparison for {type(want)}")


def _regression(got, want, rtol=None):
    for key in ("summary_df", "params", "bse", "pvalues", "data_long"):
        same(got[key], want[key], rtol, key)
    for key in ("coef_pre", "coef_post", "p_interaction",
                "p_intercept_diff", "nobs"):
        same(got[key], want[key], rtol, key)


def _event_result(got, want, rtol=SUM_ORDER_RTOL):
    """An ``event_triggered_analysis`` result: the peri-event table and
    the regressions exactly, the shuffles' means and the pre/post
    statistics to the sum-order tolerance."""
    same(got["feature"], want["feature"])
    # the shuffles' column means: pandas sums them in another order
    same(got["shuffle"], want["shuffle"], rtol)
    for key in ("diff_median", "effect_size", "wc_res", "corr_res"):
        same(got[key], want[key], rtol, key)
    _regression(got["reg_res"], want["reg_res"])
    if "reg_res_shuffle" in want:  # fitted to the shuffles' means
        _regression(got["reg_res_shuffle"], want["reg_res_shuffle"], rtol)


@pytest.fixture(autouse=True)
def _seeded_default_rng(monkeypatch):
    """``np.random.default_rng(None)`` seeded: the shuffles of
    ``analysis.get_peri_event_with_shuffle`` and
    ``shuffle_test_distance_vs_label``, which the workflows call without a
    seed, then draw the same numbers in both packages."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: (
        default_rng(20250 if seed is None else seed)))


def both(make):
    """``make(timeseries module)`` for the port and for the JAX package."""
    return make(pts), make(jts)


# ---------------------------------------------------------------------------
# the T-maze workflow
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tmaze_sim():
    """``tests/test_workflows.py``'s ``tmaze_sim``, in both packages'
    containers."""
    rng = np.random.default_rng(0)
    T = 400
    t = np.arange(T) * 0.1
    map_latent = rng.integers(0, 4, T)
    speed = np.where(map_latent == 2, 1.0, 10.0)
    xy = np.zeros((T, 2))
    xy[map_latent == 1] = [10, 10]
    xy[map_latent == 3] = [50, 50]
    xy += rng.normal(0, 0.3, (T, 2))
    maze_xy = np.stack([np.linspace(0, 15, 50), np.linspace(0, 15, 50)],
                       axis=1)
    return both(lambda nap: (nap.Tsd(d=map_latent.astype(float), t=t),
                             nap.TsdFrame(d=xy, t=t, columns=["x", "y"]),
                             nap.Tsd(d=speed, t=t), maze_xy))


def test_occurrence_index_and_maze_distance_match_jax(tmaze_sim):
    (pm, ppos, pspeed, maze), (jm, _, jspeed, _) = tmaze_sim
    for thresh in ((5,), (2, 8)):
        same(ptmz.get_latent_occurance_index_per_speed_level(
            pm, pspeed, thresh),
            jtmz.get_latent_occurance_index_per_speed_level(
                jm, jspeed, thresh))
    # the MAP latent as a tensor
    same(ptmz.get_latent_occurance_index_per_speed_level(
        torch.as_tensor(pm.d), pspeed),
        jtmz.get_latent_occurance_index_per_speed_level(jm, jspeed))
    same(ptmz.get_dist_to_maze(torch.as_tensor(ppos.d), maze),
         jtmz.get_dist_to_maze(ppos.d, maze))


def test_classify_latent_matches_jax(tmaze_sim):
    (pm, ppos, pspeed, maze), (jm, jpos, jspeed, _) = tmaze_sim
    for kw in ({}, dict(speed_thresh=5, dist_to_maze_thresh=5,
                        min_run_time=10, min_off_maze_time=10, eps=3),
               dict(eps=0.5, min_run_time=50)):
        same(ptmz.classify_latent(pm, ppos, pspeed, maze, **kw),
             jtmz.classify_latent(jm, jpos, jspeed, maze, **kw))


@pytest.mark.parametrize("trials_as", ["frame", "table", "intervals",
                                       None])
def test_latent_field_properties_match_jax(tmaze_sim, trials_as):
    (pm, ppos, pspeed, maze), (jm, jpos, jspeed, _) = tmaze_sim
    res_p = ptmz.classify_latent(pm, ppos, pspeed, maze)
    res_j = jtmz.classify_latent(jm, jpos, jspeed, maze)
    t = pm.t
    lin_p, lin_j = both(lambda nap: nap.Tsd(d=ppos.d[:, 0], t=t))
    starts = np.arange(0, 40, 2.5)
    trials = {"frame": pd.DataFrame({"start": starts, "end": starts + 2}),
              "table": ResultTable({"start": starts, "end": starts + 2}),
              "intervals": None, None: None}[trials_as]
    for circ in (False, True):
        rng_cmp = {"early": (0, 4), "late": (-4, None)}
        if trials_as == "intervals":
            tp, tj = pts.IntervalSet(starts, starts + 2), jts.IntervalSet(
                starts, starts + 2)
        else:
            tp = trials
            tj = (trials.to_dataframe() if isinstance(trials, ResultTable)
                  else trials)
        got = ptmz.get_latent_field_properties(
            res_p["latent_occurance_index_per_speed_level"],
            res_p["cluster_label_per_time_all_latent"], lin_p,
            trial_intervals=tp, trial_range_to_compare=rng_cmp,
            do_circular_stat=circ)
        want = jtmz.get_latent_field_properties(
            res_j["latent_occurance_index_per_speed_level"],
            res_j["cluster_label_per_time_all_latent"], lin_j,
            trial_intervals=tj, trial_range_to_compare=rng_cmp,
            do_circular_stat=circ)
        same(got, want)


def test_circular_stats_match_jax():
    rng = np.random.default_rng(3)
    for vals in (np.array([350.0, 355.0, 5.0, 10.0]), rng.uniform(0, 360, 50),
                 np.array([]), np.array([np.nan, 10.0])):
        for a, b in ((0.0, 360.0), (0.0, 0.0), (10.0, 200.0)):
            same(ptmz._circular_mean(torch.as_tensor(vals), a, b),
                 jtmz._circular_mean(vals, a, b))
            same(ptmz._circular_std(vals, a, b),
                 jtmz._circular_std(vals, a, b))
    for late, early in ((5.0, 355.0), (100.0, 20.0)):
        same(ptmz._circular_diff(late, early, 0.0, 360.0),
             jtmz._circular_diff(late, early, 0.0, 360.0))


@pytest.mark.parametrize("correct_only", [True, False])
def test_reward_latent_selection_matches_jax(correct_only):
    rng = np.random.default_rng(0)
    T = 300
    t = np.arange(T) * 0.1
    map_latent = rng.integers(0, 4, T).astype(float)
    lin = np.where(map_latent == 1, 111.0, 50.0) + rng.normal(0, 0.5, T)
    lin[map_latent == 3] = np.where(t[map_latent == 3] < 15, 111.0, 40.0)
    speed = np.where(map_latent == 2, 8.0, 1.0)
    (pm, pl, ps), (jm, jl, js) = both(lambda nap: (
        nap.Tsd(d=map_latent, t=t), nap.Tsd(d=lin, t=t),
        nap.Tsd(d=speed, t=t)))
    cols = {"start": [0.0, 10.0, 15.0, 22.0], "end": [9.9, 14.9, 21.9, 29.9],
            "choice": [1, 0, 1, 1], "visitedArm": [0, 0, 1, 1]}
    occ_p = ptmz.get_latent_occurance_index_per_speed_level(pm, ps, [5])
    occ_j = jtmz.get_latent_occurance_index_per_speed_level(jm, js, [5])
    want = jtmz.get_latent_in_position_range(
        occ_j, jl, pd.DataFrame(cols), speed_level=0,
        correct_only=correct_only)
    for trials in (pd.DataFrame(cols), ResultTable(cols)):
        got = ptmz.get_latent_in_position_range(
            occ_p, pl, trials, speed_level=0, correct_only=correct_only)
        same(got, want)
        for fn in ("get_single_reward_latent", "get_both_reward_latent"):
            for thr in ((0.7, 10), (0.5, 2)):
                assert getattr(ptmz, fn)(got, *thr) == \
                    getattr(jtmz, fn)(want, *thr)
                assert getattr(ptmz, fn)(want, *thr) == \
                    getattr(jtmz, fn)(want, *thr)
    # speed level 1: a latent seen only while running
    same(ptmz.get_latent_in_position_range(occ_p, pl, ResultTable(cols),
                                           speed_level=1),
         jtmz.get_latent_in_position_range(occ_j, jl, pd.DataFrame(cols),
                                           speed_level=1))


def test_latent_pairs_and_transition_times_match_jax():
    t = np.arange(20) * 0.5
    path = np.array([0, 0, 5, 5, 0, 0, 5, 5, 0, 0] * 2, dtype=float)
    pairs = [(0, 5), (5, 0), (3, 3)]
    for thr in (0, 1, 2):
        for mp, mj in (both(lambda nap: nap.Tsd(d=path, t=t)),
                       (torch.as_tensor(path), path)):
            same(ptmz.find_all_index_per_latent_pair(pairs, mp, thr),
                 jtmz.find_all_index_per_latent_pair(pairs, mj, thr))
    lin_p, lin_j = both(lambda nap: nap.Tsd(
        d=np.tile(np.linspace(100, 130, 10), 2), t=t))
    cols = {"start": [0.0, 5.0], "end": [4.5, 9.5]}
    for kind in ("arrival", "departure"):
        for lin_pt, tol in ((115, 10), (120, 3), (200, 10)):
            want = jtmz.find_transition_times(
                {"lin": lin_j}, pd.DataFrame(cols), lin_pt, kind, tol)
            for trials in (pd.DataFrame(cols), ResultTable(cols),
                           pts.IntervalSet(cols["start"], cols["end"])):
                same(ptmz.find_transition_times(
                    {"lin": lin_p}, trials, lin_pt, kind, tol), want)
            same(ptmz.find_transition_times(lin_p, ResultTable(cols),
                                            lin_pt, kind, tol), want)


def test_consensus_fractions_and_shuffles_match_jax():
    rng = np.random.default_rng(1)
    t = np.arange(500) * 0.1
    jump = (rng.random(500) < 0.03).astype(float)
    trans_times = np.array([10.0, 20.0, 30.0, 40.5])
    for k in trans_times:
        jump[int(k / 0.1)] = 1.0
    (pj, ptr), (jj, jtr) = both(lambda nap: (nap.Tsd(d=jump, t=t),
                                             nap.Ts(trans_times)))
    mat = rng.random((21, 6)) > 0.8
    for w in (3, 10):
        same(ptmz.compute_consensus_fractions_by_window(torch.as_tensor(mat),
                                                        w),
             jtmz.compute_consensus_fractions_by_window(mat, w))
    for win, wsi in ((1, 2), (0.5, 1)):
        same(ptmz.compute_shuffle_consensus_fractions(
            pj, ptr, win, wsi, n_shuffle=20, rng=4),
            jtmz.compute_shuffle_consensus_fractions(
                jj, jtr, win, wsi, n_shuffle=20, rng=4))
    lin = np.tile(np.concatenate([np.linspace(100, 130, 50), np.full(50,
                                                                   90.0)]),
                  5)
    beh_p, beh_j = both(lambda nap: nap.Tsd(d=lin, t=t))
    cols = {"start": np.arange(5) * 10.0, "end": np.arange(5) * 10.0 + 9.9}
    for kind in ("arrival", "departure"):
        want = jtmz.analyze_peri_transition_jump_consensus(
            beh_j, pd.DataFrame(cols), jj, lin_pt=110, transition_type=kind,
            max_window_size=4, n_shuffle=15, rng=2)
        got = ptmz.analyze_peri_transition_jump_consensus(
            beh_p, ResultTable(cols), pj, lin_pt=110, transition_type=kind,
            max_window_size=4, n_shuffle=15, rng=2)
        same(got, want)


def test_jump_triggered_analysis_and_null_projection_match_jax():
    rng = np.random.default_rng(2)
    T, N, L = 600, 9, 12
    t = np.arange(T) * 0.05
    path = np.clip(np.cumsum(rng.integers(-1, 2, T)) % L, 0, L - 1)
    path[200] = 9
    path[201] = 2
    path[400:402] = [9, 2]
    spk = rng.poisson(1.0, (T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, (L, N)).astype(np.float32)
    beh = np.column_stack([np.sin(t), np.cos(t), t])
    jump_p = rng.random((T, 2)).astype(np.float32) * 0.2
    (pm, pb, ps), (jm, jb, js) = both(lambda nap: (
        nap.Tsd(d=path.astype(float), t=t),
        nap.TsdFrame(d=beh, t=t, columns=["x", "y", "lin"]),
        nap.TsdFrame(d=spk, t=t)))
    for kw in (dict(t=t[201]), dict(seq=np.array([9.0, 2.0]),
                                    contrast_axis_latent_window=1,
                                    cols=["lin"]),
               dict(seq=np.array([3.0, 4.0]), latent_distance_thresh=0,
                    peri_event_win=0.5)):
        got = ptmz.latent_jump_triggered_analysis(
            pm, pb, ps, torch.as_tensor(tuning), **kw)
        want = jtmz.latent_jump_triggered_analysis(
            jm, jb, js, jax.numpy.asarray(tuning), **kw)
        same(got, want)
    for jp, win in ((jump_p, 0), (jump_p[:, 1], 1)):
        got = ptmz.get_null_contrastive_projection(
            ps, torch.as_tensor(tuning), pm, torch.as_tensor(jp),
            jump_p_thresh=0.15, contrast_axis_latent_window=win,
            n_shuffle=12, peri_event_win=1, rng=5)
        want = jtmz.get_null_contrastive_projection(
            js, jax.numpy.asarray(tuning), jm, jp, jump_p_thresh=0.15,
            contrast_axis_latent_window=win, n_shuffle=12,
            peri_event_win=1, rng=5)
        same(got, want)


def test_time_of_arrival_matches_jax():
    t = np.arange(100) * 0.1
    lin = np.concatenate([np.linspace(100, 120, 40),
                          np.linspace(120, 100, 40), np.full(20, 100.0)])
    lin2 = np.concatenate([np.full(10, 100.0), np.full(10, 111.0),
                           np.full(10, 100.0), np.full(10, 111.0),
                           np.full(60, 100.0)])
    for d in (lin, lin2):
        pp, pj = both(lambda nap: nap.TsdFrame(d=d[:, None], t=t,
                                               columns=["lin"]))
        for rng_ in ((109, 113), (95, 101)):
            same(ptmz.get_time_of_arrival_based_one_position(pp, rng_),
                 jtmz.get_time_of_arrival_based_one_position(pj, rng_))


def _scatter_offsets(ax):
    return [np.asarray(c.get_offsets()) for c in ax.collections]


def test_tmaze_plots_match_jax(tmaze_sim):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    (pm, ppos, pspeed, _), (jm, jpos, jspeed, _) = tmaze_sim
    t = pm.t
    beh_p, beh_j = both(lambda nap: nap.TsdFrame(
        d=np.column_stack([ppos.d, pspeed.d]), t=t,
        columns=["x", "y", "speed_gauss"]))
    cases = (dict(latent_l=[0, 1], color=None, color_time=False,
                  seperate_colorbar=False),
             dict(latent_l=[1], seperate_colorbar=True),
             dict(latent_l=[2, 3], color="k", do_plot_maze=True,
                  seperate_colorbar=False))
    for kw in cases:
        kw = dict(kw)
        lat = kw.pop("latent_l")
        kp, kj = dict(kw), dict(kw)
        if kw.get("do_plot_maze"):
            kp["position_tsdf"], kj["position_tsdf"] = beh_p, beh_j
        got = ptmz.plot_latent_list_vs_position(
            lat, torch.as_tensor(pm.d), beh_p, **kp)
        want = jtmz.plot_latent_list_vs_position(lat, jm.d, beh_j, **kj)
        assert len(got) == len(want)
        for a, b in zip(_scatter_offsets(got[1]), _scatter_offsets(want[1])):
            assert np.array_equal(a, b)
        assert [ln.get_xydata().tolist() for ln in got[1].lines] == \
            [ln.get_xydata().tolist() for ln in want[1].lines]
        for a, b in zip(got[1].collections, want[1].collections):
            assert np.array_equal(a.get_edgecolors(), b.get_edgecolors())
    fig_p, axs_p = ptmz.plot_multiple_latent_spatial_map([0, 1], pm, beh_p)
    fig_j, axs_j = jtmz.plot_multiple_latent_spatial_map([0, 1], jm, beh_j)
    for a, b in zip(np.ravel(axs_p), np.ravel(axs_j)):
        assert a.get_title() == b.get_title()
        for x, y in zip(_scatter_offsets(a), _scatter_offsets(b)):
            assert np.array_equal(x, y)
    post = np.random.default_rng(0).dirichlet(np.ones(3), 50)
    fig_p, axs_p = ptmz.plot_multiple_latent_posterior_in_time(
        torch.as_tensor(post))
    fig_j, axs_j = jtmz.plot_multiple_latent_posterior_in_time(post)
    for a, b in zip(np.ravel(axs_p), np.ravel(axs_j)):
        assert a.get_title() == b.get_title()
        assert [ln.get_xydata().tolist() for ln in a.lines] == \
            [ln.get_xydata().tolist() for ln in b.lines]
    plt.close("all")


# ---------------------------------------------------------------------------
# the ACh workflow
# ---------------------------------------------------------------------------


def _sigmoid_ramps(t, at):
    return sum(1.0 / (1 + np.exp(-(t - a) * 4)) for a in at)


def test_ramp_onsets_match_jax():
    t = np.arange(3000) * 0.01
    sig = _sigmoid_ramps(t, (5.0, 12.0, 21.0)) + 0.02 * np.sin(3 * t)
    p_in, j_in = both(lambda nap: nap.Tsd(d=sig, t=t))
    for kw in (dict(smooth_win=0.2, finite_diff_window_s=0.5, height=0.1),
               dict(smooth_win=None, height=0.2, do_zscore=False),
               dict(height=0.05, detrend_cutoff=0.05)):
        same(pach.find_ach_ramp_onset(p_in, **kw),
             jach.find_ach_ramp_onset(j_in, **kw))
    for kw in (dict(smooth_win=0.2, height=0.1, shift=-0.5),
               dict(smooth_win=None, height=0.05, do_zscore=False),
               dict(height=0.05, detrend_cutoff=0.05)):
        same(pach.find_ach_ramp_onset_old(p_in, **kw),
             jach.find_ach_ramp_onset_old(j_in, **kw))


@pytest.fixture(scope="module")
def steps():
    rng = np.random.default_rng(0)
    t = np.arange(5000) * 0.01
    events = np.array([10.0, 20.0, 30.0, 40.0, 44.0])
    feat = rng.normal(0, 0.1, len(t))
    for ev in events:
        feat[t >= ev] += 1.0
    return t, events, feat


@pytest.mark.parametrize("kw", [
    dict(n_shuffle=5, minmax=2, test_win=1),
    dict(n_shuffle=3, minmax=1.5, test_win=0.5),
    dict(n_shuffle=0, minmax=2, test_win=1)])
def test_event_triggered_analysis_matches_jax(steps, kw):
    t, events, feat = steps
    (pf, pe), (jf, je) = both(lambda nap: (nap.Tsd(d=feat, t=t),
                                           nap.Ts(events)))
    got = pach.event_triggered_analysis(pf, pe, **kw)
    want = jach.event_triggered_analysis(jf, je, **kw)
    _event_result(got, want)
    # z-scored, the table's columns are numbered, none before 0: both
    # packages raise in the pre-event correlation
    for pkg, f, e in ((pach, pf, pe), (jach, jf, je)):
        with pytest.raises(ValueError, match="length at least 2"):
            pkg.event_triggered_analysis(f, e, do_zscore=True, **kw)


def test_event_triggered_over_features_and_events_matches_jax(steps):
    t, events, feat = steps
    (pfd, ped), (jfd, jed) = both(lambda nap: (
        {"a": nap.Tsd(d=feat, t=t), "b": nap.Tsd(d=-feat[::-1], t=t)},
        {"e1": nap.Ts(events), "e2": nap.Ts(events[:1]),
         "e3": nap.Ts(events[1:] + 0.3)}))
    got = pach.event_triggered_analysis_multiple_feature_event(
        pfd, ped, n_shuffle=3, minmax=2, test_win=1, ylabel_d={"a": "A"})
    want = jach.event_triggered_analysis_multiple_feature_event(
        jfd, jed, n_shuffle=3, minmax=2, test_win=1, ylabel_d={"a": "A"})
    assert set(got) == set(want) == {("a", "e1"), ("a", "e3"), ("b", "e1"),
                                     ("b", "e3")}
    for k in want:
        _event_result(got[k], want[k])


def _peri(rng, n=30, m=20):
    up = np.linspace(0, 1, m) + rng.normal(0, 0.05, (n // 2, m))
    down = np.linspace(1, 0, m) + rng.normal(0, 0.05, (n - n // 2, m))
    return np.vstack([up, down]), np.linspace(-2, 2, m)


@pytest.mark.parametrize("do_zscore", [False, True])
def test_peri_event_clustering_matches_jax(do_zscore):
    rng = np.random.default_rng(0)
    vals, cols = _peri(rng)
    frame = pd.DataFrame(vals, columns=cols)
    table = ResultTable({c: vals[:, j] for j, c in enumerate(cols)})
    rtol = SUM_ORDER_RTOL
    for n_cluster in (2, 3):
        want = jach.cluster_peri_event(vals, n_cluster, do_zscore=do_zscore)
        got = pach.cluster_peri_event(torch.as_tensor(vals), n_cluster,
                                      do_zscore=do_zscore)
        same(got, want, rtol)
        want = jach.manual_cluster_peri_event(frame, n_cluster=n_cluster,
                                              do_zscore=do_zscore)
        for inp in (frame, table):
            same(pach.manual_cluster_peri_event(inp, n_cluster=n_cluster,
                                                do_zscore=do_zscore),
                 want, rtol)
    want = jach.manual_cluster_peri_event(frame, time_window=(0, 1),
                                          bin=[-1.0, 0.4, 0.6, 2.0],
                                          do_zscore=do_zscore)
    same(pach.manual_cluster_peri_event(table, time_window=(0, 1),
                                        bin=[-1.0, 0.4, 0.6, 2.0],
                                        do_zscore=do_zscore), want, rtol)
    # duplicate quantile edges raise in both
    flat = np.ones((6, 4))
    with pytest.raises(ValueError, match="Bin edges must be unique"):
        jach.manual_cluster_peri_event(pd.DataFrame(flat, columns=[-1, -.5,
                                                                   .5, 1]))
    with pytest.raises(ValueError, match="Bin edges must be unique"):
        pach.manual_cluster_peri_event(ResultTable(
            {c: flat[:, j] for j, c in enumerate([-1, -.5, .5, 1])}))


def test_sleep_states_and_pre_post_match_jax():
    t = np.arange(100) * 1.0
    state = np.zeros(100)
    state[20:40] = 2
    state[60:70] = 4
    state[90:] = 2
    (ps, pev), (js, jev) = both(lambda nap: (
        nap.Tsd(d=state, t=t),
        {"ev": nap.Ts(np.array([25.0, 65.0, 90.0, 95.0])),
         "ev2": nap.Ts(np.array([1.0, 30.0]))}))
    for labels in (None, {"Awake": 0, "NREM": 2}):
        ip = pach.turn_sleep_state_tsd_to_interval(ps, labels)
        ij = jach.turn_sleep_state_tsd_to_interval(js, labels)
        same(ip, ij)
        same(pach.segregate_event_ts_by_sleep_state(pev, ip),
             jach.segregate_event_ts_by_sleep_state(jev, ij))
    rng = np.random.default_rng(0)
    cols = np.linspace(-2, 2, 21)
    df = pd.DataFrame(np.where(cols[None, :] > 0, 1.0, 0.0)
                      + rng.normal(0, 0.2, (10, 21)), columns=cols)
    df_sh = pd.DataFrame(rng.normal(0, 0.1, (50, 21)), columns=cols)
    tab = ResultTable({c: df[c].to_numpy() for c in cols})
    tab_sh = ResultTable({c: df_sh[c].to_numpy() for c in cols})
    for kw in ({}, dict(center=0.5), dict(test_win=1.0)):
        want = jach.get_post_pre_diff(df, **kw)
        for inp in (df, tab):
            same(pach.get_post_pre_diff(inp, **kw), want, SUM_ORDER_RTOL)
        same(pach.test_pre_post_against_shuffle(tab, tab_sh, **kw),
             jach.test_pre_post_against_shuffle(df, df_sh, **kw),
             SUM_ORDER_RTOL)
    one = pd.DataFrame(np.ones((1, 21)), columns=cols)
    same(pach.get_post_pre_diff(ResultTable({c: np.ones(1) for c in cols})),
         jach.get_post_pre_diff(one))


def _prep_res(nap, s, post_latent, post_dyn, t_l, with_ripple=True):
    spikes = nap.TsdFrame(d=s["spikes"][:len(t_l)], t=t_l)
    res = {"spike_mat_sub": spikes,
           "fluo_data": nap.TsdFrame(d=s["ach"][:, None], t=s["t"],
                                     columns=["ACh"]),
           "sleep_state_index": nap.Tsd(d=s["sleep_state_index"], t=s["t"]),
           "is_stim": nap.Tsd(d=s["is_stim"], t=s["t"]),
           "posterior_latent_marg": nap.TsdFrame(d=post_latent, t=t_l),
           "posterior_dynamics_marg": nap.TsdFrame(d=post_dyn, t=t_l),
           "t_l": t_l}
    if with_ripple:
        starts = t_l[::97][1:-1]
        res["is_ripple"] = nap.IntervalSet(starts, starts + 0.5)
    return res


@pytest.fixture(scope="module")
def ach_small():
    """A small ``ach_session`` (0.1 s bins) and posteriors made from its
    planted path, in both packages' containers."""
    s = testing.ach_session(n_neuron=12, n_latent_bin=16, T=3000, dt=0.1,
                            p_leave_jump=0.2, p_enter_jump=0.3, seed=1)
    rng = np.random.default_rng(1)
    T, L = len(s["t"]), 16
    post = rng.dirichlet(np.full(L, 0.3), T)
    post[np.arange(T), s["latent"]] += 2.0
    post /= post.sum(axis=1, keepdims=True)
    p_jump = np.clip(0.05 + 0.9 * s["dynamics"] + rng.normal(0, 0.02, T),
                     0, 1)
    dyn = np.column_stack([1 - p_jump, p_jump])
    return s, both(lambda nap: _prep_res(nap, s, post, dyn, s["t"]))


def test_feature_prep_mean_features_and_distances_match_jax(ach_small):
    s, (pp, jp) = ach_small
    feats = ("ach", "pop_fr", "consec_pv_dist", "p_continuous", "p_jump",
             "pv", "p_latent")
    ma = np.zeros(16, bool)
    ma[3:9] = True
    for mask_d in (None, {"p_latent": (slice(None), ma)}):
        fp = pach.prep_feature_d(pp, feature_to_include=feats, mask_d=mask_d)
        fj = jach.prep_feature_d(jp, feature_to_include=feats, mask_d=mask_d)
        same(fp, fj)
    fp = pach.prep_feature_d(pp, feature_to_include=("pv", "p_latent"))
    fj = jach.prep_feature_d(jp, feature_to_include=("pv", "p_latent"))
    onsets = s["onset_t"]
    ip, ij = both(lambda nap: {"on": nap.IntervalSet(onsets, onsets + 2.0),
                               "rip": nap.Ts(onsets[:4] + 0.5)})
    mp = pach.get_mean_feature_in_interval(fp, {"on": ip["on"]})
    mj = jach.get_mean_feature_in_interval(fj, {"on": ij["on"]})
    same(mp, mj)
    same(pach.get_mean_feature_in_interval(fp, {"rip": ip["rip"]}),
         jach.get_mean_feature_in_interval(fj, {"rip": ij["rip"]}))
    for metric in (None, {"pv": "cosine"}):
        same(pach.get_distance_matrix(mp, metric),
             jach.get_distance_matrix(mj, metric))
    label_p, label_j = both(lambda nap: nap.IntervalSet(
        np.array([0.0, 120.0]), np.array([100.0, 280.0])))
    ach_p, ach_j = both(lambda nap: nap.Ts(onsets))
    aint_p, aint_j = both(lambda nap: nap.IntervalSet(onsets, onsets + 1.5))
    for kw in (dict(n_shuffles=20), dict(n_shuffles=10,
                                         label_distance_threshold=0.5,
                                         interval_key_l=("ACh_onset",))):
        np.random.seed(0)
        got = pach.feature_distance_vs_label_distance_analysis(
            pp, label_p, ach_onset=ach_p, **kw)
        np.random.seed(0)
        want = jach.feature_distance_vs_label_distance_analysis(
            jp, label_j, ach_onset=ach_j, **kw)
        same(got, want)
    got = pach.feature_distance_vs_label_distance_analysis(
        pp, label_p, ach_intv=aint_p, n_shuffles=5,
        interval_key_l=("ACh_onset",))
    want = jach.feature_distance_vs_label_distance_analysis(
        jp, label_j, ach_intv=aint_j, n_shuffles=5,
        interval_key_l=("ACh_onset",))
    same(got, want)


ETA_KW = {"n_shuffle": 8, "minmax": 4, "do_zscore": False, "test_win": 2,
          "do_plot": False}


def test_main_and_session_aggregation_match_jax(ach_small, tmp_path):
    s, (pp, jp) = ach_small
    ramp = {"height": 0.05, "detrend_cutoff": None, "smooth_win": 1,
            "finite_diff_window_s": 1}
    np.random.seed(11)
    got = pach.main(prep_res=pp, ach_ramp_kwargs=ramp,
                    event_triggered_analysis_kwargs=ETA_KW,
                    res_data_save_path=str(tmp_path / "p" / "res.pkl"))
    np.random.seed(11)
    want = jach.main(prep_res=jp, ach_ramp_kwargs=ramp,
                     event_triggered_analysis_kwargs=ETA_KW)
    assert set(got) == set(want) and len(want) >= 4
    for k in want:
        _event_result(got[k], want[k])
    with open(tmp_path / "p" / "res.pkl", "rb") as f:
        assert set(pickle.load(f)) == set(want)
    # no ACh: the stim onsets alone
    pp2 = {k: v for k, v in pp.items() if k != "fluo_data"}
    jp2 = {k: v for k, v in jp.items() if k != "fluo_data"}
    np.random.seed(2)
    got2 = pach.main(prep_res=pp2, event_triggered_analysis_kwargs=ETA_KW)
    np.random.seed(2)
    want2 = jach.main(prep_res=jp2, event_triggered_analysis_kwargs=ETA_KW)
    assert set(got2) == set(want2)
    for k in want2:
        _event_result(got2[k], want2[k])
    # across sessions: the same session twice and a shifted copy
    sess_p = [got, {k: v for k, v in list(got.items())[:2]}]
    sess_j = [want, {k: v for k, v in list(want.items())[:2]}]
    agg_p = pach.gather_feature_shuffle_across_sessions(
        sess_p, prep_fig_save_dir=str(tmp_path / "p"))
    agg_j = jach.gather_feature_shuffle_across_sessions(
        sess_j, prep_fig_save_dir=str(tmp_path / "j"))
    for key in ("all_feature_allsess", "all_shuffle_allsess", "to_shift_d"):
        same(agg_p[key], agg_j[key], SUM_ORDER_RTOL)
    tp, tj = agg_p["test_res_d"], agg_j["test_res_d"]
    assert tp.columns == list(tj.columns)
    assert len(tp.index) == tj.index.nlevels
    for j, level in enumerate(tp.index):
        assert list(level) == list(tj.index.get_level_values(j))
    for col in ("diff", "p", "effect_size"):
        np.testing.assert_allclose(tp[col], tj[col].to_numpy(dtype=float),
                                   rtol=SUM_ORDER_RTOL, atol=0)
    for g, w in zip(tp["diff_shuffle"], tj["diff_shuffle"]):
        # an array in the port's cell, a Series in the JAX frame's
        np.testing.assert_allclose(g, w.to_numpy(), rtol=SUM_ORDER_RTOL,
                                   atol=0)
    csv_p = pd.read_csv(tmp_path / "p" / "peri_event_session_agg_test_res.csv")
    csv_j = pd.read_csv(tmp_path / "j" / "peri_event_session_agg_test_res.csv")
    assert list(csv_p.columns) == list(csv_j.columns)
    for col in ("diff", "p", "effect_size"):
        np.testing.assert_allclose(csv_p[col], csv_j[col],
                                   rtol=SUM_ORDER_RTOL, atol=0)
    for col in csv_j.columns[:2]:
        assert list(csv_p[col]) == list(csv_j[col])
    # the posterior-weighted ACh per dynamics state
    got_t = pach.ach_vs_dynamics_tuning_all_sessions([pp, pp], do_plot=False)
    want_t = jach.ach_vs_dynamics_tuning_all_sessions([jp, jp], do_plot=False)
    same(got_t, want_t)


def test_ach_plots_match_jax(ach_small, steps, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t, events, feat = steps
    (pf, pe), (jf, je) = both(lambda nap: (nap.Tsd(d=feat, t=t),
                                           nap.Ts(events)))
    np.random.seed(5)
    _, _, ax_p = pach.event_triggered_analysis(pf, pe, n_shuffle=3,
                                               do_plot=True, ylabel="f",
                                               title="e", ylim=(-1, 2))
    np.random.seed(5)
    _, _, ax_j = jach.event_triggered_analysis(jf, je, n_shuffle=3,
                                               do_plot=True, ylabel="f",
                                               title="e", ylim=(-1, 2))
    assert [ln.get_xydata().tolist() for ln in ax_p.lines] == \
        [ln.get_xydata().tolist() for ln in ax_j.lines]
    assert ax_p.get_title() == ax_j.get_title() and \
        ax_p.get_ylim() == ax_j.get_ylim()
    _, (pp, jp) = ach_small
    df_p, _, ax_p = pach.ach_vs_dynamics_tuning_all_sessions(
        [pp, pp], fig_save_dir=str(tmp_path / "p"))
    df_j, _, ax_j = jach.ach_vs_dynamics_tuning_all_sessions(
        [jp, jp], fig_save_dir=str(tmp_path / "j"))
    same(df_p, df_j)
    assert [ln.get_xydata().tolist() for ln in ax_p.lines] == \
        [ln.get_xydata().tolist() for ln in ax_j.lines]
    assert (tmp_path / "p" / "ACh_tuning.png").exists()
    rng = np.random.default_rng(0)
    vals, cols = _peri(rng)
    out_p = pach.manual_cluster_peri_event(torch.as_tensor(vals),
                                           do_plot=True)
    out_j = jach.manual_cluster_peri_event(vals, do_plot=True)
    np.testing.assert_allclose(
        np.concatenate([ln.get_ydata() for ln in out_p[2].lines]),
        np.concatenate([ln.get_ydata() for ln in out_j[2].lines]),
        rtol=SUM_ORDER_RTOL)
    plt.close("all")


def test_cluster_timing_regression_matches_jax():
    rng = np.random.default_rng(0)
    starts = np.arange(5) * 100.0
    t, labels = [], []
    for i in range(5):
        t.append(np.sort(rng.uniform(i * 100, i * 100 + 80, 8)))
        labels.append(np.full(8, i % 2))
    t, labels = np.concatenate(t), np.concatenate(labels)
    (pn, pe), (jn, je) = both(lambda nap: (nap.IntervalSet(starts,
                                                           starts + 80.0),
                                           nap.Ts(t)))
    for kw in (dict(n_shuffle=6, rng=0), dict(n_shuffle=0,
                                              include_previous_label=False,
                                              regularization_method="l2")):
        # saga draws from numpy's global state
        np.random.seed(0)
        got = pach.latent_cluster_vs_timing_regression(
            torch.as_tensor(labels), pe, pn, **kw)
        np.random.seed(0)
        want = jach.latent_cluster_vs_timing_regression(labels, je, jn, **kw)
        same(got, want)


def test_decode_res_from_em_res_and_loading_match_jax(ach_small, tmp_path):
    dill = pytest.importorskip("dill")
    rng = np.random.default_rng(4)
    T, L = 50, 6
    log_post = np.log(rng.dirichlet(np.ones(2 * L), T).reshape(T, 2, L)
                      ).astype(np.float32)
    log_lat = np.log(rng.dirichlet(np.ones(L), T)).astype(np.float32)
    t_l = np.arange(T) * 0.1
    for has_dyn, lp in ((True, log_post), (False, log_lat)):
        for tt in (None, t_l):
            same(pach.get_decode_res_l_from_em_res_l(
                [{"log_posterior_final": torch.as_tensor(lp)}], tt, has_dyn),
                jach.get_decode_res_l_from_em_res_l(
                    [{"log_posterior_final": lp}], tt, has_dyn))
    data_path, fit_path = tmp_path / "data.pkl", tmp_path / "fit.pkl"
    with open(data_path, "wb") as f:
        dill.dump({"t_l": t_l, "extra": np.arange(3)}, f)
    with open(fit_path, "wb") as f:
        dill.dump({"em_res_l": [{"log_posterior_final": log_post},
                                {"log_posterior_final": log_post[::-1]}],
                   "metric_eval_result": {"metric_overall": {
                       "best_index": 1}},
                   "model_fit_l": ["m0", "m1"]}, f)
    same(pach.load_data_and_fit_res(data_path, fit_path),
         jach.load_data_and_fit_res(data_path, fit_path))


# ---------------------------------------------------------------------------
# the slice: session -> fit and decode -> workflows, through both packages
# ---------------------------------------------------------------------------

N_S, L_S, T_S = 12, 16, 2000
MODEL_KW = dict(n_latent_bin=L_S, movement_variance=1.0,
                tuning_lengthscale=1.0)
FIT_KW = dict(n_iter=3, m_step_maxiter=20, verboase=False, fused=False)


def _fit_both(y):
    """The JAX and the port fit from the same weights and initial
    posterior, and each fitted model's decode."""
    jm = jpmg.PoissonGPLVMJump1D(N_S, inference_engine="prob", **MODEL_KW)
    lpi = np.asarray(jm.init_latent_posterior(T_S, jr.PRNGKey(3))[0])
    state = convert.state_from_model(jm)
    pm = pmt.PoissonGPLVMJump1D(N_S, inference_engine="cuda_parallel",
                                device="cpu", **MODEL_KW)
    convert.load_jax_state(pm, state["params"], state["tuning_basis"])
    em_j = jm.fit_em(y, log_posterior_init=lpi, **FIT_KW)
    em_p = pm.fit_em(y, log_posterior_init=lpi, **FIT_KW)
    np.testing.assert_allclose(
        [float(v) for v in em_p["log_marginal_l"]],
        [float(v) for v in em_j["log_marginal_l"]], rtol=TOL_LML)
    assert np.abs(em_p["posterior"].numpy()
                  - np.asarray(em_j["posterior"])).max() <= TOL_FIT_POST
    return jm, pm


def test_tmaze_slice_fit_decode_and_workflows_match_jax():
    s = testing.tmaze_session(N_S, L_S, T_S, n_trials=2, seed=0)
    y = s["spikes"]
    jm, pm = _fit_both(y)
    dec_j = jm.decode_latent(y)
    dec_p = pm.decode_latent(torch.as_tensor(y))
    # the port's own fit, decoded, against the JAX decode of the JAX fit
    for key in ("posterior_latent_marg", "posterior_dynamics_marg"):
        assert np.abs(dec_p[key].numpy() - np.asarray(dec_j[key])).max() \
            <= TOL_FIT_POST
    map_p = dec_p["posterior_latent_marg"].argmax(dim=1)
    map_j = np.asarray(dec_j["posterior_latent_marg"]).argmax(axis=1)
    assert np.array_equal(map_p.numpy(), map_j)
    jump_p = dec_p["posterior_dynamics_marg"][:, 1]
    jump_j = np.asarray(dec_j["posterior_dynamics_marg"])[:, 1]
    assert np.array_equal((jump_p > 0.5).numpy(), jump_j > 0.5)

    t = s["t"]
    cols = ["x", "y", "lin", "speed_gauss"]
    beh = np.column_stack([s["x"], s["y"], s["lin"], s["speed"]])
    trials_p = ResultTable(s["trials"])
    trials_j = pd.DataFrame(s["trials"])
    (mp, bp, sp, jbp), (mj, bj, sj, jbj) = (
        (nap.Tsd(d=np.asarray(m, dtype=float), t=t),
         nap.TsdFrame(d=beh, t=t, columns=cols),
         nap.TsdFrame(d=y, t=t),
         nap.Tsd(d=(np.asarray(jp_) > 0.5).astype(float), t=t))
        for nap, m, jp_ in ((pts, map_p.numpy(), jump_p.numpy()),
                            (jts, map_j, jump_j)))
    occ_p = ptmz.get_latent_occurance_index_per_speed_level(
        map_p, bp["speed_gauss"], [5])
    occ_j = jtmz.get_latent_occurance_index_per_speed_level(
        mj, bj["speed_gauss"], [5])
    same(occ_p, occ_j)
    rng_p = ptmz.get_latent_in_position_range(occ_p, bp["lin"], trials_p)
    rng_j = jtmz.get_latent_in_position_range(occ_j, bj["lin"], trials_j)
    same(rng_p, rng_j)
    assert ptmz.get_single_reward_latent(rng_p, 0.5, 5) == \
        jtmz.get_single_reward_latent(rng_j, 0.5, 5)
    same(ptmz.find_all_index_per_latent_pair([(3, 5)], mp),
         jtmz.find_all_index_per_latent_pair([(3, 5)], mj))
    same(ptmz.find_transition_times(bp["lin"], trials_p, lin_pt=108.5),
         jtmz.find_transition_times(bj["lin"], trials_j, lin_pt=108.5))
    got = ptmz.analyze_peri_transition_jump_consensus(
        bp["lin"], trials_p, jbp, lin_pt=108.5, n_shuffle=10, rng=0)
    want = jtmz.analyze_peri_transition_jump_consensus(
        bj["lin"], trials_j, jbj, lin_pt=108.5, n_shuffle=10, rng=0)
    same(got, want)
    # the fitted tuning: the JAX fit's, as a tensor for the port
    tun = np.asarray(jm.tuning)
    seq = (int(map_j[s["dynamics"] == 1][0]), int(map_j[0]))
    same(ptmz.latent_jump_triggered_analysis(
        mp, bp, sp, torch.as_tensor(tun), seq=seq, peri_event_win=1),
        jtmz.latent_jump_triggered_analysis(mj, bj, sj, jm.tuning, seq=seq,
                                            peri_event_win=1))
    same(ptmz.get_null_contrastive_projection(
        sp, torch.as_tensor(tun), mp,
        torch.as_tensor(jump_j[:, None]), n_shuffle=20,
        peri_event_win=0.25, rng=1),
        jtmz.get_null_contrastive_projection(
            sj, jm.tuning, mj, jump_j[:, None], n_shuffle=20,
            peri_event_win=0.25, rng=1))


def test_ach_slice_selection_and_main_match_jax(monkeypatch):
    s = testing.ach_session(
        N_S, L_S, T_S, dt=0.1, onset_every_s=(6.0, 10.0), p_leave_jump=0.2,
        p_enter_jump=0.3, state_blocks=(("Awake", 0.3), ("NREM", 0.6),
                                        ("REM", 0.8), ("NREM", 1.0)),
        seed=2)
    y = s["spikes"]
    n_train = int(T_S * 0.8)
    config = dict(MODEL_KW)
    key = jr.PRNGKey(5)
    lpi = [np.asarray(_init_posterior_random(n_train, L_S, k, 0.1)[0])
           for k in jr.split(key, 2)]

    def params(nb, n, rng_init_int=123, w_init_variance=1.0,
               w_init_mean=0.0):
        return torch.as_tensor(np.array(
            jax.random.normal(jr.PRNGKey(rng_init_int), (nb, n)))
            * np.float32(np.sqrt(w_init_variance)) + w_init_mean)

    monkeypatch.setattr(sweep, "ctor_params", params)
    fit_kw = dict(selection.default_fit_kwargs, n_iter=3, verboase=False,
                  m_step_maxiter=20)
    models_j, ems_j, models_p, ems_p = [], [], [], []
    for init in lpi:
        mj, ej = jsel.fit_model_one_config(
            config, y[:n_train], fit_kwargs=dict(
                fit_kw, log_posterior_init=init, posterior_init_kwargs=None))
        mp, ep = selection.fit_model_one_config(
            config, torch.as_tensor(y[:n_train]), fit_kwargs=dict(
                fit_kw, log_posterior_init=init, posterior_init_kwargs=None),
            device="cpu")
        models_j += mj
        ems_j += ej
        models_p += mp
        ems_p += ep
    for ep, ej in zip(ems_p, ems_j):
        np.testing.assert_allclose(
            [float(v) for v in ep["log_marginal_l"]],
            [float(v) for v in ej["log_marginal_l"]], rtol=TOL_LML)
        assert np.abs(ep["log_posterior_final"].exp().numpy() - np.exp(
            np.asarray(ej["log_posterior_final"]))).max() <= TOL_FIT_POST
    metric_kw = dict(metric_type_l=("log_marginal_test",))
    ev_j = jsel.evaluate_model_one_config(models_j, y[n_train:], **metric_kw)
    ev_p = selection.evaluate_model_one_config(
        models_p, torch.as_tensor(y[n_train:]), **metric_kw)
    best = ev_j["metric_overall"]["best_index"]
    assert ev_p["metric_overall"]["best_index"] == best

    t_l = s["t"][:n_train]
    dec_p = pach.get_decode_res_l_from_em_res_l(ems_p, t_l)[best]
    dec_j = jach.get_decode_res_l_from_em_res_l(ems_j, t_l)[best]
    for key in dec_j:
        assert np.abs(dec_p[key].d - dec_j[key].d).max() <= TOL_FIT_POST
    # the workflows on the JAX fit's posterior, a tensor for the port
    ems_jt = [{"log_posterior_final": torch.as_tensor(
        np.asarray(e["log_posterior_final"]))} for e in ems_j]
    dec_p = pach.get_decode_res_l_from_em_res_l(ems_jt, t_l)[best]
    same(dec_p, dec_j)
    prep_p, prep_j = (
        {**_prep_res(nap, s, dec["posterior_latent_marg"].d,
                     dec["posterior_dynamics_marg"].d, t_l,
                     with_ripple=False), "model_fit": m}
        for nap, dec, m in ((pts, dec_p, models_p[best]),
                            (jts, dec_j, models_j[best])))
    np.random.seed(9)
    got = pach.main(prep_res=prep_p, event_triggered_analysis_kwargs=ETA_KW)
    np.random.seed(9)
    want = jach.main(prep_res=prep_j, event_triggered_analysis_kwargs=ETA_KW)
    assert set(got) == set(want) and len(want) >= 4
    for k in want:
        _event_result(got[k], want[k])
    label_p, label_j = both(lambda nap: nap.IntervalSet(
        np.array([0.0]), np.array([t_l[-1] / 2])))
    on_p, on_j = both(lambda nap: nap.Ts(s["onset_t"]))
    same(pach.feature_distance_vs_label_distance_analysis(
        prep_p, label_p, ach_onset=on_p, n_shuffles=5,
        interval_key_l=("ACh_onset",)),
        jach.feature_distance_vs_label_distance_analysis(
            prep_j, label_j, ach_onset=on_j, n_shuffles=5,
            interval_key_l=("ACh_onset",)))


def test_readme_postfit_quickstart_runs_on_the_cpu():
    import pathlib
    import re

    text = (pathlib.Path(__file__).resolve().parents[1]
            / "README.md").read_text()
    blocks = re.findall(r"```python\n(.*?)```", text, flags=re.S)
    block = [b for b in blocks if "# post-fit quickstart" in b]
    assert len(block) == 1 and 'device = "cuda"' in block[0]
    scope = {}
    exec(compile(block[0].replace('device = "cuda"', 'device = "cpu"'),
                 "README.md", "exec"), scope)
    res = scope["res"]
    assert len(res["transition_ts"].t) > 0
    assert res["consensus_fractions"][None].shape == (10,)
    assert np.isfinite(res["shuffle_fractions"].to_numpy()).all()
