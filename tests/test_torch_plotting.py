"""The plotting layer, the port against the JAX package:
``poor_man_gplvm_tpu_torch.plotting`` (and ``plot_helper``) against
``poor_man_gplvm_tpu/plotting`` on the Agg backend.

Each case of ``tests/test_plotting.py`` is drawn by both packages from the
same inputs (the port's from its own time-series containers, and from
torch tensors where a function takes data), and the drawn artists are
compared exactly: every axes' line data, collections (count and offsets),
patches (count and extents), images (arrays and extents), axis limits,
tick labels and title; the files ``save_fig``, ``save_given_name`` and
``plot_multipage_wrapper`` write (names and count).  Plotly is not
installed here: both packages raise the same ``ImportError``, and the
private plotly helpers are compared directly.  The figures of the
``backup`` module that read DataFrames are drawn from a DataFrame and from
a ``ResultTable``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from poor_man_gplvm_tpu import plotting as jplot  # noqa: E402
from poor_man_gplvm_tpu.plotting import plotly_helpers as jplotly  # noqa: E402
from poor_man_gplvm_tpu.utils import timeseries as jts  # noqa: E402
from poor_man_gplvm_tpu_torch import plot_helper  # noqa: E402
from poor_man_gplvm_tpu_torch import plotting as pplot  # noqa: E402
from poor_man_gplvm_tpu_torch.plotting import plotly_helpers as pplotly  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import timeseries as pts  # noqa: E402
from poor_man_gplvm_tpu_torch.utils.table import ResultTable  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def _axes_of(obj):
    if isinstance(obj, matplotlib.figure.Figure):
        return obj.axes
    if isinstance(obj, np.ndarray):
        return list(obj.ravel())
    if isinstance(obj, (list, tuple)):
        return [a for o in obj for a in _axes_of(o)]
    return [obj]


def _drawn(ax):
    """What an axes shows, as plain data."""
    return {
        "lines": [ln.get_xydata().tolist() for ln in ax.lines],
        "line_styles": [(ln.get_color(), ln.get_linestyle(), ln.get_marker())
                        for ln in ax.lines],
        "collections": [(type(c).__name__,
                         np.asarray(c.get_offsets()).tolist(),
                         [p.vertices.tolist() for p in c.get_paths()])
                        for c in ax.collections],
        "patches": [(type(p).__name__, p.get_extents().bounds)
                    for p in ax.patches],
        "images": [(np.asarray(im.get_array()).tolist(),
                    list(im.get_extent()), im.get_clim())
                   for im in ax.images],
        "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
        "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
        "yticklabels": [t.get_text() for t in ax.get_yticklabels()],
        "xticks": list(ax.get_xticks()), "yticks": list(ax.get_yticks()),
        "title": ax.get_title(), "xlabel": ax.get_xlabel(),
        "ylabel": ax.get_ylabel(),
    }


def assert_same_drawing(got, want):
    ga, wa = _axes_of(got), _axes_of(want)
    assert len(ga) == len(wa)
    for a, b in zip(ga, wa):
        da, db = _drawn(a), _drawn(b)
        for key in db:
            assert da[key] == db[key], key


def _both(make):
    return make(pts), make(jts)


def test_save_fig_and_save_given_name(tmp_path):
    for pkg, sub in ((pplot, "p"), (jplot, "j")):
        fig, ax = plt.subplots()
        ax.plot([0, 1], [0, 1])
        paths = pkg.save_fig(fig, "t", fig_dir=str(tmp_path / sub),
                             fig_format=["png", "svg"], do_close=True)
        assert [p.rsplit("/", 1)[1] for p in paths] == ["t.png", "t.svg"]
        fig, ax = plt.subplots()
        (tmp_path / f"g{sub}").mkdir()
        pkg.save_given_name(fig, "a.b", figdir=str(tmp_path / f"g{sub}"))
    for sub in ("p", "j"):
        assert sorted(f.name for f in (tmp_path / sub).iterdir()) == [
            "t.png", "t.svg"]
        assert sorted(f.name for f in (tmp_path / f"g{sub}").iterdir()) == [
            "adotb.png", "adotb.svg"]


def test_mean_error_and_shuffle_dist():
    rng = np.random.default_rng(0)
    data, shuffle = rng.normal(size=(20, 30)), rng.normal(size=200)
    for kw in ({}, dict(error_type="sem", color="C2")):
        assert_same_drawing(
            pplot.plot_mean_error_plot(torch.as_tensor(data), **kw)[1],
            jplot.plot_mean_error_plot(data, **kw)[1])
    for kw in ({}, dict(plot_ci_low=True, bins=7)):
        assert_same_drawing(
            pplot.plot_shuffle_data_dist_with_thresh(
                torch.as_tensor(shuffle), 2.5, **kw)[1],
            jplot.plot_shuffle_data_dist_with_thresh(shuffle, 2.5, **kw)[1])


@pytest.mark.parametrize("n", [1, 5, 7])
def test_subplots_wrapper(n):
    fig_p, axs_p = pplot.subplots_wrapper(n)
    fig_j, axs_j = jplot.subplots_wrapper(n)
    assert axs_p.shape == axs_j.shape
    assert tuple(fig_p.get_size_inches()) == tuple(fig_j.get_size_inches())


def test_pynapple_dashboard():
    t = np.arange(100) * 0.1
    rng = np.random.default_rng(0)
    heat = rng.random((100, 8))
    trace = np.sin(t)
    trace[5] = 40.0  # beyond 5 sigma: left out of the y-limits
    raster = (t[::5], np.arange(20) % 4, np.arange(20))

    def data(nap):
        return {"trace": nap.Tsd(d=trace, t=t),
                "heat": nap.TsdFrame(d=heat, t=t),
                "raster": raster}

    dp, dj = _both(data)
    for kw in (dict(add_scatter_to_heatmap=True), dict(
            plot_title=True, height_ratios=[1, 2, 1],
            add_scatter_to_heatmap={"heat": False})):
        fig_p, axs_p, common_p = pplot.plot_pynapple_data_mpl(dp, **kw)
        fig_j, axs_j, common_j = jplot.plot_pynapple_data_mpl(dj, **kw)
        assert_same_drawing(axs_p, axs_j)
        assert np.array_equal(common_p.start, common_j.start)
        assert np.array_equal(common_p.end, common_j.end)
    # the raster given as tensors
    dp["raster"] = tuple(torch.as_tensor(np.asarray(a)) for a in raster)
    assert_same_drawing(pplot.plot_pynapple_data_mpl(dp)[1],
                        jplot.plot_pynapple_data_mpl(dj)[1])


def test_shades_and_scalebar():
    for intervals in ("set", "pairs"):
        draws = []
        for pkg, nap in ((pplot, pts), (jplot, jts)):
            fig, ax = plt.subplots()
            ax.plot(np.arange(10))
            iv = (nap.IntervalSet(np.array([1.0, 1.0, 4.0]),
                                  np.array([3.0, 3.0, 4.5]))
                  if intervals == "set" else [(4.0, 4.5), (1.0, 3.0)])
            pkg.shade_intervals(ax, iv)
            pkg.add_vertical_shades_mpl(
                fig, [(5.0, 6.0), (7.0, 9.0)],
                ep=nap.IntervalSet(np.array([0.0]), np.array([8.0])),
                exclude=[3])
            pkg.add_vertical_shades_mpl(fig, nap.IntervalSet(
                np.array([2.0]), np.array([2.5])), mode="line",
                linestyle="--")
            pkg.add_scalebar(ax, 0.1, 0.1, 0.2, label="1 s")
            pkg.add_scalebar(ax, 0.8, 0.1, 0.3, label="5 Hz",
                             orientation="vertical")
            draws.append(ax)
        assert_same_drawing(*draws)


def test_data_shuffle_time_series_and_cdf():
    rng = np.random.default_rng(0)
    data, shuffle = rng.normal(size=21) + 3, rng.normal(size=(50, 21))
    for kw in ({}, dict(align_at="start")):
        assert_same_drawing(
            pplot.plot_data_shuffle_time_series(
                torch.as_tensor(data), torch.as_tensor(shuffle), **kw)[1],
            jplot.plot_data_shuffle_time_series(data, shuffle, **kw)[1])
    s1, s2 = rng.normal(size=100), rng.normal(size=100) + 1
    got = pplot.plot_cdf_and_ks_test(torch.as_tensor(s1), s2, title=None)
    want = jplot.plot_cdf_and_ks_test(s1, s2, title=None)
    assert_same_drawing(got[1], want[1])
    assert got[2] == want[2]


def test_brain_state_and_prepost():
    def intervals(nap):
        return {"REM": nap.IntervalSet(np.array([0.0, 5.0]),
                                       np.array([1.0, 6.0])),
                "NREM": nap.IntervalSet(np.array([2.0]), np.array([4.0])),
                "other": np.array([[6.5, 7.0]])}

    ip, ij = _both(intervals)
    assert_same_drawing(pplot.plot_brain_state_intervals(ip)[1],
                        jplot.plot_brain_state_intervals(ij)[1])
    t = np.arange(100) * 0.1
    (tp, pre_p, post_p), (tj, pre_j, post_j) = _both(lambda nap: (
        nap.Tsd(d=np.sin(t), t=t),
        nap.IntervalSet(np.array([0.0]), np.array([4.0])),
        nap.IntervalSet(np.array([5.0]), np.array([9.9]))))
    assert_same_drawing(
        pplot.pre_post_1d_timeseries_plot(tp, pre_p, post_p)[1],
        jplot.pre_post_1d_timeseries_plot(tj, pre_j, post_j)[1])


def test_tick_helpers():
    for kw in ({}, dict(do_int=True, apply_to="both"),
               dict(ylim=(-2.0, 3.5), apply_to="y")):
        draws = []
        for pkg in (pplot, jplot):
            fig, ax = plt.subplots()
            ax.plot([0, 10], [-3.7, 7.2])
            pkg.set_two_ticks(ax, **kw)
            draws.append(_drawn(ax))
            pkg.set_symmetric_ticks(ax, **kw)
            draws.append(_drawn(ax))
        assert draws[:2] == draws[2:]


def test_maze_paired_and_trajectories():
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"x": rng.random(100), "y": rng.random(100)})
    for kw in ({}, dict(mode="scatter", s=3), dict(c="k", ds=3)):
        assert_same_drawing(pplot.plot_maze_background(df, **kw)[1],
                            jplot.plot_maze_background(df, **kw)[1])
    # the port's own TsdFrame of positions
    pos_p = pts.TsdFrame(d=df.to_numpy(), t=np.arange(100.0),
                         columns=["x", "y"])
    assert_same_drawing(pplot.plot_maze_background(pos_p)[1],
                        jplot.plot_maze_background(df)[1])
    paired = rng.random((10, 5))
    assert_same_drawing(
        pplot.plot_paired_line_median(torch.as_tensor(paired))[1],
        jplot.plot_paired_line_median(paired)[1])
    xs, ys = rng.random((3, 20)), rng.random((3, 20))
    for kw in ({}, dict(midpoint_only=True, ds=2)):
        assert_same_drawing(
            pplot.plot_trajectories_on_maze_mark_events(
                None, torch.as_tensor(xs), ys, **kw)[1],
            jplot.plot_trajectories_on_maze_mark_events(None, xs, ys,
                                                        **kw)[1])
    assert pplot.median_plot(ci=1)["ci"] == jplot.median_plot(ci=1)["ci"]


def test_plotly_is_gated_alike():
    for fn in ("plot_pynapple_data_plotly", "save_fig_plotly",
               "add_vertical_shades", "set_plotly_fonts"):
        errors = []
        for pkg in (pplot, jplot):
            with pytest.raises(ImportError, match="plotly") as e:
                args = ({},) if fn == "plot_pynapple_data_plotly" else (
                    None, [(0, 1)]) if fn == "add_vertical_shades" else (
                    None, "f") if fn == "save_fig_plotly" else (None,)
                getattr(pkg, fn)(*args)
            errors.append(str(e.value).split(";")[0])
        assert errors[0] == errors[1]


def test_plotly_private_helpers():
    for base, extra in (({"marker": {"size": 3, "color": "red"},
                          "mode": "lines"}, {"marker": {"size": 7}}),
                        ({"a": 1}, None), ({"a": {"b": 1}}, {"a": 2})):
        got = pplotly._deep_update({k: (dict(v) if isinstance(v, dict)
                                        else v) for k, v in base.items()},
                                   extra)
        want = jplotly._deep_update({k: (dict(v) if isinstance(v, dict)
                                         else v) for k, v in base.items()},
                                    extra)
        assert got == want
    for value, key in (({"a": 5}, "a"), ({"a": 5}, "b"), (42, "x")):
        assert pplotly._per_key(value, key) == jplotly._per_key(value, key)
    for args in ((3, 0.0, 1.0), ([1.5, 2.5], 0, 1), (None, 0, 1),
                 (4, 2.0, 2.0), (4, np.nan, 1.0), (0, -1.0, 1.0)):
        assert pplotly._compute_tickvals(*args) == \
            jplotly._compute_tickvals(*args)
    y = np.array([0.0, 1.0, 2.0, np.nan, 10.0])
    for q, lim in (((0.1, 0.9), None), (None, (0, 5)), (None, None),
                   ((0.5, 0.5), None), (None, (1, 1))):
        assert pplotly._y_extent(y, q, lim) == jplotly._y_extent(y, q, lim)


def test_extras():
    rng = np.random.default_rng(0)
    for p in (0.0001, 0.0005, 0.001, 0.01, 0.03, 0.05, 0.2):
        assert pplot.p_to_star(p) == jplot.p_to_star(p)
        assert pplot.star_map(p) == jplot.star_map(p)
    events = [rng.uniform(0, 10, 20) for _ in range(5)]
    assert_same_drawing(pplot.plot_rasterplot(event_l=events)[1],
                        jplot.plot_rasterplot(event_l=events)[1])
    binary = rng.random((30, 4)) > 0.8
    for kw in ({}, dict(x_index=np.arange(30) * 0.1, y_index=[9, 8, 7, 6])):
        assert_same_drawing(
            pplot.plot_rasterplot(binary_mat=torch.as_tensor(binary),
                                  **kw)[1],
            jplot.plot_rasterplot(binary_mat=binary, **kw)[1])
    with pytest.raises(ValueError, match="event_l or binary_mat"):
        pplot.plot_rasterplot()
    draws = []
    for pkg in (pplot, jplot):
        fig, ax = plt.subplots()
        pkg.turn_off_spines(ax)
        draws.append([s.get_visible() for s in ax.spines.values()])
    assert draws[0] == draws[1]
    X = rng.normal(size=(10, 10))
    got, want = (pplot.diverging_heatmap(torch.as_tensor(X)),
                 jplot.diverging_heatmap(X))
    assert_same_drawing(got[1], want[1])
    assert got[2].get_clim() == want[2].get_clim()
    sample = rng.normal(size=(20, 15))
    assert_same_drawing(
        pplot.mean_bootstraperror_lineplot(torch.as_tensor(sample),
                                           n_boot=50, rng=0)[1],
        jplot.mean_bootstraperror_lineplot(sample, n_boot=50, rng=0)[1])
    traj = rng.normal(size=(20, 3))
    anis = []
    for pkg in (pplot, jplot):
        fig, ax, ani = pkg.animate_3d_scatter(traj)
        ani._init_draw()
        ani._draw_frame(4)
        anis.append((ax.get_xlim(), ax.get_ylim(), ax.get_zlim(),
                     [np.asarray(c._offsets3d).tolist()
                      for c in ax.collections]))
    assert anis[0] == anis[1]
    pts_ = rng.normal(size=(50, 8))
    got, want = plot_helper.plot_pca3d(pts_), jplot.plot_pca3d(pts_)
    assert np.array_equal(got[2], want[2])
    assert (got[1].get_xlabel(), got[1].get_zlabel()) == (
        want[1].get_xlabel(), want[1].get_zlabel())


def test_multipage_wrapper(tmp_path):
    def plot_one(x, fig=None, ax=None):
        ax.plot(x)

    data = [np.arange(5) * k for k in range(7)]
    for pkg, sub in ((pplot, "p"), (jplot, "j")):
        paths = pkg.plot_multipage_wrapper(
            plot_one, data, title_all=[f"u{k}" for k in range(7)],
            nplots_per_page=4, fig_save_dir=str(tmp_path / sub))
        assert [p.rsplit("/", 1)[1] for p in paths] == [
            "fig_temp_page0.png", "fig_temp_page1.png"]


def test_backup_helpers_from_frames_and_tables():
    rng = np.random.default_rng(1)
    lin = rng.uniform(0, 222, 60)
    speed = rng.uniform(-20, 20, 60)
    speed[3] = np.nan
    frame = pd.DataFrame({"lin": lin, "v": speed})
    table = ResultTable({"lin": lin, "v": speed})
    got = pplot.color_arms(lin)[0], pplot.marker_speed(speed)[0]
    want = jplot.color_arms(lin)[0], jplot.marker_speed(speed)[0]
    assert [list(a) for a in got] == [list(a) for a in want]
    for inp in (frame, table):
        got = pplot.prep_hue_scatter(inp)
        want = jplot.prep_hue_scatter(frame)
        assert list(got[0]) == list(want[0]) and list(got[1]) == list(
            want[1])
        assert [h.get_label() for h in got[2]] == [h.get_label()
                                                  for h in want[2]]
    wide = rng.random((12, 6))
    cols = np.linspace(0, 50, 6)
    frame = pd.DataFrame(wide, columns=cols)
    table = ResultTable({c: wide[:, j] for j, c in enumerate(cols)})
    for inp in (frame, table):
        for kw in ({}, dict(sem=False, c="C3")):
            assert_same_drawing(pplot.mean_error_plot(inp, **kw)[1],
                                jplot.mean_error_plot(frame, **kw)[1])
        for kw in ({}, dict(vmax=0.5, cbar=False)):
            assert_same_drawing(pplot.heatmap(inp, **kw)[1],
                                jplot.heatmap(frame, **kw)[1])
        assert_same_drawing(
            pplot.ratemap_one_raw(inp, trial=[2, None, 5],
                                  field_bound=(1, 3), title="u")[1],
            jplot.ratemap_one_raw(frame, trial=[2, None, 5],
                                  field_bound=(1, 3), title="u")[1])
        # seaborn's error band from the spread (its default bootstraps
        # unseeded)
        for kw in (dict(errorbar="sd"), dict(plot_type="bar",
                                             cols_reset=list("abcdef"),
                                             errorbar="sd")):
            assert_same_drawing(
                pplot.mean_across_row_vs_col_with_err(inp, **kw)[1],
                jplot.mean_across_row_vs_col_with_err(frame, **kw)[1])
        got = pplot.consecutive_wilcoxon_test(inp)
        want = jplot.consecutive_wilcoxon_test(frame)
        assert list(got) == list(want)
        for k in want:
            assert got[k].statistic == want[k].statistic
            assert got[k].pvalue == want[k].pvalue
        assert_same_drawing(
            pplot.box_strip_plot(inp, cols[0], cols[2], do_logy=True)[1],
            jplot.box_strip_plot(frame, cols[0], cols[2], do_logy=True)[1])
    days = pd.DataFrame(wide, index=pd.MultiIndex.from_arrays(
        [[0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2], np.arange(12)]))
    days_t = ResultTable({c: wide[:, c] for c in range(6)}, index=[
        np.array([0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2]), np.arange(12)])
    bounds = pd.DataFrame({"start": [1.0, 2.0, 3.0], "end": [2.0, 4.0, 5.0]},
                          index=pd.MultiIndex.from_arrays([[0, 1, 2],
                                                           [0, 0, 0]]))
    for inp in (days, days_t):
        assert_same_drawing(
            pplot.plot_day_on_heatmap(inp, vline=True)[1],
            jplot.plot_day_on_heatmap(days, vline=True)[1])
        for kw in ({}, dict(by_day=True), dict(by_previous_day=True)):
            assert_same_drawing(
                pplot.add_field_bounds(bounds, df=inp, **kw)[1],
                jplot.add_field_bounds(bounds, df=days, **kw)[1])


def test_backup_figures():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 3, 40)
    assert_same_drawing(pplot.plot_shades(labels)[1],
                        jplot.plot_shades(labels)[1])
    assert_same_drawing(pplot.plot_vlines([1.0, 5.0])[1],
                        jplot.plot_vlines([1.0, 5.0])[1])
    assert_same_drawing(pplot.plot_section_markers()[1],
                        jplot.plot_section_markers()[1])
    assert_same_drawing(pplot.plot_field_bound(2, 4)[1],
                        jplot.plot_field_bound(2, 4)[1])
    assert_same_drawing(pplot.plot_switch_trial([1, None, 3], xlim=(0, 9))[1],
                        jplot.plot_switch_trial([1, None, 3], xlim=(0, 9))[1])
    got, want = pplot.plot_colorbar(vmin=-1, vmax=2), jplot.plot_colorbar(
        vmin=-1, vmax=2)
    assert got[2].norm.vmin == want[2].norm.vmin
    vals = rng.uniform(0, 5, 20)
    for kw in ({}, dict(color_discrete=True, cmap_str="viridis")):
        assert np.array_equal(pplot.prep_color(torch.as_tensor(vals).numpy(),
                                               **kw),
                              jplot.prep_color(vals, **kw))
    got = pplot.plot_legend(["a", "b"], handle_types=["line", "patch"])
    want = jplot.plot_legend(["a", "b"], handle_types=["line", "patch"])
    assert [t.get_text() for t in got[0].legends[0].get_texts()] == \
        [t.get_text() for t in want[0].legends[0].get_texts()]
    theta = rng.uniform(0, 2 * np.pi, 50)
    assert_same_drawing(pplot.plot_angle(theta, ds_fac=5)[1],
                        jplot.plot_angle(theta, ds_fac=5)[1])
    for pkg in (pplot, jplot):
        fig, ax = plt.subplots()
        ax2 = ax.twinx()
        pkg.apply_axis_color(ax2, "C1", "right")
        assert ax2.spines["right"].get_edgecolor() == \
            matplotlib.colors.to_rgba("C1")


def test_plot_helper_shim_has_the_jax_surface():
    from poor_man_gplvm_tpu import plot_helper as jhelper

    assert sorted(pplot.__all__) == sorted(jplot.__all__)
    for name in jplot.__all__:
        assert callable(getattr(plot_helper, name)), name
    assert {n for n in dir(jhelper) if not n.startswith("_")} <= {
        n for n in dir(plot_helper) if not n.startswith("_")}
