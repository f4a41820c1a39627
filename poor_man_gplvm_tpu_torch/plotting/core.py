"""Matplotlib plotting utilities.

The port's own copy of ``poor_man_gplvm_tpu/plotting/core.py`` (the
matplotlib half of reference poor_man_gplvm/plot_helper.py; the plotly
half lives in :mod:`poor_man_gplvm_tpu_torch.plotting.plotly_helpers`).
Functions keep the JAX package's signatures and draw the same artists.
matplotlib is imported at the first call, not with the module (the card's
machine has none), and the JAX module's backend rule is applied then:
where no display is set and the backend is an X11 GUI one, ``Agg``.  The
inputs may be the port's ``Tsd``/``TsdFrame``s, pynapple's, numpy arrays
or torch tensors (on the card: copied to the host).
"""

from __future__ import annotations

import os

import numpy as np

from poor_man_gplvm_tpu_torch.utils import compat

__all__ = [
    "save_fig",
    "plot_mean_error_plot",
    "plot_shuffle_data_dist_with_thresh",
    "subplots_wrapper",
    "plot_pynapple_data_mpl",
    "shade_intervals",
    "add_vertical_shades_mpl",
    "pre_post_1d_timeseries_plot",
    "median_plot",
    "plot_paired_line_median",
    "plot_trajectories_on_maze_mark_events",
    "plot_maze_background",
    "plot_data_shuffle_time_series",
    "add_scalebar",
    "plot_brain_state_intervals",
    "plot_cdf_and_ks_test",
    "set_two_ticks",
    "set_symmetric_ticks",
]


_BACKEND_CHECKED = False


def _pyplot():
    """``matplotlib.pyplot``, imported at the call; the first call applies
    the JAX module's import-time backend rule (``Agg`` where no display
    is set and the backend is an X11 GUI one; non-GUI backends such as
    the Jupyter inline one are kept)."""
    global _BACKEND_CHECKED
    import matplotlib

    if not _BACKEND_CHECKED:
        backend = matplotlib.get_backend().lower()
        if (
            os.environ.get("DISPLAY", "") == ""
            and not backend.startswith("module://")
            and backend not in ("agg", "pdf", "svg", "ps", "cairo",
                                "template")
        ):
            matplotlib.use("Agg")
        _BACKEND_CHECKED = True
    import matplotlib.pyplot as plt

    return plt


def _np(x, dtype=None):
    """``x`` as a numpy array (a tensor copied to the host)."""
    out = compat.to_numpy(x)
    return out if dtype is None else np.asarray(out, dtype=dtype)


def save_fig(fig, fig_name, fig_dir="./figs", fig_format=("png", "svg"),
             dpi=300, do_close=False, bbox_inches=None):
    """Save a matplotlib figure in each requested format
    (reference plot_helper.py:26-39)."""
    os.makedirs(fig_dir, exist_ok=True)
    if isinstance(fig_format, str):
        fig_format = [fig_format]
    paths = []
    for fmt in fig_format:
        path = os.path.join(fig_dir, f"{fig_name}.{fmt}")
        fig.savefig(path, dpi=dpi, bbox_inches=bbox_inches)
        paths.append(path)
    if do_close:
        _pyplot().close(fig)
    return paths


def plot_mean_error_plot(data, error_type="std", mean_axis=0, fig=None,
                         ax=None, **kwargs):
    """Mean trace with shaded std/sem band (reference plot_helper.py:58-86)."""
    data = _np(data)
    if ax is None:
        fig, ax = _pyplot().subplots()
    mean = np.nanmean(data, axis=mean_axis)
    std = np.nanstd(data, axis=mean_axis)
    if error_type == "sem":
        std = std / np.sqrt(data.shape[mean_axis])
    x = np.arange(len(mean))
    ax.plot(x, mean, **kwargs)
    ax.fill_between(x, mean - std, mean + std, alpha=0.3,
                    color=kwargs.get("color"))
    return fig, ax


def plot_shuffle_data_dist_with_thresh(
    shuffle, data, bins=20, alpha=0.025, fig=None, ax=None, lw=4,
    plot_ci_high=True, plot_ci_low=False, figsize=(2, 1.3),
):
    """Null distribution histogram + observed value + quantile thresholds
    (reference plot_helper.py:667-683)."""
    shuffle = _np(shuffle)
    if ax is None:
        fig, ax = _pyplot().subplots(figsize=figsize)
    ax.hist(shuffle, bins=bins, alpha=0.5, color="gray", density=True)
    ax.axvline(data, color="C3", lw=lw, label="data")
    if plot_ci_high:
        ax.axvline(np.quantile(shuffle, 1 - alpha), color="k", ls="--",
                   label=f"{(1 - alpha) * 100:.1f}%")
    if plot_ci_low:
        ax.axvline(np.quantile(shuffle, alpha), color="k", ls=":")
    return fig, ax


def subplots_wrapper(nplots, return_axs=True, basewidth=6, baseheight=4,
                     figsize=None, **kwargs):
    """Near-square grid of subplots for nplots panels
    (reference plot_helper.py:685-699)."""
    ncols = int(np.ceil(np.sqrt(nplots)))
    nrows = int(np.ceil(nplots / ncols))
    if figsize is None:
        figsize = (basewidth * ncols, baseheight * nrows)
    fig, axs = _pyplot().subplots(nrows, ncols, figsize=figsize, squeeze=False,
                            **kwargs)
    if return_axs:
        return fig, axs
    return fig


def plot_pynapple_data_mpl(
    data_dict, height_per_plot=3, width_per_plot=6, height_ratios=None,
    plot_title=False, add_scatter_to_heatmap=False, heatmap_scatter_s=0.05,
    heatmap_scatter_c="yellow", fig=None, axs=None,
):
    """Stacked time-aligned dashboard of Tsd/TsdFrame panels: 1-D series as
    lines (robust y-limits), 2-D as heatmaps (robust color limits, optional
    MAP scatter), tuples (t, unit, color) as rasters.  All panels restricted
    to the common time range (reference plot_helper.py:898-1042).

    Returns (fig, axs, common_interval)."""
    import matplotlib.gridspec as gridspec
    from matplotlib.colors import Normalize

    nap = compat.timeseries_module()
    min_times = [np.min(arr.t) for arr in data_dict.values()
                 if not isinstance(arr, tuple)]
    max_times = [np.max(arr.t) for arr in data_dict.values()
                 if not isinstance(arr, tuple)]
    st, ed = np.max(min_times), np.min(max_times)
    common_interval = nap.IntervalSet(np.array([st]), np.array([ed]))

    restricted = {}
    for key, arr in data_dict.items():
        if isinstance(arr, tuple):
            tind, uind, c_l = (_np(a) for a in arr)
            ma = (tind < ed) & (tind > st)
            restricted[key] = (tind[ma], uind[ma], _np(c_l)[ma])
        else:
            restricted[key] = arr.restrict(common_interval)

    n_plots = len(restricted)
    if isinstance(add_scatter_to_heatmap, bool):
        add_scatter_to_heatmap = {k: add_scatter_to_heatmap for k in restricted}
    if height_ratios is None:
        height_ratios = [1] * n_plots

    if axs is None:
        fig = _pyplot().figure(
            figsize=(width_per_plot, height_per_plot * n_plots),
            constrained_layout=True,
        )
        gs = gridspec.GridSpec(n_plots, 1, height_ratios=height_ratios,
                               figure=fig)
        axs = []
        create = True
    else:
        create = False

    for i, (key, arr) in enumerate(restricted.items()):
        if create:
            ax = fig.add_subplot(gs[i], sharex=axs[0] if i else None)
            axs.append(ax)
        else:
            ax = axs[i]

        if isinstance(arr, tuple):
            tind, uind, c_l = arr
            ax.scatter(tind, uind, c=c_l, cmap="Spectral_r", s=5)
        else:
            t = _np(arr.t)
            d = _np(arr.d)
            if d.ndim == 1:
                ax.plot(t, d, label=key)
                sigma = np.nanstd(d)
                if sigma > 0:
                    filtered = d[np.abs((d - np.nanmean(d)) / sigma) <= 5]
                    if len(filtered):
                        ax.set_ylim(np.min(filtered), np.max(filtered))
            elif d.ndim == 2:
                d_plot = d.T
                zmin = np.nanquantile(d_plot, 0.01)
                zmax = np.nanquantile(d_plot, 0.99)
                ax.imshow(
                    d_plot, aspect="auto", origin="lower",
                    interpolation="none",
                    extent=[np.min(t), np.max(t), 0, d_plot.shape[0]],
                    norm=Normalize(vmin=zmin, vmax=zmax),
                )
                if add_scatter_to_heatmap.get(key, False):
                    ax.scatter(t, d_plot.argmax(axis=0), s=heatmap_scatter_s,
                               c=heatmap_scatter_c)
            else:
                ax.text(0.5, 0.5, f"Unsupported data dimension: {d.ndim}",
                        ha="center", va="center", transform=ax.transAxes)
        if plot_title:
            ax.set_title(key)
        if i < n_plots - 1:
            _pyplot().setp(ax.get_xticklabels(), visible=False)

    axs[-1].set_xlabel("Time")
    return fig, axs, common_interval


def shade_intervals(axs, intervals, *, sort_bounds=True, unique=True,
                    **kwargs):
    """Shade interval spans on one or many axes
    (reference plot_helper.py:1044-1114)."""
    if hasattr(intervals, "start"):
        bounds = np.stack(
            [np.asarray(intervals.start), np.asarray(intervals.end)], axis=1
        )
    else:
        bounds = np.atleast_2d(np.asarray(intervals, dtype=float))
    if unique:
        bounds = np.unique(bounds, axis=0)
    if sort_bounds:
        bounds = bounds[np.argsort(bounds[:, 0])]
    kwargs.setdefault("color", "red")
    kwargs.setdefault("alpha", 0.25)
    axs_l = np.atleast_1d(axs).ravel()
    for ax in axs_l:
        for s, e in bounds:
            ax.axvspan(s, e, **kwargs)
    return axs


def add_vertical_shades_mpl(fig, intvl_l, ep=None, *, exclude=None,
                            color="red", alpha=0.25, linewidth=0,
                            linestyle=None, zorder=0, mode="span",
                            **span_kwargs):
    """Shade interval spans on every axis of a figure
    (reference plot_helper.py:410-492)."""
    if hasattr(intvl_l, "start"):
        pairs = list(zip(np.asarray(intvl_l.start), np.asarray(intvl_l.end)))
    else:
        pairs = [tuple(p) for p in np.atleast_2d(np.asarray(intvl_l))]
    if ep is not None:
        lo, hi = float(ep.start[0]), float(ep.end[0])
        pairs = [(max(s, lo), min(e, hi)) for s, e in pairs if e > lo and s < hi]
    if exclude is not None:
        pairs = [p for i, p in enumerate(pairs) if i not in set(exclude)]
    for ax in fig.axes:
        for s, e in pairs:
            if mode == "span":
                ax.axvspan(s, e, color=color, alpha=alpha, lw=linewidth,
                           ls=linestyle, zorder=zorder, **span_kwargs)
            else:
                ax.axvline(s, color=color, alpha=alpha, lw=max(linewidth, 1),
                           ls=linestyle, zorder=zorder)
    return fig


def pre_post_1d_timeseries_plot(tsd, pre_ep, post_ep, fig=None, ax=None):
    """1-D series restricted to pre/post epochs in two colors
    (reference plot_helper.py:1116-1132)."""
    if ax is None:
        fig, ax = _pyplot().subplots()
    pre = tsd.restrict(pre_ep)
    post = tsd.restrict(post_ep)
    ax.plot(pre.t, _np(pre.d), color="C0", label="pre")
    ax.plot(post.t, _np(post.d), color="C1", label="post")
    ax.legend()
    return fig, ax


def median_plot(**kwargs):
    """estimator=median + (25, 75) percentile errorbar defaults for seaborn
    calls (reference plot_helper.py:1134-1144)."""
    defaults = dict(
        estimator=np.median,
        errorbar=lambda x: (np.percentile(x, 25), np.percentile(x, 75)),
    )
    defaults.update(kwargs)
    return defaults


def plot_paired_line_median(
    data, x=None, ax=None, fig=None, line_alpha=0.3, line_color="gray",
    median_color="C0", median_lw=3, **kwargs,
):
    """Per-row paired lines plus the median trace
    (reference plot_helper.py:701-896, core behaviour)."""
    data = _np(data, dtype=float)
    if ax is None:
        fig, ax = _pyplot().subplots()
    if x is None:
        x = np.arange(data.shape[1])
    for row in data:
        ax.plot(x, row, color=line_color, alpha=line_alpha, **kwargs)
    ax.plot(x, np.nanmedian(data, axis=0), color=median_color, lw=median_lw)
    return fig, ax


def plot_trajectories_on_maze_mark_events(
    position_tsdf, x_peri_jump, y_peri_jump, fig=None, ax=None, ds=5,
    start_marker="<", end_marker="o", midpoint_marker="x", start_color="C0",
    end_color="C1", midpoint_color="red", trajectory_color="C0",
    trajectory_alpha=0.4, midpoint_label="jump", marker_size=5,
    marker_alpha=0.5, midpoint_only=False,
):
    """2-D maze trajectories around events with start/mid/end markers
    (reference plot_helper.py:1146-1175)."""
    if ax is None:
        fig, ax = _pyplot().subplots()
    x_peri = np.atleast_2d(_np(x_peri_jump))
    y_peri = np.atleast_2d(_np(y_peri_jump))
    mid = x_peri.shape[1] // 2
    for xr, yr in zip(x_peri, y_peri):
        if not midpoint_only:
            ax.plot(xr[::ds], yr[::ds], color=trajectory_color,
                    alpha=trajectory_alpha)
            ax.scatter(xr[0], yr[0], marker=start_marker, color=start_color,
                       s=marker_size, alpha=marker_alpha)
            ax.scatter(xr[-1], yr[-1], marker=end_marker, color=end_color,
                       s=marker_size, alpha=marker_alpha)
        ax.scatter(xr[mid], yr[mid], marker=midpoint_marker,
                   color=midpoint_color, s=marker_size, label=midpoint_label)
    return fig, ax


def plot_maze_background(spk_beh_df, ds=10, fig=None, ax=None, mode="line",
                         **kwargs):
    """Downsampled x/y occupancy trace as the maze background
    (reference plot_helper.py:1177-1190)."""
    if ax is None:
        fig, ax = _pyplot().subplots()
    x = _np(spk_beh_df["x"])[::ds]
    y = _np(spk_beh_df["y"])[::ds]
    if "c" not in kwargs:
        kwargs.setdefault("color", "lightgray")
    if mode == "line":
        ax.plot(x, y, **kwargs)
    else:
        ax.scatter(x, y, s=kwargs.pop("s", 1), **kwargs)
    return fig, ax


def plot_data_shuffle_time_series(
    data, shuffle, align_at="middle", fig=None, ax=None, figsize=(6, 4),
    data_label="data", shuffle_label="null", data_color="C0",
    shuffle_color="C0", shuffle_alpha=0.3, data_lw=2, marker="o",
    marker_size=2,
):
    """Observed trace over the shuffle 2.5-97.5% band
    (reference plot_helper.py:1192-1243)."""
    data = _np(data, dtype=float)
    shuffle = _np(shuffle, dtype=float)
    if ax is None:
        fig, ax = _pyplot().subplots(figsize=figsize)
    n = len(data)
    if align_at == "middle":
        x = np.arange(n) - n // 2
    else:
        x = np.arange(n)
    lo = np.nanpercentile(shuffle, 2.5, axis=0)
    hi = np.nanpercentile(shuffle, 97.5, axis=0)
    ax.fill_between(x, lo, hi, color=shuffle_color, alpha=shuffle_alpha,
                    label=shuffle_label)
    ax.plot(x, data, color=data_color, lw=data_lw, marker=marker,
            markersize=marker_size, label=data_label)
    ax.legend()
    return fig, ax


def add_scalebar(ax, x, y, length, label=None, orientation="horizontal",
                 color="k", lw=2, fontsize=8, text_offset=0.02, **kwargs):
    """Draw a scalebar at axes-fraction position (x, y)
    (reference plot_helper.py:1245-1366, core behaviour)."""
    trans = ax.transAxes
    if orientation == "horizontal":
        ax.plot([x, x + length], [y, y], transform=trans, color=color, lw=lw,
                **kwargs)
        if label:
            ax.text(x + length / 2, y - text_offset, label, transform=trans,
                    ha="center", va="top", fontsize=fontsize)
    else:
        ax.plot([x, x], [y, y + length], transform=trans, color=color, lw=lw,
                **kwargs)
        if label:
            ax.text(x - text_offset, y + length / 2, label, transform=trans,
                    ha="right", va="center", fontsize=fontsize,
                    rotation=90)
    return ax


def plot_brain_state_intervals(
    interval_dict, color_dict=None, order=("REM", "NREM", "Awake"), gap=0.2,
    fig=None, ax=None,
):
    """Stacked horizontal state-interval bands
    (reference plot_helper.py:1368-1402)."""
    if color_dict is None:
        color_dict = {"REM": "magenta", "NREM": "blue", "Awake": "black"}
    if ax is None:
        fig, ax = _pyplot().subplots(figsize=(8, 1 + len(interval_dict) * 0.5))
    keys = [k for k in order if k in interval_dict] + [
        k for k in interval_dict if k not in order
    ]
    for row, key in enumerate(keys):
        intv = interval_dict[key]
        if hasattr(intv, "start"):
            starts = np.asarray(intv.start)
            ends = np.asarray(intv.end)
        else:
            arr = np.atleast_2d(np.asarray(intv))
            starts, ends = arr[:, 0], arr[:, 1]
        y = row * (1 + gap)
        for s, e in zip(starts, ends):
            ax.axhspan(y, y + 1, xmin=0, xmax=0)  # keep ylim updated
            ax.fill_between([s, e], y, y + 1,
                            color=color_dict.get(key, "gray"))
    ax.set_yticks([r * (1 + gap) + 0.5 for r in range(len(keys))])
    ax.set_yticklabels(keys)
    return fig, ax


def plot_cdf_and_ks_test(sample1, sample2, alpha=0.05, fig=None, ax=None,
                         label1="sample1", label2="sample2", xlabel="Value",
                         title=None):
    """Empirical CDFs of two samples + two-sample KS test annotation
    (reference plot_helper.py:1404-1470)."""
    from scipy import stats as sstats

    s1 = np.sort(_np(sample1))
    s2 = np.sort(_np(sample2))
    if ax is None:
        fig, ax = _pyplot().subplots()
    ax.step(s1, np.arange(1, len(s1) + 1) / len(s1), label=label1)
    ax.step(s2, np.arange(1, len(s2) + 1) / len(s2), label=label2)
    ks, p = sstats.ks_2samp(s1, s2)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("CDF")
    sig = "*" if p < alpha else "n.s."
    ax.set_title(title or f"KS={ks:.3f}, p={p:.3g} ({sig})")
    ax.legend()
    return fig, ax, {"ks": float(ks), "p": float(p)}


# ---------------------------------------------------------------------------
# tick helpers (reference plot_helper.py:546-665)
# ---------------------------------------------------------------------------


def _round_to_first_distinguishing_digit(a, b):
    """Round two values to the first decimal place that distinguishes them."""
    if a == b:
        return a, b
    diff = abs(b - a)
    ndigits = max(0, int(np.ceil(-np.log10(diff))))
    return round(a, ndigits), round(b, ndigits)


def set_two_ticks(axis, xlim=None, ylim=None, do_int=False, apply_to="y"):
    """Keep only two (min/max) ticks on an axis
    (reference plot_helper.py:576-621)."""
    if apply_to in ("y", "both"):
        lo, hi = ylim if ylim is not None else axis.get_ylim()
        lo, hi = _round_to_first_distinguishing_digit(lo, hi)
        if do_int:
            lo, hi = int(lo), int(hi)
        axis.set_yticks([lo, hi])
    if apply_to in ("x", "both"):
        lo, hi = xlim if xlim is not None else axis.get_xlim()
        lo, hi = _round_to_first_distinguishing_digit(lo, hi)
        if do_int:
            lo, hi = int(lo), int(hi)
        axis.set_xticks([lo, hi])
    return axis


def set_symmetric_ticks(axis, xlim=None, ylim=None, do_int=False,
                        apply_to="y"):
    """Three symmetric ticks (-m, 0, m) around zero
    (reference plot_helper.py:623-665)."""
    def _sym(lo, hi):
        m = max(abs(lo), abs(hi))
        if do_int:
            m = int(np.ceil(m))
        return [-m, 0, m]

    if apply_to in ("y", "both"):
        lo, hi = ylim if ylim is not None else axis.get_ylim()
        axis.set_yticks(_sym(lo, hi))
    if apply_to in ("x", "both"):
        lo, hi = xlim if xlim is not None else axis.get_xlim()
        axis.set_xticks(_sym(lo, hi))
    return axis
