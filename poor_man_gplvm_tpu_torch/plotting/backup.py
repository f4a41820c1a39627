"""Remaining plotting utilities from the reference's backup helper module
(reference _plot_helper_backup.py): ratemaps with field bounds, maze
section/speed encodings, standalone legends/colorbars, paired box plots,
day markers, and small statistical annotation helpers.

The port's own copy of ``poor_man_gplvm_tpu/plotting/backup.py``:
matplotlib, seaborn and scipy are imported inside the functions that use
them.  The functions that take a DataFrame also take a ``ResultTable``
(made a DataFrame at the call: pandas is needed there, as seaborn needs
it).
"""

from __future__ import annotations

import os

import numpy as np

from poor_man_gplvm_tpu_torch.plotting.core import _pyplot
from poor_man_gplvm_tpu_torch.utils.table import ResultTable

__all__ = [
    "mean_error_plot",
    "color_arms",
    "marker_speed",
    "prep_hue_scatter",
    "plot_vlines",
    "plot_section_markers",
    "plot_shades",
    "ratemap_one_raw",
    "plot_field_bound",
    "plot_switch_trial",
    "plot_colorbar",
    "prep_color",
    "mean_across_row_vs_col_with_err",
    "plot_day_on_heatmap",
    "heatmap",
    "add_field_bounds",
    "save_given_name",
    "box_strip_plot",
    "plot_legend",
    "star_map",
    "consecutive_wilcoxon_test",
    "apply_axis_color",
    "plot_angle",
]

# default T-maze linearized-position sections (reference
# _plot_helper_backup.py:293-295)
_DEFAULT_SECTIONS = {
    "home": [0, 15], "central": [15, 74], "T": [74, 111],
    "return side": [111, 185], "return central": [185, 222],
}
_DEFAULT_SPEED_RANGES = {
    "nan": np.nan, "stationary": [0, 2], "low speed": [2, 10],
    "high speed": [10, 100],
}


def _frame(df):
    """A ``ResultTable`` as its DataFrame; anything else as it is."""
    return df.to_dataframe() if isinstance(df, ResultTable) else df


def mean_error_plot(df, xs=None, ci_scale=1.96, axis=0, fig=None, ax=None,
                    alpha=0.5, label=None, sem=True, linestyle="-", c="C0"):
    """Mean line + shaded CI band from a DataFrame
    (reference _plot_helper_backup.py:133-152)."""
    df = _frame(df)
    plt = _pyplot()

    dfmean = df.mean(axis=axis)
    if sem:
        error = df.sem(axis=axis) * ci_scale
        dfup, dflow = dfmean + error, dfmean - error
    else:
        dfup = np.nanquantile(df.values, 1 - 0.025, axis=axis)
        dflow = np.nanquantile(df.values, 0.025, axis=axis)
    if ax is None:
        fig, ax = plt.subplots()
    if xs is None:
        xs = df.columns.astype(float)
    ax.fill_between(xs, dflow, dfup, alpha=alpha, color=c)
    ax.plot(xs, np.asarray(dfmean), label=label, linestyle=linestyle, color=c)
    return fig, ax


def color_arms(lin, section_dict=None, color_l=None):
    """Per-timepoint colors by maze section + patch legend handles
    (reference _plot_helper_backup.py:292-309)."""
    import matplotlib.patches as mpatches

    if section_dict is None:
        section_dict = dict(_DEFAULT_SECTIONS)
    if color_l is None:
        color_l = [f"C{i}" for i in range(len(section_dict))]
    lin = np.asarray(lin)
    color_in_time = np.zeros_like(lin, dtype=object)
    legend_l = []
    for ii, (name, sec) in enumerate(section_dict.items()):
        if ii == 0:
            mask = (lin >= sec[0]) & (lin <= sec[1])
        else:
            mask = (lin > sec[0]) & (lin <= sec[1])
        color_in_time[mask] = color_l[ii]
        legend_l.append(mpatches.Patch(color=color_l[ii], label=name))
    return color_in_time, legend_l, section_dict, color_l


def marker_speed(speed, speed_range_dict=None, marker_l=None):
    """Per-timepoint markers by speed range + line legend handles
    (reference _plot_helper_backup.py:312-336)."""
    from matplotlib.lines import Line2D

    if speed_range_dict is None:
        speed_range_dict = dict(_DEFAULT_SPEED_RANGES)
    if marker_l is None:
        marker_l_all = ["x", ".", "v", "*", "<", "d", "p", "s"]
        assert len(speed_range_dict) <= len(marker_l_all)
        marker_l = marker_l_all[: len(speed_range_dict)]
    speed = np.asarray(speed, dtype=float)
    marker_in_time = np.zeros_like(speed, dtype=object)
    legend_l = []
    for ii, (name, sec) in enumerate(speed_range_dict.items()):
        if isinstance(sec, list):
            if ii == 0:
                mask = (speed >= sec[0]) & (speed <= sec[1])
            else:
                mask = (speed > sec[0]) & (speed <= sec[1])
        else:
            mask = np.isnan(speed)
        marker_in_time[mask] = marker_l[ii]
        legend_l.append(
            Line2D([0], [0], marker=marker_l[ii], color="k", label=name)
        )
    return marker_in_time, legend_l, speed_range_dict, marker_l


def prep_hue_scatter(spks_onetrial_, speed_key="v"):
    """Combined section-color + speed-marker encodings for one trial's
    scatter (reference _plot_helper_backup.py:338-351)."""
    spks_onetrial_ = _frame(spks_onetrial_)
    lin = spks_onetrial_["lin"].values
    color_in_time, legend_color, _, _ = color_arms(lin)
    speed = spks_onetrial_[speed_key].abs().values
    marker_in_time, legend_marker, _, _ = marker_speed(speed)
    return (
        color_in_time, marker_in_time, legend_color + legend_marker,
        legend_color, legend_marker,
    )


def plot_vlines(lin_val_left, fig=None, ax=None):
    """Dotted vertical landmark lines (reference
    _plot_helper_backup.py:354-359)."""
    plt = _pyplot()

    if ax is None:
        fig, ax = plt.subplots()
    for val in lin_val_left:
        ax.axvline(val, color="k", linestyle=":")
    return fig, ax


def plot_section_markers(labels=None, bounds=None, fig=None, ax=None,
                         rotation=20):
    """Vertical maze-section boundaries with minor-tick section labels
    (reference _plot_helper_backup.py:361-383)."""
    plt = _pyplot()

    if bounds is None:
        bounds = np.array([0, 15, 74, 111, 185, 222]) / 2.2
    if labels is None:
        labels = list(_DEFAULT_SECTIONS)
    bounds = np.asarray(bounds, dtype=float)
    minor_ticks = (bounds[:-1] + bounds[1:]) / 2
    if ax is None:
        fig, ax = plt.subplots(figsize=(10, 6))
    ax.set_xticks([])
    ylims = ax.get_ylim()
    for xx in bounds[1:-1]:
        ax.vlines(xx, ylims[0], ylims[1], color="k", linestyle=":")
    ax.set_xticks(minor_ticks, minor=True)
    ax.set_xticklabels(labels, minor=True, rotation=rotation)
    return fig, ax


def plot_shades(labels, fig=None, ax=None):
    """Shade contiguous same-label segments (HMM-state style), one color per
    label (reference _plot_helper_backup.py:386-404)."""
    plt = _pyplot()

    if ax is None:
        fig, ax = plt.subplots()
    labels = np.asarray(labels)
    labels_ext = np.concatenate([[-1], labels, [-1]])
    for ii, c in enumerate(np.unique(labels)):
        seg = (labels_ext == c).astype(int)
        dseg = np.diff(seg)
        starts = np.nonzero(dseg == 1)[0]
        ends = np.nonzero(dseg == -1)[0]
        for st, ed in zip(starts, ends):
            ax.fill_between(
                np.array([st, ed]), 0, 1, color=f"C{ii}", alpha=0.3,
                transform=ax.get_xaxis_transform(),
            )
    return fig, ax


def heatmap(df, fig=None, ax=None, vmin=0, vmax=None, vmax_quantile=0.99,
            cmap="viridis", xlabel="Position", ylabel="", cbar=True,
            cbar_ax=None):
    """Quantile-clipped seaborn heatmap with integer x ticks mapped to
    column labels (reference _plot_helper_backup.py:608-633)."""
    df = _frame(df)
    plt = _pyplot()
    import seaborn as sns
    from matplotlib.ticker import MaxNLocator

    if ax is None:
        fig, ax = plt.subplots()
    vals = np.asarray(df.values, dtype=float).ravel()
    vals = vals[~np.isnan(vals)]
    if vmax is None:
        vmax = np.nanquantile(vals, vmax_quantile)
    sns.heatmap(df, cmap=cmap, vmax=vmax, vmin=vmin, ax=ax, cbar=cbar,
                cbar_ax=cbar_ax)
    ax.set(xlabel=xlabel, ylabel=ylabel)
    ax.xaxis.set_major_locator(MaxNLocator(nbins=5, integer=True))
    idx = np.round(ax.get_xticks()).astype(int)
    idx = idx[(idx >= 0) & (idx < len(df.columns))]
    ax.set_xticks(idx)
    ax.set_xticklabels(df.columns[idx], rotation=0)
    return fig, ax


def ratemap_one_raw(data, trial=None, field_bound=None, fig=None, ax=None,
                    line_kws=None, title=None, heatmap_kws=None):
    """Ratemap heatmap + optional trial hlines and field-bound vlines
    (reference _plot_helper_backup.py:408-436)."""
    data = _frame(data)
    plt = _pyplot()

    line_kws_ = {"linewidth": 2, "linestyle": ":"}
    line_kws_.update(line_kws or {})
    heatmap_kws_ = dict(vmin=0, vmax=None, vmax_quantile=0.99, cmap="viridis",
                        xlabel="Position", ylabel="", cbar=True, cbar_ax=None)
    heatmap_kws_.update(heatmap_kws or {})
    if ax is None:
        fig, ax = plt.subplots(figsize=(3, 2))
    fig, ax = heatmap(data, fig=fig, ax=ax, **heatmap_kws_)
    if trial is not None:
        trials = trial if hasattr(trial, "__iter__") else [trial]
        for tr in trials:
            if tr is not None:
                ax.hlines(tr, *ax.get_xlim(), color="pink", **line_kws_)
    if field_bound is not None:
        field_st, field_end = field_bound
        ax.vlines(field_st, *ax.get_ylim(), color="red", **line_kws_)
        ax.vlines(field_end, *ax.get_ylim(), color="red", **line_kws_)
    if title is not None:
        ax.set_title(title)
    return fig, ax


def plot_field_bound(field_st, field_end, ax=None, fig=None, c="C1",
                     line_kws=None):
    """Dotted vlines at a place field's bounds
    (reference _plot_helper_backup.py:438-445)."""
    plt = _pyplot()

    line_kws_ = {"linewidth": 3, "linestyle": ":"}
    line_kws_.update(line_kws or {})
    if ax is None:
        fig, ax = plt.subplots()
    ax.vlines(field_st, *ax.get_ylim(), color=c, **line_kws_)
    ax.vlines(field_end, *ax.get_ylim(), color=c, **line_kws_)
    return fig, ax


def plot_switch_trial(trial, xlim=None, c="C0", fig=None, ax=None,
                      line_kws=None):
    """Horizontal line(s) marking switch trial(s)
    (reference _plot_helper_backup.py:447-463)."""
    plt = _pyplot()

    line_kws_ = {"linewidth": 3, "linestyle": ":"}
    line_kws_.update(line_kws or {})
    if ax is None:
        fig, ax = plt.subplots()
    if xlim is None:
        xlim = ax.get_xlim()
    if trial is not None:
        trials = trial if hasattr(trial, "__iter__") else [trial]
        for tr in trials:
            if tr is not None:
                ax.hlines(tr, *xlim, color=c, **line_kws_)
    return fig, ax


def plot_colorbar(**kwargs):
    """Standalone colorbar figure (reference
    _plot_helper_backup.py:466-484)."""
    import matplotlib as mpl
    plt = _pyplot()

    fig, ax = plt.subplots(figsize=kwargs.get("figsize", (0.2, 4)))
    cmap = kwargs.get("cmap", mpl.cm.viridis)
    norm = mpl.colors.Normalize(vmin=kwargs.get("vmin", 0),
                                vmax=kwargs.get("vmax", 1))
    cb = mpl.colorbar.ColorbarBase(
        ax, cmap=cmap, norm=norm,
        orientation=kwargs.get("orientation", "vertical"),
    )
    return fig, ax, cb


def prep_color(colors, cmap_str="jet", color_discrete=False):
    """Map scalar values to RGBA via a colormap
    (reference _plot_helper_backup.py:486-497)."""
    plt = _pyplot()
    from matplotlib.colors import BoundaryNorm
    from matplotlib.ticker import MaxNLocator

    cmap = plt.get_cmap(cmap_str)
    colors = np.asarray(colors, dtype=float)
    cmin, cmax = np.min(colors), np.max(colors)
    if color_discrete:
        levels = MaxNLocator(nbins=int(cmax - cmin + 1)).tick_values(
            cmin, cmax + 1
        )
        norm = BoundaryNorm(levels, ncolors=cmap.N, clip=True)
    else:
        norm = plt.Normalize(cmin, cmax)
    return cmap(norm(colors))


def mean_across_row_vs_col_with_err(df, value_name="value", var_name="Trial",
                                    integer_x=True, cols_reset=None, fig=None,
                                    ax=None, plot_type="line", **kwargs):
    """Melt a (row x col) DataFrame and seaborn line/bar plot with error
    (reference _plot_helper_backup.py:571-587)."""
    df = _frame(df)
    import copy

    plt = _pyplot()
    import seaborn as sns
    from matplotlib.ticker import MaxNLocator

    df_ = copy.copy(df)
    df_.columns = (np.arange(df_.shape[1]) if cols_reset is None
                   else cols_reset)
    df_ = df_.melt(var_name=var_name, value_name=value_name)
    if ax is None:
        fig, ax = plt.subplots()
    if plot_type == "line":
        sns.lineplot(data=df_, x=var_name, y=value_name, ax=ax, **kwargs)
    elif plot_type == "bar":
        sns.barplot(data=df_, x=var_name, y=value_name, ax=ax, **kwargs)
    if integer_x:
        ax.xaxis.set_major_locator(MaxNLocator(integer=True))
    return fig, ax


def plot_day_on_heatmap(df, axis=0, level=0, vline=False, hline=True, ax=None,
                        fig=None, color="C0"):
    """Dotted lines at day changes of a MultiIndexed heatmap
    (reference _plot_helper_backup.py:591-605)."""
    df = _frame(df)
    plt = _pyplot()

    day_l = (df.index.get_level_values(level=level) if axis == 0
             else df.columns.get_level_values(level=level))
    day_change = np.nonzero(np.diff(day_l))[0] + 1
    if ax is None:
        fig, ax = plt.subplots()
    for dd in day_change:
        if hline:
            ax.axhline(dd, color=color, linestyle=":")
        if vline:
            ax.axvline(dd, color=color, linestyle=":")
    return fig, ax


def add_field_bounds(field_bounds, df=None, by_day=False,
                     by_previous_day=False, fig=None, ax=None, **kwargs):
    """Vertical field-bound lines, optionally clipped to (cumulative) day
    bands of a day-indexed heatmap (reference
    _plot_helper_backup.py:635-697)."""
    field_bounds = _frame(field_bounds)
    df = None if df is None else _frame(df)
    plt = _pyplot()

    kwargs_ = {"c": "C1", "linestyle": ":", "linewidth": 3}
    kwargs_.update(kwargs)
    if ax is None:
        fig, ax = plt.subplots()
    if df is not None:
        day_l = df.index.get_level_values(0)
        plot_height = df.shape[0]
    for i, row in field_bounds.iterrows():
        if by_day or by_previous_day:
            day = i[0]
            ma = (day_l == day) if by_day else (day_l <= day)
            change = np.diff(ma, append=False, prepend=False)
            ymin, ymax = np.nonzero(change)[0]
            ymin = 1 - ymin / plot_height
            ymax = 1 - ymax / plot_height
        else:
            ymin, ymax = 0, 1
        ax.axvline(row["start"], ymin, ymax, **kwargs_)
        ax.axvline(row["end"], ymin, ymax, **kwargs_)
    return fig, ax


def save_given_name(fig, figfn, figdir="", dpi="figure"):
    """Save png+svg with dots in the name sanitized
    (reference _plot_helper_backup.py:699-703)."""
    figfn_clean = figfn.replace(".", "dot")
    for fmt in ["png", "svg"]:
        fig.savefig(os.path.join(figdir, f"{figfn_clean}.{fmt}"),
                    bbox_inches="tight", dpi=dpi)


def box_strip_plot(df, x1, x2, hue=None, fig=None, ax=None, line_kws=None,
                   do_logy=False):
    """Paired lines + box plot for two columns
    (reference _plot_helper_backup.py:705-719)."""
    df = _frame(df)
    plt = _pyplot()
    import seaborn as sns

    line_kws_ = {"c": "Grey", "alpha": 0.3}
    line_kws_.update(line_kws or {})
    xs = np.arange(2) + 1
    if ax is None:
        fig, ax = plt.subplots()
    for _, row in df.iterrows():
        ax.plot(xs, row[[x1, x2]].values, **line_kws_)
    ax.boxplot(df[[x1, x2]].values)
    if do_logy:
        ax.set_yscale("log")
    sns.despine()
    ax.set_xticklabels([x1, x2])
    return fig, ax


def plot_legend(labels, colors=None, handle_types=None, vertical=True,
                frameon=False, figsize=(0.6, 0.4)):
    """Standalone legend figure (reference
    _plot_helper_backup.py:726-759)."""
    plt = _pyplot()
    from matplotlib.lines import Line2D
    from matplotlib.patches import Patch

    if colors is None:
        colors = [f"C{i}" for i in range(len(labels))]
    if handle_types is None:
        handle_types = ["patch"] * len(labels)
    handles = []
    for color, handle_type in zip(colors, handle_types):
        if handle_type == "line":
            handles.append(Line2D([0], [0], color=color, lw=2))
        else:
            handles.append(Patch(facecolor=color))
    fig, ax = plt.subplots(figsize=figsize)
    fig.legend(handles=handles, labels=list(labels), loc="center",
               ncol=1 if vertical else len(labels), frameon=frameon)
    ax.axis("off")
    return fig, ax


def star_map(r):
    """p-value to stars, 4-star variant
    (reference _plot_helper_backup.py:773-784)."""
    if r > 0.05:
        return "n.s."
    if r > 0.01:
        return "*"
    if r > 0.001:
        return "**"
    if r > 0.0001:
        return "***"
    return "****"


def consecutive_wilcoxon_test(df):
    """Wilcoxon signed-rank between consecutive columns
    (reference _plot_helper_backup.py:786-794)."""
    df = _frame(df)
    import scipy.stats

    cols = df.columns
    res_all = {}
    for i in range(1, len(cols)):
        diff = (df[cols[i]] - df[cols[i - 1]]).dropna(axis=0)
        res_all[(cols[i - 1], cols[i])] = scipy.stats.wilcoxon(diff)
    return res_all


def apply_axis_color(axis, color, spine_side="left"):
    """Consistent spine/tick/label coloring
    (reference _plot_helper_backup.py:806-810)."""
    axis.spines[spine_side].set_color(color)
    axis.tick_params(axis="y", colors=color)
    axis.yaxis.label.set_color(color)


def plot_angle(theta, ds_fac=10, xs=None, y_coord=1, fig=None, ax=None,
               arrow_size=10, width=0.003, c="C2"):
    """Downsampled head-direction quiver along an x axis
    (reference _plot_helper_backup.py:817-846)."""
    plt = _pyplot()

    theta_val = getattr(theta, "values", theta)
    if xs is None:
        xs = getattr(theta, "index", np.arange(len(theta_val)))
    xs = np.asarray(xs)
    xs_ds = xs[::ds_fac]
    theta_ds = np.asarray(theta_val)[::ds_fac]
    if ax is None:
        fig, ax = plt.subplots()
    ax.quiver(
        xs_ds, y_coord * np.ones_like(xs_ds, dtype=float),
        np.cos(theta_ds) * arrow_size, np.sin(theta_ds) * arrow_size,
        fc=c, ec=c, width=width,
    )
    return fig, ax
