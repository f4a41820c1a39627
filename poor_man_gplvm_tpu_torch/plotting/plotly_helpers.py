"""Plotly plotting utilities (gated: plotly is an optional dependency).

The port's own copy of ``poor_man_gplvm_tpu/plotting/plotly_helpers.py``
(the plotly half of reference poor_man_gplvm/plot_helper.py:
save_fig_plotly, plot_pynapple_data_plotly, add_vertical_shades,
set_plotly_fonts).  Importing this module succeeds without plotly;
calling any function raises the JAX package's ImportError.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "save_fig_plotly",
    "plot_pynapple_data_plotly",
    "add_vertical_shades",
    "set_plotly_fonts",
]


def _require_plotly():
    try:
        import plotly.graph_objects as go
        from plotly.subplots import make_subplots

        return go, make_subplots
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "plotly is required for the interactive plotting helpers; "
            "install plotly or use poor_man_gplvm_tpu_torch.plotting.core (mpl)"
        ) from e


def save_fig_plotly(fig, fig_name, fig_dir="./figs", fig_format=("png", "svg"),
                    scale_png=10, scale_svg=0.15):
    """Save a plotly figure in each requested format
    (reference plot_helper.py:41-56)."""
    _require_plotly()
    os.makedirs(fig_dir, exist_ok=True)
    paths = []
    for fmt in fig_format:
        path = os.path.join(fig_dir, f"{fig_name}.{fmt}")
        scale = scale_png if fmt == "png" else scale_svg
        if fmt == "html":
            fig.write_html(path)
        else:
            fig.write_image(path, scale=scale)
        paths.append(path)
    return paths


def _deep_update(base, extra):
    """Recursively merge nested style dicts (per-key trace kwargs like
    line/marker/colorbar) — reference plot_helper.py:88-95."""
    for k, v in (extra or {}).items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def _per_key(value, key):
    """Resolve a scalar-or-{key: value} option for one subplot key
    (reference plot_helper.py:97-100)."""
    if isinstance(value, dict):
        return value.get(key, None)
    return value


def _compute_tickvals(requested, vmin, vmax):
    """An int request becomes n evenly spaced ticks over [vmin, vmax]; an
    explicit list passes through (reference plot_helper.py:103-113)."""
    if requested is None:
        return None
    if isinstance(requested, int):
        n = max(1, requested)
        if not np.isfinite(vmin) or not np.isfinite(vmax):
            return None
        if vmin == vmax:
            return [vmin]
        return list(np.linspace(vmin, vmax, n))
    return requested


def _y_extent(y, q_cfg, lim_cfg):
    """Robust per-panel y-range: quantile config first, explicit limits
    next, raw extent last; degenerate ranges get an epsilon."""
    def _fallback():
        ymin, ymax = float(np.nanmin(y)), float(np.nanmax(y))
        if ymin == ymax:
            eps = 1e-6 if ymin == 0 else abs(ymin) * 1e-6
            ymin, ymax = ymin - eps, ymax + eps
        return ymin, ymax

    if q_cfg is not None:
        ymin = float(np.nanquantile(y, q_cfg[0]))
        ymax = float(np.nanquantile(y, q_cfg[1]))
        if not np.isfinite(ymin) or not np.isfinite(ymax) or ymin == ymax:
            ymin, ymax = _fallback()
        return ymin, ymax, True
    if lim_cfg is not None:
        ymin, ymax = lim_cfg
        if not (np.isfinite(ymin) and np.isfinite(ymax)) or ymin == ymax:
            ymin, ymax = _fallback()
        return float(ymin), float(ymax), True
    ymin, ymax = float(np.nanmin(y)), float(np.nanmax(y))
    return ymin, ymax, False


def plot_pynapple_data_plotly(
    data_dict,
    reference_time_key=None,
    width=900,
    heights=200,
    global_scale=1.0,
    vertical_spacing=0.04,
    styles=None,
    x_nticks=None,
    y_nticks=None,
    tickformat=None,
    y_lim_quantile=(0.01, 0.99),
    y_lim=None,
    ylabel=None,
    xlabel=None,
    tickvals=None,
    ticktext=None,
    ylabel_standoff=None,
    xlabel_standoff=None,
    title_top_margin=70,
    annotation_yshift=8,
    shared_vlines=None,
    showlegend=False,
    font_size=12,
    height_per_plot=None,
    row_heights=None,
    shared_xaxes=True,
    heatmap_zquantiles=(0.01, 0.99),
    **layout_kwargs,
):
    """Stacked time-aligned dashboard of Tsd/TsdFrame panels (lines for 1-D,
    heatmaps for 2-D, scatter rasters for (t, unit, color) tuples) — the
    interactive counterpart of plot_pynapple_data_mpl, with the reference's
    full per-key configuration surface (reference plot_helper.py:125-345):
    per-key ``styles`` trace overrides (deep-merged), per-key or global
    ``x_nticks``/``y_nticks``/``tickvals``/``ticktext``/``ylabel``/
    ``xlabel``/standoffs, quantile- or explicit y-limits, shared vertical
    lines, and pixel ``heights`` (int or per-panel list) scaled by
    ``global_scale``.

    Returns the plotly Figure."""
    go, make_subplots = _require_plotly()

    # optional common-interval restriction (reference :147-157)
    data = dict(data_dict)
    if reference_time_key is not None and hasattr(
        data[reference_time_key], "restrict"
    ):
        try:
            import pynapple as nap

            ref = data[reference_time_key]
            common = nap.IntervalSet([ref.t[0], ref.t[-1]])
            data = {
                k: (v.restrict(common) if hasattr(v, "restrict") else v)
                for k, v in data.items()
            }
        except ImportError:  # pragma: no cover
            pass
    keys = list(data.keys())
    n = len(keys)
    if n == 0:
        raise ValueError("plot_pynapple_data_plotly: data_dict is empty")

    if height_per_plot is not None:  # back-compat alias
        heights = height_per_plot
    if isinstance(heights, (list, tuple, np.ndarray)):
        heights = np.asarray(heights, dtype=float) * global_scale
        fig_height = int(np.sum(heights))
        if row_heights is None:
            row_heights = [h / float(np.sum(heights)) for h in heights]
        if len(row_heights) != n:
            raise ValueError("len(heights) must equal number of subplots.")
    else:
        heights = float(heights) * global_scale
        fig_height = int(n * heights)
        if row_heights is None:
            row_heights = [1.0 / n] * n
    width = width * global_scale
    vertical_spacing = vertical_spacing * global_scale
    title_top_margin = title_top_margin * global_scale
    annotation_yshift = annotation_yshift * global_scale

    fig = make_subplots(
        rows=n, cols=1, shared_xaxes=shared_xaxes,
        row_heights=row_heights, vertical_spacing=vertical_spacing,
        subplot_titles=keys,
    )

    y_extents = {}
    for i, key in enumerate(keys, start=1):
        arr = data[key]
        sty = (styles or {}).get(key, {})
        if isinstance(arr, tuple):  # raster: (t, unit, color)
            tind, uind, c_l = arr
            defaults = dict(
                mode="markers",
                marker=dict(size=3, color=np.asarray(c_l),
                            colorscale="Spectral_r"),
                name=key,
            )
            _deep_update(defaults, sty)
            fig.add_trace(
                go.Scattergl(x=np.asarray(tind), y=np.asarray(uind),
                             **defaults),
                row=i, col=1,
            )
            continue
        t = np.asarray(arr.t)
        d = np.asarray(arr.d)
        if d.size == 0:  # empty pane still needs a trace for its title
            fig.add_trace(go.Scatter(x=[], y=[], mode="lines", name=key),
                          row=i, col=1)
            continue
        if d.ndim == 1:
            defaults = dict(mode="lines", name=key)
            _deep_update(defaults, sty)
            fig.add_trace(go.Scattergl(x=t, y=d, **defaults), row=i, col=1)
        elif d.ndim == 2:
            d_plot = d.T
            defaults = dict(
                x=t,
                y=np.asarray(getattr(arr, "columns",
                                     np.arange(d_plot.shape[0]))),
                z=d_plot, colorscale="Viridis", showscale=False,
                zauto=False, name=key,
            )
            if "zmin" not in sty:
                defaults["zmin"] = float(
                    np.nanquantile(d_plot, heatmap_zquantiles[0])
                )
            if "zmax" not in sty:
                defaults["zmax"] = float(
                    np.nanquantile(d_plot, heatmap_zquantiles[1])
                )
            _deep_update(defaults, sty)
            fig.add_trace(go.Heatmap(**defaults), row=i, col=1)
        else:
            raise ValueError(f"Unsupported dim for key {key!r}: {d.ndim}")

    # axis ranges, ticks, labels (reference :221-318)
    for i, key in enumerate(keys, start=1):
        arr = data[key]
        is_1d = (
            not isinstance(arr, tuple)
            and np.asarray(getattr(arr, "d", np.empty(0))).ndim == 1
            and np.asarray(arr.d).size > 0
        )
        y_min_used = y_max_used = None
        if is_1d:
            q_cfg = (
                y_lim_quantile.get(key, (0.01, 0.99))
                if isinstance(y_lim_quantile, dict) else y_lim_quantile
            )
            lim_cfg = (
                y_lim.get(key, None) if isinstance(y_lim, dict) else y_lim
            )
            y_min_used, y_max_used, set_range = _y_extent(
                np.asarray(arr.d), q_cfg, lim_cfg
            )
            if set_range:
                fig.update_yaxes(range=[y_min_used, y_max_used],
                                 row=i, col=1)
        y_extents[key] = (y_min_used, y_max_used)

        nt = _per_key(x_nticks, key)
        if nt:
            fig.update_xaxes(nticks=nt, row=i, col=1)
        nt = _per_key(y_nticks, key)
        if nt:
            fig.update_yaxes(nticks=nt, row=i, col=1)
        if tickformat:
            fig.update_xaxes(tickformat=tickformat, row=i, col=1)

        y_update = {}
        ylab = _per_key(ylabel, key)
        if ylab is not None:
            y_update["title"] = ylab
        ystandoff = _per_key(ylabel_standoff, key)
        if ystandoff is not None:
            y_update["title_standoff"] = ystandoff
        y_tick_req = _per_key(tickvals, key)
        if y_tick_req is not None:
            vmin, vmax = y_extents[key]
            if (vmin is None or vmax is None) and is_1d:
                vmin = float(np.nanmin(arr.d))
                vmax = float(np.nanmax(arr.d))
            tv = _compute_tickvals(
                y_tick_req,
                vmin if vmin is not None else np.nan,
                vmax if vmax is not None else np.nan,
            )
            if tv is not None:
                y_update["tickmode"] = "array"
                y_update["tickvals"] = tv
                y_tick_text = _per_key(ticktext, key)
                if y_tick_text is not None:
                    y_update["ticktext"] = y_tick_text
        if y_update:
            fig.update_yaxes(**y_update, row=i, col=1)

        x_update = {}
        xlab = _per_key(xlabel, key)
        if xlab is not None:
            x_update["title"] = xlab
        xstandoff = _per_key(xlabel_standoff, key)
        if xstandoff is not None:
            x_update["title_standoff"] = xstandoff
        if x_update:
            fig.update_xaxes(**x_update, row=i, col=1)

    if shared_xaxes:  # hide x tick labels except the bottom row
        for i in range(1, n):
            fig.update_xaxes(showticklabels=False, row=i, col=1)

    if shared_vlines:
        for x0 in shared_vlines:
            try:
                fig.add_vline(x=x0, row="all", col=1, line_dash="dash",
                              line_width=1)
            except TypeError:  # older plotly: one per row
                for i in range(1, n + 1):
                    fig.add_vline(x=x0, row=i, col=1, line_dash="dash",
                                  line_width=1)

    fig.update_layout(
        width=width, height=fig_height, showlegend=showlegend,
        margin=dict(t=title_top_margin, r=10, b=10, l=10),
        **layout_kwargs,
    )
    fig.for_each_annotation(lambda a: a.update(yshift=annotation_yshift))
    set_plotly_fonts(fig, size=font_size)
    return fig


def add_vertical_shades(fig, intvl_l, ep=None, *, exclude=None,
                        fillcolor="red", opacity=0.25, line_width=0,
                        line_dash=None, layer="above", **vrect_kwargs):
    """Shade interval spans across all subplots of a plotly figure
    (reference plot_helper.py:358-408)."""
    _require_plotly()
    if hasattr(intvl_l, "start"):
        pairs = list(zip(np.asarray(intvl_l.start), np.asarray(intvl_l.end)))
    else:
        pairs = [tuple(p) for p in np.atleast_2d(np.asarray(intvl_l))]
    if ep is not None:
        lo, hi = float(ep.start[0]), float(ep.end[0])
        pairs = [(max(s, lo), min(e, hi)) for s, e in pairs
                 if e > lo and s < hi]
    if exclude is not None:
        pairs = [p for i, p in enumerate(pairs) if i not in set(exclude)]
    line = dict(width=line_width)
    if line_dash is not None:
        line["dash"] = line_dash
    for s, e in pairs:
        fig.add_vrect(x0=s, x1=e, fillcolor=fillcolor, opacity=opacity,
                      line=line, layer=layer, **vrect_kwargs)
    return fig


def set_plotly_fonts(fig, family="Arial", size=12, title_size=None,
                     tick_size=None, legend_size=None):
    """Uniform font styling across a plotly figure
    (reference plot_helper.py:494-544)."""
    _require_plotly()
    fig.update_layout(font=dict(family=family, size=size))
    if title_size is not None:
        fig.update_layout(title_font_size=title_size)
    if tick_size is not None:
        fig.update_xaxes(tickfont_size=tick_size)
        fig.update_yaxes(tickfont_size=tick_size)
    if legend_size is not None:
        fig.update_layout(legend_font_size=legend_size)
    return fig
