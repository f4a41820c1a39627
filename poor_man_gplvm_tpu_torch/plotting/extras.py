"""Additional plotting utilities: rasters, 3-D scatter animation, bootstrap
error bands, significance stars, multipage export.

The port's own copy of ``poor_man_gplvm_tpu/plotting/extras.py`` (the
unique utilities of reference poor_man_gplvm/_plot_helper_backup.py):
matplotlib and sklearn are imported inside the functions that use them.
"""

from __future__ import annotations

import numpy as np

from poor_man_gplvm_tpu_torch.plotting.core import (
    _np,
    _pyplot,
    save_fig,
    subplots_wrapper,
)

__all__ = [
    "p_to_star",
    "turn_off_spines",
    "plot_rasterplot",
    "diverging_heatmap",
    "mean_bootstraperror_lineplot",
    "plot_multipage_wrapper",
    "animate_3d_scatter",
    "plot_pca3d",
]


def p_to_star(p_value):
    """Significance stars from a p-value — the reference's exact tiers
    with inclusive upper bounds and a '****' tier
    (reference _plot_helper_backup.py:23-34)."""
    if p_value <= 0.0001:
        return "****"
    if p_value <= 0.001:
        return "***"
    if p_value <= 0.01:
        return "**"
    if p_value <= 0.05:
        return "*"
    return "n.s."


def turn_off_spines(ax=None, to_turn=("top", "right", "left")):
    """Hide the listed axis spines
    (reference _plot_helper_backup.py:51-57)."""
    plt = _pyplot()

    if ax is None:
        ax = plt.gca()
    for side in to_turn:
        ax.spines[side].set_visible(False)
    return ax


def plot_rasterplot(event_l=None, binary_mat=None, x_index=None, y_index=None,
                    fig=None, ax=None, s=2, color="k", **kwargs):
    """Spike raster from either per-unit event lists or a binary matrix
    (reference _plot_helper_backup.py:59-109)."""
    plt = _pyplot()

    if ax is None:
        fig, ax = plt.subplots()
    if event_l is not None:
        for i, events in enumerate(event_l):
            events = np.asarray(events)
            ax.scatter(events, np.full(len(events), i), s=s, color=color,
                       marker="|", **kwargs)
    elif binary_mat is not None:
        binary_mat = _np(binary_mat)
        tt, uu = np.nonzero(binary_mat)
        x = tt if x_index is None else np.asarray(x_index)[tt]
        y = uu if y_index is None else np.asarray(y_index)[uu]
        ax.scatter(x, y, s=s, color=color, marker="|", **kwargs)
    else:
        raise ValueError("provide event_l or binary_mat")
    ax.set_xlabel("Time")
    ax.set_ylabel("Unit")
    return fig, ax


def diverging_heatmap(X, quantile=0.99, ax=None, fig=None, cmap="RdBu_r",
                      **kwargs):
    """Heatmap with symmetric color limits at the given quantile
    (reference _plot_helper_backup.py:111-114)."""
    plt = _pyplot()

    X = _np(X)
    if ax is None:
        fig, ax = plt.subplots()
    vmax = np.nanquantile(np.abs(X), quantile)
    im = ax.imshow(X, aspect="auto", cmap=cmap, vmin=-vmax, vmax=vmax,
                   **kwargs)
    return fig, ax, im


def mean_bootstraperror_lineplot(data_sample, data=None, xs=None, ci=0.95,
                                 fig=None, ax=None, n_boot=1000, rng=None,
                                 **kwargs):
    """Mean trace with a bootstrap confidence band
    (reference _plot_helper_backup.py:154-178)."""
    plt = _pyplot()

    rng = np.random.default_rng(rng)
    data_sample = _np(data_sample, dtype=float)
    if ax is None:
        fig, ax = plt.subplots()
    if xs is None:
        xs = np.arange(data_sample.shape[1])
    mean = np.nanmean(data_sample, axis=0) if data is None else np.asarray(data)
    boots = np.array(
        [
            np.nanmean(
                data_sample[rng.integers(0, len(data_sample),
                                         len(data_sample))], axis=0
            )
            for _ in range(n_boot)
        ]
    )
    alpha = (1 - ci) / 2
    lo = np.nanpercentile(boots, 100 * alpha, axis=0)
    hi = np.nanpercentile(boots, 100 * (1 - alpha), axis=0)
    ax.plot(xs, mean, **kwargs)
    ax.fill_between(xs, lo, hi, alpha=0.3, color=kwargs.get("c"))
    return fig, ax


def plot_multipage_wrapper(plot_one_func, data_all, title_all=None,
                           func_args=(), func_kwargs=None, nplots_per_page=20,
                           fig_save_fn="fig_temp", fig_save_dir="./"):
    """Paginate many per-item plots into saved multi-panel figures
    (reference _plot_helper_backup.py:180-217)."""
    plt = _pyplot()

    func_kwargs = func_kwargs or {}
    n_items = len(data_all)
    n_pages = -(-n_items // nplots_per_page)
    paths = []
    for page in range(n_pages):
        lo, hi = page * nplots_per_page, min((page + 1) * nplots_per_page,
                                             n_items)
        fig, axs = subplots_wrapper(hi - lo)
        for k, idx in enumerate(range(lo, hi)):
            ax = axs.ravel()[k]
            plot_one_func(data_all[idx], *func_args, fig=fig, ax=ax,
                          **func_kwargs)
            if title_all is not None:
                ax.set_title(title_all[idx])
        paths += save_fig(fig, f"{fig_save_fn}_page{page}", fig_save_dir,
                          fig_format=["png"])
        plt.close(fig)
    return paths


def animate_3d_scatter(data, legend_handles=None, color_l=None, marker_l=None,
                       fig=None, ax=None, ax_kws=None, animate_kws=None,
                       dosave=False, save_path="animation.gif"):
    """Rotating/incremental 3-D scatter animation of a (T, 3) trajectory
    (reference _plot_helper_backup.py:222-264)."""
    plt = _pyplot()
    from matplotlib.animation import FuncAnimation

    data = _np(data)
    ax_kws = ax_kws or {}
    kws = {"frames": data.shape[0], "interval": 50, "blit": False}
    kws.update(animate_kws or {})

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d", **ax_kws)
    if color_l is None:
        color_l = plt.cm.Spectral_r(np.linspace(0, 1, data.shape[0]))

    scat = ax.scatter([], [], [], s=8)
    ax.set_xlim(np.nanmin(data[:, 0]), np.nanmax(data[:, 0]))
    ax.set_ylim(np.nanmin(data[:, 1]), np.nanmax(data[:, 1]))
    ax.set_zlim(np.nanmin(data[:, 2]), np.nanmax(data[:, 2]))
    if legend_handles is not None:
        ax.legend(handles=legend_handles)

    def init():
        return (scat,)

    def animate(frame):
        pts = data[: frame + 1]
        scat._offsets3d = (pts[:, 0], pts[:, 1], pts[:, 2])
        scat.set_color(color_l[: frame + 1])
        return (scat,)

    ani = FuncAnimation(fig, animate, init_func=init, **kws)
    if dosave:
        ani.save(save_path)
    return fig, ax, ani


def plot_pca3d(toplot, color=None, marker=None, fig=None, ax=None):
    """3-D PCA projection scatter (reference _plot_helper_backup.py:266-290)."""
    plt = _pyplot()
    from sklearn.decomposition import PCA

    toplot = _np(toplot)
    proj = PCA(n_components=3).fit_transform(toplot)
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    ax.scatter(proj[:, 0], proj[:, 1], proj[:, 2],
               c=color if color is not None else np.arange(len(proj)),
               marker=marker or "o", cmap="Spectral_r", s=8)
    ax.set_xlabel("PC1")
    ax.set_ylabel("PC2")
    ax.set_zlabel("PC3")
    return fig, ax, proj
