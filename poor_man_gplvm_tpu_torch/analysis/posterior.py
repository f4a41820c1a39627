"""Post-fit posterior analyses: weighted averages, state intervals,
peri-event signals, population-vector distances, sequence matching.

The port's own copy of ``poor_man_gplvm_tpu/analysis/posterior.py``.  The
functions take the port's decode results as they come: a ``TsdFrame``/
``Tsd`` of the port's ``utils.timeseries`` (or pynapple's, where it is
installed; ``utils.compat``), or tensors on the card, which are copied to
the host (``compat.to_numpy``).  The numbers are computed in numpy on the
host, as in the JAX package.  Where the JAX function returns a pandas
object this returns a ``ResultTable`` (``to_dataframe()``/``to_series()``
give the JAX object); ``get_peri_event_with_shuffle`` shows no progress
bar (``verbose`` is accepted and prints nothing).
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import scipy.stats

from poor_man_gplvm_tpu_torch.utils import compat
from poor_man_gplvm_tpu_torch.utils.table import ResultTable

__all__ = [
    "get_posterior_weighted_average",
    "get_state_interval",
    "shift_timestamp",
    "get_peri_event_with_shuffle",
    "get_consecutive_pv_distance",
    "get_sequence_occurence",
]


def _is_pynapple(nap):
    return nap.__name__ == "pynapple"


def get_posterior_weighted_average(feature, posterior):
    """Occupancy-normalized posterior-weighted average of a feature.

    feature: Tsd or TsdFrame; posterior: TsdFrame (latent or dynamics).
    Returns a one-column ``ResultTable`` (the JAX Series, ``to_series()``)
    for a 1-D feature, else a ``ResultTable`` of one column per feature
    column (the JAX DataFrame), indexed by the posterior's columns."""
    time_support = feature.time_support.union(posterior.time_support)
    feature = feature.restrict(time_support)
    posterior = posterior.restrict(time_support)
    feature_aligned = feature.interpolate(posterior)
    post_d = compat.to_numpy(posterior.d)
    feat_d = compat.to_numpy(feature_aligned.d)
    columns = np.asarray(getattr(posterior, "columns",
                                 np.arange(post_d.shape[1])))
    # zero-occupancy states (posterior never visits them) have no defined
    # average: NaN, not a divide RuntimeWarning
    occ = post_d.sum(axis=0)
    occ = np.where(occ > 0, occ, np.nan)
    if feat_d.ndim == 1:
        pwa = (post_d * feat_d[:, None]).sum(axis=0) / occ
        return ResultTable({None: pwa}, index=[columns])
    pwa = np.einsum("tp,tf->pf", post_d, feat_d) / occ[:, None]
    names = getattr(feature_aligned, "columns", None)
    names = range(pwa.shape[1]) if names is None else names
    return ResultTable({c: pwa[:, j] for j, c in enumerate(names)},
                       index=[columns])


def get_state_interval(p_l, p_thresh=0.8, merge_thresh=1, duration_thresh=2):
    """Threshold a state probability, merge close intervals, drop short
    ones."""
    nap = compat.timeseries_module()
    intv = p_l.threshold(p_thresh).time_support
    intv_merge = intv.merge_close_intervals(merge_thresh)
    starts = np.asarray(intv_merge.start)
    ends = np.asarray(intv_merge.end)
    keep = (ends - starts) > duration_thresh
    return nap.IntervalSet(starts[keep], ends[keep])


def shift_timestamp(ts, time_support=None, rng=None):
    """Shift all timestamps by one uniform random offset, wrapping around
    the time support."""
    nap = compat.timeseries_module()
    rng = np.random.default_rng(rng)
    if time_support is None:
        time_support = [ts.t[0], ts.t[-1]]
    shift = rng.uniform(time_support[0], time_support[1])
    t_shift = ts.t + shift
    below = t_shift < time_support[0]
    above = t_shift > time_support[1]
    t_shift[below] = t_shift[below] - time_support[0] + time_support[1]
    t_shift[above] = t_shift[above] - time_support[1] + time_support[0]
    return nap.Ts(t=np.sort(t_shift))


def _peri(nap, feature_tsd, event_ts, minmax, do_zscore):
    """The (n_event, n_time) peri-event matrix and its time labels; z-scored
    per event (a plain array, as scipy's zscore of the JAX frame gives)
    or as a ``ResultTable`` indexed by event, columns the relative times."""
    if _is_pynapple(nap):  # pragma: no cover - environment dependent
        pe = nap.compute_perievent_continuous(
            timeseries=feature_tsd, tref=event_ts, minmax=minmax)
        values, rel = np.asarray(pe.values).T, np.asarray(pe.index)
    else:
        pe = nap.compute_perievent_continuous(feature_tsd, event_ts, minmax)
        values, rel = np.asarray(pe.d).T, np.asarray(pe.rel_times)
    if do_zscore:
        # in C order, as the JAX frame's values come: the per-event sums
        # then add in its order
        return scipy.stats.zscore(np.ascontiguousarray(values), axis=1), None
    table = ResultTable({c: values[:, j] for j, c in enumerate(rel)},
                        index=[np.arange(values.shape[0])])
    return table, values


def _nan_skipping_mean(values):
    """Column means over the rows that are not NaN (NaN where none is)."""
    valid = ~np.isnan(values)
    n = valid.sum(axis=0)
    total = np.where(valid, values, 0.0).sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(n > 0, total / np.maximum(n, 1), np.nan)


def get_peri_event_with_shuffle(
    feature_tsd, event_ts, n_shuffle=100, minmax=4, do_zscore=True,
    return_full_shuffle=False, verbose=True, rng=None,
):
    """Peri-event signal + circularly-shifted-event null.

    Returns (peri-event (n_event, n_time), the shuffles' means
    (n_shuffle, n_time) as a ``ResultTable``, or the list of full
    shuffles).  Z-scored results are arrays, as in the JAX package;
    otherwise tables whose columns are the relative times."""
    nap = compat.timeseries_module()
    rng = np.random.default_rng(rng)
    trim = (feature_tsd.t[0] + minmax, feature_tsd.t[-1] - minmax)
    keep = (event_ts.t > trim[0]) & (event_ts.t < trim[1])
    event_ts = nap.Ts(event_ts.t[keep])

    peri, _ = _peri(nap, feature_tsd, event_ts, minmax, do_zscore)

    peri_sh_l, labels = [], None
    for _ in range(n_shuffle):
        if _is_pynapple(nap):  # pragma: no cover
            ev_sh = nap.shift_timestamps(event_ts, min_shift=1.0,
                                         max_shift=10.0)
        else:
            ev_sh = nap.shift_timestamps(
                event_ts, min_shift=1.0, max_shift=10.0,
                rng=rng.integers(2**31),
            )
        keep = (ev_sh.t > trim[0]) & (ev_sh.t < trim[1])
        ev_sh = nap.Ts(ev_sh.t[keep])
        sh, values = _peri(nap, feature_tsd, ev_sh, minmax, do_zscore)
        if return_full_shuffle:
            peri_sh_l.append(sh)
            continue
        if values is None:
            peri_sh_l.append(np.mean(sh, axis=0))
        else:  # the frame's mean skips NaN, as DataFrame.mean does
            labels = sh.columns
            peri_sh_l.append(_nan_skipping_mean(values))
    if n_shuffle > 0 and not return_full_shuffle:
        means = np.array(peri_sh_l).reshape(n_shuffle, -1)
        labels = range(means.shape[1]) if labels is None else labels
        peri_sh_l = ResultTable({c: means[:, j]
                                 for j, c in enumerate(labels)})
    return peri, peri_sh_l


def _pairwise_similarity_distance(x1, x2):
    numerator = np.sum(x1 * x2, axis=1)
    norm1 = np.linalg.norm(x1, axis=1)
    norm2 = np.linalg.norm(x2, axis=1)
    denom = norm1 * norm2
    with np.errstate(invalid="ignore", divide="ignore"):
        sim = np.divide(
            numerator, denom, out=np.zeros_like(numerator), where=denom > 0
        )
    dist = 1 - sim
    is_zero1 = norm1 <= 1e-12
    is_zero2 = norm2 <= 1e-12
    dist[is_zero1 & is_zero2] = 0.0
    dist[is_zero1 ^ is_zero2] = 2.0
    return dist


def get_consecutive_pv_distance(X, smooth_window=None, metric="cosine"):
    """Distance between consecutive population vectors with zero-norm edge
    handling; ``X`` a TsdFrame, an array or a tensor (T, N)."""
    nap = compat.timeseries_module()
    is_tsd = compat.is_tsdframe(X)
    if is_tsd:
        if smooth_window is not None:
            X = X.smooth(smooth_window)
        X_ = np.asarray(X.d, dtype=float)
    else:
        X_ = compat.to_numpy(X).astype(float)
        if smooth_window is not None:
            X_ = scipy.ndimage.gaussian_filter1d(X_, smooth_window)
    x1, x2 = X_[:-1], X_[1:]

    if metric == "euclidean":
        dist = np.linalg.norm(x2 - x1, axis=1)
    elif metric == "cosine":
        dist = _pairwise_similarity_distance(x1, x2)
    elif metric == "correlation":
        dist = _pairwise_similarity_distance(
            x1 - x1.mean(axis=1, keepdims=True),
            x2 - x2.mean(axis=1, keepdims=True),
        )
    else:
        raise ValueError(f"Unknown metric: {metric}")

    if is_tsd:
        return nap.Tsd(t=X.t[1:], d=dist)
    return dist


def get_sequence_occurence(sequence, post_latent_map, latent_distance_thresh=1):
    """Vectorized sliding-window match of a latent sequence in the MAP path
    (a Tsd, an array or a tensor).

    Returns (occurrence Ts, occurrence indices)."""
    nap = compat.timeseries_module()
    sequence = np.array(sequence)
    seq_len = len(sequence)

    if compat.is_tsd_like(post_latent_map):
        data = np.asarray(post_latent_map.d)
        times = post_latent_map.t
    else:
        data = compat.to_numpy(post_latent_map)
        times = None

    if len(data) < seq_len:
        return nap.Ts(np.array([])), np.array([], dtype=int)

    matches = np.ones(len(data) - seq_len + 1, dtype=bool)
    for offset, target_val in enumerate(sequence):
        matches &= (
            np.abs(data[offset : offset + len(matches)] - target_val)
            <= latent_distance_thresh
        )
    idx = np.nonzero(matches)[0]
    if times is not None:
        return nap.Ts(times[idx]), idx
    return nap.Ts(idx.astype(float)), idx
