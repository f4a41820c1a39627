"""Minimal time-series containers (a pynapple-compatible subset).

The port's own copy of ``poor_man_gplvm_tpu/utils/timeseries.py``: the
JAX package's module imports no JAX itself, but importing it runs that
package's ``__init__``, which does, and the card's machine has neither JAX
nor pynapple.  numpy only; scipy is imported inside the functions that
need it and pandas inside ``_PeriEvent.as_dataframe``.  When pynapple is
installed, :mod:`poor_man_gplvm_tpu_torch.utils.compat` prefers it.

Implemented: ``Ts``, ``Tsd``, ``TsdFrame``, ``IntervalSet`` with
``restrict``, ``threshold``, ``time_support``, ``value_from``, ``get_slice``,
``merge_close_intervals``, ``set_diff``, ``intersect``, ``union``; and
``TsGroup``, ``compute_perievent_continuous``, ``apply_lowpass_filter``,
``shift_timestamps``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "IntervalSet",
    "Ts",
    "Tsd",
    "TsdFrame",
    "TsGroup",
    "compute_perievent_continuous",
    "apply_lowpass_filter",
    "shift_timestamps",
]


class IntervalSet:
    """A set of [start, end] intervals (pynapple-compatible subset)."""

    def __init__(self, start, end=None):
        if end is None:
            start = np.atleast_2d(np.asarray(start, dtype=float))
            self.start = start[:, 0].copy()
            self.end = start[:, 1].copy()
        else:
            self.start = np.atleast_1d(np.asarray(start, dtype=float)).copy()
            self.end = np.atleast_1d(np.asarray(end, dtype=float)).copy()
        order = np.argsort(self.start)
        self.start, self.end = self.start[order], self.end[order]

    def __len__(self):
        return len(self.start)

    def __iter__(self):
        for s, e in zip(self.start, self.end):
            yield IntervalSet(np.array([s]), np.array([e]))

    def __getitem__(self, i):
        return IntervalSet(np.atleast_1d(self.start[i]), np.atleast_1d(self.end[i]))

    def __repr__(self):
        return f"IntervalSet(n={len(self)}, start={self.start}, end={self.end})"

    @property
    def values(self):
        return np.stack([self.start, self.end], axis=1)

    def tot_length(self):
        return float(np.sum(self.end - self.start))

    def merge_close_intervals(self, threshold):
        """Merge intervals whose gap is <= threshold."""
        if len(self) == 0:
            return IntervalSet(np.empty(0), np.empty(0))
        starts, ends = [self.start[0]], [self.end[0]]
        for s, e in zip(self.start[1:], self.end[1:]):
            if s - ends[-1] <= threshold:
                ends[-1] = max(ends[-1], e)
            else:
                starts.append(s)
                ends.append(e)
        return IntervalSet(np.array(starts), np.array(ends))

    def union(self, other):
        allint = np.concatenate(
            [self.values, other.values], axis=0
        ) if len(other) else self.values
        if len(allint) == 0:
            return IntervalSet(np.empty(0), np.empty(0))
        order = np.argsort(allint[:, 0])
        allint = allint[order]
        starts, ends = [allint[0, 0]], [allint[0, 1]]
        for s, e in allint[1:]:
            if s <= ends[-1]:
                ends[-1] = max(ends[-1], e)
            else:
                starts.append(s)
                ends.append(e)
        return IntervalSet(np.array(starts), np.array(ends))

    def intersect(self, other):
        # both sets are sorted and disjoint, so each of self's intervals
        # overlaps a contiguous run of other's — searchsorted finds the
        # run bounds and the pairs expand vectorized (O((n+m) log m);
        # the nested-loop version went quadratic on noisy long traces,
        # e.g. Tsd.threshold of a 1e6-sample trace over a 1e3-epoch
        # support)
        s1, e1 = np.asarray(self.start), np.asarray(self.end)
        s2, e2 = np.asarray(other.start), np.asarray(other.end)
        if len(s1) == 0 or len(s2) == 0:
            return IntervalSet(np.empty(0), np.empty(0))
        lo = np.searchsorted(e2, s1, side="left")   # first j: e2[j] >= s1[i]
        hi = np.searchsorted(s2, e1, side="right")  # first j: s2[j] >  e1[i]
        counts = np.maximum(hi - lo, 0)
        total = int(counts.sum())
        if total == 0:
            return IntervalSet(np.empty(0), np.empty(0))
        i_idx = np.repeat(np.arange(len(s1)), counts)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        j_idx = np.arange(total) - np.repeat(offsets, counts) \
            + np.repeat(lo, counts)
        starts = np.maximum(s1[i_idx], s2[j_idx])
        ends = np.minimum(e1[i_idx], e2[j_idx])
        keep = starts <= ends
        return IntervalSet(starts[keep], ends[keep])

    def set_diff(self, other):
        """Intervals of self not covered by other."""
        starts, ends = [], []
        for s1, e1 in zip(self.start, self.end):
            pieces = [(s1, e1)]
            for s2, e2 in zip(other.start, other.end):
                new_pieces = []
                for ps, pe in pieces:
                    if e2 <= ps or s2 >= pe:
                        new_pieces.append((ps, pe))
                        continue
                    if s2 > ps:
                        new_pieces.append((ps, s2))
                    if e2 < pe:
                        new_pieces.append((e2, pe))
                pieces = new_pieces
            for ps, pe in pieces:
                if pe > ps:
                    starts.append(ps)
                    ends.append(pe)
        return IntervalSet(np.array(starts), np.array(ends))

    def in_interval(self, t):
        """Interval membership.  Given raw timestamps, returns a boolean
        mask; given a Tsd/TsdFrame (pynapple-compatible call), returns the
        per-sample interval INDEX (NaN outside all intervals)."""
        if isinstance(t, _TimeIndexed):
            tt = np.asarray(t.t)
            label = np.full(tt.shape, np.nan)
            for k, (s, e) in enumerate(zip(self.start, self.end)):
                label[(tt >= s) & (tt <= e)] = k
            return label
        t = np.asarray(t)
        mask = np.zeros(t.shape, dtype=bool)
        for s, e in zip(self.start, self.end):
            mask |= (t >= s) & (t <= e)
        return mask


class _TimeIndexed:
    """Shared base for Ts/Tsd/TsdFrame."""

    def __init__(self, t, time_support=None):
        self.t = np.asarray(t, dtype=float)
        if time_support is None and len(self.t):
            time_support = IntervalSet(
                np.array([self.t[0]]), np.array([self.t[-1]])
            )
        elif time_support is None:
            time_support = IntervalSet(np.empty(0), np.empty(0))
        self.time_support = time_support

    def __len__(self):
        return len(self.t)

    @property
    def index(self):
        return self.t

    def get_slice(self, start, end):
        """Positional slice of timestamps within [start, end]
        (pynapple Ts.get_slice subset)."""
        i0 = int(np.searchsorted(self.t, start, side="left"))
        i1 = int(np.searchsorted(self.t, end, side="right"))
        return slice(i0, i1)


class Ts(_TimeIndexed):
    def __init__(self, t, time_support=None):
        super().__init__(t, time_support)

    def value_from(self, tsd):
        """Nearest-timestamp value lookup (pynapple Ts.value_from subset):
        for each of self's timestamps inside tsd's time support, take the
        value of tsd at the closest timestamp."""
        mask = tsd.time_support.in_interval(self.t)
        t_sel = self.t[mask]
        idx = np.searchsorted(tsd.t, t_sel)
        idx = np.clip(idx, 1, len(tsd.t) - 1)
        left = tsd.t[idx - 1]
        right = tsd.t[idx]
        idx = np.where(np.abs(t_sel - left) <= np.abs(t_sel - right), idx - 1, idx)
        d = np.asarray(tsd.d)[idx]
        cls = TsdFrame if d.ndim == 2 else Tsd
        return cls(d=d, t=t_sel)

    def restrict(self, ep):
        return Ts(self.t[ep.in_interval(self.t)], time_support=ep)


class Tsd(_TimeIndexed):
    """1-D time series."""

    def __init__(self, d=None, t=None, time_support=None):
        super().__init__(t, time_support)
        self.d = np.asarray(d)

    @property
    def values(self):
        return self.d

    def __array__(self, dtype=None):
        return np.asarray(self.d, dtype=dtype)

    def __getitem__(self, key):
        out = self.d[key]
        if np.ndim(out) == 1 and isinstance(key, slice):
            return Tsd(d=out, t=self.t[key])
        return out

    def __setitem__(self, key, value):
        self.d[key] = value

    def copy(self):
        return Tsd(d=self.d.copy(), t=self.t.copy(), time_support=self.time_support)

    def restrict(self, ep):
        mask = ep.in_interval(self.t)
        return Tsd(d=self.d[mask], t=self.t[mask], time_support=ep)

    def threshold(self, th, method="above"):
        """Samples above (or below) threshold; time_support becomes the
        contiguous runs where the condition holds."""
        if method == "above":
            cond = self.d > th
        elif method == "aboveequal":
            cond = self.d >= th
        elif method == "belowequal":
            cond = self.d <= th
        else:
            cond = self.d < th
        runs = _contiguous_runs(cond)
        starts = np.array([self.t[a] for a, b in runs])
        ends = np.array([self.t[b - 1] for a, b in runs])
        # index-adjacency runs alone over-merge on an already-restricted
        # Tsd (e.g. a second chained .threshold): two samples adjacent in
        # self.t can straddle a gap in self.time_support.  Intersecting
        # with the existing support splits such runs at the gaps, matching
        # pynapple (threshold epochs live inside the parent's support).
        support = IntervalSet(starts, ends).intersect(self.time_support)
        return Tsd(d=self.d[cond], t=self.t[cond], time_support=support)

    def value_from(self, tsd):
        return Ts(self.t).value_from(tsd)

    def interpolate(self, target):
        """Linear interpolation of self's values at target's timestamps
        (pynapple Tsd.interpolate subset: target is a time-indexed object)."""
        t_new = np.asarray(target.t)
        return Tsd(d=np.interp(t_new, self.t, np.asarray(self.d, dtype=float)),
                   t=t_new)

    def smooth(self, std):
        """Gaussian smoothing with std in time units (pynapple subset)."""
        from scipy.ndimage import gaussian_filter1d

        dt = np.median(np.diff(self.t)) if len(self.t) > 1 else 1.0
        return Tsd(
            d=gaussian_filter1d(np.asarray(self.d, dtype=float), std / dt),
            t=self.t, time_support=self.time_support,
        )

    def derivative(self):
        """Time derivative via central differences (pynapple subset)."""
        return Tsd(
            d=np.gradient(np.asarray(self.d, dtype=float), self.t),
            t=self.t, time_support=self.time_support,
        )

    def to_numpy(self):
        return np.asarray(self.d)


class TsdFrame(_TimeIndexed):
    """2-D time series (time x columns)."""

    def __init__(self, d=None, t=None, columns=None, time_support=None):
        super().__init__(t, time_support)
        self.d = np.asarray(d)
        if columns is None:
            columns = np.arange(self.d.shape[1]) if self.d.ndim == 2 else None
        self.columns = columns

    @property
    def values(self):
        return self.d

    @property
    def shape(self):
        return self.d.shape

    def __array__(self, dtype=None):
        return np.asarray(self.d, dtype=dtype)

    def _col_index(self, name):
        cols = list(self.columns) if self.columns is not None else []
        return cols.index(name)

    def __getitem__(self, key):
        if isinstance(key, str):
            return Tsd(d=self.d[:, self._col_index(key)], t=self.t,
                       time_support=self.time_support)
        if (isinstance(key, list)
                and key and all(isinstance(k, str) for k in key)):
            idx = [self._col_index(k) for k in key]
            return TsdFrame(d=self.d[:, idx], t=self.t, columns=key,
                            time_support=self.time_support)
        if isinstance(key, tuple):
            rows, cols = key
            out = self.d[rows, cols]
            if np.ndim(out) == 1 and isinstance(rows, slice):
                return Tsd(d=out, t=self.t[rows])
            if np.ndim(out) == 2:
                return TsdFrame(d=out, t=self.t[rows])
            return out
        if isinstance(key, np.ndarray) and key.dtype == bool:
            # keep the parent's time_support: rebuilding the default
            # [t_first, t_last] span would merge across epoch gaps the
            # parent restriction excluded (pynapple preserves restriction)
            return TsdFrame(d=self.d[key], t=self.t[key],
                            columns=self.columns,
                            time_support=self.time_support)
        out = self.d[key]
        if isinstance(key, slice):
            if np.ndim(out) == 2:
                return TsdFrame(d=out, t=self.t[key], columns=self.columns)
            return Tsd(d=out, t=self.t[key])
        return out

    def __setitem__(self, key, value):
        self.d[key] = value

    def copy(self):
        return TsdFrame(
            d=self.d.copy(), t=self.t.copy(), time_support=self.time_support
        )

    def restrict(self, ep):
        mask = ep.in_interval(self.t)
        return TsdFrame(d=self.d[mask], t=self.t[mask], time_support=ep)

    def interpolate(self, target):
        t_new = np.asarray(target.t)
        d = np.asarray(self.d, dtype=float)
        out = np.column_stack(
            [np.interp(t_new, self.t, d[:, j]) for j in range(d.shape[1])]
        )
        return TsdFrame(d=out, t=t_new, columns=self.columns)

    def smooth(self, std):
        from scipy.ndimage import gaussian_filter1d

        dt = np.median(np.diff(self.t)) if len(self.t) > 1 else 1.0
        return TsdFrame(
            d=gaussian_filter1d(
                np.asarray(self.d, dtype=float), std / dt, axis=0
            ),
            t=self.t, columns=self.columns, time_support=self.time_support,
        )

    def to_numpy(self):
        return np.asarray(self.d)


def _contiguous_runs(cond):
    """Return [(start, stop), ...) index pairs for runs of True in cond."""
    cond = np.asarray(cond, dtype=bool)
    if not cond.any():
        return []
    padded = np.concatenate([[False], cond, [False]])
    diff = np.diff(padded.astype(int))
    starts = np.nonzero(diff == 1)[0]
    stops = np.nonzero(diff == -1)[0]
    return list(zip(starts, stops))


class _PeriEvent:
    """Result wrapper for compute_perievent_continuous (pynapple-compatible
    .as_dataframe(): index = relative time, columns = events)."""

    def __init__(self, values, rel_times):
        self.d = values  # (n_rel_time, n_event)
        self.rel_times = rel_times

    def as_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.d, index=self.rel_times)


def _nearest_index(t, events):
    """For each event, the index ``argmin(|t - event|)`` gives (the first
    of equal distances).  On ascending times without NaN it is found by
    bisection, between the two neighbours of the event; else by the
    scan."""
    events = np.asarray(events, dtype=float)
    if len(t) == 0 or np.isnan(t).any() or np.isnan(events).any() or (
            np.diff(t) < 0).any():
        return [int(np.argmin(np.abs(t - ev))) for ev in events]
    idx = np.searchsorted(t, events, side="left")
    left = np.clip(idx - 1, 0, len(t) - 1)
    right = np.clip(idx, 0, len(t) - 1)
    pick = np.where(np.abs(t[left] - events) <= np.abs(t[right] - events),
                    left, right)
    # the first index that holds the nearest time
    return np.searchsorted(t, t[pick], side="left").tolist()


def compute_perievent_continuous(timeseries, tref, minmax):
    """Align a continuous signal around each event time (pynapple
    compute_perievent_continuous subset): samples on the signal's own grid in
    [t_ref - minmax, t_ref + minmax]. Returns (n_rel_time, n_event)."""
    t = np.asarray(timeseries.t)
    d = np.asarray(timeseries.d, dtype=float)
    dt = np.median(np.diff(t)) if len(t) > 1 else 1.0
    n_half = int(round(minmax / dt))
    rel = (np.arange(2 * n_half + 1) - n_half) * dt
    events = np.asarray(tref.t if hasattr(tref, "t") else tref)
    out = np.full((len(rel), len(events)), np.nan)
    for k, c in enumerate(_nearest_index(t, events)):
        lo, hi = c - n_half, c + n_half + 1
        src_lo, src_hi = max(lo, 0), min(hi, len(t))
        out[src_lo - lo : src_lo - lo + (src_hi - src_lo), k] = d[src_lo:src_hi]
    return _PeriEvent(out, rel)


def apply_lowpass_filter(tsd, cutoff, order=4):
    """Zero-phase Butterworth low-pass filter (pynapple subset);
    cutoff in Hz."""
    from scipy.signal import butter, filtfilt

    fs = 1.0 / np.median(np.diff(tsd.t))
    b, a = butter(order, cutoff / (fs / 2), btype="low")
    d = filtfilt(b, a, np.asarray(tsd.d, dtype=float), axis=0)
    if d.ndim == 2:
        return TsdFrame(d=d, t=tsd.t, columns=getattr(tsd, "columns", None),
                        time_support=tsd.time_support)
    return Tsd(d=d, t=tsd.t, time_support=tsd.time_support)


def shift_timestamps(ts, min_shift=1.0, max_shift=10.0, rng=None):
    """Circularly shift all timestamps by one random offset in
    [min_shift, max_shift], wrapping inside the time support (pynapple
    shift_timestamps subset)."""
    rng = np.random.default_rng(rng)
    lo = ts.time_support.start[0]
    hi = ts.time_support.end[0]
    shift = rng.uniform(min_shift, max_shift)
    t_new = ts.t + shift
    span = hi - lo
    t_new = lo + np.mod(t_new - lo, span)
    return Ts(np.sort(t_new), time_support=ts.time_support)


class TsGroup:
    """Minimal dict-of-spike-trains container (pynapple TsGroup subset):
    restrict, count, rate."""

    def __init__(self, data, time_support=None):
        self.data = {k: (v if isinstance(v, Ts) else Ts(np.asarray(v)))
                     for k, v in data.items()}
        if time_support is None:
            lo = min((ts.t[0] for ts in self.data.values() if len(ts)), default=0.0)
            hi = max((ts.t[-1] for ts in self.data.values() if len(ts)), default=1.0)
            time_support = IntervalSet(np.array([lo]), np.array([hi]))
        self.time_support = time_support

    def keys(self):
        return self.data.keys()

    def __getitem__(self, k):
        return self.data[k]

    def restrict(self, ep):
        return TsGroup(
            {k: Ts(ts.t[ep.in_interval(ts.t)]) for k, ts in self.data.items()},
            time_support=ep,
        )

    def count(self, bin_size):
        """Spike counts per unit in bins of bin_size over the time support.
        Returns TsdFrame (n_bins, n_units) with bin-center timestamps."""
        edges_all, centers_all = [], []
        for s, e in zip(self.time_support.start, self.time_support.end):
            n_bins = max(int(np.ceil((e - s) / bin_size)), 1)
            edges = s + np.arange(n_bins + 1) * bin_size
            edges_all.append(edges)
            centers_all.append(0.5 * (edges[:-1] + edges[1:]))
        centers = np.concatenate(centers_all)
        mat = np.zeros((len(centers), len(self.data)))
        for j, (k, ts) in enumerate(self.data.items()):
            offset = 0
            for edges in edges_all:
                h, _ = np.histogram(ts.t, bins=edges)
                mat[offset : offset + len(h), j] = h
                offset += len(h)
        return TsdFrame(d=mat, t=centers, columns=list(self.data.keys()),
                        time_support=self.time_support)

    @property
    def rate(self):
        tot = self.time_support.tot_length()
        return np.array([len(ts) / tot if tot > 0 else 0.0
                         for ts in self.data.values()])
