"""The port's time-series shim (``poor_man_gplvm_tpu_torch.utils.
timeseries``) against the JAX package's (``poor_man_gplvm_tpu/utils/
timeseries.py``) on the same inputs.

Each case builds its inputs from a numpy seed with one module's classes and
returns a result; both modules' results are reduced to plain numpy
(classes, times, values, columns and time supports) and must be equal:
both run the same float64 numpy, so the tolerance is exact equality (NaN
equal to NaN).  The port's module must not import the JAX package.
"""

import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from poor_man_gplvm_tpu.utils import timeseries as jts  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import compat  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import timeseries as pts  # noqa: E402


def _plain(x):
    """A time-series object (or a container of them) as nested tuples of
    its class name and numpy arrays."""
    name = type(x).__name__
    if name == "IntervalSet":
        return (name, x.start, x.end)
    if name == "Ts":
        return (name, x.t, _plain(x.time_support))
    if name in ("Tsd", "TsdFrame"):
        cols = getattr(x, "columns", None)
        return (name, x.t, np.asarray(x.d),
                None if cols is None else np.asarray(cols),
                _plain(x.time_support))
    if name == "TsGroup":
        return (name, tuple((k, _plain(v)) for k, v in x.data.items()),
                _plain(x.time_support))
    if name == "_PeriEvent":
        return (name, x.d, x.rel_times)
    if isinstance(x, dict):
        return tuple((k, _plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, slice):
        return (x.start, x.stop, x.step)
    return np.asarray(x)


def _assert_same(a, b, where="result"):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif isinstance(a, str):
        assert a == b, where
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


def _intervals(ts, seed, n=4):
    """n disjoint sorted intervals with gaps, from a numpy seed."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0.0, 10.0, size=2 * n))
    return ts.IntervalSet(edges[0::2], edges[1::2])


def _trace(ts, seed, T=60, gaps=True):
    """A Tsd on a 0.1 s grid with a support of three pieces (or one)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) * 0.1
    d = rng.normal(size=T).cumsum()
    tsd = ts.Tsd(d=d, t=t)
    if gaps:
        tsd = tsd.restrict(ts.IntervalSet(np.array([0.0, 2.05, 4.05]),
                                          np.array([1.5, 3.5, 5.9])))
    return tsd


def _frame(ts, seed, T=40, cols=("x", "y", "z")):
    rng = np.random.default_rng(seed)
    return ts.TsdFrame(d=rng.normal(size=(T, len(cols))),
                       t=np.arange(T) * 0.05, columns=list(cols))


CASES = {
    # interval algebra
    "union": lambda ts: _intervals(ts, 1).union(_intervals(ts, 2)),
    "intersect": lambda ts: _intervals(ts, 1).intersect(_intervals(ts, 2)),
    "intersect_empty": lambda ts: _intervals(ts, 1).intersect(
        ts.IntervalSet(np.empty(0), np.empty(0))),
    "set_diff": lambda ts: _intervals(ts, 3).set_diff(_intervals(ts, 4, 6)),
    "merge_close": lambda ts: _intervals(ts, 5, 8).merge_close_intervals(0.4),
    "in_interval_times": lambda ts: _intervals(ts, 6).in_interval(
        np.linspace(-1.0, 11.0, 97)),
    "in_interval_tsd": lambda ts: _intervals(ts, 6).in_interval(
        _trace(ts, 7, gaps=False)),
    "iterate_and_index": lambda ts: (
        list(_intervals(ts, 8)), _intervals(ts, 8)[1:3],
        _intervals(ts, 8).values, _intervals(ts, 8).tot_length()),
    "interval_pairs_unsorted": lambda ts: ts.IntervalSet(
        np.array([[5.0, 6.0], [1.0, 2.0], [3.0, 4.5]])),
    # restrict, threshold across support gaps, get_slice
    "restrict_ts_tsd_frame": lambda ts: (
        ts.Ts(np.arange(50) * 0.2).restrict(_intervals(ts, 9)),
        _trace(ts, 10, gaps=False).restrict(_intervals(ts, 9)),
        _frame(ts, 11).restrict(_intervals(ts, 12, 2))),
    **{f"threshold_{m}": (lambda m: lambda ts: _trace(ts, 13).threshold(
        0.0, method=m))(m)
       for m in ("above", "aboveequal", "belowequal", "below")},
    "threshold_chained": lambda ts: _trace(ts, 14).threshold(
        -1.0, method="aboveequal").threshold(1.5, method="belowequal"),
    "get_slice": lambda ts: (ts.Ts(np.arange(30) * 0.5).get_slice(2.25, 9.0),
                             _frame(ts, 15).get_slice(0.5, 0.5)),
    # value_from: nearest sample inside the source's support
    "value_from_tsd": lambda ts: ts.Ts(
        np.random.default_rng(16).uniform(-0.5, 6.5, 25)).value_from(
            _trace(ts, 17)),
    "value_from_frame": lambda ts: _trace(ts, 18, T=30, gaps=False)
    .value_from(_frame(ts, 19, T=50)),
    # TsdFrame indexing and bool masks
    "frame_column": lambda ts: (_frame(ts, 20)["y"],
                                _frame(ts, 20)[["z", "x"]]),
    "frame_rows_cols": lambda ts: (_frame(ts, 21)[2:9, 1],
                                   _frame(ts, 21)[3:7, 0:2],
                                   _frame(ts, 21)[5, 2]),
    "frame_slice_and_row": lambda ts: (_frame(ts, 22)[4:11],
                                       _frame(ts, 22)[:, 0][1:4],
                                       _frame(ts, 22)[6]),
    "frame_bool_mask_keeps_support": lambda ts: (
        lambda f: f[np.arange(len(f)) % 3 != 1])(_frame(ts, 23).restrict(
            ts.IntervalSet(np.array([0.0, 1.2]), np.array([0.6, 1.9])))),
    "tsd_copy_interpolate_derivative": lambda ts: (
        _trace(ts, 24).copy(), _trace(ts, 24, gaps=False).interpolate(
            ts.Ts(np.linspace(0.05, 5.5, 17))),
        _trace(ts, 24, gaps=False).derivative()),
    "frame_interpolate": lambda ts: _frame(ts, 25).interpolate(
        ts.Ts(np.linspace(0.0, 1.9, 23))),
    "smooth": lambda ts: (_trace(ts, 26, gaps=False).smooth(0.3),
                          _frame(ts, 27).smooth(0.1)),
    # TsGroup, filters, peri-event, shifts
    "tsgroup_count_rate": lambda ts: (
        lambda g: (g.count(0.25), g.rate,
                   g.restrict(_intervals(ts, 29, 2)).count(0.5)))(
        ts.TsGroup({k: np.sort(np.random.default_rng(28 + k).uniform(
            0.0, 10.0, 40 + 10 * k)) for k in range(3)},
            time_support=ts.IntervalSet(np.array([0.0, 6.0]),
                                        np.array([4.0, 10.0])))),
    "lowpass_filter": lambda ts: (
        ts.apply_lowpass_filter(_trace(ts, 30, T=400, gaps=False), 2.0),
        ts.apply_lowpass_filter(_frame(ts, 31, T=300), 3.0, order=2)),
    "perievent": lambda ts: ts.compute_perievent_continuous(
        _trace(ts, 32, gaps=False), ts.Ts(np.array([0.3, 2.5, 5.8])), 0.5),
    "shift_timestamps": lambda ts: ts.shift_timestamps(
        ts.Ts(np.sort(np.random.default_rng(33).uniform(0, 20, 50))),
        min_shift=1.0, max_shift=5.0, rng=7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shim_matches_jax(case):
    _assert_same(_plain(CASES[case](jts)), _plain(CASES[case](pts)), case)


def test_perievent_dataframe_needs_pandas():
    got = pts.compute_perievent_continuous(
        _trace(pts, 34, gaps=False), np.array([1.0, 3.0]), 0.3)
    df = got.as_dataframe()  # pandas is installed here
    np.testing.assert_array_equal(df.values, got.d)
    np.testing.assert_array_equal(df.index.values, got.rel_times)


def test_compat_uses_the_ports_shim_without_pynapple():
    if compat.timeseries_module().__name__ == "pynapple":
        pytest.skip("pynapple installed: compat uses its classes")
    assert compat.timeseries_module() is pts
    f = compat.tsdframe(d=np.ones((3, 2)), t=np.arange(3.0))
    assert isinstance(f, pts.TsdFrame) and compat.is_tsdframe(f)
    assert compat.is_tsd_like(compat.tsd(d=np.zeros(3), t=np.arange(3.0)))
    assert not compat.is_tsdframe(jts.TsdFrame(d=np.ones((3, 2)),
                                               t=np.arange(3.0)))
    src = open(pts.__file__).read() + open(compat.__file__).read()
    assert "import jax" not in src and "poor_man_gplvm_tpu." not in src
    assert "pynapple" not in sys.modules
