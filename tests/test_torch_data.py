"""``poor_man_gplvm_tpu_torch.data`` against ``poor_man_gplvm_tpu/data``
on the same inputs, one test per module.

The host modules are copies that run the same numpy and scipy code, so
they are held exactly: ``np.array_equal`` on arrays, and
``pandas.testing.assert_frame_equal`` (index and dtypes included) on
``ResultTable.to_dataframe()`` where the JAX function returns a
DataFrame.  The native binner's integer counts equal the JAX package's
numpy and native binners on 1e5+ spikes, with spikes on bin edges and
before ``t_origin``, and it raises (never falls back) where it cannot be
built.  The naive-Bayes decoders run in torch float64 on the CPU:
``predict`` equal, log-probabilities within 1e-10 of the largest
magnitude (their products sum in another order than numpy's).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from poor_man_gplvm_tpu import data as jdata  # noqa: E402
from poor_man_gplvm_tpu_torch import convert  # noqa: E402
from poor_man_gplvm_tpu_torch import data as pdata  # noqa: E402
from poor_man_gplvm_tpu_torch.data import native  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import _build  # noqa: E402

torch.set_num_threads(1)


def _equal(a, b):
    """Recursive exact equality of numpy arrays, scalars, tuples, lists
    and dicts (NaN equal to NaN)."""
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif hasattr(a, "_fieldnames"):  # a scipy mat_struct
        assert a._fieldnames == b._fieldnames
        for f in a._fieldnames:
            _equal(getattr(a, f), getattr(b, f))
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a, b)
        if a.dtype.kind in "fc":
            assert np.array_equal(a, b, equal_nan=True)
        elif a.dtype.kind == "O" and a.ndim == 0:
            assert a.item() == b.item()
        elif a.dtype.kind == "O":
            for x, y in zip(a.ravel(), b.ravel()):
                _equal(x, y)
        else:
            assert np.array_equal(a, b)


def _spikes(n, t_max, n_units, seed):
    rng = np.random.default_rng(seed)
    return (np.sort(rng.uniform(0.0, t_max, n)),
            rng.integers(0, n_units, n))


@pytest.mark.parametrize("kw", [
    dict(window_size=1.0, step_size=0.5),
    dict(window_size=0.5, step_size=0.2, rates=True, sigma=1.5, zscore=True),
    dict(window_size=0.01, step_size=0.01, t_origin=2.5),
])
def test_bin_spikes_sliding_matches_jax(kw):
    st, clu = _spikes(4000, 60.0, 9, 0)
    _equal(pdata.bin_spikes_sliding(st, clu, use_native=False, **kw),
           jdata.bin_spikes_sliding(st, clu, use_native=False, **kw))
    # the empty and shorter-than-a-window inputs
    _equal(pdata.bin_spikes_sliding([], []),
           jdata.bin_spikes_sliding([], []))
    _equal(pdata.bin_spikes_sliding([0.1, 0.2], [1, 3], window_size=1.0),
           jdata.bin_spikes_sliding([0.1, 0.2], [1, 3], window_size=1.0))


@pytest.mark.parametrize("kw", [
    dict(window_size=1.0, step_size=1.0),
    dict(window_size=1.0, step_size=0.25, sigma=2.0, zscore=True),
])
def test_compute_spike_counts_and_smoothing_match_jax(kw):
    st, clu = _spikes(4000, 60.0, 9, 1)
    _equal(pdata.compute_spike_counts(st, clu, use_native=False, **kw),
           jdata.compute_spike_counts(st, clu, use_native=False, **kw))
    m = np.random.default_rng(2).poisson(2.0, (5, 300)).astype(float)
    m[3] = 0.0  # a flat unit: its std is set to 1
    for sigma, z in ((0.0, False), (2.0, False), (1.0, True)):
        _equal(pdata.smooth_and_zscore(m, sigma=sigma, zscore=z),
               jdata.smooth_and_zscore(m, sigma=sigma, zscore=z))
    with pytest.raises(ValueError):
        pdata.compute_spike_counts(st, clu[:-1])


def _edge_spikes():
    """1.2e5 spikes at 10 ms bins: random times, times on bin edges
    (k * step), and times before t_origin."""
    rng = np.random.default_rng(3)
    st = rng.uniform(0.0, 100.0, 100_000)
    edges = np.arange(0, 10_000) * 0.01
    st = np.concatenate([st, rng.choice(edges, 20_000), [0.5, 1.0, 1.25]])
    clu = rng.integers(0, 40, st.size)
    return st, clu


def test_native_binner_counts_equal_jax():
    st, clu = _edge_spikes()
    assert st.size >= 1e5
    for t_origin in (0.0, 1.3):  # 1.3 puts ~1.3 % of spikes before it
        kw = dict(window_size=0.01, step_size=0.01, t_origin=t_origin)
        calls = native.bin_sliding_native.calls
        got = pdata.bin_spikes_sliding(st, clu, **kw)  # None: native
        assert native.bin_sliding_native.calls == calls + 1
        _equal(got, pdata.bin_spikes_sliding(st, clu, use_native=True, **kw))
        _equal(got, jdata.bin_spikes_sliding(st, clu, use_native=False, **kw))
        _equal(got, jdata.bin_spikes_sliding(st, clu, use_native=True, **kw))
        assert np.array_equal(got[0], np.round(got[0]))
    # a unit whose spikes all fall outside the windows has no row (as in
    # the numpy binner)
    st2 = np.concatenate([st, [-5.0, -4.0]])
    clu2 = np.concatenate([clu, [99, 99]])
    _equal(pdata.bin_spikes_sliding(st2, clu2, 0.01, 0.01, use_native=True),
           jdata.bin_spikes_sliding(st2, clu2, 0.01, 0.01, use_native=False))
    for kw in (dict(window_size=0.05, step_size=0.01),
               dict(window_size=0.01, step_size=0.01)):
        calls = native.bin_overlapping_native.calls
        got = pdata.compute_spike_counts(st, clu, use_native=True, **kw)
        assert native.bin_overlapping_native.calls == calls + 1
        _equal(got, jdata.compute_spike_counts(st, clu, use_native=False,
                                               **kw))
        _equal(got, jdata.compute_spike_counts(st, clu, use_native=True,
                                               **kw))


def test_native_binner_raises_where_it_cannot_build(monkeypatch, tmp_path):
    """No silent fallback: without a compiler the native path raises,
    naming use_native=False, and available() says False."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    st, clu = _spikes(200, 10.0, 3, 4)
    with pytest.raises(RuntimeError, match="use_native=False"):
        pdata.bin_spikes_sliding(st, clu, use_native=True)
    with pytest.raises(RuntimeError, match="use_native=False"):
        pdata.compute_spike_counts(st, clu, use_native=True)
    # the numpy binner needs no compiler
    _equal(pdata.bin_spikes_sliding(st, clu, use_native=False),
           jdata.bin_spikes_sliding(st, clu, use_native=False))
    monkeypatch.undo()
    assert native.available()


def test_presence_ratio_matches_jax():
    rng = np.random.default_rng(5)
    counts = rng.poisson(0.3, (7, 500)).astype(float)
    counts[2, 100:] = 0.0
    counts[4] = 0.0
    tb = np.arange(500) * 0.1
    for n_coarse in (1, 10, 100, 499):
        _equal(pdata.get_presence_ratio(counts, tb, n_coarse),
               jdata.get_presence_ratio(counts, tb, n_coarse))
    _equal(pdata.get_presence_ratio(torch.from_numpy(counts[:, :1]),
                                    tb[:1], 3),
           jdata.get_presence_ratio(counts[:, :1], tb[:1], 3))
    for bad in ((counts, tb[:-1]), (counts, tb[None])):
        with pytest.raises(ValueError):
            pdata.get_presence_ratio(*bad, 10)


def _kilosort_dir(path, label_file, id_name, label_name, rows):
    st, clu = _spikes(5000, 40.0, 8, 6)
    fs = 30000.0
    np.save(path / "spike_times.npy", (st * fs).astype(np.int64))
    np.save(path / "spike_times_sec_adj.npy", st)
    np.save(path / "spike_clusters.npy", clu.astype(np.int32))
    (path / "params.py").write_text(
        f"dat_path = 'x.bin'\nsample_rate = {fs}\nn_channels_dat = 4\n")
    (path / label_file).write_text(
        f"{id_name}\t{label_name}\tother\n"
        + "".join(f"{i}\t{lab}\t{k}\n" for k, (i, lab) in enumerate(rows)))
    return str(path)


_ROWS = [("0", "good"), ("1", "MUA"), ("2", "noise"), ("3", "good"),
         ("4", ""), ("5", "mua"), ("6", "Good"), ("7", "noise")]


@pytest.mark.parametrize("layout", [
    ("cluster_KSLabel.tsv", "cluster_id", "KSLabel", _ROWS),
    ("cluster_group.tsv", "id", "group",
     _ROWS[:3] + [("x", "good"), ("", "mua")] + _ROWS[3:]),
])
def test_kilosort_loaders_match_jax(tmp_path, layout):
    d = _kilosort_dir(tmp_path, *layout)
    pd.testing.assert_frame_equal(
        pdata.load_cluster_labels(d).to_dataframe(),
        jdata.load_cluster_labels(d))
    from poor_man_gplvm_tpu.data import kilosort as jks
    from poor_man_gplvm_tpu_torch.data import kilosort as pks
    for use_units in ("all", "good", "mua", "good/mua", "noise"):
        for adj in ("", "_sec_adj"):
            _equal(pks.load_kilosort_spikes(d, use_units, adj),
                   jks.load_kilosort_spikes(d, use_units, adj))
        kw = dict(window_size=0.5, step_size=0.25, use_units=use_units,
                  adj="")
        _equal(pdata.compute_spike_rates(d, **kw),
               jdata.compute_spike_rates(d, **kw))
        _equal(pdata.compute_spike_counts_old(d, sigma=0, zscore=False, **kw),
               jdata.compute_spike_counts_old(d, sigma=0, zscore=False, **kw))
    with pytest.raises(ValueError):
        pks.keep_ids_for_label(pdata.load_cluster_labels(d), "bad")
    # the default adj=None looks for spike_timesNone.npy, in both packages
    for fn in (pdata.compute_spike_counts_old,
               jdata.compute_spike_counts_old):
        with pytest.raises(FileNotFoundError):
            fn(d)
    with pytest.raises(FileNotFoundError):
        pdata.load_cluster_labels(str(tmp_path / "nowhere"))


def test_kilosort_label_ids_that_are_not_integers_raise(tmp_path):
    (tmp_path / "cluster_group.tsv").write_text(
        "cluster_id\tgroup\n1\tgood\n2.5\tmua\n")
    for fn in (pdata.load_cluster_labels, jdata.load_cluster_labels):
        with pytest.raises(TypeError):
            fn(str(tmp_path))
    (tmp_path / "cluster_group.tsv").write_text("cid\tgroup\n1\tgood\n")
    for fn in (pdata.load_cluster_labels, jdata.load_cluster_labels):
        with pytest.raises(ValueError):
            fn(str(tmp_path))


def test_grouping_matches_jax():
    rng = np.random.default_rng(7)
    mats = {p: (rng.poisson(2.0, (6, 400)).astype(float), None, None)
            for p in ("p0", "p1")}
    regions = {"p0": np.array(["CA1"] * 3 + ["PFC"] * 3),
               "p1": np.array(["CA1", "PFC"] * 3)}
    types = {p: np.array(["pyr", "int", "pyr", "pyr", "int", "pyr"])
             for p in mats}
    hemi = {"p0": "L", "p1": "R"}
    groups = {"pyr": ["pyr"], "all": ["pyr", "int"], "none": ["x"]}
    for region in ("CA1", "PFC", "nowhere"):
        for key in groups:
            args = (mats, region, regions, key, types, ["p0", "p1"], groups)
            _equal(pdata.collect_matrix_for(*args),
                   jdata.collect_matrix_for(*args))
            _equal(pdata.collect_matrix_for_bilat(*args, "L", hemi),
                   jdata.collect_matrix_for_bilat(*args, "L", hemi))
    m = rng.poisson(1.0, (12, 300)).astype(float)
    m[4] = 0.0  # a flat unit: sorted last
    m[7] = 2.0
    for mode in ("corr", "mean", "peak", "other"):
        _equal(pdata.sort_units(m, mode), jdata.sort_units(m, mode))
    for small in (m[:1], m[[4, 7]], m[[1, 4]], np.zeros((0, 5))):
        _equal(pdata.sort_units(small), jdata.sort_units(small))
    assert pdata.sort_units(None) is None


def test_cellexplorer_matches_jax(tmp_path):
    from scipy.io import savemat

    rng = np.random.default_rng(8)
    n = 5
    spikes = np.empty(n, dtype=object)
    for i in range(n):
        spikes[i] = np.sort(rng.uniform(0, 100, 20 + i))
    cm = {
        "cellID": np.arange(1, n + 1), "cluID": np.arange(n) + 10,
        "spikeCount": np.array([20, 21, 22, 23, 24]),
        "refractoryPeriodViolation": rng.uniform(0, 1, n),
        "putativeCellType": np.array(["Pyramidal Cell", "Narrow Interneuron",
                                      "Pyramidal Cell", "Wide Interneuron",
                                      "Pyramidal Cell"], dtype=object),
        "shankID": np.array([1, 1, 2, 2, 3]),
        "tags": {"CA1": np.array([1, 2, 3]), "PFC": np.array([4])},
        "spikes": {"times": spikes},
        "general": {"states": {"SleepState": {
            "WAKEstate": np.array([[0.0, 10.0], [20.0, 30.0]]),
            "NREMstate": np.array([[10.0, 20.0]])}}},
    }
    path = str(tmp_path / "s.cell_metrics.cellinfo.mat")
    savemat(path, {"cell_metrics": cm})
    _equal(pdata.load_cell_metrics(path, verbose=True),
           jdata.load_cell_metrics(path))
    savemat(path, {"other": 1})
    for fn in (pdata.load_cell_metrics, jdata.load_cell_metrics):
        with pytest.raises(KeyError):
            fn(path)
        with pytest.raises(FileNotFoundError):
            fn(path + ".missing")


def _behavior_dir(tmp_path):
    rng = np.random.default_rng(9)
    n = 400
    ts = np.cumsum(rng.uniform(20, 40, n)).astype(np.int64)
    reward = (np.arange(n) // 50 % 2).astype(np.int64)
    cx = np.cumsum(rng.normal(0, 3, n))
    cx[[10, 11, 200]] = np.nan
    cx[150] = 5e3  # a speed outlier
    pd.DataFrame({"timestamp_ms": ts, "centroid_x": cx,
                  "centroid_y": np.cumsum(rng.normal(0, 3, n)),
                  "reward_state": reward,
                  "note": ["a", ""] * (n // 2)}).to_csv(
        tmp_path / "events.csv", index=False)
    return str(tmp_path), n, ts


def test_behavior_matches_jax(tmp_path):
    import h5py

    d, n, ts = _behavior_dir(tmp_path)
    ev_p, ev_j = pdata.load_behavior(d), jdata.load_behavior(d)
    pd.testing.assert_frame_equal(ev_p.to_dataframe(), ev_j)
    tracks = np.random.default_rng(10).normal(0, 50, (2, 3, n + 7))
    with h5py.File(tmp_path / "t.analysis.h5", "w") as f:
        f["tracks"] = tracks
    pd.testing.assert_frame_equal(
        pdata.load_behavior(d, str(tmp_path / "t.analysis.h5"))
        .to_dataframe(),
        jdata.load_behavior(d, str(tmp_path / "t.analysis.h5")))

    rng = np.random.default_rng(11)
    units = np.array([3, 8, 11])
    t0 = ts[0] / 1000.0 - 0.5  # the first bins precede every sample
    time_bins = t0 + np.arange(120) * 0.1
    rates = rng.uniform(0, 5, (3, 120))
    for events in (ev_p, ev_j):
        for kw in (dict(), dict(speed_threshold=1.0),
                   dict(interp_method="nearest"),
                   dict(interp_method="polynomial", order=2)):
            pd.testing.assert_frame_equal(
                pdata.align_brain_and_behavior(events, rates, units,
                                               time_bins, **kw)
                .to_dataframe(),
                jdata.align_brain_and_behavior(ev_j, rates, units, time_bins,
                                               **kw))


def test_bursts_match_jax():
    rng = np.random.default_rng(12)
    z = rng.normal(0, 1, 3000)
    for c in (100, 104, 400, 1500, 1508, 2990):
        z[c:c + 6] += 5.0
    z[0:3] = 4.0  # a burst at the start
    for kw in (dict(), dict(BURST_THRESHOLD=2.5, BURST_BOUNDARY_THRESHOLD=0.5,
                            MIN_BURST_DURATION=0.03,
                            MIN_INTERBURST_INTERVAL=0.1, STEP_SIZE=0.01)):
        _equal(pdata.detect_population_bursts(z, **kw),
               jdata.detect_population_bursts(z, **kw))
    tb = np.arange(3000) * 0.01
    dd = {"A": {"time_bins": tb,
                "burst_boundaries": jdata.detect_population_bursts(z)},
          "B": {"time_bins": tb + 0.003,
                "burst_boundaries": jdata.detect_population_bursts(
                    np.roll(z, 3))},
          "C": {"time_bins": tb}}
    for a, b in (("A", "B"), ("B", "A"), ("A", "C")):
        for end_inclusive in (True, False):
            for strict in (True, False):
                _equal(pdata.merge_overlapping_bursts_two_probes(
                           dd, a, b, end_inclusive, strict),
                       jdata.merge_overlapping_bursts_two_probes(
                           dd, a, b, end_inclusive, strict))


def test_cv_matches_jax():
    rng = np.random.default_rng(13)
    X = rng.normal(size=(4, 1003))
    Y = rng.integers(0, 7, 1003)
    for k in range(5):
        for k_cv, n_blocks in ((5, 10), (10, 10), (3, 7)):
            want = jdata.cv_split(X.T, k, k_cv, n_blocks)
            _equal(pdata.cv_split(X.T, k, k_cv, n_blocks), want)
            # a tensor is split on its own device
            got = pdata.cv_split(torch.from_numpy(X.T), k, k_cv, n_blocks)
            assert torch.is_tensor(got[0]) and torch.is_tensor(got[1])
            _equal([got[0].numpy(), got[1].numpy(), got[2], got[3]],
                   list(want))
            _equal(pdata.DecoderDataset(X, Y).split(k, k_cv, n_blocks),
                   jdata.DecoderDataset(X, Y).split(k, k_cv, n_blocks))
            tr, te, sw_tr, sw_te = pdata.DecoderDataset(
                torch.from_numpy(X), torch.from_numpy(Y)).split(k, k_cv,
                                                                n_blocks)
            _equal([tr[0].numpy(), tr[1].numpy(), te[0].numpy(),
                    te[1].numpy(), sw_tr, sw_te],
                   [a for pair in jdata.DecoderDataset(X, Y).split(
                       k, k_cv, n_blocks)[:2] for a in pair]
                   + list(jdata.DecoderDataset(X, Y).split(
                       k, k_cv, n_blocks)[2:]))
    for bad in ((X[0], Y), (X, Y[:, None]), (X, Y[:-1])):
        with pytest.raises(ValueError):
            pdata.DecoderDataset(*bad)


def _close_log_probs(got, want):
    got = got.numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale)


@pytest.mark.parametrize("kind", ["Poisson", "Gaussian"])
@pytest.mark.parametrize("uniform_prior", [False, True])
def test_bayes_decoders_match_jax(kind, uniform_prior):
    rng = np.random.default_rng(14)
    K, N, T = 9, 15, 2000
    Y = rng.integers(0, K - 1, T)  # the last class is never visited
    rates = rng.gamma(2.0, 1.0, (N, K))
    X = rng.poisson(rates[:, Y]).astype(float)
    if kind == "Gaussian":
        X = X + rng.normal(0, 0.3, X.shape)
    jcls = getattr(jdata, f"{kind}BayesDecoder")
    pcls = getattr(pdata, f"{kind}BayesDecoder")
    jdec = jcls(K, uniform_prior=uniform_prior).fit(X, Y)
    pdec = pcls(K, uniform_prior=uniform_prior, device="cpu").fit(X, Y)
    carried = convert.bayes_decoder_from_jax(jdec, device="cpu")
    attrs = (("mu_", "var_") if kind == "Gaussian" else ("rate_",
                                                         "log_rate_"))
    for name in attrs + ("log_prior_",):
        np.testing.assert_allclose(getattr(pdec, name).numpy(),
                                   getattr(jdec, name), rtol=1e-12)
    X_test = X[:, :700]
    want = jdec.predict_log_probabilities(X_test)
    for dec in (pdec, carried):
        _close_log_probs(dec.predict_log_probabilities(
            torch.from_numpy(X_test)), want)
        assert np.array_equal(dec.predict(X_test).numpy(),
                              jdec.predict(X_test))
    with pytest.raises(ValueError):
        pcls(K, device="cpu").fit(X, np.where(Y == 0, K, Y))
    with pytest.raises(RuntimeError):
        pcls(K, device="cpu").predict(X_test)
    if kind == "Poisson":
        with pytest.raises(ValueError):
            pdec.predict_log_probabilities(X_test[:-1])
    unfitted = convert.bayes_decoder_from_jax(jcls(K), device="cpu")
    assert unfitted.log_prior_ is None


def test_bayes_decoders_default_to_the_card():
    for cls in (pdata.GaussianBayesDecoder, pdata.PoissonBayesDecoder):
        if torch.cuda.is_available():
            assert cls(3).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="needs a CUDA card"):
                cls(3)
    with pytest.raises(TypeError):
        convert.bayes_decoder_from_jax(object(), device="cpu")


def _moser_mat(path):
    from scipy.io import savemat

    rng = np.random.default_rng(15)
    t = 100.0 + np.arange(2000) * 0.01
    def unit(uid, label, n):
        u = {"id": uid, "spikeTimes": np.sort(rng.uniform(99.0, 121.0, n)),
             "meanRate": n / 20.0}
        if label is not None:
            u["ks2Label"] = label
        return u
    mec = np.empty(3, dtype=object)
    mec[:] = [unit("m1", "good", 300), unit("m2", "mua", 50),
              unit("m3", None, 80)]
    hc = np.empty(2, dtype=object)
    hc[:] = [unit("h1", "Good", 200), unit("h2", "noise", 10)]
    savemat(path, {"Dsession": {
        "t": t, "x": np.sin(t), "y": np.cos(t), "z": t * 0.1,
        "units": {"mec": mec, "hc": hc}}})


def test_moser_matches_jax(tmp_path):
    path = str(tmp_path / "moser.mat")
    _moser_mat(path)
    for kw in (dict(), dict(window_size=0.5, step_size=0.1, sigma=1.0,
                            zscore=True),
               dict(use_units="good", locations="mec"),
               dict(use_units="noise", locations="hc"),
               dict(use_units="mua", locations="hc"),
               dict(window_size=100.0)):
        _equal(pdata.preprocess_moser_data(path, **kw),
               jdata.preprocess_moser_data(path, **kw))
    for fn in (pdata.preprocess_moser_data, jdata.preprocess_moser_data):
        with pytest.raises(ValueError):
            fn(path, use_units="bad")
        with pytest.raises(FileNotFoundError):
            fn(path + ".missing")


def test_data_package_exports_the_jax_names():
    assert sorted(pdata.__all__) == sorted(jdata.__all__)
    for name in pdata.__all__:
        assert getattr(pdata, name).__module__.startswith(
            "poor_man_gplvm_tpu_torch.data"), name
    assert os.path.basename(native.__file__) == "native.py"


def test_read_csv_types_columns_as_pandas(tmp_path):
    """The loaders' pandas-free reader against ``pandas.read_csv``: int,
    float with missing, bool, strings with missing, and fields python
    would read as numbers but pandas does not."""
    from poor_man_gplvm_tpu_torch.utils.table import read_csv

    path = tmp_path / "t.csv"
    path.write_text("i,f,b,s,u,m\n"
                    "1,0.5,True,a,1_000,3\n"
                    "-2,,False,,2,NA\n"
                    "3,1e3,true,NaN,x,4\n")
    want = pd.read_csv(path)
    got = read_csv(path).to_dataframe()
    pd.testing.assert_frame_equal(got, want)
    path.write_text("a\tb\n")
    assert read_csv(path, sep="\t").columns == ["a", "b"]
