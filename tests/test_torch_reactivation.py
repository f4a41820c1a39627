"""``poor_man_gplvm_tpu_torch.analysis.reactivation`` against
``poor_man_gplvm_tpu/analysis/reactivation.py`` on the same weights and
spikes, from the same numpy ``rng``.

The port models take the JAX models' ``params`` and ``tuning_basis``
(``convert.load_jax_state``) and run on the CPU, on ``'prob'`` and on
``'cuda'`` (whose batched kernel wrappers run their plain versions on CPU
tensors: ``hmm.smooth_batch_latent_mean``); the JAX models run ``'prob'``.
The shuffles are the JAX module's exactly (one seed per shuffle and key
from the numpy stream, in its order).  Every table is held to the JAX
DataFrame through ``ResultTable.to_dataframe()`` and
``pandas.testing.assert_frame_equal`` (index included), at rtol 1e-5 and
an absolute 1e-7 for the means of posteriors that are nearly 0;
posteriors 1e-4 absolute, log-marginals 1e-5 relative (PARITY.json).
Within the port, the batched null equals the serial one bit for bit.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu.analysis import reactivation as jreact  # noqa: E402
from poor_man_gplvm_tpu.utils import timeseries as jts  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import convert  # noqa: E402
from poor_man_gplvm_tpu_torch.analysis import reactivation  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import timeseries as pts  # noqa: E402
from poor_man_gplvm_tpu_torch.utils.table import ResultTable  # noqa: E402

torch.set_num_threads(1)

N, L = 12, 20
T_EP = 120  # bins per epoch
DT = 0.025
N_SHUFFLE = 5
BATCH = 2  # ragged: batches of 2, 2 and 1
SEED = 7
TOL_POST = 1e-4
TOL_LML = 1e-5
FRAME_TOL = dict(rtol=1e-5, atol=1e-7)
CLASSES = ("PoissonGPLVMJump1D", "GaussianGPLVM1D")


def _kw(name):
    kw = dict(n_latent_bin=L, movement_variance=1, tuning_lengthscale=4.0)
    if name.startswith("Gaussian"):
        kw["noise_std"] = 1.0
    return kw


def _port(jm, name, engine):
    m = getattr(pmt, name)(N, device="cpu", inference_engine=engine,
                           **_kw(name))
    state = convert.state_from_model(jm)
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


@pytest.fixture(scope="module", params=CLASSES)
def sim(request):
    """A model of each family, spikes along a random walk (Poisson counts
    as integers, Gaussian observations), a gap between the epochs, and
    both packages' TsdFrames and pre/post IntervalSets."""
    name = request.param
    jm = getattr(jpmg, name)(N, inference_engine="prob", **_kw(name))
    rng = np.random.default_rng(1)
    T = 2 * T_EP + 10
    lat = np.clip(np.cumsum(rng.integers(-1, 2, size=T)) + L // 2, 0, L - 1)
    mean = np.asarray(jm.tuning)[lat]
    y = (mean + rng.normal(size=mean.shape)).astype(np.float32) \
        if name.startswith("Gaussian") else rng.poisson(mean)
    t = np.arange(T) * DT
    eps = {"pre": (0.0, (T_EP - 0.5) * DT),
           "post": ((T_EP + 9.5) * DT, (T - 0.5) * DT)}
    common = (2.0 * DT, (T - 3.5) * DT)  # trims both epochs
    return dict(
        name=name, jm=jm, y=y,
        jy=jts.TsdFrame(d=y, t=t), py=pts.TsdFrame(d=y, t=t),
        jeps={k: jts.IntervalSet(*v) for k, v in eps.items()},
        peps={k: pts.IntervalSet(*v) for k, v in eps.items()},
        jcommon=jts.IntervalSet(*common), pcommon=pts.IntervalSet(*common))


def _frame(table):
    assert isinstance(table, ResultTable)
    return table.to_dataframe()


@pytest.mark.parametrize("common", [False, True])
@pytest.mark.parametrize("decoder_type", ["naive_bayes", "dynamics"])
def test_decode_pre_post(sim, decoder_type, common):
    s = sim
    if s["name"] == "GaussianGPLVM1D" and decoder_type == "dynamics":
        # the JAX function reads posterior_latent_marg, which a latent-only
        # decode does not have; the port reads its posterior_all
        with pytest.raises(KeyError):
            jreact.decode_pre_post(s["jm"], s["jy"], s["jeps"],
                                   decoder_type=decoder_type)
        got = reactivation.decode_pre_post(
            _port(s["jm"], s["name"], "prob"), s["py"], s["peps"],
            decoder_type=decoder_type)
        assert got["post_latent_mean_d"].columns == ["pre", "post", "diff"]
        return
    want = jreact.decode_pre_post(
        s["jm"], s["jy"], s["jeps"], decoder_type=decoder_type,
        common_ep=s["jcommon"] if common else None)
    for engine in ("prob", "cuda"):
        got = reactivation.decode_pre_post(
            _port(s["jm"], s["name"], engine), s["py"], s["peps"],
            decoder_type=decoder_type,
            common_ep=s["pcommon"] if common else None)
        for k in ("pre", "post"):
            assert np.abs(got["post_latent_d"][k]
                          - want["post_latent_d"][k]).max() <= TOL_POST
        pd.testing.assert_frame_equal(_frame(got["post_latent_mean_d"]),
                                      want["post_latent_mean_d"],
                                      **FRAME_TOL)
    # a dict of spike matrices, as the serial null passes them
    arrs = {k: s["py"].restrict(ep).d for k, ep in s["peps"].items()}
    got_d = reactivation.decode_pre_post(
        _port(s["jm"], s["name"], "prob"), arrs, decoder_type=decoder_type)
    if not common:
        pd.testing.assert_frame_equal(_frame(got_d["post_latent_mean_d"]),
                                      want["post_latent_mean_d"],
                                      **FRAME_TOL)
    with pytest.raises(ValueError, match="'pre' and 'post'"):
        reactivation.decode_pre_post(_port(s["jm"], s["name"], "prob"),
                                     {"pre": arrs["pre"]})
    with pytest.raises(ValueError, match="not supported"):
        reactivation.decode_pre_post(_port(s["jm"], s["name"], "prob"),
                                     arrs, decoder_type="map")


@pytest.mark.parametrize("decoder_type", ["naive_bayes", "dynamics"])
def test_within_epoch_shuffle_null(sim, decoder_type):
    """The batched null (batches of 2 of 5 shuffles) against the JAX
    batched null, and against the port's serial loop bit for bit, on
    both engines, with ``common_ep``; the JAX serial loop gives the JAX
    batched frame (a check of the reference's own contract)."""
    s = sim
    kw = dict(decoder_type=decoder_type, n_shuffle=N_SHUFFLE, verbose=False,
              shuffle_batch_size=BATCH)
    want = jreact.circular_shuffle_spikes_within_epoch_and_decode(
        s["jm"], s["jy"], s["jeps"], common_ep=s["jcommon"], rng=SEED, **kw)
    assert want.index.nlevels == 2 and len(want) == N_SHUFFLE * L
    for engine in ("prob", "cuda"):
        pm = _port(s["jm"], s["name"], engine)
        got = reactivation.circular_shuffle_spikes_within_epoch_and_decode(
            pm, s["py"], s["peps"], common_ep=s["pcommon"], rng=SEED, **kw)
        pd.testing.assert_frame_equal(_frame(got), want, **FRAME_TOL)
        serial = reactivation.circular_shuffle_spikes_within_epoch_and_decode(
            pm, s["py"], s["peps"], common_ep=s["pcommon"], rng=SEED,
            batched=False, **kw)
        for c in ("pre", "post", "diff"):
            np.testing.assert_array_equal(serial[c], got[c])
        assert all(np.array_equal(a, b)
                   for a, b in zip(serial.index, got.index))
    if s["name"] == "PoissonGPLVMJump1D":
        jserial = jreact.circular_shuffle_spikes_within_epoch_and_decode(
            s["jm"], s["jy"], s["jeps"], common_ep=s["jcommon"], rng=SEED,
            batched=False, **kw)
        pd.testing.assert_frame_equal(jserial, want, **FRAME_TOL)


def test_null_moves_only_the_means_to_the_host(sim):
    """Per batch only its (shuffles, L) means cross to the host (counted
    on a device other than the CPU; here the count stays 0) and the
    shuffle batch size does not change the null."""
    s = sim
    pm = _port(s["jm"], s["name"], "cuda")
    reactivation._to_host.bytes = 0
    kw = dict(decoder_type="dynamics", n_shuffle=3, verbose=False, rng=SEED)
    a = reactivation.circular_shuffle_spikes_within_epoch_and_decode(
        pm, s["py"], s["peps"], shuffle_batch_size=1, **kw)
    b = reactivation.circular_shuffle_spikes_within_epoch_and_decode(
        pm, s["py"], s["peps"], shuffle_batch_size=32, **kw)
    assert reactivation._to_host.bytes == 0
    for c in a.columns:
        np.testing.assert_array_equal(a[c], b[c])
    with pytest.raises(ValueError, match="shuffle_batch_size"):
        reactivation.circular_shuffle_spikes_within_epoch_and_decode(
            pm, s["py"], s["peps"], shuffle_batch_size=0, **kw)


def test_circular_shuffle_column_independently():
    y = np.random.default_rng(3).poisson(2.0, (40, 6))
    for seed in (0, 5, np.int64(123)):
        np.testing.assert_array_equal(
            reactivation.circular_shuffle_column_independently(
                y, min_shift=5, rng=seed),
            jreact.circular_shuffle_column_independently(
                y, min_shift=5, rng=seed))


def test_random_reassign_prepost_latent_difference():
    rng = np.random.default_rng(4)
    post_d = {"pre": rng.dirichlet(np.ones(L), 30).astype(np.float32),
              "post": rng.dirichlet(np.ones(L), 25).astype(np.float32)}
    want = jreact.random_reassign_prepost_latent_difference(
        post_d, n_shuffle=4, verbose=False, rng=9)
    got = reactivation.random_reassign_prepost_latent_difference(
        {k: torch.as_tensor(v) for k, v in post_d.items()}, n_shuffle=4,
        verbose=False, rng=9)
    pd.testing.assert_frame_equal(_frame(got), want, **FRAME_TOL)


def test_generate_homogeneous_poisson_surrogate_data():
    rng = np.random.default_rng(5)
    spikes = {k: np.sort(rng.uniform(0, 10, 40 + 10 * k)) for k in range(4)}
    jg, pg = jts.TsGroup(spikes), pts.TsGroup(spikes)
    j_intv = {"pre": jts.IntervalSet(0.0, 4.0),
              "post": jts.IntervalSet(5.0, 9.5)}
    p_intv = {"pre": pts.IntervalSet(0.0, 4.0),
              "post": pts.IntervalSet(5.0, 9.5)}
    want = jreact.generate_homogeneous_poisson_surrogate_data(
        jg, j_intv, count_bin=0.1, n_repeat=3, verbose=False, rng=2)
    got = reactivation.generate_homogeneous_poisson_surrogate_data(
        pg, p_intv, count_bin=0.1, n_repeat=3, verbose=False, rng=2)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    for k in ("pre", "post"):
        np.testing.assert_array_equal(got[1][k], want[1][k])
        assert got[2][k] == want[2][k]
    np.testing.assert_array_equal(got[3], want[3])


def test_decode_ripple_epochs(sim):
    s = sim
    rng = np.random.default_rng(8)
    starts = rng.integers(0, len(s["y"]) - 40, size=9)
    intervals = np.stack([starts, starts + rng.integers(5, 40, size=9)], 1)
    jm = s["jm"]
    hyper = {"noise_std": 1.0} if s["name"].startswith("Gaussian") else None
    want = jreact.decode_ripple_epochs(jm, s["y"], intervals,
                                       hyperparam=hyper)
    for engine in ("prob", "cuda"):
        pm = _port(jm, s["name"], engine)
        got = reactivation.decode_ripple_epochs(pm, s["y"], intervals,
                                                batch_size=4)
        pd.testing.assert_frame_equal(_frame(got["posterior_mean_df"]),
                                      want["posterior_mean_df"],
                                      rtol=1e-5, atol=TOL_POST)
        np.testing.assert_allclose(got["log_marginal_per_epoch"],
                                   want["log_marginal_per_epoch"],
                                   rtol=TOL_LML)
        own = pm.decode_latent_epochs(s["y"], intervals, batch_size=4)
        np.testing.assert_array_equal(got["epoch_res"]["posterior_mean"],
                                      own["posterior_mean"])
    # a TsdFrame and time-valued intervals
    ep_t = np.stack([intervals[:, 0] * DT, (intervals[:, 1] - 0.5) * DT], 1)
    got_t = reactivation.decode_ripple_epochs(
        _port(jm, s["name"], "prob"), s["py"], ep_t)
    assert got_t["posterior_mean_df"].index_names == ("epoch",)
    np.testing.assert_array_equal(got_t["epoch_res"]["lengths"],
                                  intervals[:, 1] - intervals[:, 0])


def test_aggregate_within_ripple_per_epoch():
    rng = np.random.default_rng(6)
    t = np.arange(400) * DT
    post = rng.dirichlet(np.ones(L), len(t)).astype(np.float32)
    post[10:14, 3] = np.nan  # a NaN inside a ripple: skipped by the max
    ripples = {"pre": (np.array([0.2, 1.0, 2.05]), np.array([0.4, 1.5, 2.5])),
               "post": (np.array([6.0, 8.0]), np.array([6.3, 8.6])),
               "empty": (np.array([]), np.array([]))}
    want = jreact.aggregate_within_ripple_per_epoch(
        jts.TsdFrame(d=post, t=t),
        {k: jts.IntervalSet(*v) for k, v in ripples.items()})
    got = reactivation.aggregate_within_ripple_per_epoch(
        pts.TsdFrame(d=post, t=t),
        {k: pts.IntervalSet(*v) for k, v in ripples.items()})
    assert set(got) == set(want) == {"pre", "post"}
    for k in want:
        assert got[k].shape == want[k].shape == (L,)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_result_table_without_pandas(monkeypatch):
    """The card's machine has no pandas: ``to_dataframe()`` raises an
    ImportError naming it; the table itself needs none."""
    table = reactivation.random_reassign_prepost_latent_difference(
        {"pre": np.ones((3, 2)), "post": np.zeros((4, 2))}, n_shuffle=2,
        verbose=False, rng=0)
    assert len(table) == 4 and table.columns == ["pre", "post", "diff"]
    np.testing.assert_array_equal(table.index[0], [0, 0, 1, 1])
    np.testing.assert_array_equal(table.index[1], [0, 1, 0, 1])
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        table.to_dataframe()
