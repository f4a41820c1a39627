"""``poor_man_gplvm_tpu_torch.validation`` against
``poor_man_gplvm_tpu/validation.py`` on the same weights and spikes.

The port models take the JAX models' ``params`` and ``tuning_basis``
(``convert.load_jax_state``) and run on the CPU, on ``'prob'`` and on
``'cuda'`` (the batched kernel wrappers, which run their plain versions on
CPU tensors: ``hmm.smooth_batch_full``).  Tolerances (PARITY.json): the
shuffles exactly equal (the same numpy stream); posteriors and ``p_*``
1e-4 absolute; log-marginals 1e-5 relative; the other log keys 1e-5
relative to their largest magnitude, over entries above -50 (the floored
zeros carry no mass).  Within the port, a batched dynamics null equals the
serial one bit for bit (each shuffle's emission product and pairwise joint
are formed on their own), and a batched naive-Bayes null, one emission
product for the batch, agrees with the serial one to the same
tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu import validation as jval  # noqa: E402
from poor_man_gplvm_tpu.utils import timeseries as jts  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import convert, validation  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import timeseries as pts  # noqa: E402

torch.set_num_threads(1)

T, N, L = 200, 16, 24
N_SHUFFLE = 5
BATCH = 2  # ragged: batches of 2, 2 and 1
SEED = 3
TOL_POST = 1e-4
TOL_LMF = 1e-5
TOL_LOG = 1e-5
CLASSES = ("PoissonGPLVMJump1D", "GaussianGPLVM1D")


def _kw(name):
    kw = dict(n_latent_bin=L, movement_variance=1, tuning_lengthscale=4.0)
    if name.startswith("Gaussian"):
        kw["noise_std"] = 1.0
    return kw


def _data(jm, seed):
    rng = np.random.default_rng(seed)
    lat = np.clip(np.cumsum(rng.integers(-1, 2, size=T)) + L // 2, 0, L - 1)
    mean = np.asarray(jm.tuning)[lat]
    if jm.observation_model == "gaussian":
        return (mean + rng.normal(size=mean.shape)).astype(np.float32)
    return rng.poisson(mean).astype(np.float32)


def _port(jm, name, engine):
    m = getattr(pmt, name)(N, device="cpu", inference_engine=engine,
                           **_kw(name))
    state = convert.state_from_model(jm)
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


@pytest.fixture(scope="module", params=CLASSES)
def setup(request):
    name = request.param
    jm = getattr(jpmg, name)(N, inference_engine="prob", **_kw(name))
    return name, jm, _data(jm, 1 + CLASSES.index(name))


def assert_key_close(k, got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, k
    if k.startswith(("posterior", "p_")):
        assert np.abs(got - want).max() <= TOL_POST, k
    elif k.startswith("log_marginal"):
        np.testing.assert_allclose(got, want, rtol=TOL_LMF, err_msg=k)
    else:
        mask = np.isfinite(want) & (want > -50.0)
        err = np.abs(got - want)[mask].max() / np.abs(want[mask]).max()
        assert err <= TOL_LOG, (k, err)


def assert_null_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert isinstance(got[k], np.ndarray), k
            assert_key_close(k, got[k], want[k])


@pytest.mark.parametrize("ep", [None, "restricted"])
def test_circular_shuffles_equal_jax(ep):
    y = np.random.default_rng(4).poisson(2.0, size=(90, 7)).astype(float)
    t = np.arange(90) * 0.1
    if ep is None:
        want = jval.circular_shuffle_data(y, n_shuffle=4, seed=11)
        got = validation.circular_shuffle_data(y, n_shuffle=4, seed=11)
    else:
        iv = (np.array([0.5, 4.0]), np.array([2.5, 7.05]))
        want = jval.circular_shuffle_data(
            jts.TsdFrame(d=y, t=t), n_shuffle=4, ep=jts.IntervalSet(*iv),
            seed=11)
        got = validation.circular_shuffle_data(
            pts.TsdFrame(d=y, t=t), n_shuffle=4, ep=pts.IntervalSet(*iv),
            seed=11)
    got, want = list(got), list(want)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(TypeError):
        next(validation.circular_shuffle_data(y, ep=pts.IntervalSet(0, 1)))


@pytest.mark.parametrize("engine", ["prob", "cuda"])
@pytest.mark.parametrize("decoder_type", ["naive_bayes", "dynamics"])
def test_shuffle_and_decode_matches_jax(setup, decoder_type, engine):
    name, jm, y = setup
    kw = dict(n_shuffle=N_SHUFFLE, seed=SEED, decoder_type=decoder_type,
              verbose=False, shuffle_batch_size=BATCH)
    want = jval.shuffle_and_decode(jm, y, **kw)
    got = validation.shuffle_and_decode(_port(jm, name, engine), y, **kw)
    assert_null_close(got, want)


@pytest.mark.parametrize("memory_mode", ["checkpoint", "filter"])
def test_nonfull_memory_mode_matches_jax(setup, memory_mode):
    name, jm, y = setup
    kw = dict(n_shuffle=3, seed=SEED, decoder_type="dynamics", verbose=False,
              shuffle_batch_size=BATCH, memory_mode=memory_mode)
    want = jval.shuffle_and_decode(jm, y, **kw)
    for engine in ("prob", "cuda"):
        got = validation.shuffle_and_decode(_port(jm, name, engine), y, **kw)
        assert got["log_likelihood_all"] is None
        assert_null_close(got, want)


@pytest.mark.parametrize("decoder_type", ["naive_bayes", "dynamics"])
def test_batched_equals_serial(setup, decoder_type, capsys):
    name, jm, y = setup
    m = _port(jm, name, "cuda")
    kw = dict(n_shuffle=N_SHUFFLE, seed=SEED, decoder_type=decoder_type)
    serial = validation.shuffle_and_decode(m, y, batched=False,
                                           verbose=False, **kw)
    batched = validation.shuffle_and_decode(m, y, shuffle_batch_size=BATCH,
                                            **kw)
    # verbose: one line per batch
    assert capsys.readouterr().out.count("shuffle_and_decode: batch") == 3
    assert set(serial) == set(batched)
    for k in serial:
        if decoder_type == "dynamics":
            np.testing.assert_array_equal(batched[k], serial[k].astype(
                batched[k].dtype), err_msg=k)
        else:
            assert_key_close(k, batched[k], serial[k])
    # every shuffle in one batch, or one at a time: the same bits
    one = validation.shuffle_and_decode(m, y, shuffle_batch_size=1,
                                        verbose=False, **kw)
    big = validation.shuffle_and_decode(m, y, shuffle_batch_size=132,
                                        verbose=False, **kw)
    if decoder_type == "dynamics":
        for k in one:
            np.testing.assert_array_equal(one[k], big[k], err_msg=k)


def test_batched_rows_equal_decode_latent_alone(setup):
    """Each stacked row of the batched dynamics null is
    ``decode_latent(engine='cuda')`` of that shuffle alone, bit for bit."""
    name, jm, y = setup
    m = _port(jm, name, "cuda")
    res = validation.shuffle_and_decode(
        m, y, n_shuffle=3, seed=SEED, decoder_type="dynamics", verbose=False,
        shuffle_batch_size=3)
    for s, y_s in enumerate(validation.circular_shuffle_data(
            y, n_shuffle=3, seed=SEED)):
        alone = m.decode_latent(y_s, n_time_per_chunk=10000)
        for k, v in alone.items():
            v = v.numpy() if torch.is_tensor(v) else np.float32(v)
            np.testing.assert_array_equal(res[k][s], v, err_msg=k)


@pytest.mark.parametrize("decoder_type", ["naive_bayes", "dynamics"])
def test_one_model_matches_jax(setup, decoder_type):
    """The thresholds within tolerance; ``is_sig`` equal wherever the true
    value lies farther than that tolerance from the threshold."""
    name, jm, y = setup
    t = np.arange(T) * 0.025
    want = jval.test_one_model(jts.TsdFrame(d=y, t=t), jm, n_shuffle=8,
                               decoder_type=decoder_type, seed=SEED)
    got = validation.test_one_model(pts.TsdFrame(d=y, t=t),
                                    _port(jm, name, "cuda"), n_shuffle=8,
                                    decoder_type=decoder_type, seed=SEED)
    thr_j, thr_p = want["log_marg_thresh"], got["log_marg_thresh"]
    tol = TOL_LMF * np.abs(thr_j).max()
    assert np.abs(thr_p - thr_j).max() <= tol
    key = "log_marginal_l" if decoder_type == "naive_bayes" else \
        "log_one_step_predictive_marginals_all"
    true_j = np.asarray(want["decode_res_true"][key])
    decided = np.abs(true_j - thr_j) > 2 * tol
    assert decided.mean() > 0.9
    assert isinstance(got["is_sig_tsd"], pts.Tsd)
    np.testing.assert_array_equal(got["is_sig_tsd"].t, t)
    np.testing.assert_array_equal(np.asarray(got["is_sig_tsd"].d)[decided],
                                  np.asarray(want["is_sig_tsd"].d)[decided])
    assert_null_close(got["decode_res_shuffle"], want["decode_res_shuffle"])


def test_entropy_contrast_and_jump_segments():
    rng = np.random.default_rng(8)
    logp = np.log(rng.dirichlet(np.ones(6), size=(10, 3)))
    for axis in ((-1, -2), -1):
        np.testing.assert_array_equal(
            validation.compute_entropy(torch.as_tensor(logp), axis=axis),
            jval.compute_entropy(logp, axis=axis))
    tuning = rng.gamma(2.0, 1.0, size=(20, 6))
    x = rng.normal(size=(30, 6))
    got = validation.get_contrast_axis_and_proj(
        torch.as_tensor(x), torch.as_tensor(tuning), 5, 15, 2)
    want = jval.get_contrast_axis_and_proj(x, tuning, 5, 15, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    t = np.arange(60) * 0.1
    jump = np.zeros(60)
    jump[[18, 19, 21, 40, 41]] = 0.9
    post = np.concatenate([np.full(20, 3.0), np.full(20, 12.0),
                           np.full(20, 7.0)])
    got = validation.segment_trial_by_jump(
        pts.Tsd(d=jump, t=t), pts.Tsd(d=post, t=t),
        jump_p_merge_threshold_time=0.25)
    want = jval.segment_trial_by_jump(
        jts.Tsd(d=jump, t=t), jts.Tsd(d=post, t=t),
        jump_p_merge_threshold_time=0.25)
    assert got["post_map_median_per_epoch"] == \
        want["post_map_median_per_epoch"]
    for k in ("jump_epoch", "continuous_epoch"):
        np.testing.assert_array_equal(got[k].values, want[k].values)
    assert len(got["continuous_epoch"]) == 3


def test_invalid_arguments_raise(setup):
    name, jm, y = setup
    m = _port(jm, name, "cuda")
    with pytest.raises(ValueError, match="decoder_type"):
        validation.shuffle_and_decode(m, y, n_shuffle=1, decoder_type="x")
    with pytest.raises(ValueError, match="shuffle_batch_size"):
        validation.shuffle_and_decode(m, y, n_shuffle=1,
                                      shuffle_batch_size=0)
    with pytest.raises(ValueError, match="decoder_type"):
        validation.test_one_model(pts.TsdFrame(d=y, t=np.arange(T) * 1.0), m,
                                  n_shuffle=1, decoder_type="x")
