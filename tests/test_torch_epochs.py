"""``PoissonGPLVMJump1D.decode_latent_epochs`` of the port against the JAX
method on the same weights, spikes and intervals.

The model is the README's (T = 1000, N = 30, L = 100).  The JAX method
runs its ``'prob'`` smoother under ``vmap`` over the padded epochs; the
port model is built on the CPU from the JAX model's weights through
``convert.load_jax_state`` and runs ``'cuda'`` (the batched kernel
wrappers, which run ``*_batch_plain`` on CPU tensors: each epoch over
exactly its own bins) and ``'prob'`` (the per-epoch loop).  Tolerances, as
PARITY.json: posteriors 1e-4 absolute, log-marginals 1e-5 relative; the
lengths, the valid mask and the NaN pattern must be equal.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D, convert  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402
from poor_man_gplvm_tpu_torch.testing import scan_case  # noqa: E402

torch.set_num_threads(1)

T, N, L = 1000, 30, 100
TOL_POST = 1e-4
TOL_LML = 1e-5
#: ragged epochs: a 1-bin one, the longest odd, two that overlap, one that
#: ends at the recording's last bin
INTERVALS = np.array([[10, 47], [100, 101], [300, 361], [340, 352],
                      [700, 723], [990, 1000]])
DT = 0.02  # bin width of the time-valued intervals


def _spikes(tuning, seed=0):
    """Poisson counts along a numpy random-walk latent path with jumps."""
    rng = np.random.default_rng(seed)
    x, lat = int(rng.integers(L)), []
    for _ in range(T):
        x = int(rng.integers(L)) if rng.random() < 0.02 else int(
            np.clip(x + rng.integers(-1, 2), 0, L - 1))
        lat.append(x)
    return rng.poisson(np.asarray(tuning)[lat]).astype(np.float32)


def _port_model(jax_model, engine):
    m = PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                           tuning_lengthscale=10.0, inference_engine=engine,
                           device="cpu")
    state = convert.state_from_model(jax_model)
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


@pytest.fixture(scope="module")
def models():
    jm = jpmg.PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                                 tuning_lengthscale=10.0,
                                 inference_engine="prob")
    pm = {e: _port_model(jm, e) for e in ("cuda", "prob")}
    return jm, pm, _spikes(jm.tuning)


@pytest.fixture(scope="module")
def jax_epochs(models):
    jm, _, y = models
    return jm.decode_latent_epochs(y, INTERVALS)


def assert_epochs_close(got, want):
    assert set(got) == set(want) == {
        "posterior_latent_marg", "posterior_mean", "log_marginal_per_epoch",
        "lengths", "valid"}
    assert all(isinstance(v, np.ndarray) for v in got.values())
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].dtype == bool
    post = got["posterior_latent_marg"]
    post_ref = want["posterior_latent_marg"]
    assert post.shape == post_ref.shape
    np.testing.assert_array_equal(np.isnan(post), np.isnan(post_ref))
    assert np.nanmax(np.abs(post - post_ref)) <= TOL_POST
    assert np.abs(got["posterior_mean"]
                  - want["posterior_mean"]).max() <= TOL_POST
    lml, lml_ref = (np.asarray(x["log_marginal_per_epoch"], np.float64)
                    for x in (got, want))
    assert (np.abs(lml - lml_ref) <= TOL_LML * np.abs(lml_ref)).all()


def _equal(a, b):
    return all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)


@pytest.mark.parametrize("engine", ["cuda", "prob"])
def test_epochs_match_jax(models, jax_epochs, engine):
    _, pm, y = models
    res = pm[engine].decode_latent_epochs(y, INTERVALS)
    assert_epochs_close(res, jax_epochs)
    lengths = INTERVALS[:, 1] - INTERVALS[:, 0]
    post = res["posterior_latent_marg"]
    assert post.shape == (len(INTERVALS), lengths.max(), L)
    # NaN exactly past each epoch's end, rows of probabilities before it
    valid = np.arange(lengths.max())[None, :] < lengths[:, None]
    np.testing.assert_array_equal(np.isnan(post).all(axis=2), ~valid)
    np.testing.assert_array_equal(np.isnan(post).any(axis=2), ~valid)
    assert np.abs(post.sum(axis=2)[valid] - 1).max() <= 1e-5
    assert res["posterior_mean"].dtype == np.float64


@pytest.mark.parametrize("batch_size", [1, 4, 6, 100])
def test_batch_size_invariance(models, jax_epochs, batch_size):
    _, pm, y = models
    whole = pm["cuda"].decode_latent_epochs(y, INTERVALS)
    parts = pm["cuda"].decode_latent_epochs(y, INTERVALS,
                                            batch_size=batch_size)
    assert _equal(whole, parts)
    assert_epochs_close(parts, jax_epochs)


def test_epochs_equal_decode_latent_on_each_epoch_alone(models):
    _, pm, y = models
    res = pm["cuda"].decode_latent_epochs(y, INTERVALS)
    for e, (a, b) in enumerate(INTERVALS):
        alone = pm["cuda"].decode_latent(y[a:b])
        np.testing.assert_allclose(
            res["posterior_latent_marg"][e, :b - a],
            alone["posterior_latent_marg"].numpy(), rtol=0, atol=1e-6)
        assert abs(res["log_marginal_per_epoch"][e]
                   - alone["log_marginal_final"]) <= 1e-6 * abs(
                       alone["log_marginal_final"])


class _FakeIntervalSet:
    """Duck-typed as the JAX method duck-types a pynapple IntervalSet."""

    def __init__(self, values):
        self.values, self.loc = values, None


def test_time_valued_intervals(models):
    jm, pm, y = models
    t_l = np.arange(T) * DT
    # bounds between bin times, on a bin time, and up to the last bin
    times = np.array([[0.205, 0.95], [2.0, 2.0], [6.01, 7.205],
                      [19.495, 25.0]])
    want = jm.decode_latent_epochs(y, times, t_l=t_l)
    got = pm["cuda"].decode_latent_epochs(y, times, t_l=t_l)
    assert_epochs_close(got, want)
    np.testing.assert_array_equal(got["lengths"], [37, 1, 60, 25])
    # an IntervalSet-like object and a TsdFrame-like y carry the same
    frame = types.SimpleNamespace(d=y, t=t_l)
    assert _equal(got, pm["cuda"].decode_latent_epochs(
        frame, _FakeIntervalSet(times)))
    # an explicit t_l wins over the frame's
    assert _equal(got, pm["cuda"].decode_latent_epochs(
        types.SimpleNamespace(d=y, t=t_l + 1.0), times, t_l=t_l))


#: epochs of one length: the JAX method pads nothing
EQUAL_INTERVALS = np.array([[10, 47], [300, 337], [700, 737]])
MA_LATENT = (np.arange(L) % 11 != 3).astype(np.float32)


def test_overrides_reach_the_batched_path(models):
    jm, pm, y = models
    kw = dict(hyperparam={"movement_variance": 4.0, "p_move_to_jump": 0.05},
              ma_neuron=(np.arange(N) % 5 != 0).astype(np.float32),
              ma_latent=MA_LATENT, likelihood_scale=0.5)
    want = jm.decode_latent_epochs(y, EQUAL_INTERVALS, **kw)
    got = pm["cuda"].decode_latent_epochs(y, EQUAL_INTERVALS, **kw)
    assert_epochs_close(got, want)
    plain = pm["cuda"].decode_latent_epochs(y, EQUAL_INTERVALS)
    assert np.nanmax(np.abs(plain["posterior_latent_marg"]
                            - got["posterior_latent_marg"])) > 1e-3
    # masked latent bins carry exactly no mass
    assert (got["posterior_latent_marg"][..., 3::11] == 0).all()
    # without a latent mask ragged epochs match as well
    del kw["ma_latent"]
    assert_epochs_close(pm["cuda"].decode_latent_epochs(y, INTERVALS, **kw),
                        jm.decode_latent_epochs(y, INTERVALS, **kw))


def test_masked_latent_bins_in_ragged_epochs_follow_the_epoch_alone(models):
    """A divergence from the JAX method, whose padding is not exact under a
    latent mask: a padded row's likelihood is 1 on the kept bins and 0 on
    the masked ones, so it tells the shorter epochs that the state stays
    off the masked bins after their end.  The port runs each epoch over its
    own bins only and equals the JAX ``decode_latent`` of the epoch alone;
    the JAX batch is off on the padded epochs."""
    jm, pm, y = models
    got = pm["cuda"].decode_latent_epochs(y, INTERVALS, ma_latent=MA_LATENT)
    padded = jm.decode_latent_epochs(y, INTERVALS, ma_latent=MA_LATENT)
    longest = int(np.argmax(INTERVALS[:, 1] - INTERVALS[:, 0]))
    off = 0.0
    for e, (a, b) in enumerate(INTERVALS):
        alone = jm.decode_latent(y[a:b], ma_latent=MA_LATENT)
        post = np.asarray(alone["posterior_latent_marg"])
        assert np.abs(got["posterior_latent_marg"][e, :b - a]
                      - post).max() <= TOL_POST
        lml = alone["log_marginal_final"]
        assert abs(got["log_marginal_per_epoch"][e]
                   - lml) <= TOL_LML * abs(lml)
        gap = np.abs(padded["posterior_latent_marg"][e, :b - a] - post).max()
        if e == longest:  # no padded row: the JAX batch is exact there
            assert gap <= TOL_POST
        off = max(off, gap)
    assert off > 1e-3


def test_latent_only_transition_through_the_batched_plain_scans():
    """n_dyn = 1: ``hmm.smooth_epochs`` with a ``LatentTransition`` (the
    batched wrappers run ``*_batch_plain`` on CPU tensors) against the JAX
    smoother on each epoch alone."""
    Ls, Ns = 37, 9
    c = scan_case(11, 4, Ls, 1, "masked")  # its RBF channel
    tl = c["tlat"][0]
    rng = np.random.default_rng(5)
    tuning = rng.uniform(0.2, 3.0, (Ls, Ns)).astype(np.float32)
    lengths = np.array([13, 1, 30, 2])
    y_b = np.zeros((4, 30, Ns), np.float32)
    for e, n in enumerate(lengths):
        y_b[e, :n] = rng.poisson(1.0, (n, Ns))
    ma = np.ones(Ns, np.float32)
    trans = hmm.LatentTransition(torch.tensor(tl), torch.log(torch.tensor(tl)))
    got = {eng: hmm.smooth_epochs(torch.tensor(y_b), lengths,
                                  torch.tensor(tuning), {}, trans,
                                  torch.tensor(ma), engine=eng)
           for eng in ("cuda", "cuda_parallel", "prob")}
    for e, n in enumerate(lengths):  # rows past a length are unspecified
        assert torch.equal(got["cuda"][0][e, :n],
                           got["cuda_parallel"][0][e, :n])
    j_trans = jhmm.LatentTransition(jnp.asarray(tl), jnp.log(jnp.asarray(tl)))
    for e, n in enumerate(lengths):
        smooth, lml, *_ = jhmm.smooth_combined_chunked(
            jnp.asarray(y_b[e, :n]), jnp.asarray(tuning), {}, j_trans,
            jnp.asarray(ma), engine="prob", want_acc=False)
        want = np.exp(np.asarray(smooth))
        for eng in ("cuda", "prob"):
            lat, lml_p = got[eng]
            assert np.abs(lat[e, :n].numpy() - want).max() <= TOL_POST, eng
            assert abs(float(lml_p[e]) - float(lml)) <= TOL_LML * abs(
                float(lml)), eng


@pytest.mark.parametrize("bad, error, match", [
    (dict(intervals=np.array([1, 5])), ValueError, r"must be \(E, 2\)"),
    (dict(intervals=np.array([[1, 5, 7]])), ValueError, r"must be \(E, 2\)"),
    (dict(intervals=np.array([[5, 5]])), ValueError, ">= 1 bin"),
    (dict(intervals=np.array([[7, 3]])), ValueError, ">= 1 bin"),
    (dict(intervals=np.array([[0.1, 0.5]])), ValueError, "need t_l"),
    (dict(ma_neuron=np.ones((T, N), np.float32)), ValueError, "1-D ma_neuron"),
    (dict(batch_size=0), ValueError, "batch_size"),
    # the two deliberate divergences: the JAX method lets a negative start
    # wrap around and drops a non-numeric hyperparameter silently
    (dict(intervals=np.array([[-5, -2]])), ValueError, "bounds must lie in"),
    (dict(intervals=np.array([[-3, 4]])), ValueError, "bounds must lie in"),
    (dict(intervals=np.array([[990, 1001]])), ValueError,
     "bounds must lie in"),
    (dict(hyperparam={"note": "ripples"}), TypeError, "hyperparam\\['note'\\]"),
    (dict(hyperparam={"movement_variance": None}), TypeError,
     "movement_variance"),
    (dict(hyperparam={"x": np.array(["a"])}), TypeError, "numeric array"),
])
@pytest.mark.parametrize("engine", ["cuda", "prob"])
def test_input_validation(models, engine, bad, error, match):
    _, pm, y = models
    kw = dict(intervals=INTERVALS[:2])
    kw.update(bad)
    with pytest.raises(error, match=match):
        pm[engine].decode_latent_epochs(y, **kw)


def test_jax_method_lets_those_inputs_through(models):
    """What the port raises on: a negative start wraps to the recording's
    end in the JAX method, and a non-numeric hyperparameter is dropped."""
    jm, pm, y = models
    wrapped = jm.decode_latent_epochs(y, np.array([[-5, -2]]))
    same = pm["cuda"].decode_latent_epochs(y, np.array([[T - 5, T - 2]]))
    assert_epochs_close(same, wrapped)
    dropped = jm.decode_latent_epochs(y, np.array([[T - 5, T - 2]]),
                                      hyperparam={"note": "ripples"})
    assert_epochs_close(same, dropped)


@pytest.mark.parametrize("engine", ["cuda", "prob"])
def test_one_bin_epoch_and_single_epoch(models, engine):
    jm, pm, y = models
    one = np.array([[412, 413]])
    got = pm[engine].decode_latent_epochs(y, one)
    assert got["posterior_latent_marg"].shape == (1, 1, L)
    assert not np.isnan(got["posterior_latent_marg"]).any()
    assert_epochs_close(got, jm.decode_latent_epochs(y, one))
    alone = pm[engine].decode_latent(y[412:413])
    np.testing.assert_allclose(got["posterior_latent_marg"][0],
                               alone["posterior_latent_marg"].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["posterior_mean"],
                               got["posterior_latent_marg"][0], atol=1e-7)
    # E = 1 with many bins, and numeric hyperparameters of every kind
    single = pm[engine].decode_latent_epochs(
        torch.tensor(y), np.array([[200, 260]]),
        hyperparam={"movement_variance": np.float32(1.0),
                    "p_move_to_jump": torch.tensor(0.01),
                    "p_jump_to_move": np.float64(0.01)})
    alone = pm[engine].decode_latent(y[200:260])
    np.testing.assert_allclose(single["posterior_latent_marg"][0],
                               alone["posterior_latent_marg"].numpy(),
                               rtol=0, atol=1e-6)
    assert single["valid"].all() and single["lengths"].tolist() == [60]
