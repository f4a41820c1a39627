"""``engine='log'`` of the port against the JAX package's ``'log'``
engine: the log-space scans in the JAX order of operations, for the
latent-only transition (n_dyn = 1) and the joint one (n_dyn = 2), through
the transition methods, ``decode_latent``, ``decode_latent_epochs`` and
``fit_em``.  The log engine is a plain PyTorch loop, the second oracle of
the probability-space engines; it runs only when asked for by name.

Tolerances (PARITY.json): log-marginals 1e-5 relative, decode posteriors
1e-4, fit posteriors 1e-2; the transition methods to f32 rounding (1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu.ops import kernels as jker  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import convert  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402
from test_torch_families import (  # noqa: E402
    _data, _lml, _uniform_noise_init, assert_decode_close,
)

torch.set_num_threads(1)

T, N, L = 500, 20, 60
CLASSES = ("PoissonGPLVM1D", "PoissonGPLVMJump1D")


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _models(name, port_engine="log", n=N, l=L, **kw):
    jm = getattr(jpmg, name)(n, n_latent_bin=l, movement_variance=1,
                             tuning_lengthscale=5.0, inference_engine="log",
                             **kw)
    pm = getattr(pmt, name)(n, n_latent_bin=l, movement_variance=1,
                            tuning_lengthscale=5.0, device="cpu",
                            inference_engine=port_engine, **kw)
    state = convert.state_from_model(jm)
    convert.load_jax_state(pm, state["params"], state["tuning_basis"])
    return jm, pm


@pytest.mark.parametrize("latent_only", [True, False])
def test_log_transition_methods_match_jax(latent_only):
    rng = np.random.default_rng(1)
    Lt = 9
    lat, log_lat, dyn, log_dyn = (np.asarray(a) for a in
                                  jker.create_transition_prob_1d(
                                      jnp.arange(Lt), jnp.arange(2), 1.5,
                                      0.03, 0.1))
    if latent_only:
        j = jhmm.LatentTransition(jnp.asarray(lat[0]), jnp.asarray(log_lat[0]))
        p = hmm.LatentTransition(_t(lat[0]), _t(log_lat[0]))
        shape = (Lt,)
    else:
        j = jhmm.JointTransition(*map(jnp.asarray, (dyn, lat, log_dyn,
                                                    log_lat)))
        p = hmm.JointTransition(*map(_t, (dyn, lat, log_dyn, log_lat)))
        shape = (2, Lt)
    logs = [np.log(rng.dirichlet(np.ones(int(np.prod(shape))))).reshape(
        shape).astype(np.float32) for _ in range(3)]
    np.testing.assert_allclose(p.push_log(_t(logs[0])).numpy(),
                               np.asarray(j.push_log(jnp.asarray(logs[0]))),
                               rtol=1e-5, atol=1e-5)
    got = p.smooth_step_log(*map(_t, logs))
    want = j.smooth_step_log(*map(jnp.asarray, logs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module", params=CLASSES)
def log_models(request):
    jm, pm = _models(request.param)
    y = _data(jm, T, seed=1)
    return jm, pm, y, jm.decode_latent(y)


def test_log_decode_matches_jax(log_models):
    jm, pm, y, want = log_models
    assert pm.inference_engine == "log"
    got = pm.decode_latent(y)
    assert_decode_close(got, want)
    # chunked: the log-space carries (smoothed posterior, log joint) cross
    assert_decode_close(pm.decode_latent(y, n_time_per_chunk=37), want)


def test_log_decode_matches_prob_engine(log_models):
    jm, pm, y, want = log_models
    prob = pmt.__dict__[type(pm).__name__](
        N, n_latent_bin=L, movement_variance=1, tuning_lengthscale=5.0,
        device="cpu", inference_engine="prob")
    convert.load_jax_state(prob, convert.state_from_model(jm)["params"],
                           pm.tuning_basis.numpy())
    assert_decode_close(prob.decode_latent(y), want)


def test_log_fit_matches_jax(log_models):
    jm, pm, y, _ = log_models
    lpi = _uniform_noise_init(T, L, 2)
    want = jm.fit_em(y, n_iter=2, log_posterior_init=lpi, verboase=False,
                     m_step_maxiter=20)
    got = pm.fit_em(y, n_iter=2, log_posterior_init=lpi, verboase=False,
                    m_step_maxiter=20)
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=1e-5)
    assert np.abs(got["posterior"].numpy()
                  - np.asarray(want["posterior"])).max() <= 1e-2
    assert got["m_step_res_l"]["n_iter"] == want["m_step_res_l"]["n_iter"]


def test_log_epochs_match_jax(log_models):
    """``decode_latent_epochs`` on the log engine loops over the epochs;
    the JAX method runs its log engine under ``vmap``."""
    jm, pm, y, _ = log_models
    intervals = np.array([[0, 40], [100, 117], [300, 301], [420, 500]])
    want = jm.decode_latent_epochs(y, intervals)
    got = pm.decode_latent_epochs(y, intervals)
    np.testing.assert_allclose(got["log_marginal_per_epoch"],
                               want["log_marginal_per_epoch"], rtol=1e-5)
    np.testing.assert_allclose(got["posterior_latent_marg"],
                               want["posterior_latent_marg"], atol=1e-4)


def test_log_engine_is_asked_for_by_name(log_models):
    jm, pm, y, _ = log_models
    assert type(pm)(4, n_latent_bin=6, device="cpu").inference_engine == "prob"
    trans = pm._make_transition({})[0]
    assert not hmm.engine_resolves_parallel(10**6, trans, "log", "cpu")
    assert hmm.parallel_scan_carry_spec(10**6, trans, "log") is None
    with pytest.raises(ValueError, match="memory_mode"):
        hmm.smooth_combined_chunked(y, pm.tuning, {}, trans,
                                    pm.ma_neuron_default, engine="log",
                                    memory_mode="checkpoint")
    # a lean fit needs the checkpoint memory mode: both packages raise
    for model in (jm, pm):
        with pytest.raises(ValueError, match="memory_mode"):
            model.fit_em(y, n_iter=1, verboase=False, output_mode="lean",
                         m_step_maxiter=5)


def test_log_engine_is_the_oracle_where_prob_underflows():
    """GaussianGPLVM1D fitted from a random Dirichlet posterior: the first
    ridge M-step gives tuning curves that the narrow latent-only
    transition cannot follow, the likelihood weights of the
    probability-space engines underflow, and both packages' 'prob' fits
    leave the exact trajectory (by ~4 % here), each in its own way (XLA
    flushes subnormals, torch keeps them).  The two log engines stay
    together: the port's 'log' is the oracle there."""
    Tg, Ng, Lg = 1000, 30, 100
    jm, pm = _models("GaussianGPLVM1D", n=Ng, l=Lg, noise_std=0.5)
    y = _data(jm, Tg, seed=0)
    lpi = np.log(np.random.default_rng(5).dirichlet(np.ones(Lg), Tg)).astype(
        np.float32)
    want = jm.fit_em(y, n_iter=3, log_posterior_init=lpi, verboase=False)
    got = pm.fit_em(y, n_iter=3, log_posterior_init=lpi, verboase=False)
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=1e-5)
    pm.inference_engine = "prob"
    prob = pm.fit_em(y, n_iter=3, log_posterior_init=lpi, verboase=False)
    assert abs(_lml(prob)[2] - _lml(got)[2]) > 1e-3 * abs(_lml(got)[2])
