"""Edge shapes of the neuron mask, port against the JAX package: a 2-D
``ma_neuron`` (T, N) with all-masked rows (every neuron masked in a bin)
and a whole all-masked host chunk, through ``decode_latent`` and
``fit_em``, on the CPU ('prob', and 'cuda', whose kernel wrappers run
their plain versions on CPU tensors).

A fully masked bin carries no evidence: its log-likelihood row is 0 for
every latent bin, and the filter only pushes the prior through it.
Tolerances (PARITY.json): log-marginals 1e-5 relative, decode posteriors
1e-4, fit posteriors 1e-2; the fit caps ``m_step_maxiter``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import convert  # noqa: E402

torch.set_num_threads(1)

T, N, L = 200, 10, 16
CHUNK = 50
TOL_LMF, TOL_POST, TOL_FIT = 1e-5, 1e-4, 1e-2
CLASSES = ("PoissonGPLVMJump1D", "GaussianGPLVM1D")


def _kw(name):
    kw = dict(n_latent_bin=L, movement_variance=1, tuning_lengthscale=4.0)
    if name.startswith("Gaussian"):
        kw["noise_std"] = 1.0
    return kw


def _mask():
    ma = np.ones((T, N), dtype=np.float32)
    ma[10:20] = 0.0  # all-masked rows inside a chunk
    ma[100:150] = 0.0  # a whole all-masked chunk (CHUNK = 50)
    ma[160:170, :3] = 0.0  # a few neurons only
    return ma


@pytest.fixture(scope="module", params=CLASSES)
def pair(request):
    name = request.param
    jm = getattr(jpmg, name)(N, inference_engine="prob", **_kw(name))
    rng = np.random.default_rng(4)
    lat = np.clip(np.cumsum(rng.integers(-1, 2, size=T)) + L // 2, 0, L - 1)
    mean = np.asarray(jm.tuning)[lat]
    y = (mean + rng.normal(size=mean.shape) if name.startswith("Gaussian")
         else rng.poisson(mean)).astype(np.float32)
    return name, jm, y


def _port(jm, name, engine):
    m = getattr(pmt, name)(N, device="cpu", inference_engine=engine,
                           **_kw(name))
    state = convert.state_from_model(jm)
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("engine", ["prob", "cuda"])
def test_decode_with_all_masked_rows_and_chunks(pair, engine):
    name, jm, y = pair
    ma = _mask()
    want = jm.decode_latent(y, ma_neuron=jnp.asarray(ma),
                            n_time_per_chunk=CHUNK)
    pm = _port(jm, name, engine)
    got = pm.decode_latent(y, ma_neuron=torch.as_tensor(ma),
                           n_time_per_chunk=CHUNK)
    np.testing.assert_allclose(got["log_marginal_final"],
                               float(want["log_marginal_final"]),
                               rtol=TOL_LMF)
    post = _np(got["posterior_all"])
    np.testing.assert_allclose(post, np.asarray(want["posterior_all"]),
                               atol=TOL_POST)
    assert np.all(np.isfinite(post))
    # a masked bin has no evidence: its log-likelihood row is 0
    ll = _np(got["log_likelihood_all"])
    assert np.all(ll[10:20] == 0) and np.all(ll[100:150] == 0)
    np.testing.assert_allclose(
        _np(got["log_one_step_predictive_marginals_all"]),
        np.asarray(want["log_one_step_predictive_marginals_all"]),
        rtol=TOL_LMF, atol=1e-5)


def test_fit_with_all_masked_rows_and_chunks(pair):
    name, jm, y = pair
    ma = _mask()
    lpi, _ = jm.init_latent_posterior(T, jr.PRNGKey(2))
    kw = dict(n_iter=3, log_posterior_init=lpi, verboase=False,
              n_time_per_chunk=CHUNK)
    if name.startswith("Poisson"):
        kw["m_step_maxiter"] = 20
    pm = _port(jm, name, "prob")  # before the JAX fit moves jm's params
    want = getattr(jpmg, name)(N, inference_engine="prob", **_kw(name))
    want = want.fit_em(y, key=jr.PRNGKey(1), ma_neuron=jnp.asarray(ma), **kw)
    kw["log_posterior_init"] = np.asarray(lpi)
    got = pm.fit_em(y, ma_neuron=torch.as_tensor(ma), **kw)
    np.testing.assert_allclose([float(v) for v in got["log_marginal_l"]],
                               [float(v) for v in want["log_marginal_l"]],
                               rtol=TOL_LMF)
    np.testing.assert_allclose(_np(got["posterior"]),
                               np.asarray(want["posterior"]), atol=TOL_FIT)
