"""``poor_man_gplvm_tpu_torch.experimental.gain`` against
``poor_man_gplvm_tpu/experimental/gain.py``: the gain model's fit, its
gain-refitting naive-Bayes decode, its statistics and M-steps, the
gain-aware decode on both port engines, and the shuffle null.

Same numpy spikes and weights in both packages (``convert.
load_jax_state``), the same initial posterior, on the CPU ('prob', and
'cuda', whose kernel wrappers run their plain versions on CPU tensors).
Tolerances: the ``poisson_gain[prob]`` case of PARITY.json (log-marginals
1e-5 relative, fit posteriors and fitted gain 1e-2, naive-Bayes posteriors
1e-4); the fit caps ``m_step_maxiter`` (the Adam stop flips under 1-ulp
loss differences).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

from poor_man_gplvm_tpu import experimental as jexp  # noqa: E402
from poor_man_gplvm_tpu.ops import kernels as jgpk  # noqa: E402
from poor_man_gplvm_tpu_torch import convert, experimental  # noqa: E402

torch.set_num_threads(1)

T, N, L = 200, 10, 12
CHUNK = 97
TOL_LML = 1e-5
TOL_FIT = 1e-2
TOL_POST = 1e-4
KW = dict(n_latent_bin=L, tuning_lengthscale=5.0, movement_variance=1.0,
          p_move_to_jump=0.02, p_jump_to_move=0.05)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def sim():
    jm = jexp.PoissonGPLVMGain1D_gain(N, inference_engine="prob", **KW)
    gain = np.concatenate([np.full(T // 2, 0.5), np.full(T // 2, 2.0)])
    _, y = jm.sample(T, key=jr.PRNGKey(0), gain=jnp.asarray(gain))
    return jm, np.asarray(y, dtype=np.float32), gain.astype(np.float32)


def _port(jm, engine="prob"):
    pm = experimental.PoissonGPLVMGain1D_gain(
        N, inference_engine=engine, device="cpu", **KW)
    return convert.load_jax_state(pm, jm.params, jm.tuning_basis)


def _fresh_jax(jm):
    m = jexp.PoissonGPLVMGain1D_gain(N, inference_engine="prob", **KW)
    m.params, m.tuning = jm.params, jm.tuning
    return m


def test_gain_fit_matches_jax(sim):
    jm, y, _ = sim
    lpi, _ = jm.init_latent_posterior(T, jr.PRNGKey(7))
    kw = dict(n_iter=3, n_time_per_chunk=CHUNK, m_step_maxiter=20,
              verboase=False)
    want = _fresh_jax(jm).fit_em(y, key=jr.PRNGKey(3),
                                 log_posterior_init=lpi, **kw)
    pm = _port(jm)
    got = pm.fit_em(y, log_posterior_init=np.asarray(lpi), **kw)
    np.testing.assert_allclose(
        [float(v) for v in got["log_marginal_l"]],
        [float(v) for v in want["log_marginal_l"]], rtol=TOL_LML)
    np.testing.assert_allclose(_np(got["gain_saved"][-1]),
                               np.asarray(want["gain_saved"][-1]),
                               rtol=TOL_FIT)
    np.testing.assert_allclose(_np(got["posterior"]),
                               np.asarray(want["posterior"]), atol=TOL_FIT)
    assert set(got) == set(want)
    assert set(got["m_step_res_l"]) == set(want["m_step_res_l"])
    # the log posterior kept for post-fit gain refits
    np.testing.assert_allclose(_np(pm.get_gain_mstep_chunk(y)),
                               np.asarray(jm.get_gain_mstep_chunk(
                                   jnp.asarray(y), jnp.asarray(
                                       _np(pm.log_posterior)),
                                   jnp.asarray(_np(pm.tuning)))),
                               rtol=1e-5)


def test_gain_naive_bayes_matches_jax(sim):
    jm, y, _ = sim
    pm = _port(jm)
    kw = dict(n_time_per_chunk=CHUNK, gain_refit_n_iter=2)
    want = jm.decode_latent_naive_bayes(y, gain=jnp.ones(T), **kw)
    got = pm.decode_latent_naive_bayes(y, gain=torch.ones(T), **kw)
    np.testing.assert_allclose(got["log_marginal"], want["log_marginal"],
                               rtol=TOL_LML)
    np.testing.assert_allclose(np.exp(_np(got["log_posterior"])),
                               np.exp(np.asarray(want["log_posterior"])),
                               atol=TOL_POST)
    np.testing.assert_allclose(_np(got["gain"]), np.asarray(want["gain"]),
                               rtol=1e-5)
    t = np.arange(T) * 0.1
    res_t = pm.decode_latent_naive_bayes(y, t_l=t, n_time_per_chunk=CHUNK)
    np.testing.assert_allclose(res_t["posterior_latent"].t, t)


def test_gain_statistics_mstep_and_objective_match_jax(sim):
    jm, y, gain = sim
    rng = np.random.default_rng(0)
    post = rng.dirichlet(np.ones(L), size=T).astype(np.float32)
    lp = np.log(post)
    want = jexp.get_statistics_gain(jnp.asarray(lp), y, jnp.asarray(gain))
    got = experimental.get_statistics_gain(torch.as_tensor(lp), y, gain)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5)
    tuning = np.asarray(jm.tuning)
    np.testing.assert_allclose(
        _np(experimental.get_gain_mstep(y, torch.as_tensor(lp), tuning)),
        np.asarray(jexp.get_gain_mstep(jnp.asarray(y), jnp.asarray(lp),
                                       jnp.asarray(tuning))), rtol=1e-5)
    np.testing.assert_allclose(
        _np(experimental.get_gain_mstep_chunk(
            torch.as_tensor(y), torch.as_tensor(lp), tuning, 37)),
        np.asarray(jexp.get_gain_mstep_chunk(
            jnp.asarray(y), jnp.asarray(lp), jnp.asarray(tuning), 37)),
        rtol=1e-5)
    args = [np.asarray(a) for a in want]
    w = np.asarray(jm.params)
    basis = np.asarray(jm.tuning_basis)
    want_obj = float(jexp.poisson_m_step_objective_gain(
        jnp.asarray(w), {"param_prior_std": 1.0}, jnp.asarray(basis),
        *[jnp.asarray(a) for a in args]))
    got_obj = float(experimental.poisson_m_step_objective_gain(
        torch.as_tensor(w), {"param_prior_std": 1.0}, torch.as_tensor(basis),
        *[torch.as_tensor(a) for a in args]))
    np.testing.assert_allclose(got_obj, want_obj, rtol=TOL_LML)


def test_gain_decode_engines_agree_with_jax(sim):
    """The gain-aware decode (the gain in the per-bin dt of the emissions)
    through 'prob' and 'cuda' (the kernels' plain versions here) against
    the JAX decode."""
    jm, y, gain = sim
    _, log_lat, _, log_dyn = jgpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), 1.0, 0.02, 0.05)
    kw = dict(ma_latent=None, likelihood_scale=1.0, n_time_per_chunk=64)
    want = jm._decode_latent(jnp.asarray(y), jm.tuning, {}, log_lat, log_dyn,
                             jnp.ones(N), gain=jnp.asarray(gain), **kw)
    for engine in ("prob", "cuda"):
        pm = _port(jm, engine)
        got = pm._decode_latent(y, pm.tuning, {}, np.asarray(log_lat),
                                np.asarray(log_dyn), torch.ones(N),
                                gain=torch.as_tensor(gain), **kw)
        np.testing.assert_allclose(float(got[1]), float(want[1]),
                                   rtol=TOL_LML)
        np.testing.assert_allclose(np.exp(_np(got[0])),
                                   np.exp(np.asarray(want[0])),
                                   atol=TOL_POST)


def test_gain_shuffle_sample_and_mesh(sim):
    jm, y, gain = sim
    pm = _port(jm)
    want = jexp.shuffle_and_decode_gain(jm, y, n_shuffle=2, seed=0,
                                        verbose=False)
    got = experimental.shuffle_and_decode_gain(pm, y, n_shuffle=2, seed=0,
                                               verbose=False)
    assert got["log_marginal_l"].shape == (2, T)
    np.testing.assert_allclose(got["log_marginal"], want["log_marginal"],
                               rtol=TOL_LML)
    lat, y_s = pm.sample(T, generator=torch.Generator().manual_seed(1),
                         gain=torch.as_tensor(gain))
    assert lat.shape == (T, 2) and y_s.shape == (T, N)
    assert float(y_s[T // 2:].mean()) > float(y_s[:T // 2].mean())
    with pytest.raises(NotImplementedError, match="item J"):
        pm.fit_em(y, n_iter=1, mesh=object(), verboase=False)
