"""The other model families of the port against the JAX package:
``PoissonGPLVM1D``, ``GaussianGPLVM1D`` and ``GaussianGPLVMJump1D`` on the
README configuration (T = 1000, N = 30, L = 100): every decode key on
three engines, chunk invariance and overrides, naive Bayes with a scalar
and a per-bin dt, 3 EM iterations on the host loop and the fused
schedule, pickling, ``loglikelihood``, sampling and the initial
posteriors.

Same numpy inputs through both packages; the port model takes the JAX
model's ``params`` and ``tuning_basis`` (``convert.load_jax_state``) and
runs on the CPU.  Tolerances (PARITY.json): log-marginals 1e-5 relative,
decode posteriors and ``p_*`` 1e-4 absolute, the other log keys 1e-5
max-normalised relative (over entries above -50: the floored zeros carry
no mass), fit posteriors 1e-2.  The Poisson fits cap ``m_step_maxiter``
(the Adam stop flips under 1-ulp loss differences, ROADMAP §3); the ridge
fits of the Gaussian classes run uncapped.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import poor_man_gplvm_tpu as jpmg  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import convert  # noqa: E402

torch.set_num_threads(1)

T, N, L = 1000, 30, 100
TOL_LMF = 1e-5
TOL_POST = 1e-4
TOL_LOG = 1e-5
TOL_FIT_POST = 1e-2
TOL_LML_FIT = 1e-5
CLASSES = ("PoissonGPLVM1D", "GaussianGPLVM1D", "GaussianGPLVMJump1D")
LATENT_KEYS = {
    "log_posterior_all", "posterior_all",
    "log_one_step_predictive_marginals_all", "log_likelihood_all",
    "log_marginal_final", "p_joint_latent", "p_transition_latent",
    "log_joint_latent", "log_transition_latent",
}
JUMP_KEYS = LATENT_KEYS | {
    "posterior_latent_marg", "posterior_dynamics_marg", "p_joint_full",
    "p_joint_dynamics", "p_transition_full", "p_transition_dynamics",
    "log_joint_full", "log_joint_dynamics", "log_transition_full",
    "log_transition_dynamics",
}


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12))


def _log_rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    mask = np.isfinite(ref) & (ref > -50.0)
    denom = max(float(np.abs(ref[mask]).max()), 1e-12)
    return float(np.abs(ours[mask] - ref[mask]).max() / denom)


def assert_decode_close(got, want, tol_post=TOL_POST):
    keys = JUMP_KEYS if "p_joint_full" in want else LATENT_KEYS
    assert set(got) == set(want) == keys
    lmf, lmf_ref = got["log_marginal_final"], want["log_marginal_final"]
    assert abs(lmf - lmf_ref) <= TOL_LMF * abs(lmf_ref)
    for k in keys - {"log_marginal_final"}:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k.startswith("p_") or k.startswith("posterior"):
            err, tol = float(np.abs(g - w).max()), tol_post
        elif k in ("log_likelihood_all",
                   "log_one_step_predictive_marginals_all"):
            err, tol = _rel_err(g, w), TOL_LOG
        else:
            err, tol = _log_rel_err(g, w), TOL_LOG
        assert err <= tol, (k, err)


def _path(T_, L_, seed, p_jump=0.01):
    """A latent path that sweeps every bin back and forth (so every row of
    the transition posterior carries mass), with small steps and, at rate
    ``p_jump``, jumps."""
    rng = np.random.default_rng(seed)
    period = 2 * (L_ - 1) if L_ > 1 else 1
    sweep = np.abs((np.arange(T_) * 0.37).astype(int) % period - (L_ - 1))
    lat = np.clip(sweep + rng.integers(-1, 2, T_), 0, L_ - 1)
    jumps = rng.random(T_) < p_jump
    lat[jumps] = rng.integers(L_, size=int(jumps.sum()))
    return lat, rng


def _data(jm, T_=T, seed=0):
    """Observations along ``_path``; jumps only for a model that has them.
    (A jump that a latent-only model cannot follow leaves its filter on
    subnormal probabilities, which XLA on the CPU flushes to zero and torch
    keeps: ROADMAP §3, "Subnormals".)"""
    lat, rng = _path(T_, jm.n_latent_bin, seed,
                     0.01 if jm.has_dynamics else 0.0)
    tuning = np.asarray(jm.tuning)[lat]
    if jm.observation_model == "gaussian":
        return (tuning + jm.noise_std * rng.normal(size=tuning.shape)).astype(
            np.float32)
    return rng.poisson(tuning).astype(np.float32)


def _noise(name):
    """``noise_std`` of a Gaussian model: 1.0 (the observations' unit
    scale; the repo's reference parity runs 0.7).  The log-marginal of a
    Gaussian fit moves with the tuning curves by ~T N |y - mu| / s^2, so at
    s = 0.5 the two packages' f32 statistics (1e-5 apart) part by 1.7e-5
    relative after three EM iterations."""
    return {"noise_std": 1.0} if name.startswith("Gaussian") else {}


def _jax_model(name, engine, n=N, l=L, **kw):
    return getattr(jpmg, name)(n, n_latent_bin=l, movement_variance=1,
                               tuning_lengthscale=5.0, inference_engine=engine,
                               **_noise(name), **kw)


def _port_model(name, jm, engine, **kw):
    m = getattr(pmt, name)(jm.n_neuron, n_latent_bin=jm.n_latent_bin,
                           movement_variance=1, tuning_lengthscale=5.0,
                           inference_engine=engine, device="cpu",
                           **_noise(name), **kw)
    state = convert.state_from_model(jm)
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


@pytest.fixture(scope="module", params=CLASSES)
def family(request):
    name = request.param
    jm = _jax_model(name, "prob")
    y = _data(jm)
    return name, jm, y, jm.decode_latent(y)


# (JAX engine, port engine): the JAX 'pallas' engine runs its kernels in
# interpret mode; the port's 'cuda' and 'cuda_parallel' run the kernels'
# plain versions on CPU tensors
ENGINE_PAIRS = [("prob", "prob"), ("pallas", "cuda"), ("prob", "cuda_parallel")]


@pytest.mark.parametrize("engines", ENGINE_PAIRS, ids="-".join)
def test_decode_matches_jax(family, engines):
    name, jm, y, want = family
    if engines[0] != "prob":
        want = _jax_model(name, engines[0]).decode_latent(y)
    got = _port_model(name, jm, engines[1]).decode_latent(y)
    assert_decode_close(got, want)
    post = got["posterior_all"]
    dims = tuple(range(1, post.ndim))
    np.testing.assert_allclose(post.sum(dim=dims).numpy(), 1.0, atol=1e-5)


def test_decode_chunk_invariance_and_overrides(family):
    name, jm, y, want = family
    pm = _port_model(name, jm, "cuda")
    assert_decode_close(pm.decode_latent(y, n_time_per_chunk=37), want)
    hp = {"movement_variance": 2.0}
    if name.startswith("Gaussian"):
        hp["noise_std"] = 0.8
    got = pm.decode_latent(y, hyperparam=hp)
    assert_decode_close(got, jm.decode_latent(y, hyperparam=hp))
    assert got["log_marginal_final"] != want["log_marginal_final"]


@pytest.mark.parametrize("dt", ["scalar", "per_bin"])
def test_naive_bayes(family, dt):
    name, jm, y, _ = family
    dt_l = 1.0 if dt == "scalar" else np.random.default_rng(3).uniform(
        0.5, 1.5, T).astype(np.float32)
    want = jm.decode_latent_naive_bayes(y, n_time_per_chunk=300, dt_l=dt_l)
    got = _port_model(name, jm, "prob").decode_latent_naive_bayes(
        y, n_time_per_chunk=300, dt_l=dt_l)
    assert set(got) == set(want)
    assert abs(got["log_marginal_total"] - want["log_marginal_total"]) <= (
        TOL_LMF * abs(want["log_marginal_total"]))
    assert np.abs(got["posterior_latent"].numpy()
                  - np.asarray(want["posterior_latent"])).max() <= TOL_POST
    for k in ("log_marginal_l", "ll_per_pos_l"):
        assert _rel_err(got[k].numpy(), want[k]) <= TOL_LOG, k


def _uniform_noise_init(T_, L_, seed):
    """A numpy uniform-plus-noise initial log posterior (the latent-only
    family's init).  From a random Dirichlet one, the first ridge M-step
    gives the latent-only Gaussian model tuning curves its narrow
    transition cannot follow, and both packages' probability-space
    engines underflow (``tests/test_torch_log_engine.py``)."""
    post = 1.0 / L_ + np.random.default_rng(seed).random((T_, L_)) * 0.1
    return np.log(post / post.sum(axis=1, keepdims=True)).astype(np.float32)


def _lml(res):
    return np.array([float(v) for v in res["log_marginal_l"]])


@pytest.mark.parametrize("port_engine", ["prob", "cuda_parallel"])
def test_fit_em_matches_jax(family, port_engine):
    """3 EM iterations from a numpy initial posterior: the JAX host loop
    on 'prob' against the port's host loop on 'prob' and its fused
    schedule on 'cuda_parallel' (marginal smoothing, warm-started fixed
    points: the n_dyn = 1 carries of the latent-only classes)."""
    name, jm, y, _ = family
    lpi = _uniform_noise_init(T, L, 5)
    kw = {"m_step_maxiter": 20} if name.startswith("Poisson") else {}
    want = _jax_model(name, "prob").fit_em(
        y, n_iter=3, log_posterior_init=lpi, verboase=False, fused=False, **kw)
    pm = _port_model(name, jm, port_engine)
    got = pm.fit_em(y, n_iter=3, log_posterior_init=lpi, verboase=False,
                    fused=port_engine != "prob", **kw)
    assert set(got) == set(want)
    assert set(got["m_step_res_l"]) == set(want["m_step_res_l"])
    if name.startswith("Gaussian"):  # the ridge: no optimizer state
        assert got["m_step_res_l"] == {"params": [], "opt_state": []} == {
            k: list(v) for k, v in want["m_step_res_l"].items()}
    else:
        assert got["m_step_res_l"]["n_iter"] == want["m_step_res_l"]["n_iter"]
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=TOL_LML_FIT)
    assert np.abs(got["posterior"].numpy()
                  - np.asarray(want["posterior"])).max() <= TOL_FIT_POST
    tun, jtun = got["tuning"].numpy(), np.asarray(want["tuning"])
    assert np.abs(tun - jtun).max() <= 1e-3 * np.abs(jtun).max()
    assert got["iter_saved"] == want["iter_saved"] == [0]
    if port_engine == "cuda_parallel":
        assert pm._scan_passes_mid.shape == (1, 2)
    assert torch.equal(pm.params, got["params"])


def test_pickle_round_trip(family):
    name, jm, y, _ = family
    pm = _port_model(name, jm, "cuda")
    kw = {"m_step_maxiter": 5} if name.startswith("Poisson") else {}
    pm.fit_em(y[:200], n_iter=2, verboase=False, **kw)
    first = pm.decode_latent(y)
    assert getattr(pm, "_trans_cache", None)
    back = pickle.loads(pickle.dumps(pm))
    assert back.adam_runner is None and back.opt_state_init_fun is None
    assert not hasattr(back, "_trans_cache")
    assert pm.adam_runner is not None or name.startswith("Gaussian")
    again = back.decode_latent(y)
    for k, v in first.items():
        assert (v == again[k]) if isinstance(v, float) else torch.equal(
            v, again[k]), k
    assert back.fit_em(y[:200], n_iter=1, verboase=False, **kw)
    if name.startswith("Gaussian"):
        assert back.noise_std == pm.noise_std == 1.0


def test_loglikelihood_method(family):
    name, jm, y, _ = family
    pm = _port_model(name, jm, "prob")
    ypred = np.asarray(jm.tuning)[_path(50, L, 1)[0]]
    want = np.asarray(jm.loglikelihood(y[:50], ypred, {"noise_std": 0.7}))
    got = pm.loglikelihood(torch.tensor(y[:50]), torch.tensor(ypred),
                           {"noise_std": 0.7}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sample_and_initial_posteriors(family):
    name, jm, _, _ = family
    pm = _port_model(name, jm, "prob")
    lat, y = pm.sample(60, generator=torch.Generator().manual_seed(4))
    lat2, y2 = pm.sample(60, generator=torch.Generator().manual_seed(4))
    assert torch.equal(lat, lat2) and torch.equal(y, y2)
    assert y.shape == (60, N) and y.dtype == torch.float32
    if pm.has_dynamics:
        assert lat.shape == (60, 2) and lat[:, 1].max() < L
    else:
        assert lat.shape == (60,) and lat.max() < L and lat.min() >= 0
        # a latent-only path moves by the RBF of movement_variance = 1
        assert int((lat[1:] - lat[:-1]).abs().max()) <= 11
    log_post, post = pm.init_latent_posterior(
        40, torch.Generator().manual_seed(2))
    torch.testing.assert_close(post.sum(1), torch.ones(40))
    assert torch.isfinite(log_post).all()
    # uniform plus noise (latent-only) against purely random (jump)
    if pm.has_dynamics:
        assert float(post.min()) < 0.1 / L
    else:
        assert float(post.min()) >= (1.0 / L) / (1.0 + 0.1 * L)
