"""The fit slice of the port against the JAX package: M-step statistics,
the Poisson objective and its gradient, the hand-written optax Adam, the
carry of a JAX Adam state, and ``PoissonGPLVMJump1D.fit_em``.

The port model takes the JAX model's ``params`` and ``tuning_basis``
(``convert.load_jax_state``); spikes and ``log_posterior_init`` are made
with numpy.  Tolerances (PARITY.json): log-marginals 1e-5 relative, fit
posteriors 1e-2 absolute; parameters 1e-5 absolute; objective, gradient and
statistics 1e-5 relative.

The Adam stopping rule (relative loss change <= tol after >= 5 iterations)
is discontinuous: the two packages sum the f32 loss in different orders,
1 ulp apart, and that can move the stopping iteration by one.  The exact
parity tests therefore cap the loop (``m_step_maxiter``), as the JAX
package's own engine-vs-engine fit tests do; the default-settings test
bounds the recorded divergence (ROADMAP §3).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu.ops import mstep as jms  # noqa: E402
from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D, convert  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import mstep as ms  # noqa: E402
from poor_man_gplvm_tpu_torch.parallel import spmd  # noqa: E402

torch.set_num_threads(1)

T, N, L = 1600, 8, 20
HP = {"param_prior_std": 1.0}
TOL_LML = 1e-5
TOL_FIT_POST = 1e-2
TOL_PARAMS = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def setup():
    """JAX model, its weights, numpy spikes along a random walk with jumps,
    and a numpy initial log posterior."""
    jm = jpmg.PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                                 tuning_lengthscale=5.0)
    rng = np.random.default_rng(0)
    x, lat = int(rng.integers(L)), []
    for _ in range(T):
        x = int(rng.integers(L)) if rng.random() < 0.02 else int(
            np.clip(x + rng.integers(-1, 2), 0, L - 1))
        lat.append(x)
    y = rng.poisson(np.asarray(jm.tuning)[lat]).astype(np.float32)
    lpi = np.log(rng.dirichlet(np.ones(L), T)).astype(np.float32)
    return jm, convert.state_from_model(jm), y, lpi


def _port_model(state, engine):
    m = PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                           tuning_lengthscale=5.0, inference_engine=engine,
                           device="cpu")
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


def _stats(setup):
    _, state, y, lpi = setup
    yw, tw = jms.get_statistics(jnp.asarray(lpi), jnp.asarray(y))
    j_args = (HP, jnp.asarray(state["tuning_basis"]), yw, tw)
    p_args = (HP, torch.tensor(state["tuning_basis"]),
              torch.tensor(np.asarray(yw)), torch.tensor(np.asarray(tw)))
    return j_args, p_args


@pytest.mark.parametrize("chunk", [700, 200_000])
def test_get_statistics_matches_jax(setup, chunk):
    _, _, y, lpi = setup
    yw, tw = ms.get_statistics(torch.tensor(lpi), torch.tensor(y),
                               n_time_per_chunk=chunk)
    jyw, jtw = jms.get_statistics(jnp.asarray(lpi), jnp.asarray(y),
                                  n_time_per_chunk=chunk)
    assert _rel(yw, jyw) <= 1e-5 and _rel(tw, jtw) <= 1e-5


def test_objective_and_gradient_match_jax(setup):
    _, state, _, _ = setup
    j_args, p_args = _stats(setup)
    params = state["params"]
    jl, jg = jax.value_and_grad(jms.poisson_m_step_objective)(
        jnp.asarray(params), *j_args)
    p = torch.tensor(params, requires_grad=True)
    loss = ms.poisson_m_step_objective(p, *p_args)
    loss.backward()
    assert _rel(loss.detach(), jl) <= 1e-5
    assert _rel(p.grad, jg) <= 1e-5
    assert float(ms.tree_l2_norm(p.grad)) == pytest.approx(
        float(jms.tree_l2_norm(jg)), rel=1e-5)


def test_adam_update_matches_optax():
    rng = np.random.default_rng(1)
    params = rng.normal(size=(5, 7)).astype(np.float32)
    opt = optax.adam(0.01)
    jstate, jp = opt.init(jnp.asarray(params)), jnp.asarray(params)
    pstate, pp = ms.adam_init(torch.tensor(params)), torch.tensor(params)
    for _ in range(200):
        g = rng.normal(size=params.shape).astype(np.float32)
        upd, jstate = opt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        pupd, pstate = ms.adam_update(torch.tensor(g), pstate, 0.01)
        pp = pp + pupd
    assert int(pstate.count) == int(jstate[0].count) == 200
    assert _rel(pstate.mu, jstate[0].mu) <= 1e-6
    assert _rel(pstate.nu, jstate[0].nu) <= 1e-6
    assert float(np.abs(pp.numpy() - np.asarray(jp)).max()) <= 1e-6


def test_adam_update_constants_made_once_keep_the_bits():
    """``adam_update`` takes its decay rates from ``_const`` (made once per
    device, no copy from the host per iteration); 50 steps equal the
    formula that built both as fresh 0-dim f32 tensors every step, bit for
    bit, and so does the prior's scale in the objective."""

    def reference_update(grads, state, step_size):
        mu = (1 - ms.ADAM_B1) * grads + ms.ADAM_B1 * state.mu
        nu = (1 - ms.ADAM_B2) * grads**2 + ms.ADAM_B2 * state.nu
        count = state.count + 1
        b1 = torch.tensor(ms.ADAM_B1, dtype=torch.float32)
        b2 = torch.tensor(ms.ADAM_B2, dtype=torch.float32)
        updates = (mu / (1 - b1**count)) / (
            torch.sqrt(nu / (1 - b2**count)) + ms.ADAM_EPS)
        return -step_size * updates, ms.AdamState(count, mu, nu)

    rng = np.random.default_rng(2)
    params = torch.tensor(rng.normal(size=(6, 9)).astype(np.float32))
    got = want = ms.adam_init(params)
    p_got = p_want = params
    for _ in range(50):
        g = torch.tensor(rng.normal(size=(6, 9)).astype(np.float32))
        u_got, got = ms.adam_update(g, got, 0.01)
        u_want, want = reference_update(g, want, 0.01)
        assert torch.equal(u_got, u_want)
        p_got, p_want = p_got + u_got, p_want + u_want
    assert torch.equal(p_got, p_want) and int(got.count) == 50
    assert got.count.dtype == torch.int32
    assert torch.equal(got.mu, want.mu) and torch.equal(got.nu, want.nu)
    assert ms._const(ms.ADAM_B1, "cpu") is ms._const(ms.ADAM_B1, "cpu")
    assert ms._const(0.9, "cpu").dtype == torch.float32
    for scale in (1.0, 0.37, np.float32(2.5), 3):
        want = (torch.log(2 * np.pi * torch.tensor(scale, dtype=torch.float32)
                          ** 2) + params**2
                / torch.tensor(scale, dtype=torch.float32)**2) / -2
        assert torch.equal(ms._norm_logpdf(params, scale), want)
        assert torch.equal(ms._norm_logpdf(params, torch.tensor(scale)), want)


@pytest.mark.parametrize("maxiter,tol", [(20, 1e-6), (1000, 1e-3)])
def test_adam_run_matches_jax(setup, maxiter, tol):
    """One Adam run from the same init: same n_iter (capped, or stopped
    early by a loose tolerance), params and histories alike."""
    _, state, _, _ = setup
    j_args, p_args = _stats(setup)
    run, init = jms.make_adam_runner(jms.poisson_m_step_objective, 0.01,
                                     maxiter=maxiter, tol=tol)
    prun, pinit = ms.make_adam_runner(ms.poisson_m_step_objective, 0.01,
                                      maxiter=maxiter, tol=tol)
    jp = jnp.asarray(state["params"])
    want = jms.package_adam_result(run(jp, init(jp), *j_args))
    p = torch.tensor(state["params"])
    got = ms.package_adam_result(prun(p, pinit(p), *p_args))
    assert got["n_iter"] == want["n_iter"]
    if maxiter == 20:
        assert got["n_iter"] == 20
    else:
        assert got["n_iter"] < 100  # the tolerance, not the cap, stopped it
    assert float(np.abs(got["params"].numpy()
                        - np.asarray(want["params"])).max()) <= TOL_PARAMS
    assert _rel(got["loss_history"], want["loss_history"]) <= 1e-5
    assert _rel(got["error_history"], want["error_history"]) <= 1e-5
    assert _rel(got["final_loss"], want["final_loss"]) <= 1e-5


def test_adam_resumes_from_jax_state(setup):
    """A JAX Adam run's optimizer state carried into the port continues
    the same way."""
    _, state, _, _ = setup
    j_args, p_args = _stats(setup)
    run, init = jms.make_adam_runner(jms.poisson_m_step_objective, 0.01,
                                     maxiter=30)
    jp = jnp.asarray(state["params"])
    first = run(jp, init(jp), *j_args)
    run2, _ = jms.make_adam_runner(jms.poisson_m_step_objective, 0.01,
                                   maxiter=40)
    want = jms.package_adam_result(run2(first["params"], first["opt_state"],
                                        *j_args))
    carried = convert.adam_state_from_jax(first["opt_state"], device="cpu")
    assert int(carried.count) == 29 and carried.mu.dtype == torch.float32
    prun, _ = ms.make_adam_runner(ms.poisson_m_step_objective, 0.01,
                                  maxiter=40)
    got = ms.package_adam_result(prun(
        torch.tensor(np.asarray(first["params"])), carried, *p_args))
    assert got["n_iter"] == want["n_iter"]
    assert float(np.abs(got["params"].numpy()
                        - np.asarray(want["params"])).max()) <= TOL_PARAMS
    assert int(got["opt_state"].count) == int(want["opt_state"][0].count)
    with pytest.raises(ValueError):
        convert.adam_state_from_jax((1, 2), device="cpu")


def test_batch_trim_m_step_histories():
    res = {"n_iter": [torch.tensor(3), torch.tensor(5)],
           "loss_history": [torch.arange(8.0), torch.arange(8.0) + 1],
           "error_history": [torch.ones(8), torch.zeros(8)]}
    ms.batch_trim_m_step_histories(res)
    assert res["n_iter"] == [3, 5]
    np.testing.assert_array_equal(res["loss_history"][1], [1, 2, 3, 4, 5])
    assert res["error_history"][0].shape == (3,)
    assert ms.batch_trim_m_step_histories(res)["n_iter"] == [3, 5]


def _fits(setup, jax_engine, port_engine, n_iter, **kw):
    jm, state, y, lpi = setup
    jmod = jpmg.PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                                   tuning_lengthscale=5.0,
                                   inference_engine=jax_engine)
    jmod.params, jmod.tuning_basis = jm.params, jm.tuning_basis
    want = jmod.fit_em(y, n_iter=n_iter, log_posterior_init=lpi,
                       verboase=False, fused=False, **kw)
    got = _port_model(state, port_engine).fit_em(
        y, n_iter=n_iter, log_posterior_init=lpi, verboase=False,
        fused=False, **kw)
    return got, want


def _lml(res):
    return np.array([float(v) for v in res["log_marginal_l"]])


@pytest.mark.parametrize("engines", [("pallas_parallel", "cuda_parallel"),
                                     ("prob", "prob")])
def test_fit_em_matches_jax(setup, engines):
    got, want = _fits(setup, *engines, n_iter=3, m_step_maxiter=20)
    assert set(got) == set(want)
    assert set(got["m_step_res_l"]) == set(want["m_step_res_l"])
    assert got["m_step_res_l"]["n_iter"] == want["m_step_res_l"]["n_iter"]
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=TOL_LML)
    post_err = np.abs(got["posterior"].numpy()
                      - np.asarray(want["posterior"])).max()
    assert post_err <= TOL_FIT_POST
    assert float(np.abs(got["params"].numpy()
                        - np.asarray(want["params"])).max()) <= 1e-3
    for k in ("posterior_latent_marg", "posterior_dynamics_marg"):
        assert got[k].shape == np.asarray(want[k]).shape
    assert got["iter_saved"] == want["iter_saved"] == [0]


def test_fit_em_default_adam_stopping_divergence(setup):
    """Default M-step settings: the first E-step agrees to 1e-5; the Adam
    stopping iteration may differ by one between the packages (1-ulp loss
    differences), which moves later log-marginals within the JAX package's
    own engine-vs-engine bound of 5e-5."""
    got, want = _fits(setup, "pallas_parallel", "cuda_parallel", n_iter=2)
    a, b = _lml(got), _lml(want)
    assert abs(a[0] - b[0]) <= TOL_LML * abs(b[0])
    np.testing.assert_allclose(a, b, rtol=5e-5)
    diff = np.abs(np.subtract(got["m_step_res_l"]["n_iter"],
                              want["m_step_res_l"]["n_iter"]))
    assert diff.max() <= 1


def test_fit_em_options_and_profile(setup):
    _, state, y, lpi = setup
    m = _port_model(state, "cuda_parallel")
    lpi64 = lpi.astype(np.float64)
    lpi64[:, 0] = -1e40  # a reference-style floor: clamped, no overflow
    res = m.fit_em(y, n_iter=2, log_posterior_init=lpi64, verboase=False,
                   profile=True, save_every=1, fused=True, m_step_maxiter=8)
    assert res["log_posterior_init"].dtype == torch.float32
    assert float(res["log_posterior_init"].min()) == float(np.float32(-3.0e38))
    assert res["iter_saved"] == [0, 1] and len(res["params_saved"]) == 2
    prof = res["profile"]
    assert len(prof["m_step"]) == len(prof["e_step"]) == 2
    assert len(prof["scan_passes"]) == 2 and min(prof["scan_passes"][0]) >= 1
    assert res["m_step_res_l"]["n_iter"] == [8, 8]
    assert all(len(h) == 8 for h in res["m_step_res_l"]["loss_history"])
    assert torch.equal(m.params, res["params"])
    assert np.isfinite(float(m.log_marginal_final))
    # mesh= takes a spmd.Mesh: a real one runs the E-step sharded, any
    # other object raises
    with pytest.raises(TypeError, match="Mesh"):
        m.fit_em(y, n_iter=1, verboase=False, mesh=object())
    em_mesh = copy.deepcopy(m).fit_em(
        y, n_iter=1, verboase=False, m_step_maxiter=8,
        mesh=spmd.make_mesh(devices=["cpu"] * 2, shape=(1, 2, 1)))
    assert np.isfinite(float(em_mesh["log_marginal"]))
    with pytest.raises(ValueError, match="output_mode"):
        m.fit_em(y, n_iter=1, verboase=False, output_mode="no_such_mode")
    with pytest.raises(ValueError):
        m.fit_em(y, n_iter=0, verboase=False)
    with pytest.raises(TypeError):
        m.fit_em(y, n_iter=1, verboase=False, no_such_option=1)
    # the B-spline basis's objective, ported: no penalty, no difference
    _, p_args = _stats(setup)
    p = torch.tensor(state["params"])
    assert torch.equal(
        ms.poisson_m_step_objective_smoothness(
            p, dict(HP, smoothness_penalty=0.0), *p_args[1:]),
        ms.poisson_m_step_objective(p, *p_args))


def test_fit_em_new_lengthscale_and_nan_guard(setup):
    """A swept tuning_lengthscale that changes the basis rank regenerates
    the basis and re-initialises the params; nan_guard stops a fit whose
    log marginal is not finite."""
    _, state, y, lpi = setup
    m = _port_model(state, "prob")
    rank = m.tuning_basis.shape[1]
    res = m.fit_em(y[:200], hyperparam={"tuning_lengthscale": 1.0},
                   n_iter=1, log_posterior_init=lpi[:200], verboase=False,
                   m_step_maxiter=6)
    assert m.tuning_lengthscale == 1.0
    assert m.tuning_basis.shape[1] == res["params"].shape[0] != rank
    assert np.isfinite(float(res["log_marginal"]))
    y_bad = y[:200].copy()
    y_bad[3, 0] = np.nan
    with pytest.raises(FloatingPointError, match="diverged"):
        m.fit_em(y_bad, n_iter=1, log_posterior_init=lpi[:200],
                 verboase=False, m_step_maxiter=6, nan_guard=True)
