"""The port's ops modules against the JAX package on the same numpy inputs:
transition builders, the tuning basis, the softplus link, Poisson
emissions, naive Bayes, ``prob_to_log`` and the transition posteriors.
Tolerances as PARITY.json (1e-5 relative for log-likelihoods and
log-marginals, 1e-4 for probabilities) unless a test states a tighter one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from poor_man_gplvm_tpu.ops import basis as jbasis  # noqa: E402
from poor_man_gplvm_tpu.ops import emissions as jem  # noqa: E402
from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu.ops import kernels as jker  # noqa: E402
from poor_man_gplvm_tpu.ops import mstep as jmstep  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import (  # noqa: E402
    basis,
    emissions,
    hmm,
    kernels,
    mstep,
)

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _spikes(seed, T, N, L):
    rng = np.random.default_rng(seed)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    return y, tuning, rng


@pytest.mark.parametrize("mv,p_mj,p_jm", [(1.0, 0.01, 0.01), (2.5, 0.05, 0.2)])
def test_create_transition_prob_1d(mv, p_mj, p_jm):
    L = 30
    want = jker.create_transition_prob_1d(jnp.arange(L), jnp.arange(2), mv,
                                          p_mj, p_jm)
    got = kernels.create_transition_prob_1d(torch.arange(L), None, mv, p_mj,
                                            p_jm)
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        fin = np.isfinite(w)
        assert (fin == np.isfinite(g)).all()  # exact zeros far off-diagonal
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-6, atol=1e-6)
    # movement_variance is the RBF lengthscale (the reference quirk)
    raw = np.exp(-((np.arange(L)[:, None] - np.arange(L)) ** 2) / mv**2)
    np.testing.assert_allclose(got[0][0].numpy(),
                               raw / raw.sum(1, keepdims=True), atol=1e-6)


def test_create_transition_prob_1d_custom_kernel():
    L = 12
    ck = np.random.default_rng(0).uniform(size=(L, L)).astype(np.float32)
    ck[0, 3] = 0.0
    want = jker.create_transition_prob_1d(jnp.arange(L), jnp.arange(2), 1.0,
                                          custom_kernel=jnp.asarray(ck))
    got = kernels.create_transition_prob_1d(torch.arange(L), None, 1.0,
                                            custom_kernel=ck)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert got[1][0, 0, 3] == -np.inf == np.asarray(want[1])[0, 0, 3]


def _projector(b):
    u = b[:, 1:] / np.linalg.norm(b[:, 1:], axis=0)
    return u @ u.T


@pytest.mark.parametrize("kind", ["rbf", "custom"])
def test_generate_basis(kind):
    L = 40
    ck = None
    if kind == "custom":
        x = np.random.default_rng(1).normal(size=(L, 6)).astype(np.float32)
        ck = x @ x.T
    want = np.asarray(jbasis.generate_basis(
        8.0, L, custom_kernel=None if ck is None else jnp.asarray(ck)))
    got = basis.generate_basis(8.0, L, custom_kernel=ck).numpy()
    assert got.shape == want.shape  # same cumsum rank rule
    np.testing.assert_array_equal(got[:, 0], 1.0)
    # singular vectors agree up to sign: compare the projector and the
    # s**0.25 column scales
    np.testing.assert_allclose(_projector(got), _projector(want), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0),
                               np.linalg.norm(want, axis=0), rtol=1e-5)


def test_softplus_link_matches_jax():
    rng = np.random.default_rng(2)
    params = (rng.normal(size=(5, 7)) * 15).astype(np.float32)
    b = rng.normal(size=(9, 5)).astype(np.float32)
    want = np.asarray(jmstep.get_tuning_softplus(jnp.asarray(params),
                                                 jnp.asarray(b)))
    got = mstep.get_tuning_softplus(_t(params), _t(b)).numpy()
    assert (np.abs(b @ params) > 20).any()  # the range where F.softplus
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)  # is linear
    np.testing.assert_allclose(
        mstep.get_tuning_linear(_t(params), _t(b)).numpy(),
        np.asarray(jmstep.get_tuning_linear(jnp.asarray(params),
                                            jnp.asarray(b))), rtol=1e-6)


@pytest.mark.parametrize("mask", ["1d", "2d"])
def test_poisson_loglik(mask):
    T, N, L = 45, 13, 21
    y, tuning, rng = _spikes(3, T, N, L)
    ma_latent = np.ones(L, np.float32)
    ma_latent[[2, 9]] = 0
    shape = (N,) if mask == "1d" else (T, N)
    ma = (rng.uniform(size=shape) > 0.2).astype(np.float32)
    want = np.asarray(jem.poisson_loglik(jnp.asarray(y), jnp.asarray(tuning),
                                         jnp.asarray(ma),
                                         jnp.asarray(ma_latent)))
    got = emissions.poisson_loglik(_t(y), _t(tuning), _t(ma),
                                   _t(ma_latent)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got[:, [2, 9]] == emissions.MASK_NEG).all()
    np.testing.assert_allclose(
        emissions.poisson_lgamma_term(_t(y), _t(ma)).numpy(),
        np.asarray(jem.poisson_lgamma_term(jnp.asarray(y), jnp.asarray(ma))),
        rtol=1e-5)
    np.testing.assert_allclose(
        emissions.get_loglikelihood_ma_all(_t(y), _t(tuning), {}, _t(ma),
                                           _t(ma_latent)).numpy(),
        np.asarray(jem.get_loglikelihood_ma_all(
            jnp.asarray(y), jnp.asarray(tuning), {}, jnp.asarray(ma),
            jnp.asarray(ma_latent))), rtol=1e-5)


def test_naive_bayes_chunked():
    T, N, L = 100, 9, 16
    y, tuning, _ = _spikes(4, T, N, L)
    ones_n, ones_l = np.ones(N, np.float32), np.ones(L, np.float32)
    want = jem.get_naive_bayes_ma_chunk(
        jnp.asarray(y), jnp.asarray(tuning), {}, jnp.asarray(ones_n),
        jnp.asarray(ones_l), n_time_per_chunk=37)
    got = emissions.get_naive_bayes_ma_chunk(
        _t(y), _t(tuning), {}, _t(ones_n), _t(ones_l), n_time_per_chunk=37)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-5)


def test_prob_to_log_floor():
    # (no subnormal input: XLA on the CPU flushes them to zero, torch not)
    p = np.array([0.0, 1e-30, 0.5, 1.0], dtype=np.float32)
    got = hmm.prob_to_log(_t(p)).numpy()
    want = np.asarray(jhmm.prob_to_log(jnp.asarray(p)))
    np.testing.assert_array_equal(got[0], np.float32(hmm.JOINT_ACC_INIT))
    assert hmm.JOINT_ACC_INIT == jhmm.JOINT_ACC_INIT
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _log_acc(shape, seed):
    """A JAX-made log pairwise joint with exact zeros floored."""
    acc = np.random.default_rng(seed).gamma(1.0, size=shape)
    acc = np.where(acc < 0.3, 0.0, acc).astype(np.float32)
    return np.asarray(jhmm.prob_to_log(jnp.asarray(acc)))


@pytest.mark.parametrize("latent_only", [False, True])
def test_transition_posteriors(latent_only):
    if latent_only:
        log_acc = _log_acc((11, 11), 5)
        want = jhmm.compute_transition_posterior_prob_latent(
            jnp.asarray(log_acc))
        got = hmm.compute_transition_posterior_prob_latent(_t(log_acc))
    else:
        log_acc = _log_acc((2, 2, 11, 11), 6)
        want = jhmm.compute_transition_posterior_prob(jnp.asarray(log_acc))
        got = hmm.compute_transition_posterior_prob(_t(log_acc))
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if k.startswith("p_"):
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                       err_msg=k)


def test_auto_chunk_size_matches_jax_on_cpu():
    for T, s, L in [(10_000, 200, 100), (10**7, 1000, 500), (3, 2, 1)]:
        assert hmm.auto_chunk_size(T, s, L) == jhmm.auto_chunk_size(T, s, L)
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("latent_only", [False, True])
def test_transition_push_pull_outer(latent_only):
    """push / push_batch / pull / outer_acc against the JAX Transitions."""
    rng = np.random.default_rng(7)
    L, n_dyn, T = 9, 2, 6
    tlat = np.asarray(jker.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), 1.5, 0.03, 0.1)[0])
    tdyn = np.array([[0.97, 0.03], [0.1, 0.9]], np.float32)
    if latent_only:
        shape = (L,)
        j = jhmm.LatentTransition(jnp.asarray(tlat[0]),
                                  jnp.log(jnp.asarray(tlat[0])))
        p = hmm.LatentTransition(_t(tlat[0]), torch.log(_t(tlat[0])))
    else:
        shape = (n_dyn, L)
        logs = np.log(tdyn), np.log(tlat)
        j = jhmm.JointTransition(jnp.asarray(tdyn), jnp.asarray(tlat),
                                 jnp.asarray(logs[0]), jnp.asarray(logs[1]))
        p = hmm.JointTransition(_t(tdyn), _t(tlat), _t(logs[0]), _t(logs[1]))
    assert p.uniform_rows == j.uniform_rows
    x = rng.uniform(size=shape).astype(np.float32)
    xs = rng.uniform(size=(T, *shape)).astype(np.float32)
    ys = rng.uniform(size=(T, *shape)).astype(np.float32)
    for name, args in (("push", (x,)), ("push_batch", (xs,)),
                       ("pull", (x,)), ("outer_acc", (xs, ys))):
        want = np.asarray(getattr(j, name)(*map(jnp.asarray, args)))
        got = getattr(p, name)(*map(_t, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_allclose(p.uniform_log_init().numpy(),
                               np.asarray(j.uniform_log_init()), rtol=1e-6)
    assert p.joint_shape() == j.joint_shape()


# --------------------------------------------------------------------------
# the ops of the other model families: latent-only transitions, the
# rbf-plus-isolated custom kernels, the small public kernels, the B-spline
# basis, Gaussian emissions, per-bin dt, the ridge M-step and the
# smoothness objective
# --------------------------------------------------------------------------


def _f32_equal(got, want):
    """Equal to f32 rounding: a few ulp of the largest entry; -inf where
    the JAX function gives -inf."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert (fin == np.isfinite(got)).all()
    assert (got[~fin] == want[~fin]).all()
    scale = max(float(np.abs(want[fin]).max()), 1e-30)
    assert float(np.abs(got[fin] - want[fin]).max()) <= 4 * 2.0**-23 * scale


@pytest.mark.parametrize("mv,custom", [(1.0, False), (3.5, False),
                                       (1.0, True)])
def test_create_transition_prob_latent_1d(mv, custom):
    L = 25
    ck = None
    if custom:
        ck = np.random.default_rng(8).uniform(size=(L, L)).astype(np.float32)
        ck[2, 5] = 0.0
    want = jker.create_transition_prob_latent_1d(
        jnp.arange(L), mv, custom_kernel=None if ck is None else jnp.asarray(ck))
    got = kernels.create_transition_prob_latent_1d(torch.arange(L), mv,
                                                   custom_kernel=ck)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _f32_equal(g.numpy(), w)
    np.testing.assert_allclose(got[0].sum(1).numpy(), 1.0, rtol=1e-6)
    if not custom:  # movement_variance is the RBF lengthscale (the quirk)
        raw = np.exp(-((np.arange(L)[:, None] - np.arange(L)) ** 2) / mv**2)
        np.testing.assert_allclose(got[0].numpy(),
                                   raw / raw.sum(1, keepdims=True), atol=1e-6)


@pytest.mark.parametrize("L,ls_tun,ls_tr,var,p_iso", [
    (40, 5.0, 1.0, 1.0, 0.001), (17, 2.0, 3.0, 2.5, 0.05)])
def test_custom_kernel_rbf_plus_isolated(L, ls_tun, ls_tr, var, p_iso):
    want = jker.get_custom_kernel_rbf_plus_isolated(jnp.arange(L), ls_tun,
                                                    ls_tr, var, p_iso)
    got = kernels.get_custom_kernel_rbf_plus_isolated(torch.arange(L), ls_tun,
                                                      ls_tr, var, p_iso)
    for g, w in zip(got, want):
        _f32_equal(g.numpy(), w)
    tun, tr = (g.numpy() for g in got)
    # row 0 keeps the 1/n of the whole-matrix scale, the rest sum to 1
    np.testing.assert_allclose(tr[0], 1.0 / L, rtol=1e-6)
    np.testing.assert_allclose(tr[1:].sum(1), 1.0, rtol=1e-5)
    assert (tr[1:, 0] == np.float32(p_iso)).all()
    assert tun[0, 0] == var and (tun[0, 1:] == 0).all() and (tun[1:, 0] == 0).all()


def test_small_public_kernels():
    x, y = np.array([0.5, 2.0], np.float32), np.array([1.5, -1.0], np.float32)
    for fn, args in ((kernels.rbf_kernel, (3.0, 2.0)),
                     (kernels.rbf_kernel_multi_d,
                      (np.array([1.5, 4.0], np.float32), 0.7))):
        jfn = getattr(jker, fn.__name__)
        want = jfn(jnp.asarray(x), jnp.asarray(y), *map(jnp.asarray, args))
        got = fn(torch.tensor(x), torch.tensor(y), *args)
        for g, w in zip(got, want):
            _f32_equal(g.numpy(), w)
    got, want = kernels.uniform_kernel(1, 2, 7), jker.uniform_kernel(1, 2, 7)
    assert got[0] == want[0] and float(got[1]) == float(want[1])
    mat = np.array([[0.2, 0.8], [0.0, 1.0]], np.float32)
    for i, j in ((0, 1), (1, 0)):
        got = kernels.discrete_transition_kernel(i, j, torch.tensor(mat))
        want = jker.discrete_transition_kernel(i, j, jnp.asarray(mat))
        for g, w in zip(got, want):
            assert float(g) == float(w)


@pytest.mark.parametrize("L,nb", [(30, None), (50, 7), (4, None)])
def test_bspline_basis_exact(L, nb):
    want = np.asarray(jbasis.generate_basis(1.0, L, basis_type="bspline",
                                            n_basis_bspline=nb))
    got = basis.generate_basis(1.0, L, basis_type="bspline",
                               n_basis_bspline=nb).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], 1.0)
    np.testing.assert_allclose(got[:, 1:].sum(1), 1.0, rtol=1e-6)  # unity
    with pytest.raises(ValueError, match="order"):
        basis.generate_basis(1.0, L, basis_type="bspline", n_basis_bspline=3)
    with pytest.raises(ValueError):
        basis.generate_basis(1.0, L, basis_type="no_such_basis")


def _gauss_inputs(T, N, L, seed):
    rng = np.random.default_rng(seed)
    tuning = rng.normal(size=(L, N)).astype(np.float32) * 2
    y = (tuning[rng.integers(L, size=T)]
         + rng.normal(size=(T, N)) * 0.5).astype(np.float32)
    return y, tuning, rng


@pytest.mark.parametrize("noise", ["scalar", "per_neuron"])
@pytest.mark.parametrize("mask", ["1d", "2d"])
def test_gaussian_loglik(noise, mask):
    T, N, L = 40, 11, 19
    y, tuning, rng = _gauss_inputs(T, N, L, 9)
    ma_latent = np.ones(L, np.float32)
    ma_latent[[3, 4]] = 0
    ma = (rng.uniform(size=(N,) if mask == "1d" else (T, N)) > 0.2).astype(
        np.float32)
    std = 0.7 if noise == "scalar" else rng.uniform(0.3, 1.5, N).astype(
        np.float32)
    want = np.asarray(jem.gaussian_loglik(
        jnp.asarray(y), jnp.asarray(tuning), jnp.asarray(std), jnp.asarray(ma),
        jnp.asarray(ma_latent)))
    got = emissions.gaussian_loglik(_t(y), _t(tuning), std if noise ==
                                    "scalar" else _t(std), _t(ma),
                                    _t(ma_latent)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got[:, [3, 4]] == emissions.MASK_NEG).all()
    # the direct sum of the normal log-densities, in float64
    ma2 = np.broadcast_to(ma, (T, N)).astype(np.float64)
    resid = (y[:, None, :] - tuning[None].astype(np.float64)) / np.asarray(std)
    direct = ((-0.5 * resid**2 - np.log(std) - 0.5 * np.log(2 * np.pi))
              * ma2[:, None, :]).sum(-1)
    keep = ma_latent > 0
    np.testing.assert_allclose(got[:, keep], direct[:, keep], rtol=1e-5,
                               atol=1e-4)
    hp = {"noise_std": std}
    np.testing.assert_allclose(
        emissions.get_loglikelihood_ma_all(
            _t(y), _t(tuning), hp, _t(ma), _t(ma_latent),
            observation_model="gaussian", lgamma_term=torch.ones(T)).numpy(),
        got, rtol=0, atol=0)  # the lgamma term is ignored


@pytest.mark.parametrize("model", ["poisson", "gaussian"])
def test_per_bin_dt(model):
    T, N, L = 30, 7, 12
    if model == "poisson":
        y, tuning, rng = _spikes(10, T, N, L)
        hp = {}
    else:
        y, tuning, rng = _gauss_inputs(T, N, L, 10)
        hp = {"noise_std": 0.6}
    dt = rng.uniform(0.5, 2.0, T).astype(np.float32)
    ma, ma_latent = np.ones(N, np.float32), np.ones(L, np.float32)
    ma_latent[0] = 0
    want = np.asarray(jem.get_loglikelihood_ma_all_changing_dt(
        jnp.asarray(y), jnp.asarray(tuning), hp, jnp.asarray(ma),
        jnp.asarray(ma_latent), jnp.asarray(dt), observation_model=model))
    got = emissions.get_loglikelihood_ma_all_changing_dt(
        _t(y), _t(tuning), hp, _t(ma), _t(ma_latent), _t(dt),
        observation_model=model).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a constant per-bin dt equals the scalar matmul form
    const = emissions.get_loglikelihood_ma_all_changing_dt(
        _t(y), _t(tuning), hp, _t(ma), _t(ma_latent), torch.full((T,), 1.5),
        observation_model=model).numpy()
    scalar = emissions.get_naive_bayes_ma(
        _t(y), _t(tuning), hp, _t(ma), _t(ma_latent), 1.5,
        observation_model=model)[3].numpy()
    np.testing.assert_allclose(const, scalar, rtol=1e-5)
    # chunked naive Bayes with per-bin dt
    want = jem.get_naive_bayes_ma_chunk(
        jnp.asarray(y), jnp.asarray(tuning), hp, jnp.asarray(ma),
        jnp.asarray(ma_latent), dt_l=jnp.asarray(dt), n_time_per_chunk=11,
        observation_model=model)
    got = emissions.get_naive_bayes_ma_chunk(
        _t(y), _t(tuning), hp, _t(ma), _t(ma_latent), dt_l=dt,
        n_time_per_chunk=11, observation_model=model)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    with pytest.raises(ValueError, match="observation_model"):
        emissions.get_loglikelihood_ma_all(_t(y), _t(tuning), hp, _t(ma),
                                           _t(ma_latent), "no_such_model")


def _grouped_stats(seed, T, L, N, nb):
    rng = np.random.default_rng(seed)
    lpi = np.log(rng.dirichlet(np.ones(L), T)).astype(np.float32)
    y = rng.poisson(2.0, size=(T, N)).astype(np.float32)
    b = rng.normal(size=(L, nb)).astype(np.float32)
    yw, tw = jmstep.get_statistics(jnp.asarray(lpi), jnp.asarray(y))
    return b, np.asarray(yw), np.asarray(tw), rng


def test_gaussian_ridge_m_step():
    L, N, nb = 30, 9, 8
    b, yw, tw, _ = _grouped_stats(11, 300, L, N, nb)
    hp = {"noise_std": 0.4, "param_prior_std": 2.0}
    want = np.asarray(jmstep.gaussian_m_step_analytic(
        hp, jnp.asarray(b), jnp.asarray(yw), jnp.asarray(tw)))
    got = mstep.gaussian_m_step_analytic(hp, _t(b), _t(yw), _t(tw))
    assert got.shape == (nb, N)
    np.testing.assert_allclose(
        mstep.get_tuning_linear(got, _t(b)).numpy(), b @ want,
        rtol=1e-5, atol=1e-5 * float(np.abs(b @ want).max()))


def test_smoothness_objective_and_gradient():
    L, N, nb = 26, 6, 9
    b, yw, tw, rng = _grouped_stats(12, 400, L, N, nb)
    params = rng.normal(size=(nb, N)).astype(np.float32)
    hp = {"param_prior_std": 1.3, "smoothness_penalty": 4.0}
    jl, jg = jax.value_and_grad(jmstep.poisson_m_step_objective_smoothness)(
        jnp.asarray(params), hp, jnp.asarray(b), jnp.asarray(yw),
        jnp.asarray(tw))
    p = _t(params).requires_grad_(True)
    loss = mstep.poisson_m_step_objective_smoothness(p, hp, _t(b), _t(yw),
                                                     _t(tw))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    g, jg = p.grad.numpy(), np.asarray(jg)
    assert np.abs(g - jg).max() <= 1e-5 * np.abs(jg).max()
    # the penalty adds to the plain objective
    plain = mstep.poisson_m_step_objective(p.detach(), hp, _t(b), _t(yw),
                                           _t(tw))
    assert loss > float(plain)


def _fused_trip_inputs(case):
    """Inputs of B = 4 runs for the fused Adam trip's plain version: the
    basis shared or per run, zeros in y_weighted, X past +-20, or one
    stopped run; an Adam state three steps in."""
    B, L, N, nb = 4, 40, 13, 9
    rng = np.random.default_rng(21)
    shape = (B, L, nb) if case == "per_run_basis" else (L, nb)
    b = rng.normal(size=shape).astype(np.float32)
    params = (rng.normal(size=(B, nb, N))
              * (6.0 if case == "x_past_20" else 0.3)).astype(np.float32)
    yw = rng.gamma(2.0, 3.0, size=(B, L, N)).astype(np.float32)
    if case == "zeros_in_y":
        yw[rng.uniform(size=yw.shape) < 0.3] = 0.0
        yw[:, :, 4] = 0.0
    tw = rng.uniform(5.0, 50.0, size=(B, L)).astype(np.float32)
    prior = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
    state = mstep.AdamState(
        torch.full((B,), 3, dtype=torch.int32),
        _t(rng.normal(size=params.shape) * 0.1),
        _t(rng.uniform(size=params.shape) * 0.01))
    active = torch.tensor([True, case != "stopped_run", True, True])
    return b, params, yw, tw, prior, state, active


@pytest.mark.parametrize("case", ["shared_basis", "per_run_basis",
                                  "zeros_in_y", "x_past_20", "stopped_run"])
def test_fused_trip_plain_version(case):
    """``poisson_value_and_grad_batch_plain`` (the fused Adam trip's
    arithmetic) against autograd of ``poisson_m_step_objective_batch`` and
    against ``jax.value_and_grad`` of the JAX objective vmapped over runs:
    losses and errors 2e-6 relative, gradients 1e-5 of their largest (f32
    sums in other orders); Adam on the live runs, a stopped run's entries
    bit for bit."""
    b, params, yw, tw, prior, state, active = _fused_trip_inputs(case)
    hp = {"param_prior_std": _t(prior)}
    args = (hp, _t(b), _t(yw), _t(tw))
    got = mstep.poisson_value_and_grad_batch_plain(
        _t(params), *args, opt_state=state, active=active, step_size=0.01)
    p = _t(params).requires_grad_(True)
    loss = mstep.poisson_m_step_objective_batch(p, *args)
    (grads,) = torch.autograd.grad(loss.sum(), p)
    jl, jg = jax.vmap(jax.value_and_grad(jmstep.poisson_m_step_objective),
                      in_axes=(0, {"param_prior_std": 0},
                               0 if b.ndim == 3 else None, 0, 0))(
        jnp.asarray(params), {"param_prior_std": jnp.asarray(prior)},
        jnp.asarray(b), jnp.asarray(yw), jnp.asarray(tw))
    x = np.matmul(b, params)
    if case == "x_past_20":
        assert (x > 20).any() and (x < -20).any()
    for want_l, want_g in ((loss.detach().numpy(), grads.numpy()),
                           (np.asarray(jl), np.asarray(jg))):
        np.testing.assert_allclose(got["loss"].numpy(), want_l, rtol=2e-6)
        assert (np.abs(got["grads"].numpy() - want_g).max()
                <= 1e-5 * np.abs(want_g).max())
        np.testing.assert_allclose(
            got["error"].numpy(),
            np.sqrt(np.square(want_g.astype(np.float64)).sum(axis=(1, 2))),
            rtol=2e-6)
    updates, moved = mstep.adam_update(grads, state, 0.01)
    live = active.numpy()
    np.testing.assert_allclose(got["params"].numpy()[live],
                               (_t(params) + updates).numpy()[live],
                               rtol=0, atol=1e-6)
    for g_s, m_s in zip(got["opt_state"][1:], moved[1:]):
        np.testing.assert_allclose(g_s.numpy()[live], m_s.numpy()[live],
                                   rtol=1e-4, atol=1e-9)
    assert torch.equal(got["opt_state"].count,
                       torch.where(active, state.count + 1, state.count))
    dead = ~active
    assert torch.equal(got["params"][dead], _t(params)[dead])
    assert torch.equal(got["opt_state"].mu[dead], state.mu[dead])
    assert torch.equal(got["opt_state"].nu[dead], state.nu[dead])
