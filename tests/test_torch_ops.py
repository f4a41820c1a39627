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
