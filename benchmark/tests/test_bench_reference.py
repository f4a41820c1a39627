"""The benchmark's reference smoother and EM against a dense float64
forward-backward written out here, at tiny sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import em
from benchmark.reference import model as rm
from benchmark.reference import smoother


def dense_forward_backward(ll, trans):
    """Sequential float64 forward-backward over the (2 L) joint state with
    the full transition matrix: (log-marginal, posterior (T, 2, L),
    pairwise joint summed over steps (2, 2, L, L))."""
    ll = ll.numpy()
    T, L = ll.shape
    cont = trans.Tcont.numpy()
    lat = np.stack([cont, np.full((L, L), 1.0 / L)])
    dyn = trans.Tdyn.numpy()
    A = np.einsum("de,eij->diej", dyn, lat).reshape(2 * L, 2 * L)
    e = np.exp(ll - ll.max(axis=1, keepdims=True))
    e2 = np.concatenate([e, e], axis=1)
    alpha = np.empty((T, 2 * L))
    c = np.empty(T)
    a = np.full(2 * L, 1.0 / (2 * L))
    for t in range(T):
        a = (a @ A) * e2[t]
        c[t] = a.sum()
        a = a / c[t]
        alpha[t] = a
    lml = np.log(c).sum() + ll.max(axis=1).sum()
    beta = np.ones((T, 2 * L))
    for t in range(T - 2, -1, -1):
        b = A @ (e2[t + 1] * beta[t + 1])
        beta[t] = b / b.sum()
    post = alpha * beta
    post /= post.sum(axis=1, keepdims=True)
    joint = np.zeros((2 * L, 2 * L))
    for t in range(T - 1):
        x = alpha[t][:, None] * A * (e2[t + 1] * beta[t + 1])[None, :]
        joint += x / x.sum()
    joint = joint.reshape(2, L, 2, L).transpose(0, 2, 1, 3)
    return lml, post.reshape(T, 2, L), joint


@pytest.mark.parametrize("T,k", [(7, 500), (300, 40), (301, 40), (1, 500)])
def test_smoother_matches_dense_forward_backward(T, k):
    g = torch.Generator().manual_seed(T)
    L, N = 12, 9
    trans = rm.transition(L, 1.0, 0.05, 0.1, "cpu")
    tun = torch.rand((L, N), generator=g, dtype=torch.float64) * 2
    y = torch.poisson(tun[torch.randint(L, (T,), generator=g)], generator=g)
    ll = rm.loglik(y, tun, "poisson")
    lml, post, joint = dense_forward_backward(ll.clone(), trans)
    out = smoother.smooth(ll, trans, k=k, want_joint=True)
    assert out.log_marginal == pytest.approx(lml, rel=1e-12, abs=1e-9)
    np.testing.assert_allclose(out.latent_marg.numpy(), post.sum(axis=1),
                               atol=1e-11)
    np.testing.assert_allclose(out.dyn_marg.numpy(), post.sum(axis=2),
                               atol=1e-11)
    if T > 1:
        np.testing.assert_allclose(out.joint.numpy(), joint, atol=1e-10)
        assert float(out.joint.sum()) == pytest.approx(T - 1, rel=1e-12)


def test_gaussian_loglik_is_the_normal_density():
    g = torch.Generator().manual_seed(3)
    y = torch.randn((5, 4), generator=g, dtype=torch.float64)
    mu = torch.randn((6, 4), generator=g, dtype=torch.float64)
    ll = rm.loglik(y, mu, "gaussian", noise_std=0.7)
    want = torch.distributions.Normal(mu[None], 0.7).log_prob(
        y[:, None]).sum(-1)
    torch.testing.assert_close(ll, want, rtol=1e-12, atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0],
                     dtype=torch.float32)
    r = rm.tf32_round(x)
    assert r[1] == x[1] and r[2] == 3.0 and abs(float(r[0]) - 1.0) in (
        0.0, 2 ** -10)
    v = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rel = ((rm.tf32_round(v) - v).abs() / v.abs()).max()
    assert 0 < float(rel) <= 2 ** -11


def test_adam_m_step_lowers_the_objective_and_stops_by_the_rule():
    g = torch.Generator().manual_seed(5)
    basis = rm.tuning_basis(20, 10.0)
    p = torch.randn((basis.shape[1], 6), generator=g, dtype=torch.float64)
    post = torch.rand((400, 20), generator=g, dtype=torch.float64)
    post /= post.sum(1, keepdim=True)
    y = torch.poisson(torch.ones((400, 6), dtype=torch.float64), generator=g)
    yw, tw = em.statistics(post, y)
    before = em.poisson_objective(p, basis, yw, tw, 1.0)
    p2, state, n = em.adam_m_step(p, em.Adam(), basis, yw, tw, 1.0)
    assert em.poisson_objective(p2, basis, yw, tw, 1.0) < before
    assert 6 <= n <= 999 and state.count == n - 1


def test_ridge_m_step_solves_the_normal_equations():
    g = torch.Generator().manual_seed(6)
    basis = rm.tuning_basis(20, 10.0)
    yw = torch.randn((20, 5), generator=g, dtype=torch.float64)
    tw = torch.rand(20, generator=g, dtype=torch.float64) + 0.5
    w = em.ridge_m_step(basis, yw, tw, 0.5, 1.0)
    grad = (basis.T @ (tw[:, None] * (basis @ w)) - basis.T @ yw) / 0.25 + w
    assert float(grad.abs().max()) < 1e-9
