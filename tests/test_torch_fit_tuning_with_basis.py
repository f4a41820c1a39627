"""``poor_man_gplvm_tpu_torch.ops.fit_tuning_with_basis`` against
``poor_man_gplvm_tpu/ops/fit_tuning_with_basis.py``.

The JAX package solves each neuron with ``optax.lbfgs`` under vmap; the
port runs one batched L-BFGS over all neurons with another line search,
so the iterates differ and the tests compare objective values (the
``basis_*`` cases of PARITY.json): the (w, b) link and the grouped
statistics to 1e-6, the objective at pinned params to 1e-4 relative, and
the solver improves on its start and reaches the JAX solver's optimum.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from poor_man_gplvm_tpu.ops import fit_tuning_with_basis as jftb  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import (  # noqa: E402
    fit_tuning_with_basis as ftb,
)

torch.set_num_threads(1)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _parity_inputs(T=400, N=10, L=25, rank=6):
    """PARITY.json's basis case (scripts/parity_vs_reference.py)."""
    rng = np.random.default_rng(0)
    spk = rng.poisson(1.0, size=(T, N)).astype(np.float32)
    post = rng.dirichlet(np.ones(L), size=T).astype(np.float32)
    basis = rng.normal(size=(L, rank)).astype(np.float32)
    w = (rng.normal(size=(rank, N)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(N,)) * 0.1).astype(np.float32)
    return spk, post, basis, w, b


def test_link_statistics_and_objective_match_jax():
    spk, post, basis, w, b = _parity_inputs()
    t = [torch.as_tensor(a) for a in (spk, post, basis, w, b)]
    np.testing.assert_allclose(
        _np(ftb.glm_get_tuning((t[3], t[4]), t[2])),
        np.asarray(jftb.glm_get_tuning((jnp.asarray(w), jnp.asarray(b)),
                                       jnp.asarray(basis))), rtol=1e-6)
    s_b, t_b = ftb.group_spk_occupancy_chunk_neuron(t[0], t[1],
                                                    n_neuron_per_chunk=4)
    js, jt = jftb.group_spk_occupancy_chunk_neuron(
        jnp.asarray(spk), jnp.asarray(post), n_neuron_per_chunk=4)
    np.testing.assert_allclose(_np(s_b), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(_np(t_b), np.asarray(jt), rtol=1e-6)
    _, t_b2 = ftb.group_spk_occupancy_chunk_neuron(t[0], t[1], dt=2.0)
    np.testing.assert_allclose(_np(t_b2), 2 * _np(t_b), rtol=1e-6)
    np.testing.assert_allclose(_np(ftb.get_s_b(t[0], t[1])), _np(s_b))
    for n in range(3):
        got = float(ftb.get_log_poisson_p_y_joint_params_oneneuron_grouped(
            (t[3][:, n], t[4][n]), s_b[:, n], t[2], t_b, 1.0))
        want = float(jftb.get_log_poisson_p_y_joint_params_oneneuron_grouped(
            (jnp.asarray(w[:, n]), jnp.asarray(b[n])), js[:, n],
            jnp.asarray(basis), jt, 1.0))
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_solver_improves_and_reaches_the_jax_optimum():
    spk, post, basis, w, b = _parity_inputs()
    s_b, t_b = ftb.group_spk_occupancy_chunk_neuron(torch.as_tensor(spk),
                                                    torch.as_tensor(post))
    init = sum(float(ftb._neg_objective(
        (torch.as_tensor(w[:, n]), torch.as_tensor(b[n])), s_b[:, n],
        torch.as_tensor(basis), t_b, 1.0)) for n in range(w.shape[1]))
    for maxiter in (30, 100):
        _, _, got = ftb.m_step_get_tuning_all_neuron_grouped(
            (w, b), torch.as_tensor(spk), basis, post, 1.0, maxiter=maxiter)
        _, _, want = jftb.m_step_get_tuning_all_neuron_grouped(
            (jnp.asarray(w), jnp.asarray(b)), jnp.asarray(spk),
            jnp.asarray(basis), jnp.asarray(post), 1.0, maxiter=maxiter)
        assert float(got) < init
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_lbfgs_recovers_tuning():
    """The JAX package's recovery case: delta posteriors at random bins,
    the fit's tuning correlates with the truth and its objective reaches
    the truth's."""
    rng = np.random.default_rng(0)
    L, B, N, T = 12, 4, 6, 2000
    basis = rng.normal(size=(L, B)).astype(np.float32)
    w_true = rng.normal(size=(B, N)).astype(np.float32)
    b_true = (rng.normal(size=(N,)) * 0.5).astype(np.float32)
    tuning_true = _np(ftb.glm_get_tuning(
        (torch.as_tensor(w_true), torch.as_tensor(b_true)),
        torch.as_tensor(basis)))
    bins = rng.integers(0, L, size=T)
    post = np.zeros((T, L), dtype=np.float32)
    post[np.arange(T), bins] = 1.0
    spk = rng.poisson(tuning_true[bins]).astype(np.float32)
    params, tuning_fit, err = ftb.m_step_get_tuning_all_neuron_grouped(
        (torch.zeros((B, N)), torch.zeros(N)), torch.as_tensor(spk), basis,
        post, prior_hyper=100.0, maxiter=200)
    assert params[0].shape == (B, N) and params[1].shape == (N,)
    corr = np.corrcoef(_np(tuning_fit).ravel(), tuning_true.ravel())[0, 1]
    assert corr > 0.95
    s_b, t_b = ftb.group_spk_occupancy_chunk_neuron(torch.as_tensor(spk),
                                                    torch.as_tensor(post))
    val_true = sum(float(ftb._neg_objective(
        (torch.as_tensor(w_true[:, n]), torch.as_tensor(b_true[n])),
        s_b[:, n], torch.as_tensor(basis), t_b, 100.0)) for n in range(N))
    assert float(err) <= val_true + 1e-3
