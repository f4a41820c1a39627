"""Options and edge cases of the port's model classes against the JAX
package: the initial posteriors of ``initializers`` (PCA with sklearn's
sign convention, the label binning of ``pandas.cut``), the carry of
weights for every class, the rbf-plus-isolated custom kernels (a
transition with a dense row and column), the B-spline basis with its
roughness-penalised objective in a fit, and the edge shapes T = 1, N = 1
and L = 2.  Helpers and tolerances as in ``test_torch_families.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu import initializers as jinit  # noqa: E402
from poor_man_gplvm_tpu.ops import kernels as jker  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import convert, initializers  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import kernels as pker  # noqa: E402
from test_torch_families import (  # noqa: E402
    CLASSES, TOL_LMF, _data, _jax_model, _lml, _port_model,
    assert_decode_close,
)

torch.set_num_threads(1)


def test_initializers_match_jax():
    rng = np.random.default_rng(6)
    y = rng.poisson(2.0, size=(400, 40)).astype(np.float32)
    for n_comp in (None, 7):
        want = np.asarray(jinit.init_with_pca(y, 20, n_pca_components=n_comp))
        got = initializers.init_with_pca(y, 20, n_pca_components=n_comp)
        assert got.shape == want.shape and got.dtype == torch.float32
        # sklearn's sign convention: not "up to sign"
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with pytest.raises(ValueError, match="less than"):
        initializers.init_with_pca(y, 40)
    noisy = initializers.init_with_pca(y, 20, noise_scale=0.1,
                                       generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(noisy).all() and not torch.equal(
        noisy, initializers.init_with_pca(y, 20))
    for label in (rng.uniform(-3.0, 7.0, 500),
                  rng.uniform(0, 1, 300).astype(np.float32),
                  rng.integers(0, 37, 250), np.full(20, 2.5), np.zeros(9)):
        for n_bin, noise in ((100, 1e-3), (13, 0.0)):
            with np.errstate(divide="ignore"):
                want = jinit.init_with_label_1D(label, n_bin,
                                                noise_scale=noise, seed=3)
                got = initializers.init_with_label_1D(label, n_bin,
                                                      noise_scale=noise,
                                                      seed=3)
            np.testing.assert_array_equal(got, want)
    # aligned to other bin times (t_l): ported, equal to the JAX function
    from poor_man_gplvm_tpu.utils.timeseries import Tsd as JTsd

    t = np.arange(300) * 0.1
    label = rng.uniform(-3.0, 7.0, 300)
    t_l = np.arange(-30, 350) * 0.09
    want = jinit.init_with_label_1D(JTsd(d=label, t=t), 40, t_l=t_l, seed=3)
    got = initializers.init_with_label_1D(pmt.Tsd(d=label, t=t), 40,
                                          t_l=t_l, seed=3)
    np.testing.assert_array_equal(got, want)


def test_state_carries_for_every_class():
    for name in CLASSES + ("PoissonGPLVMJump1D",):
        jm = getattr(jpmg, name)(6, n_latent_bin=9)
        pm = getattr(pmt, name)(6, n_latent_bin=9, device="cpu")
        state = convert.state_from_model(jm)
        convert.load_jax_state(pm, state["params"], state["tuning_basis"])
        np.testing.assert_allclose(pm.tuning.numpy(), np.asarray(jm.tuning),
                                   rtol=1e-5, atol=1e-6)
        back = convert.state_from_model(pm)
        for k in ("params", "tuning_basis"):
            np.testing.assert_array_equal(back[k], state[k])


def test_rbf_plus_isolated_custom_kernels():
    """PoissonGPLVM1D with the rbf-plus-isolated tuning and transition
    kernels (a transition with a dense row and a dense column): decode
    and a capped 2-iteration fit against the JAX model."""
    Lc = 40
    tun_k, tr_k = jker.get_custom_kernel_rbf_plus_isolated(
        np.arange(Lc), 5.0, 1.0, p_to_isolated=0.01)
    ptun, ptr = pker.get_custom_kernel_rbf_plus_isolated(
        torch.arange(Lc), 5.0, 1.0, p_to_isolated=0.01)
    kw = dict(custom_tuning_kernel=np.asarray(tun_k),
              custom_transition_kernel=np.asarray(tr_k))
    jm = _jax_model("PoissonGPLVM1D", "prob", n=20, l=Lc, **kw)
    y = _data(jm, 600, seed=2)
    pkw = dict(custom_tuning_kernel=ptun, custom_transition_kernel=ptr)
    for engine in ("prob", "cuda", "cuda_parallel"):
        pm = _port_model("PoissonGPLVM1D", jm, engine, **pkw)
        assert_decode_close(pm.decode_latent(y), jm.decode_latent(y))
    want = jm.fit_em(y, n_iter=2, verboase=False, m_step_maxiter=20)
    got = pm.fit_em(y, n_iter=2, verboase=False, m_step_maxiter=20,
                    log_posterior_init=want["log_posterior_init"])
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=TOL_LMF)


def test_bspline_basis_fit_with_smoothness_penalty():
    """A B-spline basis selects the roughness-penalised Adam objective."""
    kw = dict(basis_type="bspline", smoothness_penalty=2.0)
    jm = _jax_model("PoissonGPLVM1D", "prob", n=12, l=30, **kw)
    y = _data(jm, 400, seed=7)
    pm = _port_model("PoissonGPLVM1D", jm, "prob", **kw)
    np.testing.assert_array_equal(pm.tuning_basis.numpy(),
                                  np.asarray(jm.tuning_basis))
    want = jm.fit_em(y, n_iter=2, verboase=False, m_step_maxiter=15)
    got = pm.fit_em(y, n_iter=2, verboase=False, m_step_maxiter=15,
                    log_posterior_init=want["log_posterior_init"])
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=TOL_LMF)
    np.testing.assert_allclose(
        np.concatenate(got["m_step_res_l"]["loss_history"]),
        np.concatenate(want["m_step_res_l"]["loss_history"]), rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 5, 10), (60, 1, 10), (60, 5, 2)],
                         ids=["T1", "N1", "L2"])
def test_edge_shapes(shape):
    T_, N_, L_ = shape
    jm = _jax_model("GaussianGPLVM1D", "prob", n=N_, l=L_)
    y = _data(jm, T_, seed=8)
    pm = _port_model("GaussianGPLVM1D", jm, "cuda")
    assert_decode_close(pm.decode_latent(y), jm.decode_latent(y))
    want = jm.fit_em(y, n_iter=2, verboase=False)
    got = pm.fit_em(y, n_iter=2, verboase=False,
                    log_posterior_init=want["log_posterior_init"])
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=TOL_LMF)
