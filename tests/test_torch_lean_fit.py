"""The fused and lean ``fit_em`` schedule of the port against the JAX
package, and the port's device default.

The port model takes the JAX model's ``params`` and ``tuning_basis``
(``convert.load_jax_state``); spikes and ``log_posterior_init`` are made
with numpy.  On the CPU the fused schedule runs the same math as the host
loop and is bit-equal to it (as the JAX package's own fused program is on
the CPU).  Against the JAX package: log-marginals 1e-5 relative (1e-6 for
one lean iteration, the JAX lean test's bound), with the Adam loop capped
because its stopping rule flips under 1-ulp loss differences (ROADMAP §3).
"""

import collections
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D, convert  # noqa: E402
from poor_man_gplvm_tpu_torch.models import base as mbase  # noqa: E402

torch.set_num_threads(1)

KW = dict(n_latent_bin=9, movement_variance=1.0, tuning_lengthscale=3.0)
N = 5
TOL_LML = 1e-5


def _data(T, seed=0):
    """JAX model weights, spikes along a numpy random walk with jumps, and
    a numpy initial log posterior."""
    jm = jpmg.PoissonGPLVMJump1D(N, **KW)
    L = KW["n_latent_bin"]
    rng = np.random.default_rng(seed)
    x, lat = int(rng.integers(L)), []
    for _ in range(T):
        x = int(rng.integers(L)) if rng.random() < 0.02 else int(
            np.clip(x + rng.integers(-1, 2), 0, L - 1))
        lat.append(x)
    y = rng.poisson(np.asarray(jm.tuning)[lat]).astype(np.float32)
    lpi = np.log(rng.dirichlet(np.ones(L), T)).astype(np.float32)
    return jm, convert.state_from_model(jm), y, lpi


def _port(state, engine="auto"):
    m = PoissonGPLVMJump1D(N, inference_engine=engine, device="cpu", **KW)
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


def _jax(jm, engine):
    j = jpmg.PoissonGPLVMJump1D(N, inference_engine=engine, **KW)
    j.params, j.tuning_basis = jm.params, jm.tuning_basis
    return j


def _lml(res):
    return np.array([float(v) for v in res["log_marginal_l"]])


@pytest.mark.parametrize("output_mode", ["full", "lean"])
def test_fused_matches_host_loop_bit_for_bit(output_mode):
    _, state, y, lpi = _data(300)
    kw = dict(n_iter=5, log_posterior_init=lpi, verboase=False,
              output_mode=output_mode)
    loop = _port(state).fit_em(y, fused=False, **kw)
    fused = _port(state).fit_em(y, fused=True, **kw)
    np.testing.assert_array_equal(_lml(loop), _lml(fused))
    assert torch.equal(loop["params"], fused["params"])
    assert set(loop) == set(fused)
    assert fused["m_step_res_l"]["n_iter"] == loop["m_step_res_l"]["n_iter"]
    assert len(fused["m_step_res_l"]["n_iter"]) == 5
    for a, b in zip(fused["m_step_res_l"]["loss_history"],
                    loop["m_step_res_l"]["loss_history"]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(loop["posterior"], fused["posterior"])


def test_fused_parallel_matches_jax_fused():
    """Port 'cuda_parallel' fused (warm-started fast fixed points) against
    JAX 'pallas_parallel' fused, and against the port's own host loop."""
    jm, state, y, lpi = _data(700)
    kw = dict(n_iter=6, log_posterior_init=lpi, verboase=False,
              m_step_maxiter=15)
    want = _jax(jm, "pallas_parallel").fit_em(y, fused=True, **kw)
    m = _port(state, "cuda_parallel")
    got = m.fit_em(y, fused=True, **kw)
    loop = _port(state, "cuda_parallel").fit_em(y, fused=False, **kw)
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=TOL_LML)
    np.testing.assert_allclose(_lml(got), _lml(loop), rtol=TOL_LML)
    assert m._scan_passes_mid.shape == (4, 2)
    assert m._scan_passes_mid[1:].max() <= m._scan_passes_mid[0].max()
    assert m._scan_emit_delta_mid.shape == m._scan_drift_mid.shape == (4, 2)
    assert (m._scan_emit_delta_mid <= 1e-3).all()
    assert got["m_step_res_l"]["n_iter"] == want["m_step_res_l"]["n_iter"]


def test_lean_matches_jax_lean():
    """The lean em_res contract (keys, None slots, shapes) and one
    iteration's log-marginal against the JAX package's lean fit, and lean
    against full in the port."""
    jm, state, y, lpi = _data(400)
    L = KW["n_latent_bin"]
    kw = dict(log_posterior_init=lpi, verboase=False, m_step_maxiter=15)
    want = _jax(jm, "prob").fit_em(y, n_iter=1, output_mode="lean", **kw)
    got = _port(state).fit_em(y, n_iter=1, output_mode="lean", **kw)
    full = _port(state).fit_em(y, n_iter=1, **kw)
    assert set(got) == set(want)
    for k in ("log_posterior_final", "log_posterior_init"):
        assert got[k] is None and want[k] is None
    assert got["log_posterior_all_saved"] == [] == want[
        "log_posterior_all_saved"]
    assert got["posterior"].shape == (400, L) == np.asarray(
        want["posterior"]).shape
    assert got["posterior_dynamics_marg"].shape == (400, 2)
    assert got["posterior_latent_marg"] is got["posterior"]
    np.testing.assert_allclose(float(got["log_marginal"]),
                               float(want["log_marginal"]), rtol=1e-6)
    np.testing.assert_allclose(float(got["log_marginal"]),
                               float(full["log_marginal"]), rtol=1e-6)
    torch.testing.assert_close(got["posterior"].sum(dim=1),
                               torch.ones(400))
    for k in ("posterior_latent_marg", "posterior_dynamics_marg"):
        np.testing.assert_allclose(got[k].numpy(), full[k].numpy(),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6)
    # over a fused lean fit the trajectory stays with JAX's
    kw3 = dict(kw, n_iter=4, output_mode="lean")
    np.testing.assert_allclose(
        _lml(_port(state, "cuda_parallel").fit_em(y, **kw3)),
        _lml(_jax(jm, "pallas_parallel").fit_em(y, **kw3)), rtol=TOL_LML)


def test_nan_guard_default_on_in_lean():
    _, state, y, lpi = _data(200)
    bad = y.copy()
    bad[3, 0] = np.nan
    kw = dict(log_posterior_init=lpi, verboase=False, m_step_maxiter=6)
    # lean: on by default, in the fused segment's bulk check as well
    with pytest.raises(FloatingPointError, match="diverged"):
        _port(state).fit_em(bad, n_iter=4, output_mode="lean", **kw)
    with pytest.raises(FloatingPointError, match="diverged"):
        _port(state).fit_em(bad, n_iter=1, output_mode="lean", **kw)
    # full: off by default (one host read per iteration), on when asked
    res = _port(state).fit_em(bad, n_iter=1, **kw)
    assert not np.isfinite(float(res["log_marginal"]))
    with pytest.raises(FloatingPointError, match="diverged"):
        _port(state).fit_em(bad, n_iter=4, nan_guard=True, **kw)


def test_certificate_retry_reproduces_trajectory(monkeypatch):
    """A failed warm-start certificate redoes the fused segment with strict
    fixed-point exits (with a warning) and reproduces the trajectory; a
    second failure raises."""
    _, state, y, lpi = _data(700)
    kw = dict(n_iter=6, log_posterior_init=lpi, verboase=False,
              m_step_maxiter=15)
    ref = _port(state, "cuda_parallel").fit_em(y, **kw)
    real = mbase._first_failed_certificate
    calls = {"n": 0}

    def fail_once(diag):
        calls["n"] += 1
        return (0, np.array([1.0, 1.0])) if calls["n"] == 1 else real(diag)

    monkeypatch.setattr(mbase, "_first_failed_certificate", fail_once)
    with pytest.warns(UserWarning, match="strict fixed-point exits"):
        got = _port(state, "cuda_parallel").fit_em(y, **kw)
    assert calls["n"] == 2
    np.testing.assert_allclose(_lml(got), _lml(ref), rtol=1e-6)

    monkeypatch.setattr(mbase, "_first_failed_certificate",
                        lambda diag: (0, np.array([np.nan, 1.0])))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(FloatingPointError, match="strict"):
            _port(state, "cuda_parallel").fit_em(y, **kw)
    # NaN residuals fail the certificate
    assert real({"scan_emit_delta": np.array([[0.0, 0.0],
                                               [np.nan, 0.0]])})[0] == 1
    assert real({"scan_emit_delta": np.zeros((3, 2))}) is None
    assert real({}) is None


def test_device_default_is_the_card():
    """Models and carried Adam states go to the card unless the caller asks
    for the CPU; with no card the default raises instead of falling back."""
    if torch.cuda.is_available():
        assert PoissonGPLVMJump1D(4, n_latent_bin=6).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoissonGPLVMJump1D(4, n_latent_bin=6)
    adam = collections.namedtuple("ScaleByAdamState", "count mu nu")(
        0, np.zeros(2), np.zeros(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.adam_state_from_jax((adam,))
    assert convert.adam_state_from_jax((adam,), device="cpu").mu.device \
        == torch.device("cpu")
    assert PoissonGPLVMJump1D(4, n_latent_bin=6,
                              device="cpu").device.type == "cpu"
