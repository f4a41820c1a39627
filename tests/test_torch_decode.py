"""The slice: ``PoissonGPLVMJump1D.decode_latent`` of the port against the
JAX package on the same weights and spikes.

The JAX model runs with ``inference_engine='pallas'`` (its sequential
kernels in interpret mode on the CPU) and ``'prob'``; the port model is
built on the CPU from the JAX model's ``params`` and ``tuning_basis``
through ``convert.load_jax_state`` and runs ``'cuda'`` (the kernels'
wrappers, which run their plain versions on CPU tensors) and ``'prob'``.
Metrics are the repo's parity metrics (scripts/parity_vs_reference.py) at
PARITY.json's tolerances: log-marginals 1e-5 relative, posteriors and
``p_*`` 1e-4 absolute, the other log keys 1e-5 max-normalised relative.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D, convert  # noqa: E402

torch.set_num_threads(1)

T, N, L = 201, 20, 30
TOL_LMF = 1e-5
TOL_POST = 1e-4
TOL_LOG = 1e-5
KEYS_19 = {
    "log_posterior_all", "posterior_all", "posterior_latent_marg",
    "posterior_dynamics_marg", "log_one_step_predictive_marginals_all",
    "log_likelihood_all", "log_marginal_final",
    "p_joint_full", "p_joint_latent", "p_joint_dynamics",
    "p_transition_full", "p_transition_latent", "p_transition_dynamics",
    "log_joint_full", "log_joint_latent", "log_joint_dynamics",
    "log_transition_full", "log_transition_latent",
    "log_transition_dynamics",
}


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12))


def _log_rel_err(ours, ref):
    """rel_err over entries whose reference log-prob is non-negligible
    (> -50): the floored zeros carry no mass, and their log values depend
    on representation."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    mask = np.isfinite(ref) & (ref > -50.0)
    denom = max(float(np.abs(ref[mask]).max()), 1e-12)
    return float(np.abs(ours[mask] - ref[mask]).max() / denom)


def assert_decode_close(got, want):
    assert set(got) == set(want) == KEYS_19
    lmf, lmf_ref = got["log_marginal_final"], want["log_marginal_final"]
    assert abs(lmf - lmf_ref) <= TOL_LMF * abs(lmf_ref)
    for k in KEYS_19 - {"log_marginal_final"}:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if "posterior" in k and not k.startswith("log_") or k.startswith("p_"):
            err, tol = float(np.abs(g - w).max()), TOL_POST
        elif k in ("log_likelihood_all",
                   "log_one_step_predictive_marginals_all"):
            err, tol = _rel_err(g, w), TOL_LOG
        else:
            err, tol = _log_rel_err(g, w), TOL_LOG
        assert err <= tol, (k, err)


def _spikes(tuning, seed=0):
    """Poisson counts along a numpy random-walk latent path with jumps."""
    rng = np.random.default_rng(seed)
    x, lat = int(rng.integers(L)), []
    for _ in range(T):
        x = int(rng.integers(L)) if rng.random() < 0.02 else int(
            np.clip(x + rng.integers(-1, 2), 0, L - 1))
        lat.append(x)
    return rng.poisson(np.asarray(tuning)[lat]).astype(np.float32)


def _jax_model(engine):
    return jpmg.PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                                   tuning_lengthscale=5.0,
                                   inference_engine=engine)


def _port_model(jax_model, engine):
    m = PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                           tuning_lengthscale=5.0, inference_engine=engine,
                           device="cpu")
    state = convert.state_from_model(jax_model)
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


@pytest.fixture(scope="module")
def models():
    jm = {e: _jax_model(e) for e in ("pallas", "prob")}
    pm = {e: _port_model(jm["pallas"], e) for e in ("cuda", "prob")}
    y = _spikes(jm["pallas"].tuning)
    return jm, pm, y


@pytest.fixture(scope="module")
def jax_decode(models):
    jm, _, y = models
    return jm["pallas"].decode_latent(y)


def test_weights_carry_across(models):
    jm, pm, _ = models
    np.testing.assert_allclose(pm["cuda"].tuning.numpy(),
                               np.asarray(jm["pallas"].tuning), rtol=1e-5)
    assert pm["cuda"].inference_engine == "cuda"
    assert pm["prob"].inference_engine == "prob"


def test_decode_kernel_engine_matches_jax_pallas(models, jax_decode):
    _, pm, y = models
    assert_decode_close(pm["cuda"].decode_latent(y), jax_decode)


def test_decode_prob_engine_matches_jax_prob(models):
    jm, pm, y = models
    assert_decode_close(pm["prob"].decode_latent(y),
                        jm["prob"].decode_latent(y))


@pytest.mark.parametrize("chunk", [37, T])
def test_decode_chunk_invariance(models, jax_decode, chunk):
    _, pm, y = models
    got = pm["cuda"].decode_latent(y, n_time_per_chunk=chunk)
    assert_decode_close(got, jax_decode)


def test_decode_hyperparam_override(models, jax_decode):
    jm, pm, y = models
    hp = {"movement_variance": 2.0}
    want = jm["pallas"].decode_latent(y, hyperparam=hp)
    got = pm["cuda"].decode_latent(y, hyperparam=hp)
    assert_decode_close(got, want)
    assert got["log_marginal_final"] != jax_decode["log_marginal_final"]


def test_decode_with_masks(models):
    jm, pm, y = models
    ma_neuron = np.ones(N, np.float32)
    ma_neuron[[1, 7]] = 0
    ma_latent = np.ones(L, np.float32)
    ma_latent[[0, 13, 14]] = 0
    want = jm["pallas"].decode_latent(y, ma_neuron=ma_neuron,
                                      ma_latent=ma_latent)
    got = pm["cuda"].decode_latent(y, ma_neuron=ma_neuron,
                                   ma_latent=ma_latent)
    assert_decode_close(got, want)
    assert (got["posterior_latent_marg"][:, [0, 13, 14]] == 0).all()


def test_decode_latent_naive_bayes(models):
    jm, pm, y = models
    want = jm["pallas"].decode_latent_naive_bayes(y, n_time_per_chunk=64)
    got = pm["cuda"].decode_latent_naive_bayes(y, n_time_per_chunk=64)
    assert set(got) == set(want)
    assert abs(got["log_marginal_total"] - want["log_marginal_total"]) <= (
        TOL_LMF * abs(want["log_marginal_total"]))
    for k in ("posterior_latent",):
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= TOL_POST
    for k in ("log_marginal_l", "ll_per_pos_l"):
        assert _rel_err(got[k].numpy(), want[k]) <= TOL_LOG, k


def test_predict_expected_rate(models, jax_decode):
    jm, pm, _ = models
    marg = np.asarray(jax_decode["posterior_latent_marg"])
    np.testing.assert_allclose(
        pm["cuda"].predict_expected_rate(marg).numpy(),
        np.asarray(jm["pallas"].predict_expected_rate(marg)), rtol=1e-5)


def test_engines_and_modes():
    m = PoissonGPLVMJump1D(4, n_latent_bin=6, device="cpu")
    assert m.inference_engine == "prob"  # 'auto' on a CPU device
    assert PoissonGPLVMJump1D(4, n_latent_bin=6, device="cpu",
                              inference_engine="cuda_parallel"
                              ).inference_engine == "cuda_parallel"
    assert PoissonGPLVMJump1D(4, n_latent_bin=6, device="cpu",
                              inference_engine="log"
                              ).inference_engine == "log"  # asked by name
    for engine in ("pallas", "pallas_parallel"):  # the JAX package's names
        with pytest.raises(ValueError, match="cuda_parallel"):
            PoissonGPLVMJump1D(4, n_latent_bin=6, device="cpu",
                               inference_engine=engine)
    y = np.ones((5, 4), np.float32)
    args = (y, m.tuning, {}, m._make_transition({})[0], m.ma_neuron_default,
            m.ma_latent_default, 1.0, None)
    with pytest.raises(ValueError, match="memory_mode"):
        m._smooth(*args, memory_mode="no_such_mode")
    # every JAX memory mode runs; the stored-filter modes drop the causal
    # posteriors and the log-likelihoods, as in the JAX package
    full = m._smooth(*args)
    ckpt = m._smooth(*args, memory_mode="checkpoint")
    assert ckpt[2] is None and ckpt[5] is None
    assert torch.equal(ckpt[0], full[0]) and float(ckpt[1]) == float(full[1])
    with pytest.raises(ValueError):
        convert.load_jax_state(m, np.zeros((3, 5)), np.zeros((6, 3)))


def test_single_step_and_sampling():
    m = PoissonGPLVMJump1D(6, n_latent_bin=9, inference_engine="cuda",
                           device="cpu")
    lat, y = m.sample(40, generator=torch.Generator().manual_seed(1))
    lat2, y2 = m.sample(40, generator=torch.Generator().manual_seed(1))
    assert lat.shape == (40, 2) and y.shape == (40, 6)
    assert torch.equal(lat, lat2) and torch.equal(y, y2)
    assert lat[:, 0].max() <= 1 and lat[:, 1].max() < 9
    res = m.decode_latent(y[:1])  # T=1: the smoother has nothing to do
    torch.testing.assert_close(res["posterior_all"].sum(), torch.tensor(1.0))
    log_post, post = m.init_latent_posterior(
        12, torch.Generator().manual_seed(2))
    torch.testing.assert_close(post.sum(1), torch.ones(12))
    assert torch.isfinite(log_post).all()


def test_port_imports_and_decodes_without_jax():
    code = textwrap.dedent("""
        import sys
        for banned in ("jax", "poor_man_gplvm_tpu", "pandas", "sklearn",
                       "pynapple"):
            sys.modules[banned] = None
        import numpy as np
        import poor_man_gplvm_tpu_torch as pmt
        m = pmt.PoissonGPLVMJump1D(5, n_latent_bin=8, device="cpu")
        y = np.random.default_rng(0).poisson(1.0, (30, 5)).astype("f4")
        res = m.decode_latent(y)
        assert len(res) == 19 and np.isfinite(res["log_marginal_final"])
        m.inference_engine = "cuda_parallel"
        y = np.random.default_rng(1).poisson(1.0, (300, 5)).astype("f4")
        res = m.decode_latent(y)
        assert len(res) == 19 and np.isfinite(res["log_marginal_final"])
        em = m.fit_em(y, n_iter=2, verboase=False, m_step_maxiter=10)
        assert len(em["log_marginal_l"]) == 2
        assert np.isfinite(float(em["log_marginal_l"][-1]))
        ep = m.decode_latent_epochs(y, np.array([[0, 40], [100, 117]]))
        assert ep["posterior_latent_marg"].shape == (2, 40, 8)
        assert np.isfinite(ep["log_marginal_per_epoch"]).all()
        # the fused schedule, lean output, and the bf16x3 scan precision
        from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
        ps.set_scan_precision("bf16x3")
        em = m.fit_em(y, n_iter=4, verboase=False, m_step_maxiter=10,
                      output_mode="lean")
        ps.set_scan_precision("highest")
        assert em["posterior"].shape == (300, 8)
        assert em["log_posterior_final"] is None
        assert m._scan_passes_mid.shape == (2, 2)
        assert np.isfinite(float(em["log_marginal_l"][-1]))
        # the other families, the log engine and the initializers
        g = pmt.GaussianGPLVM1D(5, n_latent_bin=8, device="cpu",
                                inference_engine="log")
        res = g.decode_latent(y[:50])
        assert len(res) == 9 and np.isfinite(res["log_marginal_final"])
        lpi = pmt.initializers.init_with_label_1D(np.arange(300.0), 8)
        em = pmt.PoissonGPLVM1D(5, n_latent_bin=4, device="cpu").fit_em(
            y, n_iter=2, verboase=False, m_step_maxiter=5,
            log_posterior_init=pmt.initializers.init_with_pca(y, 4))
        assert np.isfinite(float(em["log_marginal"])) and lpi.shape == (300, 8)
        assert not any(k == "jax" or k.startswith(("jax.", "jaxlib"))
                       for k in sys.modules if sys.modules[k] is not None)
        print("ok")
    """)
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No source file of the port, and not ``chip_smoke.py``, imports
    ``jax``, ``jaxlib``, ``optax``, sklearn or anything of
    ``poor_man_gplvm_tpu``, nor pandas, pynapple, tqdm or orbax at module
    level (the card's machine has none of them; pandas and pynapple are
    imported inside the functions that use them where installed:
    ``utils.timeseries._PeriEvent.as_dataframe``,
    ``utils.compat.timeseries_module``)."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "poor_man_gplvm_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) >= 15
    banned = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|optax|poor_man_gplvm_tpu|"
        r"sklearn)(?![\w])", re.MULTILINE)
    top_level = re.compile(
        r"^(?:import|from)\s+(?:pandas|pynapple|tqdm|orbax)(?![\w])",
        re.MULTILINE)
    for path in files:
        hits = banned.findall(path.read_text())
        hits += top_level.findall(path.read_text())
        assert not hits, (path.name, hits)
