"""The session workflow of the port against the JAX package: TsdFrame /
``t_l`` inputs and results of every entry point, ``_decode_latent`` from
explicit matrices, ``init_with_label_1D(t_l=...)``, ``fit_em``
checkpoint/resume (also from a checkpoint the JAX package wrote), the
profiling helpers, and the public signatures.

Same numpy inputs through both packages; the port models take the JAX
models' ``params`` and ``tuning_basis`` (``convert.load_jax_state``) and
run on the CPU ('prob').  Tolerances (PARITY.json): log-marginals 1e-5
relative, decode posteriors 1e-4 absolute, fit posteriors 1e-2, expected
rates 1e-5 relative; times (``.t``) and the initial posteriors of
``init_with_label_1D`` (numpy in both packages) exactly equal.  The
Poisson fits cap ``m_step_maxiter`` (the Adam stop flips under 1-ulp loss
differences, ROADMAP §3).
"""

import importlib
import inspect
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.random as jr  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu import experimental as jexp  # noqa: E402
from poor_man_gplvm_tpu import initializers as jinit  # noqa: E402
from poor_man_gplvm_tpu import selection as jsel  # noqa: E402
from poor_man_gplvm_tpu import validation as jval  # noqa: E402
from poor_man_gplvm_tpu.ops import fit_tuning_with_basis as jftb  # noqa: E402
from poor_man_gplvm_tpu.parallel import spmd as jspmd  # noqa: E402
from poor_man_gplvm_tpu.parallel import sweep as jsweep  # noqa: E402
from poor_man_gplvm_tpu.utils import checkpoint as jck  # noqa: E402
from poor_man_gplvm_tpu.utils import compat as jcompat  # noqa: E402
from poor_man_gplvm_tpu.utils import profiling as jprof  # noqa: E402
from poor_man_gplvm_tpu.utils import timeseries as jts  # noqa: E402
from poor_man_gplvm_tpu.analysis import reactivation as jreact  # noqa: E402
from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu_torch import convert, initializers  # noqa: E402
from poor_man_gplvm_tpu_torch import experimental, selection  # noqa: E402
from poor_man_gplvm_tpu_torch import validation  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import fit_tuning_with_basis as ftb  # noqa: E402
from poor_man_gplvm_tpu_torch.parallel import spmd, sweep  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import compat, profiling  # noqa: E402
from poor_man_gplvm_tpu_torch.utils import timeseries as pts  # noqa: E402
from poor_man_gplvm_tpu_torch.analysis import reactivation  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402

torch.set_num_threads(1)

T, N, L = 240, 16, 24
DT = 0.025  # bin width: the times of every TsdFrame here
TOL_LMF = 1e-5
TOL_POST = 1e-4
TOL_FIT_POST = 1e-2
TOL_RATE = 1e-5
MAXITER = 20  # capped Adam loop of the Poisson fits
CLASSES = ("PoissonGPLVMJump1D", "GaussianGPLVMJump1D", "PoissonGPLVM1D",
           "GaussianGPLVM1D")
WRAPPED = {"PoissonGPLVMJump1D": ("posterior_latent_marg",
                                  "posterior_dynamics_marg"),
           "GaussianGPLVMJump1D": ("posterior_latent_marg",
                                   "posterior_dynamics_marg"),
           "PoissonGPLVM1D": ("posterior_all",),
           "GaussianGPLVM1D": ("posterior_all",)}


def _kw(name):
    kw = dict(n_latent_bin=L, movement_variance=1, tuning_lengthscale=4.0)
    if name.startswith("Gaussian"):
        kw["noise_std"] = 1.0
    return kw


def _data(jm, seed):
    """Observations along a numpy random walk through the JAX model's
    tuning curves (Poisson counts, or means plus unit normal noise)."""
    rng = np.random.default_rng(seed)
    lat = np.clip(np.cumsum(rng.integers(-1, 2, size=T)) + L // 2, 0, L - 1)
    mean = np.asarray(jm.tuning)[lat]
    if jm.observation_model == "gaussian":
        return (mean + rng.normal(size=mean.shape)).astype(np.float32)
    return rng.poisson(mean).astype(np.float32)


def _port(jm, name, **kw):
    m = getattr(pmt, name)(N, device="cpu", **_kw(name), **kw)
    state = convert.state_from_model(jm)
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


@pytest.fixture(scope="module", params=CLASSES)
def pair(request):
    name = request.param
    jm = getattr(jpmg, name)(N, inference_engine="prob", **_kw(name))
    y = _data(jm, 1 + CLASSES.index(name))
    return name, jm, _port(jm, name), y, np.arange(T) * DT


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                      dtype=np.float64)


def assert_frames(got, want, tol):
    """Both TsdFrames of their package, equal times, values within tol."""
    assert isinstance(got, pts.TsdFrame) and isinstance(want, jts.TsdFrame)
    np.testing.assert_array_equal(got.t, want.t)
    assert np.abs(_np(got.d) - _np(want.d)).max() <= tol


def test_decode_latent_on_a_tsdframe(pair):
    name, jm, pm, y, t = pair
    got = pm.decode_latent(pts.TsdFrame(d=y, t=t))
    want = jm.decode_latent(jts.TsdFrame(d=y, t=t))
    assert set(got) == set(want)
    for k in WRAPPED[name]:
        assert_frames(got[k], want[k], TOL_POST)
    assert abs(got["log_marginal_final"] - want["log_marginal_final"]) <= \
        TOL_LMF * abs(want["log_marginal_final"])
    # the same times as t_l, and the unwrapped decode, bit for bit
    by_t = pm.decode_latent(y, t_l=t)
    plain = pm.decode_latent(y)
    for k in WRAPPED[name]:
        np.testing.assert_array_equal(by_t[k].t, t)
        np.testing.assert_array_equal(by_t[k].d, plain[k].numpy())
        assert torch.is_tensor(plain[k])


def test_naive_bayes_with_t_l(pair):
    _, jm, pm, y, t = pair
    got = pm.decode_latent_naive_bayes(y, t_l=t)
    want = jm.decode_latent_naive_bayes(y, t_l=t)
    assert_frames(got["posterior_latent"], want["posterior_latent"], TOL_POST)
    got2 = pm.decode_latent_naive_bayes(pts.TsdFrame(d=y, t=t + 1.0))
    np.testing.assert_array_equal(got2["posterior_latent"].t, t + 1.0)
    np.testing.assert_array_equal(got2["posterior_latent"].d,
                                  got["posterior_latent"].d)


def test_predict_expected_rate_on_a_tsdframe(pair):
    _, jm, pm, y, t = pair
    post = np.random.default_rng(5).dirichlet(np.ones(L), size=T)
    got = pm.predict_expected_rate(pts.TsdFrame(d=post, t=t))
    want = jm.predict_expected_rate(jts.TsdFrame(d=post, t=t))
    np.testing.assert_array_equal(got.t, want.t)
    ref = _np(want.d)
    assert np.abs(_np(got.d) - ref).max() <= TOL_RATE * np.abs(ref).max()


def _init_posterior(seed):
    """A uniform-plus-noise log posterior (T, L) from numpy."""
    p = 1.0 / L + 0.1 * np.random.default_rng(seed).random((T, L))
    return np.log(p / p.sum(axis=1, keepdims=True)).astype(np.float32)


def _fit_kw(name):
    return {"m_step_maxiter": MAXITER} if name.startswith("Poisson") else {}


def test_fit_em_on_a_tsdframe(pair):
    name, jm, pm, y, t = pair
    lpi = _init_posterior(7)
    kw = dict(n_iter=2, log_posterior_init=lpi, verboase=False,
              **_fit_kw(name))
    want = getattr(jpmg, name)(N, inference_engine="prob", **_kw(name))
    want = want.fit_em(jts.TsdFrame(d=y, t=t), **kw)
    got = _port(jm, name).fit_em(pts.TsdFrame(d=y, t=t), **kw)
    keys = ("posterior",) if name.endswith("GPLVM1D") else (
        "posterior_latent_marg", "posterior_dynamics_marg")
    for k in keys:
        assert_frames(got[k], want[k], TOL_FIT_POST)
    np.testing.assert_allclose(_np(got["log_marginal_l"]),
                               _np(want["log_marginal_l"]), rtol=TOL_LMF)
    # lean output: a jump model wraps nothing, a latent-only one its
    # posterior, as in the JAX package
    lean = _port(jm, name).fit_em(pts.TsdFrame(d=y, t=t), output_mode="lean",
                                  **kw)
    if name.endswith("GPLVM1D"):
        assert isinstance(lean["posterior"], pts.TsdFrame)
    else:
        assert torch.is_tensor(lean["posterior_latent_marg"])


@pytest.mark.parametrize("family", ["jump", "latent"])
def test_decode_latent_from_explicit_matrices(family):
    """``_decode_latent`` with a dense random log transition (the band is
    W = L) against the JAX method: the smoother tuple."""
    name = "PoissonGPLVMJump1D" if family == "jump" else "PoissonGPLVM1D"
    jm = getattr(jpmg, name)(N, inference_engine="prob", **_kw(name))
    y = _data(jm, 11)
    rng = np.random.default_rng(12)
    n_dyn = 2 if family == "jump" else 1
    lat = rng.random((n_dyn, L, L)) + 0.05
    lat = np.log(lat / lat.sum(axis=-1, keepdims=True)).astype(np.float32)
    mats = (lat, np.log(np.array([[0.9, 0.1], [0.2, 0.8]], np.float32))) \
        if family == "jump" else (lat[0],)
    ma = np.ones(N, np.float32)
    want = jm._decode_latent(y, jm.tuning, {}, *mats, ma)
    for engine in ("prob", "cuda"):
        pm = _port(jm, name, inference_engine=engine)
        got = pm._decode_latent(y, pm.tuning, {}, *mats, ma)
        assert len(got) == len(want) == 6
        assert np.abs(np.exp(_np(got[0])) - np.exp(_np(want[0]))).max() \
            <= TOL_POST
        assert abs(float(got[1]) - float(want[1])) <= \
            TOL_LMF * abs(float(want[1]))
        np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=TOL_LMF,
                                   atol=TOL_LMF)


def test_decode_latent_from_the_models_own_matrices():
    """From the model's own log matrices: the decode's posteriors to the
    decode tolerance (exp(log T) is not T to the last bit)."""
    pm = pmt.PoissonGPLVMJump1D(N, device="cpu", inference_engine="cuda",
                                **_kw("PoissonGPLVMJump1D"))
    y = pm.sample(T)[1]
    _, attrs = pm._make_transition({})
    got = pm._decode_latent(y, pm.tuning, {},
                            attrs["log_latent_transition_kernel_l"],
                            attrs["log_dynamics_transition_kernel"],
                            pm.ma_neuron_default)
    ref = pm.decode_latent(y)
    assert float((torch.exp(got[0]) - ref["posterior_all"]).abs().max()) \
        <= TOL_POST


@pytest.mark.parametrize("t_l", ["wider", "inside", "ts"])
def test_init_with_label_t_l_matches_jax(t_l):
    rng = np.random.default_rng(21)
    t = np.arange(150) * 0.1
    label = np.cumsum(rng.normal(size=150))
    bins = {"wider": np.arange(-20, 180) * 0.1,
            "inside": np.sort(rng.uniform(2.0, 12.0, 90)),
            "ts": np.arange(-5, 120) * 0.13}[t_l]
    port_t = pts.Ts(bins) if t_l == "ts" else bins
    jax_t = jts.Ts(bins) if t_l == "ts" else bins
    got = initializers.init_with_label_1D(pts.Tsd(d=label, t=t),
                                          n_latent_bin=12, t_l=port_t, seed=4)
    want = jinit.init_with_label_1D(jts.Tsd(d=label, t=t), n_latent_bin=12,
                                    t_l=jax_t, seed=4)
    np.testing.assert_array_equal(got, want)


def test_checkpointer_round_trip(tmp_path):
    ckr = ck.EMCheckpointer(tmp_path / "ck")
    g = torch.Generator().manual_seed(9)
    state = {"step": 3, "params": torch.arange(6.0).reshape(2, 3),
             "opt_state": pmt.ops.mstep.AdamState(
                 torch.tensor(4, dtype=torch.int32), torch.ones(2, 3),
                 torch.zeros(2, 3)),
             "log_posterior": torch.ones((4, 5)), "rng": g}
    ckr.save(3, state)
    ckr.save(5, dict(state, step=5, opt_state=None))
    assert ckr.all_steps() == [3, 5] and ckr.latest_step() == 5
    assert ckr.restore()["step"] == 5 and ckr.restore()["opt_state"] is None
    got = ckr.restore(3)
    np.testing.assert_array_equal(got["params"], state["params"].numpy())
    assert set(got["opt_state"]) == {"count", "mu", "nu"}
    assert got["opt_state"]["count"].dtype == np.int32
    np.testing.assert_array_equal(got["rng"], g.get_state().numpy())
    # plain numpy only: the pickle names no torch or optax class
    raw = open(os.path.join(tmp_path, "ck", "step_00000003", "state.pkl"),
               "rb").read()
    assert b"torch" not in raw and b"optax" not in raw
    assert isinstance(pickle.loads(raw)["log_posterior"], np.ndarray)
    assert ck.EMCheckpointer(tmp_path / "empty").restore() is None
    with pytest.raises(ValueError, match="orbax"):
        ck.EMCheckpointer(tmp_path / "o", use_orbax=True)


@pytest.mark.parametrize("name", ["PoissonGPLVMJump1D", "GaussianGPLVM1D"])
def test_resume_equals_the_uninterrupted_fit(tmp_path, name):
    """Interrupted after 2 iterations and resumed to 4: equal to the
    uninterrupted checkpointed fit bit for bit on the CPU."""
    model = pmt.PoissonGPLVMJump1D if name.startswith("Poisson") else \
        pmt.GaussianGPLVM1D
    y = model(N, device="cpu", **_kw(name)).sample(T)[1]
    kw = dict(verboase=False, **_fit_kw(name))

    def fit(n_iter, ckdir, generator=None, **more):
        return model(N, device="cpu", **_kw(name)).fit_em(
            y, generator=generator or torch.Generator().manual_seed(3),
            n_iter=n_iter, checkpoint_dir=str(tmp_path / ckdir), **kw,
            **more)

    full = fit(4, "a")
    fit(2, "b")
    assert ck.EMCheckpointer(tmp_path / "b").all_steps() == [0, 1]
    restored = ck.EMCheckpointer(tmp_path / "b").restore()["log_posterior"]
    g = torch.Generator().manual_seed(3)
    g_state = g.get_state()
    res = fit(4, "b", generator=g, resume=True)
    assert ck.EMCheckpointer(tmp_path / "b").all_steps() == [0, 1, 2, 3]
    # the resume starts from the restored posterior and draws none
    np.testing.assert_array_equal(_np(res["log_posterior_init"]), restored)
    assert torch.equal(g.get_state(), g_state)
    assert [float(v) for v in res["log_marginal_l"]] == \
        [float(v) for v in full["log_marginal_l"][2:]]
    for k in ("params", "tuning", "posterior", "log_posterior_final"):
        assert torch.equal(res[k], full[k]), k
    with pytest.raises(ValueError, match="nothing to do"):
        fit(4, "a", resume=True)


def test_resume_from_a_jax_checkpoint(tmp_path):
    """A JAX fit checkpointed after 2 iterations, carried into the port's
    checkpoint format and resumed to 4 by the port, against the JAX
    resume."""
    name = "PoissonGPLVMJump1D"
    jm = jpmg.PoissonGPLVMJump1D(N, inference_engine="prob", **_kw(name))
    y = _data(jm, 31)
    kw = dict(verboase=False, m_step_maxiter=MAXITER)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm.fit_em(y, key=jr.PRNGKey(2), n_iter=2, checkpoint_dir=jdir, **kw)
    want = jpmg.PoissonGPLVMJump1D(N, inference_engine="prob", **_kw(name))
    want = want.fit_em(y, key=jr.PRNGKey(2), n_iter=4, checkpoint_dir=jdir,
                       resume=True, **kw)
    state = convert.checkpoint_state_from_jax(
        jck.EMCheckpointer(jdir).restore(1), device="cpu")
    assert state["step"] == 1 and state["opt_state"].count.dtype == \
        torch.int32
    ck.EMCheckpointer(pdir).save(state["step"], state)
    got = _port(jm, name).fit_em(y, n_iter=4, checkpoint_dir=pdir,
                                 resume=True, **kw)
    assert len(got["log_marginal_l"]) == len(want["log_marginal_l"]) == 2
    np.testing.assert_allclose(_np(got["log_marginal_l"]),
                               _np(want["log_marginal_l"]), rtol=TOL_LMF)


def test_session_inputs_that_raise():
    pm = pmt.PoissonGPLVM1D(N, device="cpu", **_kw("PoissonGPLVM1D"))
    y = pm.sample(T)[1]
    # t_l of another length than y: the JAX package builds a TsdFrame whose
    # times and rows disagree; the port raises before decoding
    with pytest.raises(ValueError, match="t_l has"):
        pm.decode_latent(y, t_l=np.arange(T - 1) * DT)
    with pytest.raises(ValueError, match="t_l has"):
        pm.decode_latent_naive_bayes(y, t_l=np.arange(T + 1) * DT)
    bad = jts.TsdFrame(d=np.ones((T, 2)), t=np.arange(T - 1) * DT)
    assert len(bad.t) != bad.d.shape[0]  # what the JAX shim accepts
    # mesh= takes a spmd.Mesh: any other object raises, a real one runs
    mesh = spmd.make_mesh(devices=["cpu"] * 2, shape=(1, 2, 1))
    for call in (pm.decode_latent, pm.fit_em):
        with pytest.raises(TypeError, match="Mesh"):
            call(y, mesh=object())
    assert np.isfinite(pm.decode_latent(y, mesh=mesh)["log_marginal_final"])
    assert np.isfinite(float(pm.fit_em(y, n_iter=1, verboase=False,
                                       mesh=mesh)["log_marginal"]))


def test_profiling_trace_and_phase_timer(tmp_path):
    timer = profiling.PhaseTimer()
    with profiling.trace(str(tmp_path / "tr")) as d:
        with timer("work"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == str(tmp_path / "tr")
    assert os.path.getsize(os.path.join(d, profiling.TRACE_FILE)) > 0
    s = timer.summary()["work"]
    assert s["n"] == 1 and s["total"] >= 0.0


#: parameters of a JAX signature that the port's counterpart does not take,
#: with the reason
MISSING_OK = {
    "profiling.trace": {"host_tracer_level": "a jax.profiler option; "
                        "torch.profiler has no host tracer level"},
    **{f"{m}.init_with_pca": {"kwargs": "ignored by the JAX function; the "
                              "port raises on an unknown keyword"}
       for m in ("initializers", "initializer")},
}
#: device: where the models (or the tensors) of a port entry point live,
#: the card by default, 'cpu' on request
_DEVICE = {"device": "the card by default, 'cpu' on request"}
#: JAX functions with no counterpart in the port, with the reason
NOT_PORTED = {"profiling.enable_compilation_cache": "the port compiles no "
              "programs; its CUDA kernels are built once into build/"}
#: the functional decoder's entry points that filter or smooth take
#: ``device`` (the card by default) and, where the JAX function takes
#: ``engine="prob"``, ``engine=None``: 'prob' on the card would be a Python
#: loop over time; None resolves as the models' 'auto' ('cuda' on the card,
#: 'prob' on the CPU), and the JAX names 'pallas'/'pallas_parallel' are
#: read as 'cuda'/'cuda_parallel'
_FUNCTIONAL = {
    "decoder": ("get_loglikelihood_ma_poisson",
                "get_loglikelihood_ma_gaussian", "filter_one_step",
                "filter_all_step", "smooth_one_step", "smooth_all_step",
                "filter_all_step_combined_ma",
                "smooth_all_step_combined_ma_chunk"),
    "decoder_latentonly": ("filter_all_step_combined_ma_latent",
                           "smooth_all_step_combined_ma_chunk_latent",
                           "filter_one_step_latent", "filter_all_step_latent",
                           "smooth_one_step_latent", "smooth_all_step_latent"),
    "decoder_exp": ("get_loglikelihood_ma_poisson_gain",
                    "get_loglikelihood_ma_gaussian_gain",
                    "get_loglikelihood_ma_all_gain",
                    "get_loglikelihood_ma_all_changing_dt_gain",
                    "get_naive_bayes_ma_gain", "get_naive_bayes_ma_chunk_gain",
                    "filter_all_step_combined_ma_gain",
                    "smooth_all_step_combined_ma_chunk_gain",
                    "smooth_one_step", "smooth_all_step"),
}
#: parameters whose default the port changes, with the new default and
#: the reason
CHANGED_DEFAULT = {
    f"{mod}.{fn}": {"engine": (None, "'prob' would loop over time on the "
                               "card; None is 'cuda' there, 'prob' on the "
                               "CPU")}
    for mod, fns in _FUNCTIONAL.items() for fn in fns
}
#: parameters the port adds, with the reason
ADDED = {
    "__init__": {"device": "the card by default, 'cpu' on request"},
    "spmd.sharded_smooth": {"diag_out": "a list for the 'pscan' engine's "
                            "fixed-point passes and movements"},
    "decode_latent_naive_bayes": {"observation_model": "the port's classes "
                                  "inherit the base method, which takes it "
                                  "in both packages"},
    "sweep.sweep_fit_poisson_jump": _DEVICE,
    "sweep.sweep_fit_model_class": _DEVICE,
    # selection's, also where model_selection_helper and jump_analysis
    # re-export them
    "fit_model_one_config": _DEVICE,
    "model_selection_one_split": _DEVICE,
    "get_jump_consensus_shuffle": _DEVICE,
    "generate_basis": {"device": "where the basis is made (the JAX "
                       "function's arrays live on JAX's default device)"},
    **{f"{mod}.{fn}": _DEVICE for mod, fns in _FUNCTIONAL.items()
       for fn in fns},
    # the naive-Bayes baselines compute in float64 on the card by default
    # (the JAX decoders are numpy); the native binner takes no new
    # parameter, but raises where the JAX package falls back to numpy
    "data.decoders.GaussianBayesDecoder.__init__": _DEVICE,
    "data.decoders.PoissonBayesDecoder.__init__": _DEVICE,
    "test_exp.shuffle_and_decode": {
        "seed": "the shuffles' numpy seed (the JAX function draws them "
                "unseeded)",
        "verbose": "a line per shuffle where the JAX function shows a tqdm "
                   "bar (the card's machine has no tqdm)"},
}
#: jax.random keys -> torch.Generators.  Every ``mesh`` takes a
#: ``parallel.spmd.Mesh`` of torch devices.  The selection functions return ``selection.ResultTable`` where the JAX
#: package returns a DataFrame (ROADMAP §3).
RENAMED = {"key": "generator", "key_l": "generator_l"}


#: modules of which only these names are held here (the others are held
#: through the classes and drop-in modules that use them)
ONLY = {"hmm": {"filter_combined"},
        # the port's Mesh is a mesh of torch devices, not jax.sharding.Mesh
        "spmd": {"factorize_devices", "make_mesh", "sharded_smooth",
                 "make_sharded_em_step", "make_sharded_poisson_em_step"}}
#: the drop-in modules (the JAX package's reference-compatible surface)
DROP_IN = {m: m for m in (
    "core", "decoder", "decoder_latentonly", "gp_kernel", "fit_tuning_helper",
    "fit_tuning_with_basis", "initializer", "model_selection_helper",
    "jump_analysis", "verify_latent_jump", "test", "config",
    "reactivation_analysis")} | {
    m: f"experimental.{m}" for m in ("core_exp", "decoder_exp",
                                     "fit_tuning_helper_exp", "test_exp")}
#: the session-ingestion layer and the post-fit analyses
INGESTION = {m: m for m in (
    *(f"data.{d}" for d in ("binning", "quality", "kilosort", "grouping",
                            "cellexplorer", "behavior", "bursts", "cv",
                            "decoders", "moser", "native")),
    *(f"analysis.{a}" for a in ("ccg", "distance", "posterior",
                                "regression", "trial")),
    "utils.stats", "utils.sorting", "analysis_helper", "distance_analysis",
    "trial_analysis")}
#: the post-fit layer (plotting, workflows, the pandas helper)
POST_FIT = {m: m for m in (
    *(f"plotting.{p}" for p in ("core", "backup", "extras",
                                "plotly_helpers")),
    "workflows.tmaze_dataset", "workflows.ach_dataset",
    "utils.pandas_util", "pandas_util", "plot_helper")}


def _signature_gaps(where, jfn, pfn):
    jp = inspect.signature(jfn).parameters
    pp = inspect.signature(pfn).parameters
    gaps = []
    for name, par in jp.items():
        if name in MISSING_OK.get(where, {}):
            assert RENAMED.get(name, name) not in pp, where
            continue
        pname = RENAMED.get(name, name)
        if pname not in pp:
            gaps.append(f"{where}: no parameter {name!r}")
        elif name in CHANGED_DEFAULT.get(where, {}):
            if pp[pname].default != CHANGED_DEFAULT[where][name][0]:
                gaps.append(f"{where}: {name}={pp[pname].default!r}, "
                            "recorded "
                            f"{CHANGED_DEFAULT[where][name][0]!r}")
        elif par.default is not inspect.Parameter.empty and \
                pp[pname].default != par.default:
            gaps.append(f"{where}: {name}={pp[pname].default!r}, JAX "
                        f"{par.default!r}")
    wanted = {RENAMED.get(n, n) for n in jp}
    added = ADDED.get(where, ADDED.get(where.rsplit(".", 1)[-1], {}))
    gaps += [f"{where}: unrecorded parameter {n!r}" for n in pp
             if n not in wanted and n not in added]
    return gaps


def _public(obj, extra=()):
    return [n for n in vars(obj) if callable(getattr(obj, n))
            and not n.startswith("_")] + list(extra)


def test_public_signatures_match_jax():
    """Every public method of the four classes (and ``_decode_latent``),
    every function and class method of the ported modules, takes the JAX
    counterpart's parameters with its defaults; the exceptions are
    recorded above with their reason."""
    gaps = []
    for name in CLASSES:
        jc, pc = getattr(jpmg, name), getattr(pmt, name)
        for meth in [n for n in dir(jc) if callable(getattr(jc, n))
                     and not n.startswith("_")] + ["__init__",
                                                   "_decode_latent"]:
            if not hasattr(pc, meth):
                gaps.append(f"{name}.{meth}: missing")
                continue
            gaps += _signature_gaps(meth, getattr(jc, meth),
                                    getattr(pc, meth))
    modules = {"validation": (jval, validation),
               "initializers": (jinit, initializers),
               "compat": (jcompat, compat), "profiling": (jprof, profiling),
               "checkpoint": (jck, ck), "timeseries": (jts, pts),
               "sweep": (jsweep, sweep), "selection": (jsel, selection),
               "spmd": (jspmd, spmd),
               "gain": (jexp, experimental),
               "fit_tuning_with_basis": (jftb, ftb),
               "hmm": (jhmm, hmm),
               "reactivation": (jreact, reactivation),
               **{name: (importlib.import_module(f"poor_man_gplvm_tpu.{path}"),
                         importlib.import_module(
                             f"poor_man_gplvm_tpu_torch.{path}"))
                  for name, path in {**DROP_IN, **INGESTION,
                                     **POST_FIT}.items()}}
    for mod, (jm, pm) in modules.items():
        names = ONLY.get(mod) or set(getattr(jm, "__all__", None) or (
            n for n, v in vars(jm).items() if not n.startswith("_")
            and callable(v) and not inspect.ismodule(v))) | {
            n for n in getattr(pm, "__all__", ()) if hasattr(jm, n)}
        for fname in sorted(names):
            where = f"{mod}.{fname}"
            if where in NOT_PORTED:
                assert not hasattr(pm, fname), where
                continue
            jobj, pobj = getattr(jm, fname), getattr(pm, fname, None)
            if pobj is None:
                gaps.append(f"{where}: missing")
            elif not callable(jobj):  # module data: the same keys
                if isinstance(jobj, dict) and set(jobj) != set(pobj):
                    gaps.append(f"{where}: keys {sorted(pobj)}, JAX "
                                f"{sorted(jobj)}")
            elif inspect.isclass(jobj):
                for meth in _public(jobj, ["__init__"]):
                    if not hasattr(pobj, meth):
                        gaps.append(f"{where}.{meth}: missing")
                    else:
                        gaps += _signature_gaps(f"{where}.{meth}",
                                                getattr(jobj, meth),
                                                getattr(pobj, meth))
            else:
                gaps += _signature_gaps(where, jobj, pobj)
    assert not gaps, "\n".join(gaps)
