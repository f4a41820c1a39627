"""The port's drop-in surface against the JAX package's: the functional
decoder (``decoder``, ``decoder_latentonly``, ``experimental.decoder_exp``),
``hmm.filter_combined``, ``gp_kernel.get_log``,
``fit_tuning_helper_exp.get_gain_mstep_single_time``,
``experimental.test_exp``, ``config``, the submodules of the package root,
a name diff of every ported module, and the README's port quickstart.

The README-size model (N = 30, L = 100), spikes along a numpy random walk
through its tuning curves, so the filters and smoothers see converged,
well-scaled inputs; the same numpy arrays go through both packages, the
port on the CPU (``device="cpu"``; the kernel engines run the kernels'
plain versions there).  ``filter_all_step``/``smooth_all_step`` run K1/K2
only on the card; their kernel branch is driven here on the CPU through
``decoder._runs_kernels``.  Tolerances (PARITY.json): log-marginals 1e-5
relative, posteriors 1e-4 absolute where the probability is above 1e-30
(below, the card's prob-space kernels floor the log at -3e38 where the
log-space scans keep a finite log, ROADMAP §3), log-likelihoods 1e-5
relative.
"""

import ast
import importlib
import inspect
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu import decoder as jdec  # noqa: E402
from poor_man_gplvm_tpu import decoder_latentonly as jdlat  # noqa: E402
from poor_man_gplvm_tpu import gp_kernel as jgk  # noqa: E402
from poor_man_gplvm_tpu.experimental import decoder_exp as jdexp  # noqa: E402
from poor_man_gplvm_tpu.experimental import (  # noqa: E402
    fit_tuning_helper_exp as jfexp,
)
from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import config, decoder  # noqa: E402
from poor_man_gplvm_tpu_torch import decoder_latentonly as dlat  # noqa: E402
from poor_man_gplvm_tpu_torch import gp_kernel  # noqa: E402
from poor_man_gplvm_tpu_torch.experimental import decoder_exp  # noqa: E402
from poor_man_gplvm_tpu_torch.experimental import (  # noqa: E402
    fit_tuning_helper_exp,
)
from poor_man_gplvm_tpu_torch.ops import hmm, parallel_scan  # noqa: E402

torch.set_num_threads(1)

N, L, T = 30, 100, 300
CHUNK = 97  # n_time_per_chunk below T: three full chunks and a ragged one
TOL_LML = 1e-5
TOL_POST = 1e-4
TOL_LL = 1e-5
P_FLOOR = 1e-30
REPO = pathlib.Path(__file__).resolve().parent.parent
#: the engines a JAX caller may name, with the port's own
ENGINES = (None, "log", "cuda", "pallas", "cuda_parallel", "pallas_parallel")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.array(x)


@pytest.fixture(scope="module")
def sim():
    """The README model's tuning, spikes along a random walk, the masks
    (1-D, and 2-D with some neurons masked in some bins), the joint and
    latent-only log transitions, a gain in [0.5, 2]."""
    jm = jpmg.PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                                 tuning_lengthscale=10.0)
    tun = np.array(jm.tuning, dtype=np.float32)
    rng = np.random.default_rng(0)
    lat = np.clip(np.cumsum(rng.integers(-1, 2, size=T)) + L // 2, 0, L - 1)
    y = rng.poisson(tun[lat]).astype(np.float32)
    ma2 = (rng.random((T, N)) > 0.1).astype(np.float32)
    _, llat, _, ldyn = (np.array(a) for a in jgk.create_transition_prob_1d(
        np.arange(L), np.arange(2), 1.0, 0.01, 0.01))
    _, lker = (np.array(a) for a in jgk.create_transition_prob_latent_1d(
        np.arange(L), 1.0))
    return dict(tun=tun, y=y, ma1=np.ones(N, np.float32), ma2=ma2,
                mal=np.ones(L, np.float32), llat=llat, ldyn=ldyn, lker=lker,
                gain=rng.uniform(0.5, 2.0, T).astype(np.float32))


_JAX = {}


def _jax(key, fn):
    """The JAX result of ``fn()``, computed once per module run."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _close_log_post(got, want):
    """Posteriors given in log space: 1e-4 absolute where p > 1e-30."""
    got, want = np.exp(_np(got)), np.exp(_np(want))
    assert got.shape == want.shape
    where = (got > P_FLOOR) | (want > P_FLOOR)
    assert np.abs(got - want)[where].max() <= TOL_POST


def _close_lml(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=TOL_LML)


def _close_rel(got, want, tol=TOL_LL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


#: the joint each transition posterior is conditioned from, and the axes
#: it is normalised over
_CONDITIONED = {"p_transition_latent": ("p_joint_latent", (1,)),
                "p_transition_dynamics": ("p_joint_dynamics", (1,)),
                "p_transition_full": ("p_joint_full", (1, 3))}


def _close_joint(got, want, latent_only=False):
    """A log pairwise joint, through its transition posteriors: the joints
    to 1e-4 everywhere, each conditional where the reference's joint puts
    more than 1e-30 on the state it is conditioned on (elsewhere it is
    0/0: the log-space scans keep a finite log of a mass the kernels'
    prior floor counts as 0)."""
    post = (dlat.compute_transition_posterior_prob_latent if latent_only
            else decoder.compute_transition_posterior_prob)
    jpost = (jdlat.compute_transition_posterior_prob_latent if latent_only
             else jdec.compute_transition_posterior_prob)
    want_p = {k: np.array(v) for k, v in jpost(jnp.asarray(want)).items()}
    for k, v in post(torch.as_tensor(_np(got))).items():
        if not k.startswith("p_"):
            continue
        diff = np.abs(_np(v) - want_p[k])
        if k in _CONDITIONED:
            joint, axes = _CONDITIONED[k]
            diff = np.where(
                want_p[joint].sum(axis=axes, keepdims=True) > P_FLOOR,
                diff, 0.0)
        assert diff.max() <= TOL_POST, k


def _close_smooth6(got, want, joint=True):
    """The 6-tuple of the chunked smoothers."""
    _close_log_post(got[0], want[0])
    _close_lml(got[1], want[1])
    _close_log_post(got[2], want[2])
    _close_rel(got[3], want[3])
    _close_joint(got[4], want[4], latent_only=not joint)
    _close_rel(got[5], want[5])


# ---------------------------------------------------------------------------
# decoder: the chunked smoother and the filter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [10000, CHUNK, T])
@pytest.mark.parametrize("mask", ["ma1", "ma2"])
@pytest.mark.parametrize("engine", ENGINES)
def test_smooth_all_step_combined_ma_chunk(sim, engine, mask, chunk):
    s = sim
    want = _jax(("smooth", mask), lambda: jdec.smooth_all_step_combined_ma_chunk(
        s["y"], s["tun"], {}, s["llat"], s["ldyn"], s[mask], s["mal"],
        n_time_per_chunk=T))
    got = decoder.smooth_all_step_combined_ma_chunk(
        s["y"], s["tun"], {}, s["llat"], s["ldyn"], s[mask], s["mal"],
        n_time_per_chunk=chunk, engine=engine, device="cpu")
    _close_smooth6(got, want)


def test_smooth_combined_is_smooth_combined_chunked_on_joint(sim):
    """The functional smoother is ``hmm.smooth_combined_chunked`` on
    ``decoder._joint`` of the same matrices, bit for bit."""
    s = sim
    got = decoder.smooth_all_step_combined_ma_chunk(
        s["y"], s["tun"], {}, s["llat"], s["ldyn"], s["ma1"], s["mal"],
        n_time_per_chunk=CHUNK, engine="cuda", device="cpu")
    want = hmm.smooth_combined_chunked(
        torch.as_tensor(s["y"]), torch.as_tensor(s["tun"]), {},
        decoder._joint(s["llat"], s["ldyn"]), torch.as_tensor(s["ma1"]),
        torch.as_tensor(s["mal"]), n_time_per_chunk=CHUNK, engine="cuda")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_time", [1, 2])
def test_short_sequences(sim, n_time):
    """T = 1 and T = 2 through the smoother and the filter."""
    s = sim
    y, ma = s["y"][:n_time], s["ma2"][:n_time]
    want = jdec.smooth_all_step_combined_ma_chunk(
        y, s["tun"], {}, s["llat"], s["ldyn"], ma, s["mal"])
    for engine in (None, "cuda", "log"):
        _close_smooth6(decoder.smooth_all_step_combined_ma_chunk(
            y, s["tun"], {}, s["llat"], s["ldyn"], ma, s["mal"],
            engine=engine, device="cpu"), want)
    want_f = jdec.filter_all_step_combined_ma(
        y, s["tun"], {}, s["llat"], s["ldyn"], ma, s["mal"])
    got_f = decoder.filter_all_step_combined_ma(
        y, s["tun"], {}, s["llat"], s["ldyn"], ma, s["mal"], engine="cuda",
        device="cpu")
    _close_log_post(got_f[0], want_f[0])
    _close_lml(got_f[1], want_f[1])


def _filter_carry(s):
    """A carry after the first half of the sequence (JAX)."""
    half = jdec.filter_all_step_combined_ma(
        s["y"][:T // 2], s["tun"], {}, s["llat"], s["ldyn"], s["ma1"],
        s["mal"])
    return (np.array(half[0][-1]), np.array(half[1]))


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("mask", ["ma1", "ma2"])
@pytest.mark.parametrize("engine", [None, "log", "cuda", "pallas_parallel"])
def test_filter_all_step_combined_ma(sim, engine, mask, carry):
    s = sim
    y = s["y"][T // 2:] if carry else s["y"]
    ma = s[mask][T // 2:] if carry and mask == "ma2" else s[mask]
    carry_init = _jax(("carry",), lambda: _filter_carry(s)) if carry else None
    want = _jax(("filter", mask, carry),
                lambda: jdec.filter_all_step_combined_ma(
                    y, s["tun"], {}, s["llat"], s["ldyn"], ma, s["mal"],
                    carry_init=carry_init))
    got = decoder.filter_all_step_combined_ma(
        y, s["tun"], {}, s["llat"], s["ldyn"], ma, s["mal"],
        carry_init=carry_init, engine=engine, device="cpu")
    _close_log_post(got[0], want[0])
    _close_lml(got[1], want[1])
    _close_log_post(got[2], want[2])
    _close_rel(got[3], want[3])
    _close_rel(got[4], want[4])


@pytest.mark.parametrize("engine", ["prob", "log", "cuda", "pallas",
                                    "cuda_parallel"])
def test_hmm_filter_combined(sim, engine):
    """``hmm.filter_combined`` on a joint and a latent-only transition
    against the JAX function ('pallas_parallel' runs the sequential
    kernel in both packages)."""
    s = sim
    for tr, jtr in (
            (decoder._joint(s["llat"], s["ldyn"]),
             jdec._joint(jnp.asarray(s["llat"]), jnp.asarray(s["ldyn"]))),
            (dlat._latent(s["lker"]), jdlat._latent(jnp.asarray(s["lker"])))):
        want = _jax(("filter_combined", tr.n_latent, hasattr(tr, "Tdyn")),
                    lambda: jhmm.filter_combined(
                        s["y"], s["tun"], {}, jtr, s["ma2"], s["mal"]))
        got = hmm.filter_combined(
            torch.as_tensor(s["y"]), torch.as_tensor(s["tun"]), {}, tr,
            s["ma2"], torch.as_tensor(s["mal"]), engine=engine)
        _close_log_post(got[0], want[0])
        _close_lml(got[1], want[1])
        _close_log_post(got[2], want[2])
        _close_rel(got[4], want[4])
    with pytest.raises(ValueError, match="engine"):
        hmm.filter_combined(torch.as_tensor(s["y"]),
                            torch.as_tensor(s["tun"]), {}, tr, s["ma2"],
                            torch.as_tensor(s["mal"]), engine="tpu")


# ---------------------------------------------------------------------------
# decoder: precomputed log-likelihoods, both carry_init branches
# ---------------------------------------------------------------------------


def _kernels(monkeypatch, on):
    monkeypatch.setattr(decoder, "_runs_kernels", lambda device: on)


@pytest.mark.parametrize("kernels", [False, True], ids=["log", "kernels"])
@pytest.mark.parametrize("latent_only", [False, True],
                         ids=["joint", "latent"])
def test_filter_and_smooth_all_step(sim, monkeypatch, kernels, latent_only):
    """``filter_all_step`` and ``smooth_all_step`` (and the latent-only
    pair) on the JAX filter's log-likelihood: the log-space scans (the
    CPU's branch) and K1/K2 (the card's, here their plain versions), with
    ``carry_init`` None and given."""
    _kernels(monkeypatch, kernels)
    s = sim
    if latent_only:
        mats, jmats = (s["lker"],), (s["lker"],)
        jfilt, jsmooth = jdlat.filter_all_step_latent, \
            jdlat.smooth_all_step_latent
        filt, smooth = dlat.filter_all_step_latent, dlat.smooth_all_step_latent
        shape = (L, L)
    else:
        mats, jmats = (s["llat"], s["ldyn"]), (s["llat"], s["ldyn"])
        jfilt, jsmooth = jdec.filter_all_step, jdec.smooth_all_step
        filt, smooth = decoder.filter_all_step, decoder.smooth_all_step
        shape = (2, 2, L, L)
    ll = np.array(_jax(("filter", "ma1", False),
                       lambda: jdec.filter_all_step_combined_ma(
                           s["y"], s["tun"], {}, s["llat"], s["ldyn"],
                           s["ma1"], s["mal"]))[4])
    want_f = _jax(("fas", latent_only), lambda: jfilt(ll, *jmats))
    got_f = filt(ll, *mats, device="cpu")
    _close_log_post(got_f[0], want_f[0])
    _close_lml(got_f[1], want_f[1])
    _close_log_post(got_f[2], want_f[2])
    _close_rel(got_f[3], want_f[3])
    # a carry: the first half's end, then the second half
    carry = (np.array(want_f[0][T // 2 - 1]), np.array(
        jnp.sum(want_f[3][:T // 2])))
    want_c = _jax(("fas_carry", latent_only),
                  lambda: jfilt(ll[T // 2:], *jmats, carry_init=carry))
    got_c = filt(ll[T // 2:], *mats, carry_init=carry, device="cpu")
    _close_log_post(got_c[0], want_c[0])
    _close_lml(got_c[1], want_c[1])

    post, prior = np.array(want_f[0]), np.array(want_f[2])
    want_s = _jax(("sas", latent_only),
                  lambda: jsmooth(post, prior[1:], *jmats))
    got_s = smooth(post, prior[1:], *mats, device="cpu")
    _close_log_post(got_s[0], want_s[0])
    _close_joint(got_s[1], want_s[1], latent_only)
    # carry_init given: the last filter posterior and an empty joint, over
    # the steps before it (the branch the None case takes inside)
    carry_s = (post[-1], np.full(shape, jhmm.JOINT_ACC_INIT, np.float32))
    want_g = _jax(("sas_carry", latent_only), lambda: jsmooth(
        post[:-1], prior[1:], *jmats, carry_init=carry_s))
    got_g = smooth(post[:-1], prior[1:], *mats, carry_init=carry_s,
                   device="cpu")
    _close_log_post(got_g[0], want_g[0])
    _close_joint(got_g[1], want_g[1], latent_only)
    with pytest.raises(ValueError, match="priors"):
        smooth(post, prior, *mats, device="cpu")


def test_single_step_functions(sim):
    """``filter_one_step``, ``smooth_one_step``, their latent-only
    counterparts and the single-row log-likelihoods."""
    s = sim
    y0, tun, ma, mal = s["y"][0], s["tun"], s["ma2"][0], s["mal"]
    ll = np.array(jdec.get_loglikelihood_ma_poisson(y0, tun, {}, ma, mal))
    _close_rel(decoder.get_loglikelihood_ma_poisson(y0, tun, {}, ma, mal,
                                                    device="cpu"), ll)
    hyper = {"noise_std": 1.5}
    _close_rel(decoder.get_loglikelihood_ma_gaussian(
        y0, tun, hyper, ma, mal, dt=0.5, device="cpu"),
        jdec.get_loglikelihood_ma_gaussian(y0, tun, hyper, ma, mal, dt=0.5))
    for mats, jone, one, jsm, sm, state in (
            ((s["llat"], s["ldyn"]), jdec.filter_one_step,
             decoder.filter_one_step, jdec.smooth_one_step,
             decoder.smooth_one_step, (2, L)),
            ((s["lker"],), jdlat.filter_one_step_latent,
             dlat.filter_one_step_latent, jdlat.smooth_one_step_latent,
             dlat.smooth_one_step_latent, (L,))):
        carry = (np.log(np.full(state, 1.0 / np.prod(state), np.float32)),
                 np.float32(0.0))
        jc, (jp, jpr, jr) = jone(carry, ll, *mats)
        pc, (pp, ppr, pr) = one(carry, ll, *mats, device="cpu")
        _close_log_post(pp, jp)
        _close_log_post(ppr, jpr)
        _close_lml(pr, jr)
        _close_lml(pc[1], jc[1])
        acc = np.full(state[:-1] * 2 + (L, L), -50.0, np.float32)
        x = (np.array(jp), np.array(jpr))
        (js, jacc), _ = jsm((np.array(jp), acc), x, *mats)
        (ps, pacc), out = sm((np.array(jp), acc), x, *mats, device="cpu")
        _close_log_post(ps, js)
        assert torch.equal(out, ps)
        _close_rel(pacc, jacc)


# ---------------------------------------------------------------------------
# decoder_latentonly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", [None, "log", "cuda", "pallas_parallel"])
def test_latentonly_combined(sim, engine):
    s = sim
    want = _jax(("smooth_lat",), lambda:
                jdlat.smooth_all_step_combined_ma_chunk_latent(
                    s["y"], s["tun"], {}, s["lker"], s["ma2"], s["mal"],
                    n_time_per_chunk=T))
    got = dlat.smooth_all_step_combined_ma_chunk_latent(
        s["y"], s["tun"], {}, s["lker"], s["ma2"], s["mal"],
        n_time_per_chunk=CHUNK, engine=engine, device="cpu")
    _close_smooth6(got, want, joint=False)
    want_f = _jax(("filter_lat",), lambda:
                  jdlat.filter_all_step_combined_ma_latent(
                      s["y"], s["tun"], {}, s["lker"], s["ma1"], s["mal"]))
    got_f = dlat.filter_all_step_combined_ma_latent(
        s["y"], s["tun"], {}, s["lker"], s["ma1"], s["mal"], engine=engine,
        device="cpu")
    _close_log_post(got_f[0], want_f[0])
    _close_lml(got_f[1], want_f[1])
    _close_rel(got_f[4], want_f[4])


# ---------------------------------------------------------------------------
# experimental: decoder_exp, fit_tuning_helper_exp, test_exp
# ---------------------------------------------------------------------------


def test_decoder_exp_emissions(sim):
    s = sim
    y, tun, ma1, ma2, mal, gain = (s[k] for k in ("y", "tun", "ma1", "ma2",
                                                  "mal", "gain"))
    hyper = {"noise_std": 1.5}
    dt = np.linspace(0.5, 1.5, T).astype(np.float32)
    _close_rel(decoder_exp.get_loglikelihood_ma_poisson_gain(
        y[3], tun, {}, ma1, mal, dt=0.5, gain=1.7, device="cpu"),
        jdexp.get_loglikelihood_ma_poisson_gain(y[3], tun, {}, ma1, mal,
                                                dt=0.5, gain=1.7))
    _close_rel(decoder_exp.get_loglikelihood_ma_gaussian_gain(
        y[3], tun, hyper, ma1, mal, dt=0.5, gain=1.7, device="cpu"),
        jdexp.get_loglikelihood_ma_gaussian_gain(y[3], tun, hyper, ma1, mal,
                                                 dt=0.5, gain=1.7))
    _close_rel(decoder_exp.get_loglikelihood_ma_all_gain(
        y, tun, {}, ma2, mal, gain, device="cpu"),
        jdexp.get_loglikelihood_ma_all_gain(jnp.asarray(y), tun, {}, ma2,
                                            mal, gain))
    _close_rel(decoder_exp.get_loglikelihood_ma_all_changing_dt_gain(
        y, tun, hyper, ma2, mal, dt, gain, observation_model="gaussian",
        device="cpu"),
        jdexp.get_loglikelihood_ma_all_changing_dt_gain(
            jnp.asarray(y), tun, hyper, ma2, mal, dt, gain,
            observation_model="gaussian"))
    got = decoder_exp.get_naive_bayes_ma_gain(y, tun, {}, ma2, mal, dt_l=dt,
                                              gain_l=gain, device="cpu")
    want = jdexp.get_naive_bayes_ma_gain(jnp.asarray(y), tun, {}, ma2, mal,
                                         dt_l=dt, gain_l=gain)
    _close_log_post(got[0], want[0])
    _close_rel(got[1], want[1])
    _close_lml(got[2], want[2])
    for ma in (ma1, ma2):
        got = decoder_exp.get_naive_bayes_ma_chunk_gain(
            y, tun, {}, ma, mal, dt_l=dt, n_time_per_chunk=CHUNK,
            gain_l=gain, device="cpu")
        want = jdexp.get_naive_bayes_ma_chunk_gain(
            jnp.asarray(y), tun, {}, jnp.asarray(ma), mal, dt_l=dt,
            n_time_per_chunk=CHUNK, gain_l=gain)
        _close_log_post(got[0], want[0])
        _close_rel(got[1], want[1])
        _close_lml(got[2], want[2])
        _close_rel(got[3], want[3])


@pytest.mark.parametrize("engine", [None, "cuda", "pallas_parallel"])
def test_decoder_exp_filter_and_smoother(sim, engine):
    s = sim
    y, tun, ma2, mal, gain = (s[k] for k in ("y", "tun", "ma2", "mal",
                                             "gain"))
    want = _jax(("smooth_gain",), lambda:
                jdexp.smooth_all_step_combined_ma_chunk_gain(
                    jnp.asarray(y), tun, {}, s["llat"], s["ldyn"], ma2, mal,
                    n_time_per_chunk=T, gain_l=gain))
    got = decoder_exp.smooth_all_step_combined_ma_chunk_gain(
        y, tun, {}, s["llat"], s["ldyn"], ma2, mal, n_time_per_chunk=CHUNK,
        gain_l=gain, engine=engine, device="cpu")
    _close_smooth6(got, want)
    # the same as the smoother's per-bin dt path, bit for bit
    same = hmm.smooth_combined_chunked(
        torch.as_tensor(y), torch.as_tensor(tun), {},
        decoder._joint(s["llat"], s["ldyn"]), torch.as_tensor(ma2),
        torch.as_tensor(mal), n_time_per_chunk=CHUNK,
        engine=hmm.ENGINE_ALIASES.get(engine, engine or "prob"),
        dt_l=torch.as_tensor(gain))
    for g, w in zip(got, same):
        assert torch.equal(g, w)
    want_f = _jax(("filter_gain",), lambda:
                  jdexp.filter_all_step_combined_ma_gain(
                      jnp.asarray(y), tun, {}, s["llat"], s["ldyn"],
                      s["ma1"], mal, gain_l=gain))
    got_f = decoder_exp.filter_all_step_combined_ma_gain(
        y, tun, {}, s["llat"], s["ldyn"], s["ma1"], mal, gain_l=gain,
        device="cpu")
    _close_log_post(got_f[0], want_f[0])
    _close_lml(got_f[1], want_f[1])
    _close_rel(got_f[4], want_f[4])


def test_gain_mstep_single_time_and_get_log(sim):
    s = sim
    rng = np.random.default_rng(5)
    logp = np.log(rng.dirichlet(np.ones(L))).astype(np.float32)
    got = fit_tuning_helper_exp.get_gain_mstep_single_time(
        s["y"][7], logp, s["tun"])
    _close_lml(got, jfexp.get_gain_mstep_single_time(s["y"][7], logp,
                                                     s["tun"]))
    val = np.array([1.0, 0.0, 0.25, 1e-30], np.float32)
    np.testing.assert_array_equal(_np(gp_kernel.get_log(val)),
                                  np.array(jgk.get_log(val)))
    assert float(gp_kernel.get_log(torch.zeros(1))[0]) == -10000.0


def test_test_exp_shuffle_and_decode(monkeypatch):
    """``experimental.test_exp.shuffle_and_decode``: the gain refitted to
    each shuffle, then decoded; the JAX function draws its shuffles
    unseeded, so the test hands it the port's seeded draws."""
    from poor_man_gplvm_tpu import experimental as jexp
    from poor_man_gplvm_tpu import validation as jval
    from poor_man_gplvm_tpu_torch import convert
    from poor_man_gplvm_tpu_torch.experimental import test_exp

    n, lb, t = 8, 10, 120
    kw = dict(n_latent_bin=lb, tuning_lengthscale=5.0, movement_variance=1.0)
    jm = jexp.PoissonGPLVMGain1D_gain(n, inference_engine="prob", **kw)
    pm = convert.load_jax_state(pmt.experimental.PoissonGPLVMGain1D_gain(
        n, inference_engine="prob", device="cpu", **kw), jm.params,
        jm.tuning_basis)
    rng = np.random.default_rng(6)
    y = rng.poisson(1.0, (t, n)).astype(np.float32)
    logp = np.log(rng.dirichlet(np.ones(lb), t)).astype(np.float32)
    jm.log_posterior, pm.log_posterior = jnp.asarray(logp), torch.as_tensor(
        logp)
    seeded = jval.circular_shuffle_data
    monkeypatch.setattr(jval, "circular_shuffle_data",
                        lambda d, n_shuffle, ep: seeded(d, n_shuffle, ep,
                                                        seed=11))
    for decoder_type in ("naive_bayes", "dynamics"):
        want = jexp.test_exp.shuffle_and_decode(
            jm, y, n_shuffle=2, decoder_type=decoder_type)
        got = test_exp.shuffle_and_decode(
            pm, y, n_shuffle=2, decoder_type=decoder_type, seed=11,
            verbose=False)
        assert set(got) == set(want)
        for k in want:
            if k.startswith("posterior"):
                assert np.abs(got[k] - want[k]).max() <= TOL_POST, k
            elif k.startswith("log_marginal"):
                np.testing.assert_allclose(got[k], want[k], rtol=TOL_LML)


# ---------------------------------------------------------------------------
# config, the package surface, the name diff, the README quickstart
# ---------------------------------------------------------------------------


def test_config():
    """The scan precision round-trips through ``config`` (and the package
    root); each of the JAX package's six matmul-precision names sets its
    canonical level and round-trips through ``get_matmul_precision``; an
    unknown name raises and leaves the level as it was."""
    for mode in ("bf16x3", "bf16", "highest"):
        pmt.set_scan_precision(mode)
        assert parallel_scan.scan_mode_key()[1] == mode
    with pytest.raises(ValueError):
        config.set_scan_precision("fp8")
    assert parallel_scan.scan_mode_key()[1] == "highest"
    assert pmt.get_matmul_precision() == "highest"
    try:
        for name, level in (("float32", "highest"), ("HIGHEST", "highest"),
                            ("high", "high"), ("bfloat16_3x", "high"),
                            ("Default", "default"), ("bfloat16", "default"),
                            ("highest", "highest")):
            assert pmt.set_matmul_precision(name) == level
            assert config.get_matmul_precision() == level
            assert pmt.get_matmul_precision() == level
        config.set_matmul_precision("high")
        with pytest.raises(ValueError, match="unknown precision"):
            config.set_matmul_precision("fp8")
        assert config.get_matmul_precision() == "high"
    finally:
        config.set_matmul_precision("highest")
    assert config.get_matmul_precision() == "highest"


#: the reference's submodules, all of which the port has (importing the
#: JAX package's imports jax)
PORTED_SUBMODULES = (
    "core", "test", "utils", "model_selection_helper", "experimental",
    "gp_kernel", "decoder", "decoder_latentonly", "fit_tuning_helper",
    "fit_tuning_with_basis", "initializer", "reactivation_analysis",
    "verify_latent_jump", "jump_analysis", "analysis", "config", "parallel",
    "selection", "validation", "data", "analysis_helper",
    "distance_analysis", "trial_analysis", "pandas_util", "plot_helper",
    "plotting", "workflows")


def test_reference_submodules_present():
    for name in PORTED_SUBMODULES:
        assert hasattr(pmt, name), name
        importlib.import_module(f"poor_man_gplvm_tpu.{name}")
    for name in ("set_matmul_precision", "get_matmul_precision",
                 "set_scan_precision"):
        assert callable(getattr(pmt, name)), name


def test_module_symbols():
    """The port's counterpart of ``test_compat_surface::test_module_symbols``
    (every layer of the JAX package is in the port)."""
    assert callable(pmt.gp_kernel.create_transition_prob_1d)
    assert callable(pmt.gp_kernel.rbf_kernel)
    assert callable(pmt.decoder.smooth_all_step_combined_ma_chunk)
    assert callable(pmt.decoder.get_naive_bayes_ma_chunk)
    assert callable(pmt.decoder.compute_transition_posterior_prob)
    assert callable(
        pmt.decoder_latentonly.smooth_all_step_combined_ma_chunk_latent)
    assert callable(pmt.fit_tuning_helper.make_adam_runner)
    assert callable(pmt.fit_tuning_helper.make_adam_runner_cached)
    assert callable(pmt.fit_tuning_helper.poisson_m_step_objective)
    assert callable(pmt.model_selection_helper.model_selection_one_split)
    assert callable(pmt.model_selection_helper.get_jump_consensus)
    assert callable(pmt.test.circular_shuffle_data)
    assert callable(pmt.test.compute_entropy)
    assert callable(pmt.initializer.init_with_pca)
    assert callable(pmt.reactivation_analysis.decode_pre_post)
    assert callable(pmt.verify_latent_jump.segment_trial_by_jump)
    assert hasattr(pmt.experimental, "PoissonGPLVMGain1D_gain")
    assert callable(pmt.model_selection_helper.default_fit_kwargs.get)
    assert set(pmt.model_selection_helper.model_class_dict) == set(
        jpmg.model_selection_helper.model_class_dict)
    for mod in ("core_exp", "decoder_exp", "fit_tuning_helper_exp",
                "test_exp"):
        assert hasattr(pmt.experimental, mod), mod
    # the ingestion layer, the analyses, and the post-fit layer: the
    # plotting and pandas helpers and the dataset workflows
    assert callable(pmt.utils.post_fit_sort_neuron)
    assert callable(pmt.utils.rbf_kernel)
    assert callable(pmt.data.compute_spike_counts_old)
    assert callable(pmt.analysis_helper.get_posterior_weighted_average)
    assert callable(pmt.distance_analysis.compute_distance_lag)
    assert callable(pmt.trial_analysis.get_event_phase_in_trial)
    assert hasattr(pmt.utils, "pandas_util")
    assert hasattr(pmt, "plot_helper")
    assert callable(pmt.pandas_util.filter_df_with_spec)
    assert callable(pmt.utils.pandas_util.filter_df_with_spec)
    assert callable(pmt.plot_helper.plot_pynapple_data_mpl)
    assert callable(pmt.plot_helper.plot_pynapple_data_plotly)
    assert sorted(pmt.plotting.__all__) == sorted(jpmg.plotting.__all__)
    assert callable(pmt.workflows.tmaze_dataset.classify_latent)
    assert callable(pmt.workflows.ach_dataset.main)
    assert pmt.workflows.__all__ == jpmg.workflows.__all__


#: JAX modules not ported, with the reason: none (every module has its
#: counterpart in the port)
NOT_PORTED_PATHS = {}
#: public JAX names with no same-named counterpart, with the reason
NAME_EXCEPTIONS = {
    "ops/pallas/scan_kernels.py::filter_chunk_pallas":
        "the kernel wrapper of K1, ops.scan_kernels.filter_chunk (CUDA)",
    "ops/pallas/scan_kernels.py::smoother_chunk_pallas":
        "the kernel wrapper of K2, ops.scan_kernels.smoother_chunk (CUDA)",
    "utils/profiling.py::enable_compilation_cache":
        "the port compiles no programs; its CUDA kernels are built once "
        "into build/",
    "models/base.py::build_decode_prog":
        "the JAX decode program built for jit/vmap; the port compiles no "
        "programs and builds the decode dict in each family's _decode_res",
}


def _not_ported(rel):
    return rel.split("/")[0] in NOT_PORTED_PATHS or rel in NOT_PORTED_PATHS


def _public_names(path, rel):
    """Public top-level functions and classes of a JAX module, and the
    names of its ``__all__`` that come from a ported module."""
    tree = ast.parse(path.read_text())
    names = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and not n.name.startswith("_")}
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            jmod = importlib.import_module(
                "poor_man_gplvm_tpu." + rel[:-3].replace("/", ".")
                .removesuffix(".__init__"))
            for name in ast.literal_eval(node.value):
                home = getattr(getattr(jmod, name), "__module__", "")
                home = home.removeprefix("poor_man_gplvm_tpu.").replace(
                    ".", "/") + ".py"
                if not _not_ported(home):
                    names.add(name)
    return names


def test_name_diff():
    """Every public function and class of the JAX package's ported modules
    has a same-named counterpart at the same path in the port (the Pallas
    modules ``ops/pallas/*`` at ``ops/*``), but the listed exceptions."""
    root = REPO / "poor_man_gplvm_tpu"
    missing, checked = [], 0
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if _not_ported(rel):
            continue
        mod = "poor_man_gplvm_tpu_torch." + rel[:-3].replace(
            "ops/pallas/", "ops/").replace("/", ".").removesuffix(
            ".__init__")
        port = importlib.import_module(mod)
        for name in sorted(_public_names(path, rel)):
            checked += 1
            if f"{rel}::{name}" in NAME_EXCEPTIONS:
                assert not hasattr(port, name), f"{rel}::{name}"
            elif not hasattr(port, name):
                missing.append(f"{rel}::{name} -> {mod}")
    assert not missing, "\n".join(missing)
    # 308 names before the post-fit layer (plotting, workflows, the
    # pandas helpers) was ported, 455 with it
    assert checked >= 455


def test_the_jax_shims_import_no_jax_in_the_port():
    """Nothing of the port imports jax, or pandas, tqdm, sklearn,
    matplotlib, seaborn, h5py, statsmodels, plotly or dill (absent on the
    card's machine), at module level."""
    bad = []
    for path in (REPO / "poor_man_gplvm_tpu_torch").rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            bad += [f"{path.name}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "pandas", "tqdm",
                                           "poor_man_gplvm_tpu", "sklearn",
                                           "matplotlib", "seaborn", "h5py",
                                           "statsmodels", "plotly", "dill")]
    assert not bad, bad


def _readme_quickstart():
    text = (REPO / "README.md").read_text()
    blocks = re.findall(r"```python\n(.*?)```", text, flags=re.S)
    block = [b for b in blocks if "# drop-in quickstart" in b]
    assert len(block) == 1
    return block[0]


def test_readme_port_quickstart_runs_on_the_cpu():
    code = _readme_quickstart()
    assert 'device = "cuda"' in code
    scope = {}
    exec(compile(code.replace('device = "cuda"', 'device = "cpu"'),
                 "README.md", "exec"), scope)
    assert np.isfinite(float(scope["out"][1]))
    assert scope["null"].columns == ["pre", "post", "diff"]


def test_functional_entry_points_default_to_the_card():
    """``device="cuda"`` is the default; without a card it raises, with no
    fallback to the CPU."""
    s = {"y": np.zeros((3, 2), np.float32),
         "tun": np.ones((4, 2), np.float32)}
    for fn in (decoder.smooth_all_step_combined_ma_chunk,
               decoder.filter_all_step_combined_ma,
               decoder_exp.smooth_all_step_combined_ma_chunk_gain):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["engine"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            decoder.smooth_all_step_combined_ma_chunk(
                s["y"], s["tun"], {}, np.zeros((2, 4, 4)), np.zeros((2, 2)),
                np.ones(2), np.ones(4))
