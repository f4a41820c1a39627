"""The lower levels of ``set_matmul_precision`` ('high': bf16x3,
'default': bf16) in the port, against the JAX package run at the same
level on the CPU.

XLA on the CPU computes f32 at every ``jax.lax.Precision``, so the JAX
side is run at the TPU's meaning of the level without editing the package:
the modules the JAX knob reaches (``ops/emissions.py``, ``ops/mstep.py``,
``ops/fit_tuning_with_basis.py``, ``experimental/gain.py``) get a ``jnp``
whose ``matmul``/``einsum`` send their ``precision=`` through the package's
own ``_scan_dot`` (``ops/pallas/parallel_scan.py:126-150``: HIGH ->
'bf16x3', DEFAULT -> 'bf16'), the level is set through the package's
``config.set_matmul_precision`` (which drops the compiled programs), and
both are put back after.  On the port's side CPU tensors run
``ops/precision.matmul_plain``.

Tolerances: the plain product against ``_scan_dot`` 2e-6 of |a| @ |b|;
sites and model calls as ``PARITY.json`` (log-likelihoods, statistics and
log-marginals 1e-5 relative, decode posteriors 1e-4, fit posteriors 1e-2);
at 'high' the log marginal within 1e-5 relative of the JAX package in f32
(its ``config.py:53-59``).  Within the port, at both levels: the fused fit
equal to the host loop, a shuffle of the null equal to its decode alone,
'checkpoint' equal to 'full', an out-of-memory retry equal to the run it
repeats, and 'highest' after a lower level equal to 'highest' before, bit
for bit.  A model-size control: at 'default' the emissions part from
'highest' by more than the tolerance, so the level is really applied.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import poor_man_gplvm_tpu as jpmg  # noqa: E402
from poor_man_gplvm_tpu import config as jcfg  # noqa: E402
from poor_man_gplvm_tpu.experimental import gain as jgain  # noqa: E402
from poor_man_gplvm_tpu.ops import emissions as jem  # noqa: E402
from poor_man_gplvm_tpu.ops import fit_tuning_with_basis as jftb  # noqa: E402
from poor_man_gplvm_tpu.ops import mstep as jms  # noqa: E402
from poor_man_gplvm_tpu.ops.pallas import parallel_scan as jps  # noqa: E402
import poor_man_gplvm_tpu_torch as pmt  # noqa: E402
from poor_man_gplvm_tpu_torch import (  # noqa: E402
    PoissonGPLVMJump1D, convert, validation,
)
from poor_man_gplvm_tpu_torch.experimental import gain  # noqa: E402
from poor_man_gplvm_tpu_torch.models import base as mbase  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import emissions as em  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import (  # noqa: E402
    fit_tuning_with_basis as ftb,
)
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import mstep as ms  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import precision  # noqa: E402

torch.set_num_threads(1)

T, N, L = 300, 37, 23
KW = dict(n_latent_bin=L, movement_variance=1, tuning_lengthscale=5.0)
LEVELS = ("high", "default")
TOL_PLAIN = 2e-6  # of max(|a| @ |b|)
TOL_REL = 1e-5  # log-likelihoods, statistics, log-marginals (PARITY.json)
TOL_POST = 1e-4  # decode posteriors
TOL_FIT_POST = 1e-2  # fit posteriors

_P = jax.lax.Precision
#: the TPU meaning of each XLA precision, as _scan_dot's modes
_SCAN_MODE = {_P.HIGHEST: "highest", _P.HIGH: "bf16x3", _P.DEFAULT: "bf16"}
_MODE = {"high": "bf16x3", "default": "bf16"}


class _TpuLevelNumpy:
    """``jax.numpy`` whose ``matmul`` and ``einsum`` compute their
    ``precision=`` as the TPU does, through ``_scan_dot``'s split.  With
    ``torch_math`` (eager calls only, under ``jax.disable_jit``) its
    ``exp`` and ``log`` are torch's, so both packages split the same
    operands."""

    def __init__(self, torch_math=False):
        self.torch_math = torch_math

    def __getattr__(self, name):
        if self.torch_math and name in ("exp", "log"):
            fn = getattr(torch, name)
            return lambda x: jnp.asarray(
                fn(torch.tensor(np.asarray(x))).numpy())
        return getattr(jnp, name)

    @staticmethod
    def matmul(a, b, precision=None):
        return jps._scan_dot(jnp.asarray(a), jnp.asarray(b), None,
                             _SCAN_MODE[precision])

    @staticmethod
    def einsum(spec, x, y, precision=None):
        mode = _SCAN_MODE[precision]
        if mode == "highest":
            return jnp.einsum(spec, x, y, precision=precision)

        def f(p, q):
            return jnp.einsum(spec, p.astype(jnp.float32),
                              q.astype(jnp.float32), precision=_P.HIGHEST)

        x_hi, x_lo = jps._split_bf16(x)
        y_hi, y_lo = jps._split_bf16(y)
        if mode == "bf16":
            return f(x_hi, y_hi)
        return f(x_hi, y_hi) + f(x_lo, y_hi) + f(x_hi, y_lo)


@contextlib.contextmanager
def jax_at(level, torch_math=False):
    """Run the JAX package's knob sites at ``level`` with the TPU's
    meaning (``torch_math``: eagerly, on torch's ``exp`` and ``log``);
    everything put back after."""
    mp = pytest.MonkeyPatch()
    try:
        if level != "highest":
            for mod in (jem, jms, jftb, jgain):
                mp.setattr(mod, "jnp", _TpuLevelNumpy(torch_math))
        jcfg.set_matmul_precision(level)
        with jax.disable_jit(torch_math):
            yield
    finally:
        mp.undo()
        jcfg.set_matmul_precision("highest")


@pytest.fixture(autouse=True)
def _back_to_highest():
    yield
    pmt.set_matmul_precision("highest")


def _np(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x, np.float64)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _walk_spikes(tuning, seed, T_=T):
    rng = np.random.default_rng(seed)
    x, lat = int(rng.integers(L)), []
    for _ in range(T_):
        x = int(rng.integers(L)) if rng.random() < 0.02 else int(
            np.clip(x + rng.integers(-1, 2), 0, L - 1))
        lat.append(x)
    return rng.poisson(np.asarray(tuning)[lat]).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """JAX model, its state, numpy spikes along a random walk with jumps,
    and a numpy initial log posterior."""
    jm = jpmg.PoissonGPLVMJump1D(N, **KW)
    y = _walk_spikes(jm.tuning, 0)
    rng = np.random.default_rng(1)
    lpi = np.log(rng.dirichlet(np.ones(L), T)).astype(np.float32)
    return jm, convert.state_from_model(jm), y, lpi


def _port(state, engine="prob"):
    m = PoissonGPLVMJump1D(N, inference_engine=engine, device="cpu", **KW)
    return convert.load_jax_state(m, state["params"], state["tuning_basis"])


def _jax(jm, engine="prob"):
    j = jpmg.PoissonGPLVMJump1D(N, inference_engine=engine, **KW)
    j.params, j.tuning_basis = jm.params, jm.tuning_basis
    return j


# ---------------------------------------------------------------------------
# (i) the plain product against _scan_dot
# ---------------------------------------------------------------------------


def _operands(case):
    rng = np.random.default_rng(5)
    if case == "2d":
        return (rng.normal(size=(T, N)).astype(np.float32),
                rng.normal(size=(N, L)).astype(np.float32))
    post = rng.dirichlet(np.ones(L), T).astype(np.float32)
    y = rng.poisson(2.0, size=(T, N)).astype(np.float32)
    if case == "transposed":
        return post, y
    posts = rng.dirichlet(np.ones(L), (4, T)).astype(np.float32)
    return posts, y


@pytest.mark.parametrize("case", ["2d", "transposed", "batched"])
@pytest.mark.parametrize("level", LEVELS)
def test_matmul_plain_matches_scan_dot(level, case):
    """2-D, ``post.T @ y`` read through a transposed view, and a batch of
    (L, T) @ (T, N) against one y: within 2e-6 of |a| @ |b| of JAX's
    ``_scan_dot`` on the same numpy inputs.  ``matmul`` and ``bf16_gemm``
    on CPU tensors are the plain version, bit for bit, ``out=`` too."""
    a, b = _operands(case)
    ta, tb = torch.tensor(a), torch.tensor(b)
    if case == "2d":
        want = np.asarray(jps._scan_dot(jnp.asarray(a), jnp.asarray(b), None,
                                        _MODE[level]))
        ta_, scale = ta, np.abs(a) @ np.abs(b)
    elif case == "transposed":
        want = np.asarray(jps._scan_dot(jnp.asarray(a).T, jnp.asarray(b),
                                        None, _MODE[level]))
        ta_, scale = ta.T, np.abs(a).T @ np.abs(b)
    else:
        want = np.stack([np.asarray(jps._scan_dot(
            jnp.asarray(p).T, jnp.asarray(b), None, _MODE[level]))
            for p in a])
        ta_ = ta.transpose(1, 2)
        scale = np.abs(a).transpose(0, 2, 1) @ np.abs(b)
    got = precision.matmul_plain(ta_, tb, level)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(_np(got) - want).max() / scale.max()
    assert err <= TOL_PLAIN, err
    # the level is applied: f32 is farther from the split product
    f32 = _np(ta_ @ tb)
    assert np.abs(f32 - _np(got)).max() > 0
    with precision.level(level):
        assert torch.equal(precision.matmul(ta_, tb), got)
        out = torch.empty_like(got)
        assert precision.matmul(ta_, tb, out=out) is out
        assert torch.equal(out, got)
    assert torch.equal(
        precision.bf16_gemm(ta_, tb, precision.PASSES[level]), got)


def test_levels_and_the_kernel_routes():
    """The six names, the canonical return, an unknown name, and a
    'highest' product that is ``torch.matmul`` bit for bit; the kernel
    wrapper counts no launch for a CPU tensor and refuses a 1-D
    operand."""
    assert precision.get_level() == "highest"
    for name, lvl in precision.LEVELS.items():
        assert pmt.set_matmul_precision(name.upper()) == lvl
        assert precision.get_level() == pmt.get_matmul_precision() == lvl
    with pytest.raises(ValueError, match="unknown precision"):
        precision.set_level("tf32")
    pmt.set_matmul_precision("highest")
    a, b = (torch.tensor(v) for v in _operands("2d"))
    assert torch.equal(precision.matmul(a, b), a @ b)
    precision.reset_launches()
    precision.bf16_gemm(a, b, 3)
    assert precision.bf16_gemm.launches == 0
    with pytest.raises(ValueError, match="2-D or 3-D"):
        precision._gemm_run(a, b[:, 0], 3)


# ---------------------------------------------------------------------------
# (ii) each site of the knob against the JAX function at the same level
# ---------------------------------------------------------------------------


def _site_inputs():
    rng = np.random.default_rng(7)
    tuning = rng.uniform(0.05, 3.0, size=(L, N)).astype(np.float32)
    y = _walk_spikes(tuning, 8)
    ma1 = (rng.random(N) > 0.2).astype(np.float32)
    ma2 = (rng.random((T, N)) > 0.2).astype(np.float32)
    ma_lat = (rng.random(L) > 0.1).astype(np.float32)
    dt = rng.uniform(0.5, 1.5, size=T).astype(np.float32)
    noise = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    yg = (tuning[np.arange(T) % L] + rng.normal(size=(T, N))).astype(
        np.float32)
    return dict(tuning=tuning, y=y, ma1=ma1, ma2=ma2, ma_lat=ma_lat, dt=dt,
                noise=noise, yg=yg)


def _site(name, pkg):
    """The site's outputs from the port (``pkg`` 'port') or the JAX
    package ('jax') on the same numpy inputs."""
    d = _site_inputs()
    cv = torch.tensor if pkg == "port" else jnp.asarray
    e, s, f, g = ((em, ms, ftb, gain) if pkg == "port"
                  else (jem, jms, jftb, jgain))
    rng = np.random.default_rng(9)
    lp = np.log(rng.dirichlet(np.ones(L), T)).astype(np.float32)
    if name == "poisson_mask1d":
        return (e.poisson_loglik(cv(d["y"]), cv(d["tuning"]), cv(d["ma1"]),
                                 cv(d["ma_lat"])),)
    if name == "poisson_mask2d":
        return (e.poisson_loglik(cv(d["y"]), cv(d["tuning"]), cv(d["ma2"]),
                                 cv(d["ma_lat"])),)
    if name == "poisson_dt":
        return (e.poisson_loglik(cv(d["y"]), cv(d["tuning"]), cv(d["ma2"]),
                                 cv(d["ma_lat"]), dt=cv(d["dt"])),)
    if name == "gaussian":
        return (e.gaussian_loglik(cv(d["yg"]), cv(d["tuning"]),
                                  cv(d["noise"]), cv(d["ma2"]),
                                  cv(d["ma_lat"])),)
    if name == "statistics":
        return s.get_statistics(cv(lp), cv(d["y"]), n_time_per_chunk=70)
    if name == "statistics_batch":
        lps = np.log(rng.dirichlet(np.ones(L), (3, T))).astype(np.float32)
        if pkg == "port":
            return ms.get_statistics_batch(torch.tensor(lps),
                                           torch.tensor(d["y"]),
                                           n_time_per_chunk=70)
        outs = [jms.get_statistics(jnp.asarray(p), jnp.asarray(d["y"]),
                                   n_time_per_chunk=70) for p in lps]
        return tuple(np.stack([np.asarray(o[i]) for o in outs])
                     for i in range(2))
    if name == "group_spk":
        return f.group_spk_occupancy_chunk_neuron(cv(d["y"]), cv(np.exp(lp)),
                                                  dt=cv(d["dt"]))
    if name == "gain_statistics":
        return g.get_statistics_gain(cv(lp), cv(d["y"]), cv(d["dt"]))
    if name == "gain_mstep":
        return (g.get_gain_mstep(cv(d["y"]), cv(lp), cv(d["tuning"])),)
    raise ValueError(name)


SITES = ("poisson_mask1d", "poisson_mask2d", "poisson_dt", "gaussian",
         "statistics", "statistics_batch", "group_spk", "gain_statistics",
         "gain_mstep")


def _finite(x):
    x = _np(x)
    return np.where(x > -1e19, x, 0.0)  # masked latent bins: -1e20


def _flips(site, level):
    """How many operands of the site's products round to another bf16 in
    the two packages: torch's and XLA's ``exp`` and ``log`` part by an
    ulp on some elements, and at a rounding tie that flips the operand's
    bf16 rounding (one bf16 ulp at 'default'; at 'high' the lo term takes
    it up)."""
    if level != "default" or site in ("gaussian", "group_spk"):
        return 0
    d = _site_inputs()
    if site.startswith("poisson"):
        lam = d["tuning"] + np.float32(em.RATE_FLOOR)
        if site == "poisson_dt":
            lam = d["tuning"][None] * d["dt"][:, None, None] + np.float32(
                em.RATE_FLOOR)
        x, fn = lam, "log"
    else:
        x, fn = np.log(np.random.default_rng(9).dirichlet(
            np.ones(L), T)).astype(np.float32), "exp"
    port = getattr(torch, fn)(torch.tensor(x))
    jx = torch.tensor(np.asarray(getattr(jnp, fn)(jnp.asarray(x))))
    return int((port.bfloat16() != jx.bfloat16()).sum())


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("level", LEVELS)
def test_site_matches_jax_at_the_level(level, site):
    """Against the JAX function as it runs, where no operand's bf16
    rounding flips between the packages; against it on torch's ``exp``
    and ``log`` (the same split operands) always.  The flips are counted
    (``_flips``): at these inputs one, in the posterior ``exp(lp)`` of
    the statistics and gain sites at 'default' (2.6e-5 relative on one
    entry of the statistics)."""
    with precision.level(level):
        got = _site(site, "port")
    flips = _flips(site, level)
    for torch_math in (True, False) if flips == 0 else (True,):
        with jax_at(level, torch_math):
            want = _site(site, "jax")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == np.asarray(w).shape
            assert _rel(_finite(g), _finite(w)) <= TOL_REL, (site, torch_math)
    assert flips <= 1, flips


def _flipped_operands():
    """Elements whose bf16 rounding differs between the two packages'
    ``log(lam) * ma`` operand of the Poisson emission (the only operand of
    the sites that goes through a transcendental before its split)."""
    d = _site_inputs()
    lam = d["tuning"] + np.float32(em.RATE_FLOOR)
    port = torch.log(torch.tensor(lam)) * torch.tensor(d["ma1"])
    jx = np.asarray(jnp.log(jnp.asarray(lam)) * jnp.asarray(d["ma1"]))
    return int((port.to(torch.bfloat16).float().numpy()
                != torch.tensor(jx).to(torch.bfloat16).float().numpy()).sum())


def test_default_level_is_applied_and_rounding_flips_counted():
    """At 'default' the emission parts from 'highest' by more than the
    parity tolerance (the control: a level that was not applied passes
    nothing above); at 'high' it stays within it.  The bf16 roundings of
    the two packages' log-rate operand agree here (a 1-ulp difference of
    ``log`` could flip one at a tie)."""
    hi = _site("poisson_mask1d", "port")[0]
    for level, far in (("default", True), ("high", False)):
        with precision.level(level):
            lo = _site("poisson_mask1d", "port")[0]
        assert (_rel(_finite(lo), _finite(hi)) > TOL_REL) == far, level
    assert _flipped_operands() == 0


# ---------------------------------------------------------------------------
# (iii) decode and fit of PoissonGPLVMJump1D against JAX
# ---------------------------------------------------------------------------


def _lml(res):
    return np.array([float(v) for v in res["log_marginal_l"]])


@pytest.mark.parametrize("level", LEVELS)
def test_decode_matches_jax_at_the_level(setup, level):
    jm, state, y, _ = setup
    with jax_at(level):
        want = _jax(jm).decode_latent(y)
    with jax_at("highest"):
        f32 = _jax(jm).decode_latent(y)
    with precision.level(level):
        got = _port(state).decode_latent(y)
    np.testing.assert_allclose(float(got["log_marginal_final"]),
                               float(want["log_marginal_final"]),
                               rtol=TOL_REL)
    for k in ("posterior_latent_marg", "posterior_dynamics_marg"):
        assert np.abs(_np(got[k]) - _np(want[k])).max() <= TOL_POST, k
    if level == "high":
        np.testing.assert_allclose(float(got["log_marginal_final"]),
                                   float(f32["log_marginal_final"]),
                                   rtol=TOL_REL)


@pytest.mark.parametrize("level", LEVELS)
def test_fit_matches_jax_at_the_level(setup, level):
    """3 EM iterations, Adam capped (its stopping rule flips under 1-ulp
    loss differences)."""
    jm, state, y, lpi = setup
    kw = dict(n_iter=3, log_posterior_init=lpi, verboase=False, fused=False,
              m_step_maxiter=20)
    with jax_at(level):
        want = _jax(jm).fit_em(y, **kw)
    with precision.level(level):
        got = _port(state).fit_em(y, **kw)
    np.testing.assert_allclose(_lml(got), _lml(want), rtol=TOL_REL)
    assert np.abs(_np(got["posterior"])
                  - _np(want["posterior"])).max() <= TOL_FIT_POST
    if level == "high":
        with jax_at("highest"):
            f32 = _jax(jm).fit_em(y, **kw)
        np.testing.assert_allclose(_lml(got), _lml(f32), rtol=TOL_REL)


# ---------------------------------------------------------------------------
# (iv) the port's bit contracts at the lower levels; (v) the way back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", LEVELS)
def test_fused_equals_host_loop(setup, level):
    _, state, y, lpi = setup
    kw = dict(n_iter=4, log_posterior_init=lpi, verboase=False,
              m_step_maxiter=20)
    with precision.level(level):
        loop = _port(state, "cuda").fit_em(y, fused=False, **kw)
        fused = _port(state, "cuda").fit_em(y, fused=True, **kw)
    np.testing.assert_array_equal(_lml(loop), _lml(fused))
    assert torch.equal(loop["params"], fused["params"])
    assert torch.equal(loop["posterior"], fused["posterior"])


@pytest.mark.parametrize("level", LEVELS)
def test_shuffle_equals_its_decode_alone(setup, level):
    _, state, y, _ = setup
    m = _port(state, "cuda")
    with precision.level(level):
        res = validation.shuffle_and_decode(
            m, y, n_shuffle=3, seed=3, decoder_type="dynamics",
            verbose=False, shuffle_batch_size=3)
        for s, y_s in enumerate(validation.circular_shuffle_data(
                y, n_shuffle=3, seed=3)):
            alone = m.decode_latent(y_s, n_time_per_chunk=10000)
            for k, v in alone.items():
                v = v.numpy() if torch.is_tensor(v) else np.float32(v)
                np.testing.assert_array_equal(res[k][s], v, err_msg=k)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if torch.is_tensor(w):
            assert torch.equal(g, w), k
        elif isinstance(w, (int, float, np.ndarray)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=k)


@pytest.mark.parametrize("level", LEVELS)
def test_checkpoint_equals_full(setup, level):
    """The O(chunk) mode re-forms each chunk's emissions: the same bits
    as 'full' at the same chunking, in a fit (its E-steps) and in the
    smoother."""
    jm, state, y, lpi = setup
    kw = dict(n_iter=2, log_posterior_init=lpi, verboase=False,
              m_step_maxiter=20, n_time_per_chunk=37, fused=False)
    with precision.level(level):
        full = _port(state, "cuda").fit_em(y, memory_mode="full", **kw)
        ckpt = _port(state, "cuda").fit_em(y, memory_mode="checkpoint", **kw)
        np.testing.assert_array_equal(_lml(full), _lml(ckpt))
        assert torch.equal(full["params"], ckpt["params"])
        m = _port(state, "cuda")
        args = (torch.tensor(y), m.tuning, {}, m._make_transition({})[0],
                np.ones(N, np.float32), None)
        out = {mode: hmm.smooth_combined_chunked(
            *args, n_time_per_chunk=37, engine="cuda", memory_mode=mode)
            for mode in ("full", "checkpoint")}
    both = [(a, b) for a, b in zip(out["full"], out["checkpoint"])
            if torch.is_tensor(a) and torch.is_tensor(b)]
    assert len(both) >= 2
    for a, b in both:
        assert torch.equal(a, b)


@pytest.mark.parametrize("level", LEVELS)
def test_oom_retry_equals_the_run(setup, monkeypatch, level):
    """An out-of-memory error in the smoother: the retried decode and fit
    re-form every emission, with the bits of the unforced run."""
    _, state, y, lpi = setup
    kw = dict(n_iter=2, log_posterior_init=lpi, verboase=False,
              m_step_maxiter=20)
    with precision.level(level):
        want_d = _port(state).decode_latent(y)
        want_f = _port(state).fit_em(y, **kw)
        real = hmm.smooth_combined_chunked
        calls = {"n": 0}

        def flaky(*a, **k):
            calls["n"] += 1
            if calls["n"] in (1, 3):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
            return real(*a, **k)

        monkeypatch.setattr(hmm, "smooth_combined_chunked", flaky)
        with pytest.warns(UserWarning, match="lean parallel-scan config"):
            got_d = _port(state).decode_latent(y)
        with pytest.warns(UserWarning, match="lean parallel-scan config"):
            got_f = _port(state).fit_em(y, **kw)
    assert calls["n"] >= 4 and mbase._LEAN_SCAN_CONFIG is not None
    _assert_same(got_d, want_d)
    np.testing.assert_array_equal(_lml(got_f), _lml(want_f))
    assert torch.equal(got_f["params"], want_f["params"])


def test_highest_after_a_lower_level_keeps_its_bits(setup):
    _, state, y, lpi = setup
    kw = dict(n_iter=2, log_posterior_init=lpi, verboase=False,
              m_step_maxiter=20)
    before_d = _port(state, "cuda").decode_latent(y)
    before_f = _port(state, "cuda").fit_em(y, **kw)
    for level in LEVELS:
        pmt.set_matmul_precision(level)
        lower = _port(state, "cuda").decode_latent(y)
        assert not torch.equal(lower["posterior_latent_marg"],
                               before_d["posterior_latent_marg"])
    assert pmt.set_matmul_precision("highest") == "highest"
    _assert_same(_port(state, "cuda").decode_latent(y), before_d)
    after_f = _port(state, "cuda").fit_em(y, **kw)
    np.testing.assert_array_equal(_lml(after_f), _lml(before_f))
    assert torch.equal(after_f["params"], before_f["params"])
