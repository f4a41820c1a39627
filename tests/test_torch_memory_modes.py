"""The O(chunk) memory modes of the port's sequential smoother, its 'auto'
rule and the out-of-memory recovery of ``fit_em`` and the decode dispatch,
against the JAX package on the CPU.

``smooth_combined_chunked`` in 'checkpoint', 'filter' and 'filter_bf16' on
the 'prob' engine and on 'cuda' (the K1/K2 wrappers' plain versions on CPU
tensors, K2 with the prior recomputed for the filter store), for the jump
model's transition (n_dyn = 2) and ``PoissonGPLVM1D``'s (n_dyn = 1), with
and without ``marginal_smooth``, in 12 chunks with a ragged tail (37 rows)
and in one (420), on the same numpy-seeded inputs as JAX's
``smooth_combined_chunked`` in the same mode and chunking (its 'prob'
engine).  Tolerances (``PARITY.json``): posteriors 1e-4 absolute, the log
marginal 1e-5 relative; 'filter_bf16' against JAX's bf16 store 1e-5 (at
most 3e-7 measured on these inputs: both packages store the same bf16
roundings).  Inside the port, 'checkpoint' and 'filter' equal 'full' at
the same chunking bit for bit (posteriors, log marginal, ratios, pairwise
joint); their marginals are summed in probability space per chunk, as the
JAX package's O(chunk) functions do, where 'full' takes the logsumexp of its
log posterior (1e-6 apart, 1.2e-7 measured); 'filter_bf16' keeps the log
marginal and the ratios and stays within the bf16 rounding of a
probability, 2^-8, of 'full''s posteriors.
"""

import weakref

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu.ops import kernels as jgpk  # noqa: E402
from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D  # noqa: E402
from poor_man_gplvm_tpu_torch.models import base as mbase  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402

torch.set_num_threads(1)

T, N = 420, 5
MODELS = {"jump": 8, "latent": 16}  # L of each transition
MODES = ("checkpoint", "filter", "filter_bf16")
CHUNKS = (37, 420)
TOL_POST = 1e-4
TOL_LMF = 1e-5
TOL_BF16_JAX = 1e-5
TOL_MARGINAL_FULL = 1e-6
BF16_BOUND = 2.0 ** -8

_cache = {}


def _once(key, fn):
    if key not in _cache:
        _cache[key] = fn()
    return _cache[key]


def _transitions(model):
    """(JAX transition, port transition) of the model's dynamics."""
    L = MODELS[model]
    if model == "jump":
        lat, log_lat, dyn, log_dyn = jgpk.create_transition_prob_1d(
            jnp.arange(L), jnp.arange(2), movement_variance=1.3,
            p_move_to_jump=0.05, p_jump_to_move=0.08)
        jt = jhmm.JointTransition(dyn, lat, log_dyn, log_lat)
        return jt, hmm.JointTransition(**{
            k: torch.tensor(np.asarray(getattr(jt, k)))
            for k in ("Tdyn", "Tlat", "logTdyn", "logTlat")})
    lat, log_lat = jgpk.create_transition_prob_latent_1d(
        jnp.arange(L), movement_variance=1.3)
    return (jhmm.LatentTransition(lat, log_lat),
            hmm.LatentTransition(torch.tensor(np.asarray(lat)),
                                 torch.tensor(np.asarray(log_lat))))


def _data(model):
    rng = np.random.default_rng(11 if model == "jump" else 12)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(MODELS[model], N)).astype(np.float32)
    return y, tuning


def _port(model, engine, chunk, marginal, mode):
    def run():
        y, tuning = _data(model)
        return hmm.smooth_combined_chunked(
            y, torch.as_tensor(tuning), {}, _transitions(model)[1],
            np.ones(N, np.float32), None, n_time_per_chunk=chunk,
            engine=engine, memory_mode=mode, marginal_smooth=marginal)
    return _once(("port", model, engine, chunk, marginal, mode), run)


def _jax(model, chunk, marginal, mode):
    def run():
        y, tuning = _data(model)
        return jhmm.smooth_combined_chunked(
            y, tuning, {}, _transitions(model)[0], np.ones(N, np.float32),
            None, n_time_per_chunk=chunk, engine="prob", memory_mode=mode,
            marginal_smooth=marginal)
    return _once(("jax", model, chunk, marginal, mode), run)


def _posteriors(out, marginal):
    """The probability-space posteriors of a result, as numpy arrays."""
    parts = out[0] if marginal else (out[0],)
    return [np.exp(np.asarray(p)) for p in parts if p is not None]


@pytest.mark.parametrize("engine", ["prob", "cuda"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("marginal", [False, True])
@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("mode", MODES)
def test_memory_mode_matches_jax_and_full(mode, model, marginal, chunk,
                                          engine):
    got = _port(model, engine, chunk, marginal, mode)
    assert got[2] is None and got[5] is None
    want = _jax(model, chunk, marginal, mode)
    tol = TOL_BF16_JAX if mode == "filter_bf16" else TOL_POST
    g_post, w_post = _posteriors(got, marginal), _posteriors(want, marginal)
    assert len(g_post) == len(w_post) == (2 if marginal and model == "jump"
                                          else 1)
    for g, w in zip(g_post, w_post):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=TOL_LMF)

    full = _port(model, engine, chunk, marginal, "full")
    assert float(got[1]) == float(full[1])
    assert torch.equal(got[3], full[3])
    f_post = _posteriors(full, marginal)
    if mode == "filter_bf16":
        for g, f in zip(g_post, f_post):
            np.testing.assert_allclose(g, f, rtol=0, atol=BF16_BOUND)
        return
    assert torch.equal(got[4], full[4])
    if marginal:
        for g, f in zip(g_post, f_post):
            np.testing.assert_allclose(g, f, rtol=0, atol=TOL_MARGINAL_FULL)
    else:
        assert torch.equal(got[0], full[0])


class _Picked(Exception):
    pass


def _jax_auto_mode(monkeypatch, n_time, model, L, engine):
    """The mode the JAX package's inline 'auto' rule picks for a sequence
    of ``n_time`` steps: its mode functions are replaced by ones that report
    which of them was reached, before any work."""
    def reach(mode):
        def fn(*a, **k):
            if mode == "filter" and k.get("store_dtype") == jnp.bfloat16:
                raise _Picked("filter_bf16")
            raise _Picked(mode)
        return fn

    monkeypatch.setattr(jhmm, "_smooth_chunked_checkpoint",
                        reach("checkpoint"))
    monkeypatch.setattr(jhmm, "_smooth_chunked_filterstore", reach("filter"))
    monkeypatch.setattr(jhmm, "_filter_scan_head", reach("full"))
    monkeypatch.setattr(jhmm, "_filter_chunk", reach("full"))
    if model == "jump":
        lat, log_lat, dyn, log_dyn = jgpk.create_transition_prob_1d(
            jnp.arange(L), jnp.arange(2))
        trans = jhmm.JointTransition(dyn, lat, log_dyn, log_lat)
    else:
        trans = jhmm.LatentTransition(
            *jgpk.create_transition_prob_latent_1d(jnp.arange(L)))
    y = jnp.zeros((n_time, 1), jnp.float32)
    with pytest.raises(_Picked) as picked:
        jhmm.smooth_combined_chunked(
            y, jnp.ones((L, 1)), {}, trans, jnp.ones(1), None, engine=engine,
            memory_mode="auto")
    return str(picked.value)


#: (T, model, L, engine) on either side of the JAX thresholds: 'full' up to
#: 4e9 bytes of working set (T (3 state + L) 4 B; 285,714 steps at
#: n_dyn = 2, L = 500), 'filter' while one (T, state) f32 array takes at
#: most 2e9 (500,000 steps there; 500,000 at n_dyn = 1, L = 1,000), then
#: 'checkpoint'; the 'log' engine always 'full'
AUTO_POINTS = (
    (285_714, "jump", 500, "prob"),
    (285_715, "jump", 500, "prob"),
    (500_000, "jump", 500, "pallas"),
    (500_001, "jump", 500, "prob"),
    (500_001, "jump", 500, "log"),
    (500_001, "latent", 1000, "prob"),
)


@pytest.mark.parametrize("point", AUTO_POINTS)
def test_auto_rule_matches_jax(monkeypatch, point):
    n_time, model, L, engine = point
    want = _jax_auto_mode(monkeypatch, n_time, model, L, engine)
    state = L * (2 if model == "jump" else 1)
    port_engine = hmm.ENGINE_ALIASES.get(engine, engine)
    assert hmm._resolve_memory_mode("auto", n_time, state, L,
                                    port_engine) == want


def test_auto_points_cover_every_mode():
    modes = {hmm._resolve_memory_mode(
        "auto", n, L * (2 if m == "jump" else 1), L, e)
        for n, m, L, e in AUTO_POINTS}
    assert modes == {"full", "filter", "checkpoint"}
    for mode in ("full", *MODES):  # an explicit mode is kept
        assert hmm._resolve_memory_mode(mode, 10 ** 9, 1000, 500) == mode


@pytest.mark.parametrize("mode", ["checkpoint", "filter"])
def test_o_chunk_modes_keep_no_list_of_chunks(monkeypatch, mode):
    """The O(chunk) modes hold at most two chunks' filter outputs at any
    chunk's filter: the last chunk's, which 'checkpoint' keeps for its
    backward pass, and the one in hand; no list of the chunks over T."""
    real = hmm._filter_chunk
    made, alive_at_call = [], []

    def spy(*a, **k):
        alive_at_call.append(sum(r() is not None for r in made))
        out = real(*a, **k)
        made.append(weakref.ref(out[0]))
        return out

    monkeypatch.setattr(hmm, "_filter_chunk", spy)
    got = _port_uncached("jump", "cuda", 37, True, mode)
    n_chunks = -(-T // 37)
    # 'checkpoint' runs each chunk's filter again but the last one's
    assert len(made) == (2 * n_chunks - 1 if mode == "checkpoint"
                         else n_chunks)
    assert max(alive_at_call) <= 1
    full = _port("jump", "cuda", 37, True, "full")
    assert float(got[1]) == float(full[1])


def _port_uncached(model, engine, chunk, marginal, mode):
    y, tuning = _data(model)
    return hmm.smooth_combined_chunked(
        y, torch.as_tensor(tuning), {}, _transitions(model)[1],
        np.ones(N, np.float32), None, n_time_per_chunk=chunk, engine=engine,
        memory_mode=mode, marginal_smooth=marginal)


# ---------------------------------------------------------------------------
# out-of-memory recovery (the JAX package's tests/test_models.py:551)
# ---------------------------------------------------------------------------


def _oom():
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB")


def _model():
    return PoissonGPLVMJump1D(5, n_latent_bin=8, movement_variance=1,
                              tuning_lengthscale=3.0, device="cpu")


def _spikes():
    return np.random.default_rng(4).poisson(1.0, size=(60, 5)).astype(
        np.float32)


def _flaky(monkeypatch, fail_calls):
    """Replace the smoother by one that raises an out-of-memory error on
    the calls in ``fail_calls`` (1-based) and records the parallel-scan
    override at every call that runs."""
    real = hmm.smooth_combined_chunked
    seen = {"n": 0, "override": []}

    def flaky(*a, **k):
        seen["n"] += 1
        if seen["n"] in fail_calls:
            raise _oom()
        seen["override"].append(ps._CONFIG_OVERRIDE)
        return real(*a, **k)

    monkeypatch.setattr(hmm, "smooth_combined_chunked", flaky)
    return seen


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if torch.is_tensor(w):
            assert torch.equal(g, w), k
        elif isinstance(w, list):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                assert (torch.equal(a, b) if torch.is_tensor(b)
                        else np.array_equal(np.asarray(a), np.asarray(b))), k
        elif w is not None and not isinstance(w, dict):
            assert np.array_equal(np.asarray(g), np.asarray(w)), k


def test_oom_decode_retries_once_with_the_lean_config(monkeypatch):
    y = _spikes()
    want = _model().decode_latent(y)
    seen = _flaky(monkeypatch, {1})
    with pytest.warns(UserWarning, match="lean parallel-scan config"):
        got = _model().decode_latent(y)
    assert seen["n"] == 2 and seen["override"] == [mbase._LEAN_SCAN_CONFIG]
    assert ps._CONFIG_OVERRIDE is None  # restored after the retry
    _assert_same(got, want)


def test_oom_fit_retries_once_and_draws_the_same_init(monkeypatch):
    y = _spikes()
    kw = dict(n_iter=2, verboase=False, m_step_maxiter=20)
    want = _model().fit_em(y, generator=torch.Generator().manual_seed(7),
                           **kw)
    seen = _flaky(monkeypatch, {1})
    with pytest.warns(UserWarning, match="lean parallel-scan config"):
        got = _model().fit_em(
            y, generator=torch.Generator().manual_seed(7), **kw)
    assert seen["override"] == [mbase._LEAN_SCAN_CONFIG] * 2
    assert ps._CONFIG_OVERRIDE is None
    _assert_same(got, want)


def test_oom_twice_raises_with_the_guidance(monkeypatch):
    seen = _flaky(monkeypatch, {1, 2})
    with pytest.warns(UserWarning, match="lean parallel-scan config"):
        with pytest.raises(torch.cuda.OutOfMemoryError) as err:
            _model().decode_latent(_spikes())
    assert seen["n"] == 2
    for text in ("set_config_override", "memory_mode='checkpoint'",
                 "n_time_per_chunk", "output_mode='lean'", "fused=False",
                 "free other tensors on the card"):
        assert text in str(err.value)
    assert "16 GB" not in str(err.value) and "HBM" not in str(err.value)
    assert ps._CONFIG_OVERRIDE is None


def test_oom_under_a_set_override_raises_at_once(monkeypatch):
    seen = _flaky(monkeypatch, {1})
    ps.set_config_override((64, 8, 8))
    try:
        with pytest.raises(torch.cuda.OutOfMemoryError) as err:
            _model().decode_latent(_spikes())
    finally:
        ps.set_config_override(None)
    assert seen["n"] == 1
    assert "set_config_override" in str(err.value)


def test_other_errors_pass_through(monkeypatch):
    calls = {"n": 0}

    def other(*a, **k):
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(hmm, "smooth_combined_chunked", other)
    with pytest.raises(RuntimeError) as err:
        _model().decode_latent(_spikes())
    assert calls["n"] == 1
    assert not isinstance(err.value, torch.cuda.OutOfMemoryError)
    assert str(err.value) == "CUDA error: an illegal memory access"
    assert ps._CONFIG_OVERRIDE is None
