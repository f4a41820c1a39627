"""Marginal smoothing, memory modes, warm start, fast mode and carry export
of the port's ``smooth_combined_chunked`` against the JAX package.

The analogues of the JAX package's own ``test_parallel_scan.py`` tests for
these paths: the port's ``'cuda_parallel'`` engine (the K3/K4 wrappers'
plain versions on CPU tensors) is held against JAX's ``'pallas_parallel'``
(its pure-JAX reference passes off the TPU) and against the plain
``'prob'`` engines of both packages, on the same numpy-seeded inputs.
Tolerances are the JAX tests' own: log-marginals 1e-5 relative,
posteriors 1e-3 relative + 2e-5 absolute, the pairwise joint 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu.ops import kernels as jgpk  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402

torch.set_num_threads(1)

N, L = 6, 7


def _jtrans(mv=1.3, pmj=0.05, pjm=0.08):
    lat, log_lat, dyn, log_dyn = jgpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), movement_variance=mv,
        p_move_to_jump=pmj, p_jump_to_move=pjm)
    return jhmm.JointTransition(dyn, lat, log_dyn, log_lat)


def _ptrans(jt):
    t = {k: torch.tensor(np.asarray(getattr(jt, k)))
         for k in ("Tdyn", "Tlat", "logTdyn", "logTlat")}
    return hmm.JointTransition(**t)


def _data(seed, T):
    rng = np.random.default_rng(seed)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    return y, tuning


def _run(y, tuning, trans, engine, **kw):
    ma_n, ma_l = np.ones(N, np.float32), np.ones(L, np.float32)
    if isinstance(trans, hmm.JointTransition):
        return hmm.smooth_combined_chunked(
            y, torch.as_tensor(tuning), {}, trans, ma_n, ma_l, engine=engine,
            **kw)
    return jhmm.smooth_combined_chunked(y, tuning, {}, trans, ma_n, ma_l,
                                        engine=engine, **kw)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _jax_layout(carry):
    """The port's (C, n_dyn, L) carries in JAX's (n_dyn, C, Lp) layout,
    zero-padded to the 128-lane width."""
    c = np.swapaxes(carry.numpy(), 0, 1)
    out = np.zeros(c.shape[:2] + (128,), np.float32)
    out[..., :c.shape[-1]] = c
    return out


def _assert_match(ref, par, check_post=True):
    """The JAX test module's ``_assert_match``, for either package."""
    np.testing.assert_allclose(float(par[1]), float(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(np.exp(_np(par[0])), np.exp(_np(ref[0])),
                               rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(_np(par[3]), _np(ref[3]), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(np.exp(_np(par[4])), np.exp(_np(ref[4])),
                               rtol=1e-3, atol=1e-3)
    if check_post:
        np.testing.assert_allclose(np.exp(_np(par[2])), np.exp(_np(ref[2])),
                                   rtol=1e-3, atol=2e-5)


@pytest.mark.parametrize("want_acc", [False, True])
def test_marginal_smooth_checkpoint_matches_jax(want_acc):
    """memory_mode='checkpoint' + marginal_smooth: 'cuda_parallel' (K4's
    marginal modes) against JAX 'pallas_parallel' and against the full
    posteriors of 'prob'."""
    y, tuning = _data(11, 600)
    jt = _jtrans()
    pt = _ptrans(jt)
    kw = dict(memory_mode="checkpoint", marginal_smooth=True,
              want_acc=want_acc)
    par = _run(y, tuning, pt, "cuda_parallel", **kw)
    jpar = _run(y, tuning, jt, "pallas_parallel", **kw)
    ref = _run(y, tuning, pt, "prob")
    lat, dyn = np.exp(par[0][0].numpy()), np.exp(par[0][1].numpy())
    full = np.exp(ref[0].numpy())
    np.testing.assert_allclose(lat, full.sum(1), rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(dyn, full.sum(2), rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(lat, np.exp(np.asarray(jpar[0][0])),
                               rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(dyn, np.exp(np.asarray(jpar[0][1])),
                               rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(float(par[1]), float(jpar[1]), rtol=1e-5)
    np.testing.assert_allclose(float(par[1]), float(ref[1]), rtol=1e-5)
    assert par[2] is None and par[5] is None  # want_post off in checkpoint
    if want_acc:  # the joint through K4's r scratch and joint_acc
        np.testing.assert_allclose(np.exp(par[4].numpy()),
                                   np.exp(ref[4].numpy()), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(np.exp(par[4].numpy()),
                                   np.exp(np.asarray(jpar[4])), rtol=1e-3,
                                   atol=1e-3)
    else:
        assert par[4] is None


def test_want_acc_false_identical_and_skips_joint():
    """want_acc=False leaves every other output bit-identical and returns
    acc=None, in the marginal and the full path."""
    y, tuning = _data(17, 600)
    pt = _ptrans(_jtrans())
    for kw in (dict(memory_mode="checkpoint", marginal_smooth=True), {}):
        full = _run(y, tuning, pt, "cuda_parallel", **kw)
        lean = _run(y, tuning, pt, "cuda_parallel", want_acc=False, **kw)
        assert lean[4] is None and full[4] is not None
        assert float(lean[1]) == float(full[1])
        if kw:
            assert torch.equal(lean[0][0], full[0][0])
            assert torch.equal(lean[0][1], full[0][1])
        else:
            assert torch.equal(lean[0], full[0])


def test_warm_start_exact_and_fewer_passes():
    """A warm start from a previous converged solve returns the same answer
    with no more passes; re-solving the same problem warm takes one pass
    per direction; the second fast solve on a settled seed skips every
    finals-only pass, certified by emit residuals < 1e-4.  Each solve is
    held against 'prob' and against JAX's solve from the same seed."""
    T = 997
    y, tuning = _data(3, T)
    jt = _jtrans()
    pt = _ptrans(jt)

    def both(tun, carry_in=None, **kw):
        got = _run(y, tun, pt, "cuda_parallel", want_scan_carry=True,
                   scan_carry_in=carry_in, **kw)
        jin = None if carry_in is None else tuple(
            jnp.asarray(_jax_layout(c)) for c in carry_in[:2]
        ) + (jnp.asarray(carry_in[2].numpy()), jnp.array(True))
        want = _run(y, tun, jt, "pallas_parallel", want_scan_carry=True,
                    scan_carry_in=jin, **kw)
        _assert_match(want, got)
        _assert_match(_run(y, tun, pt, "prob"), got)
        carry = got[6]
        assert carry[0].shape == carry[1].shape == (
            hmm.parallel_scan_carry_spec(T, pt, "cuda_parallel"))
        for c, jc in zip(carry[:2], want[6][:2]):
            np.testing.assert_allclose(_jax_layout(c), np.asarray(jc),
                                       atol=1e-4)
        return carry[:3] + (True,), carry[3]

    cold, (fp_c, bp_c, _, _) = both(tuning)
    tuning2 = tuning * np.float32(1.02)  # one M-step's worth of drift
    warm, (fp_w, bp_w, _, _) = both(tuning2, cold)
    assert fp_w <= fp_c and bp_w <= bp_c
    _, (fp_r, bp_r, _, _) = both(tuning2, warm)
    assert (fp_r, bp_r) == (1, 1)
    fast1, _ = both(tuning2, warm, scan_fast=True)
    _, (fp_f, bp_f, ef, eb) = both(tuning2, fast1, scan_fast=True)
    assert (fp_f, bp_f) == (0, 0)
    assert float(ef) < 1e-4 and float(eb) < 1e-4
    # an invalid seed is ignored: the cold solve's answer and pass counts
    diag = []
    off = _run(y, tuning, pt, "cuda_parallel", want_scan_carry=True,
               scan_carry_in=warm[:3] + (False,), diag_out=diag)
    assert off[6][3][:2] == (fp_c, bp_c)
    assert len(diag[0]) == 6


def test_want_scan_carry_and_carry_spec():
    y, tuning = _data(0, 100)
    pt = _ptrans(_jtrans())
    with pytest.raises(ValueError, match="want_scan_carry"):
        _run(y, tuning, pt, "prob", want_scan_carry=True)
    with pytest.raises(ValueError, match="want_scan_carry"):
        _run(y[:40], tuning, pt, "cuda_parallel", want_scan_carry=True)
    # the spec: (C, n_dyn, L) where the parallel engine runs, else None;
    # JAX's (n_dyn, C, Lp) holds the same C
    jt = _jtrans()
    spec = hmm.parallel_scan_carry_spec(2048, pt, "cuda_parallel")
    jspec = jhmm.parallel_scan_carry_spec(2048, jt, "pallas_parallel")
    assert spec == (jspec[1], 2, L)
    assert hmm.parallel_scan_carry_spec(2048, pt, "prob") is None
    assert hmm.parallel_scan_carry_spec(2048, pt, "cuda") is None  # CPU
    assert hmm.parallel_scan_carry_spec(2048, pt, "prob", force=True) == spec
    assert hmm.parallel_scan_carry_spec(30, pt, "cuda_parallel") is None


def test_memory_modes_and_filter_bf16_store():
    """The JAX memory modes on the port's sequential engine ('prob'):
    'checkpoint' and 'filter' give full mode's posteriors, log marginal,
    ratios and pairwise joint bit for bit, and with marginal_smooth JAX's
    marginals; 'filter_bf16' stores the filter posteriors in bf16 as the
    JAX package does, and is held against JAX's bf16 result (1e-5; 3e-7
    measured on the latent marginal), its log marginal exact."""
    y, tuning = _data(5, 420)
    jt = _jtrans()
    pt = _ptrans(jt)
    full = _run(y, tuning, pt, "prob")
    for mm in ("checkpoint", "filter", "filter_bf16"):
        post = _run(y, tuning, pt, "prob", memory_mode=mm)
        assert post[2] is None and post[5] is None
        assert float(post[1]) == float(full[1])
        assert torch.equal(post[3], full[3])
        if mm != "filter_bf16":
            assert torch.equal(post[0], full[0])
            assert torch.equal(post[4], full[4])
        got = _run(y, tuning, pt, "prob", memory_mode=mm,
                   marginal_smooth=True)
        assert got[2] is None and got[5] is None
        want = _run(y, tuning, jt, "prob", memory_mode=mm,
                    marginal_smooth=True)
        tol = 1e-5 if mm == "filter_bf16" else 1e-4
        for k in (0, 1):
            np.testing.assert_allclose(np.exp(got[0][k].numpy()),
                                       np.exp(np.asarray(want[0][k])),
                                       rtol=0, atol=tol)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    jfull = _run(y, tuning, jt, "prob", marginal_smooth=True)
    jbf16 = _run(y, tuning, jt, "prob", memory_mode="filter_bf16",
                 marginal_smooth=True)
    assert not np.array_equal(np.asarray(jbf16[0][0]), np.asarray(jfull[0][0]))
    bf16 = _run(y, tuning, pt, "prob", memory_mode="filter_bf16")
    assert not torch.equal(bf16[0], full[0])  # the store is bf16
    with pytest.raises(ValueError, match="memory_mode"):
        _run(y, tuning, pt, "prob", memory_mode="no_such_mode")
