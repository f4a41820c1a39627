"""The port's scan kernels K1/K2 (their plain versions, on the CPU) against
the JAX package: the Pallas kernels in interpret mode
(``filter_chunk_pallas`` / ``smoother_chunk_pallas``) and the prob-engine
scans (``_forward_scan_prob`` / ``_backward_scan_prob_ratios``).

The batched wrappers' plain versions (``*_batch_plain``, one sequence per
thread block on the card) are held to the unbatched plain scans on each
sequence alone, bit for bit.

Inputs are made with numpy from a seed (``poor_man_gplvm_tpu_torch.testing``)
and fed to both packages in float32.  Tolerances: ``SCAN_TOLERANCES``
(posteriors 1e-4 absolute, summed log ratios 1e-5 relative, as PARITY.json).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from poor_man_gplvm_tpu.ops import hmm as jhmm  # noqa: E402
from poor_man_gplvm_tpu.ops.pallas import scan_kernels as jsk  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402
from poor_man_gplvm_tpu_torch.testing import (  # noqa: E402
    BATCH_LENGTHS,
    SCAN_TOLERANCES as TOL,
    batch_vs_single,
    scan_case,
)

torch.set_num_threads(1)

T_ODD = 51
# (n_dyn, L, case): constant, non-constant and identical-non-constant
# channels, masked bins, at L in {20, 37}
CASES = [
    (1, 20, "jump"), (1, 37, "identical"), (1, 37, "masked"),
    (2, 37, "jump"), (2, 20, "identical"), (2, 20, "masked"),
]


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _r_rel(r, r_ref, prior, nxt):
    sel = (prior > 1e-30) & (nxt > 1e-30)
    diff = np.abs(r[sel] - r_ref[sel])
    return float((diff / np.abs(r_ref[sel])).max()) if sel.any() else 0.0


def _joint(tlat, tdyn):
    logs = [np.log(np.where(a > 0, a, 1.0)) for a in (tdyn, tlat)]
    return (jhmm.JointTransition(jnp.asarray(tdyn), jnp.asarray(tlat),
                                 jnp.asarray(logs[0]), jnp.asarray(logs[1])),
            hmm.JointTransition(_t(tdyn), _t(tlat), _t(logs[0]),
                                _t(logs[1])))


@pytest.mark.parametrize("n_dyn,L,case", CASES)
def test_filter_smoother_match_jax(n_dyn, L, case):
    c = scan_case(L * 7 + n_dyn, T_ODD, L, n_dyn, case)
    ll, tlat, tdyn, init = c["ll"], c["tlat"], c["tdyn"], c["p_init"]
    if case == "identical":
        assert jsk._detect_uniform_rows(tlat)[0] is False
    assert sk._detect_uniform_rows(_t(tlat)) == jsk._detect_uniform_rows(
        tlat)

    # K1: port (plain version on the CPU) vs the Pallas kernel, interpreted
    j_post, j_prior, j_ratios = (_np(a) for a in jsk.filter_chunk_pallas(
        jnp.asarray(ll), jnp.asarray(tlat), jnp.asarray(tdyn),
        jnp.asarray(init), 1.0))
    post, prior, ratios = (a.numpy() for a in sk.filter_chunk(
        _t(ll), _t(tlat), _t(tdyn), _t(init), 1.0))
    assert np.abs(post - j_post).max() <= TOL["post_abs"]
    assert np.abs(prior - j_prior).max() <= TOL["prior_abs"]
    assert abs(ratios.sum() - j_ratios.sum()) <= (
        TOL["log_ratio_sum_rel"] * abs(j_ratios.sum()))

    # K2 on identical inputs (the JAX filter's outputs)
    filt, prior_n, last = j_post[:-1], j_prior[1:], j_post[-1]
    j_smooth, j_r = (_np(a) for a in jsk.smoother_chunk_pallas(
        jnp.asarray(filt), jnp.asarray(prior_n), jnp.asarray(tlat),
        jnp.asarray(tdyn), jnp.asarray(last)))
    smooth, r = (a.numpy() for a in sk.smoother_chunk(
        _t(filt), _t(prior_n), _t(tlat), _t(tdyn), _t(last)))
    nxt = np.concatenate([j_smooth[1:], last[None]])
    assert np.abs(smooth - j_smooth).max() <= TOL["smooth_abs"]
    assert _r_rel(r, j_r, prior_n, nxt) <= TOL["r_rel"]

    # both against the JAX prob engine's scans
    j_trans, trans = _joint(tlat, tdyn)
    jp_post, _, jp_ratios, _ = jhmm._forward_scan_prob(
        jnp.asarray(ll), j_trans, (jnp.asarray(init), jnp.float32(0.0)), 1.0)
    jp_smooth, _ = jhmm._backward_scan_prob_ratios(
        jnp.asarray(filt), jnp.asarray(prior_n), j_trans, jnp.asarray(last))
    assert np.abs(post - _np(jp_post)).max() <= TOL["post_abs"]
    assert np.abs(smooth - _np(jp_smooth)).max() <= TOL["smooth_abs"]
    p_post, _, p_ratios, (_, p_logz) = hmm._forward_scan_prob(
        _t(ll), trans, (_t(init), torch.zeros(())), 1.0)
    p_smooth, _ = hmm._backward_scan_prob_ratios(
        _t(filt), _t(prior_n), trans, _t(last))
    assert np.abs(p_post.numpy() - _np(jp_post)).max() <= TOL["post_abs"]
    assert np.abs(p_smooth.numpy() - _np(jp_smooth)).max() <= TOL["smooth_abs"]
    jp_sum = float(np.sum(_np(jp_ratios)))
    assert abs(float(p_logz) - jp_sum) <= TOL["log_ratio_sum_rel"] * abs(jp_sum)

    if case == "masked":
        m = c["masked"]
        assert (post[..., m] == 0).all() and (smooth[..., m] == 0).all()
        assert np.isfinite(r).all() and np.isfinite(smooth).all()


def test_single_step_sequence():
    """T=1: the filter runs one step and the smoother gets zero rows."""
    c = scan_case(5, 1, 20, 2, "jump")
    j_post, j_prior, j_ratios = (_np(a) for a in jsk.filter_chunk_pallas(
        jnp.asarray(c["ll"]), jnp.asarray(c["tlat"]), jnp.asarray(c["tdyn"]),
        jnp.asarray(c["p_init"]), 1.0))
    post, prior, ratios = sk.filter_chunk(_t(c["ll"]), _t(c["tlat"]),
                                          _t(c["tdyn"]), _t(c["p_init"]), 1.0)
    np.testing.assert_allclose(post.numpy(), j_post, atol=TOL["post_abs"])
    np.testing.assert_allclose(ratios.numpy(), j_ratios,
                               rtol=TOL["log_ratio_sum_rel"])
    _, trans = _joint(c["tlat"], c["tdyn"])
    acc0 = torch.zeros(trans.joint_shape())
    smooth, carry = hmm._backward_chunk(post[:0], prior[1:], trans,
                                        (post[-1], acc0), "cuda")
    assert smooth.shape == (0, 2, 20) and carry[1] is acc0
    smooth, r = sk.smoother_chunk(post[:0], prior[:0], _t(c["tlat"]),
                                  _t(c["tdyn"]), post[-1])
    assert smooth.shape == r.shape == (0, 2, 20)


def test_latent_transition_kernel_hooks_match_joint():
    """The latent-only hooks (n_dyn=1 lift) equal the joint n_dyn=1 path."""
    c = scan_case(9, 31, 20, 1, "masked")
    tl = _t(c["tlat"][0])
    lat = hmm.LatentTransition(tl, torch.log(tl))
    _, joint = _joint(c["tlat"], c["tdyn"])
    post_l, prior_l, rat_l = lat.cuda_filter(_t(c["ll"]), _t(c["p_init"][0]),
                                             1.0)
    post_j, prior_j, rat_j = joint.cuda_filter(_t(c["ll"]), _t(c["p_init"]),
                                               1.0)
    torch.testing.assert_close(post_l, post_j[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(rat_l, rat_j, rtol=0, atol=0)
    sm_l, r_l = lat.cuda_smooth(post_l[:-1], prior_l[1:], post_l[-1])
    sm_j, r_j = joint.cuda_smooth(post_j[:-1], prior_j[1:], post_j[-1])
    torch.testing.assert_close(sm_l, sm_j[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(r_l, r_j[:, 0], rtol=0, atol=0)


def test_wrappers_check_inputs():
    w = torch.rand(5, 8)
    tlat = torch.rand(1, 8, 8)
    tdyn = torch.ones(1, 1)
    init = torch.rand(1, 8)
    with pytest.raises(TypeError):
        sk.filter_scan(w.double(), tlat, tdyn, init, (False,))
    with pytest.raises(ValueError):
        sk.filter_scan(w, tlat.transpose(1, 2), tdyn, init, (False,))
    with pytest.raises(ValueError):
        sk.filter_scan(w, tlat, tdyn, init, (False, False))
    with pytest.raises(ValueError):
        sk.smoother_scan(torch.rand(4, 3, 8), torch.rand(4, 3, 8),
                         torch.rand(3, 8, 8), torch.ones(3, 3),
                         torch.rand(3, 8), (False,) * 3)


@pytest.mark.parametrize("n_dyn,L,case", CASES)
def test_batch_plain_equals_the_plain_scans_per_sequence(n_dyn, L, case):
    """``filter_scan_batch`` / ``smoother_scan_batch`` on CPU tensors run
    ``*_batch_plain``: each sequence's own rows equal the unbatched plain
    scan on that sequence alone bit for bit (ragged lengths with a 1-bin
    sequence; K2 on slices of the filter's outputs, read in place), and the
    rows past a sequence's length are zero."""
    c = scan_case(L + n_dyn, sum(BATCH_LENGTHS), L, n_dyn, case)
    err = batch_vs_single(c, torch.device("cpu"))
    assert err["equal_single"] and err["finite"], err
    assert err["masked_exact_zero"], err
    assert max(err[k] for k in ("post_abs", "prior_abs", "norm_rel",
                                "smooth_abs", "r_rel")) == 0.0, err


def _batch(seed=3, L=20, n_dyn=2, lengths=(7, 1, 12)):
    c = scan_case(seed, sum(lengths), L, n_dyn, "masked")
    E, Tmax = len(lengths), max(lengths)
    ll = torch.full((E, Tmax, L), -7.0)
    off = 0
    for e, n in enumerate(lengths):
        ll[e, :n] = _t(c["ll"][off:off + n])
        off += n
    init = _t(c["p_init"]).expand(E, n_dyn, L).contiguous()
    return c, ll, init, torch.tensor(lengths, dtype=torch.int32)


def test_chunk_batch_matches_chunk_per_sequence():
    """``filter_chunk_batch`` / ``smoother_chunk_batch`` against
    ``filter_chunk`` / ``smoother_chunk`` on each sequence alone; ratios
    are 0 past a sequence's length, outputs zero there."""
    c, ll, init, lengths = _batch()
    tlat, tdyn = _t(c["tlat"]), _t(c["tdyn"])
    post, prior, ratios = sk.filter_chunk_batch(ll, tlat, tdyn, init, lengths,
                                                0.7)
    last = post[torch.arange(3), (lengths - 1).long()]
    smooth, r = sk.smoother_chunk_batch(post[:, :-1], prior[:, 1:], tlat,
                                        tdyn, last, lengths - 1)
    assert smooth.shape == r.shape == (3, 11, 2, 20)
    for e, n in enumerate(lengths.tolist()):
        p1, prior1, rat1 = sk.filter_chunk(ll[e, :n], tlat, tdyn, init[e],
                                           0.7)
        assert torch.equal(post[e, :n], p1)
        assert torch.equal(prior[e, :n], prior1)
        assert torch.equal(ratios[e, :n], rat1)
        assert bool((ratios[e, n:] == 0).all() and (post[e, n:] == 0).all())
        s1, r1 = sk.smoother_chunk(p1[:-1], prior1[1:], tlat, tdyn, p1[-1])
        assert torch.equal(smooth[e, :n - 1], s1)
        assert torch.equal(r[e, :n - 1], r1)
        assert bool((smooth[e, max(n - 1, 0):] == 0).all())


def test_batch_wrappers_check_inputs():
    c, ll, init, lengths = _batch()
    tlat, tdyn = _t(c["tlat"]), _t(c["tdyn"])
    flags = sk._detect_uniform_rows(tlat)
    w = torch.rand(3, 12, 20)
    args = (tlat, tdyn, init)
    with pytest.raises(TypeError, match="int32"):
        sk.filter_scan_batch(w, *args, lengths.long(), flags)
    with pytest.raises(TypeError, match="int32"):
        sk.filter_scan_batch(w, *args, [7, 1, 12], flags)
    with pytest.raises(ValueError, match="every length"):  # longer than Tmax
        sk.filter_scan_batch(w, *args, lengths + 1, flags)
    with pytest.raises(ValueError, match="every length"):  # an empty one
        sk.filter_scan_batch(w, *args, lengths - 1, flags)
    with pytest.raises(ValueError, match="shape"):
        sk.filter_scan_batch(w, *args, lengths[:2].contiguous(), flags)
    with pytest.raises(ValueError, match="shape"):
        sk.filter_scan_batch(w, tlat, tdyn, init[:2], lengths, flags)
    with pytest.raises(ValueError, match="contiguous"):
        sk.filter_scan_batch(w.transpose(1, 2).contiguous().transpose(1, 2),
                             *args, lengths, flags)
    with pytest.raises(TypeError, match="float32"):
        sk.filter_scan_batch(w.double(), *args, lengths, flags)
    post, prior, _ = sk.filter_scan_batch(w, *args, lengths, flags)
    tlat_t = tlat.transpose(-1, -2).contiguous()
    last = post[:, 0].contiguous()
    # slices along time pass (their stride between sequences is free) ...
    sk.smoother_scan_batch(post[:, :-1], prior[:, 1:], tlat_t, tdyn, last,
                           lengths - 1, flags)
    # ... an empty sequence too, a negative or too long one does not
    with pytest.raises(ValueError, match="every length"):
        sk.smoother_scan_batch(post[:, :-1], prior[:, 1:], tlat_t, tdyn, last,
                               lengths - 2, flags)
    with pytest.raises(ValueError, match="every length"):
        sk.smoother_scan_batch(post[:, :-1], prior[:, 1:], tlat_t, tdyn, last,
                               lengths, flags)
    with pytest.raises(ValueError, match="contiguous"):
        sk.smoother_scan_batch(post[:, :-1, :, ::2], prior[:, 1:, :, ::2],
                               tlat_t[:, :10, :10].contiguous(), tdyn,
                               last[..., ::2], lengths - 1, flags)


def test_latent_size_cap():
    """The kernels give each latent bin a thread of one block: L <= 1024.
    Every kernel wrapper raises past it (on CPU tensors too); the 'prob'
    engine has no such limit."""
    L = sk.MAX_LATENT + 1
    w = torch.rand(3, L)
    tlat = torch.full((1, L, L), 1.0 / L)
    tdyn = torch.ones(1, 1)
    init = torch.full((1, L), 1.0 / L)
    state = torch.full((3, 1, L), 1.0 / L)
    flags = (True,)
    match = f"L must be in \\[1, {sk.MAX_LATENT}\\]"
    with pytest.raises(ValueError, match=match):
        sk.filter_scan(w, tlat, tdyn, init, flags)
    with pytest.raises(ValueError, match=match):
        sk.smoother_scan(state, state, tlat, tdyn, init, flags)
    with pytest.raises(ValueError, match=match):
        sk.filter_scan_batch(w[None], tlat, tdyn, init[None],
                             torch.tensor([3], dtype=torch.int32), flags)
    with pytest.raises(ValueError, match=match):
        sk.smoother_scan_batch(state[None], state[None], tlat, tdyn,
                               init[None],
                               torch.tensor([3], dtype=torch.int32), flags)
    with pytest.raises(ValueError, match=match):
        ps.pfilter_pass(w, tlat, tdyn, init[None], 3, flags, True)
    with pytest.raises(ValueError, match=match):
        ps.psmooth_pass(state, tlat, tlat, tdyn, init[None], 3, flags, "full")
    # the kernel engines raise through the model, 'prob' decodes
    y = np.random.default_rng(0).poisson(1.0, (4, 3)).astype(np.float32)
    tuning = torch.rand(L, 3) + 0.5
    lat = hmm.LatentTransition(tlat[0], torch.log(tlat[0]))
    args = (y, tuning, {}, lat, torch.ones(3))
    with pytest.raises(ValueError, match=match):
        hmm.smooth_combined_chunked(*args, engine="cuda")
    out = hmm.smooth_combined_chunked(*args, engine="prob")
    assert out[0].shape == (4, L) and bool(torch.isfinite(out[1]))
    torch.testing.assert_close(torch.exp(out[0]).sum(dim=1), torch.ones(4))


def _division_operands(kind, n=1_000_000):
    """(x, y) float32 operands of the kernels' divisions: x >= 0 and 0 < y
    < 2, with tails down to the subnormals and exact zeros."""
    rng = np.random.default_rng({"normaliser": 1, "ratio": 2,
                                 "subnormal": 3, "tie_prone": 4}[kind])
    if kind == "normaliser":  # one term of a sum over the sum
        y = np.exp(rng.uniform(np.log(1e-38), np.log(1.9), n))
        x = y * rng.random(n) ** 8
    elif kind == "ratio":  # smoothed posterior over prior, both anywhere
        y = np.exp(rng.uniform(np.log(1e-45), np.log(1.9), n))
        x = np.exp(rng.uniform(np.log(1e-45), np.log(1.0), n))
    elif kind == "subnormal":  # quotients in the subnormal range
        y = np.exp(rng.uniform(np.log(1e-3), np.log(1.9), n))
        x = y * np.exp(rng.uniform(np.log(1e-45), np.log(1e-37), n))
    else:  # few-bit operands, whose quotients sit closest to boundaries
        y = rng.integers(1, 1 << 12, n) * 2.0 ** rng.integers(-40, -11, n)
        x = rng.integers(0, 1 << 12, n) * 2.0 ** rng.integers(-149, -11, n)
    x, y = x.astype(np.float32), y.astype(np.float32)
    keep = (y > 0) & (y < 2)
    x[::97] = 0.0
    return x[keep], y[keep]


@pytest.mark.parametrize("kind", ["normaliser", "ratio", "subnormal",
                                  "tie_prone"])
def test_division_by_reciprocal_gives_the_f32_quotient(kind):
    """A numpy model of ``scan_common.cuh::div_by_rcp``: for f32 x >= 0 and
    0 < y < 2, the f64 product of x with a reciprocal of y good to 2^-52,
    rounded to f32, equals the correctly rounded f32 quotient bit for bit,
    whichever way the reciprocal errs.  K1, K2 and K3 divide this way; K4
    divides in f32, and the engines stay bit-identical."""
    x, y = _division_operands(kind)
    assert x.size > 900_000
    with np.errstate(under="ignore", over="ignore"):
        want = x / y  # IEEE f32 division
        r = 1.0 / y.astype(np.float64)
        assert np.isfinite(r).all()
        for ulps in (-2, -1, 0, 1, 2):  # |e| <= 2^-52 and a little more
            rr = r.copy()
            for _ in range(abs(ulps)):
                rr = np.nextafter(rr, np.inf if ulps > 0 else 0.0)
            got = (x.astype(np.float64) * rr).astype(np.float32)
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if kind == "subnormal":
        tiny = np.float32(np.finfo(np.float32).tiny)
        assert ((want > 0) & (want < tiny)).mean() > 0.5
