"""K4's marginal modes, the K5 recursion-dot precisions and the
parallel-scan knobs of the port against the JAX package.

The plain versions that CPU tensors take (``psmooth_pass_plain`` in its
"marginal" and "marginal_acc" modes, ``joint_acc_plain``, ``scan_dot``)
are held against the JAX package's pure-JAX reference pass
``_psmooth_pass_ref(marginal=True)`` and its ``_scan_dot``/``_split_bf16``.
Off the TPU the JAX reference passes ignore the scan precision, so the
port's reduced-precision passes are held against JAX's ``_scan_dot``
itself and, end to end, against the f32 answer within the bench's
certificate.  Inputs are made with numpy from a seed.  Tolerances:
marginals and carries 1e-4 absolute, the pairwise joint 1e-4 of its
largest entry, dots to f32 summation order (1e-5), log-marginals 1e-5
relative.  The last tests hold the one-step check that holds the CUDA
kernels to their precision on the card (``testing.pscan_vs_plain``): it
passes the plain passes against themselves and fails passes of another
precision or with a truncated operand.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu.ops.pallas import parallel_scan as jps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import kernels  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk  # noqa: E402
from poor_man_gplvm_tpu_torch.ops.emissions import MASK_NEG  # noqa: E402
from poor_man_gplvm_tpu_torch.testing import (  # noqa: E402
    STEP_TOLERANCES,
    pfilter_step_check,
    pscan_failures,
    pscan_inputs,
    pscan_vs_plain,
    scan_case,
)

torch.set_num_threads(1)

TOL_ABS = 1e-4
TOL_LML = 1e-5
TOL_DOT = 1e-5


def _trans_mats(L, n_dyn, mv=1.3, pmj=0.05, pjm=0.08):
    lat, _, dyn, _ = kernels.create_transition_prob_1d(
        torch.arange(L), torch.arange(2), mv, pmj, pjm)
    if n_dyn == 1:
        return lat[:1].contiguous(), torch.ones((1, 1))
    return lat, dyn


def _ll(seed, T, L, masked=(), spread=3.0):
    rng = np.random.default_rng(seed)
    ll = (rng.normal(size=(T, L)) * spread - 20.0).astype(np.float32)
    ll[:, list(masked)] = MASK_NEG
    return ll


def _chunk_major(x, C, tc):
    """(T, ...) global rows -> the JAX passes' (tc, ..., C, L) layout."""
    xc = ps._chunked(torch.as_tensor(x), C, tc).numpy()  # (C, tc, ..., L)
    return np.moveaxis(xc, 0, -2)


def _global(xc, T, chunk_axis=-2):
    """JAX chunk layout (chunk axis ``chunk_axis``) -> (T, ...)."""
    x = np.moveaxis(np.asarray(xc), chunk_axis, 0)
    return x.reshape((-1,) + x.shape[2:])[:T]


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _k4_inputs(n_dyn, T=1001, L=12, C=8, masked=(4,)):
    """Filter posteriors and backward carries for K4, from the port's
    plain K3 on converged forward carries (odd T: ragged last chunk, T-1
    mid-chunk)."""
    tc = -(-T // C)
    tlat, tdyn = _trans_mats(L, n_dyn)
    flags = sk._detect_uniform_rows(tlat)
    ll = torch.as_tensor(_ll(3, T, L, masked=masked))
    w = torch.exp(ll - ll.amax(dim=1, keepdim=True))
    ins0 = torch.full((C, n_dyn, L), 1.0 / (n_dyn * L))
    ins, _, _ = ps._solve(
        lambda i: ps.pfilter_pass(w, tlat, tdyn, i, tc, flags, False)[2],
        lambda fin: torch.cat([ins0[:1], fin[:-1]]), ins0, 1e-6, C)
    post, _, _ = ps.pfilter_pass(w, tlat, tdyn, ins, tc, flags, True)
    rng = np.random.default_rng(4)
    bins = torch.as_tensor(rng.dirichlet(np.ones(n_dyn * L), C)
                           .reshape(C, n_dyn, L).astype(np.float32))
    bins[..., list(masked)] = 0.0
    bins /= bins.sum(dim=(1, 2), keepdim=True)
    return dict(post=post, tlat=tlat, tlat_t=tlat.transpose(1, 2).contiguous(),
                tdyn=tdyn, ins=bins, tc=tc, C=C, T=T, flags=flags,
                masked=list(masked))


@pytest.mark.parametrize("n_dyn", [1, 2])
def test_psmooth_marginal_modes_match_jax_ref(n_dyn):
    k = _k4_inputs(n_dyn)
    T, C, tc = k["T"], k["C"], k["tc"]
    args = (k["post"], k["tlat"], k["tlat_t"], k["tdyn"], k["ins"], tc,
            k["flags"])
    lat, dyn, fin = ps.psmooth_pass(*args, "marginal")
    lat_a, dyn_a, acc, fin_a = ps.psmooth_pass(*args, "marginal_acc")
    sm, r, fin_full = ps.psmooth_pass(*args, "full")
    jargs = (jnp.asarray(_chunk_major(k["post"], C, tc)),
             jnp.asarray(k["tlat"].numpy()), jnp.asarray(k["tlat_t"].numpy()),
             jnp.asarray(k["tdyn"].numpy()),
             jnp.asarray(k["ins"].transpose(0, 1).numpy()))
    jkw = dict(C=C, block_t=tc, tc_eff=tc, n_valid=T,
               uniform_rows=k["flags"], marginal=True, finals_only=False)
    jlat, jdyn, jfin = jps._psmooth_pass_ref(*jargs, want_acc=False, **jkw)
    jlat_a, jdyn_a, jacc, _ = jps._psmooth_pass_ref(*jargs, want_acc=True,
                                                    **jkw)

    assert lat.shape == (T, k["tlat"].shape[-1]) and dyn.shape == (T, n_dyn)
    assert _max_abs(lat, _global(jlat, T)) <= TOL_ABS
    assert _max_abs(dyn, _global(jdyn, T, chunk_axis=-1)) <= TOL_ABS
    assert _max_abs(fin, np.swapaxes(np.asarray(jfin), 0, 1)) <= TOL_ABS
    assert _max_abs(lat_a, _global(jlat_a, T)) <= TOL_ABS
    assert _max_abs(dyn_a, _global(jdyn_a, T, chunk_axis=-1)) <= TOL_ABS
    jacc = np.asarray(jacc)
    assert acc.shape == jacc.shape == (n_dyn, n_dyn) + (lat.shape[1],) * 2
    assert _max_abs(acc, jacc) / float(np.abs(jacc).max()) <= TOL_ABS
    # every mode runs the same recursion: equal finals, marginals that are
    # the full mode's sums, acc the joint of the full mode's ratios
    assert torch.equal(fin, fin_a) and torch.equal(fin, fin_full)
    assert torch.equal(lat, lat_a) and torch.equal(dyn, dyn_a)
    assert torch.equal(lat, sm.sum(dim=1))
    torch.testing.assert_close(dyn, sm.sum(dim=2), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(acc, ps.joint_acc_plain(k["post"], r))
    # row T-1 holds post_{T-1}; masked bins stay exact zeros
    assert torch.equal(lat[T - 1], k["ins"][(T - 1) // tc].sum(dim=0))
    assert (lat[:, k["masked"]] == 0).all()
    assert ps.psmooth_pass(*args, "finals")[:2] == (None, None)
    with pytest.raises(ValueError, match="mode"):
        ps.psmooth_pass(*args, "no_such_mode")


def test_joint_acc_plain_matches_einsum():
    rng = np.random.default_rng(8)
    T, n_dyn, L = 513, 2, 11
    post = rng.dirichlet(np.ones(n_dyn * L), T).reshape(T, n_dyn, L)
    r = rng.gamma(2.0, 0.5, size=(T, n_dyn, L)) * (rng.random(
        (T, n_dyn, L)) > 0.1)
    want = np.einsum("tdi,tej->deij", post, r)  # float64
    got = ps.joint_acc(torch.as_tensor(post.astype(np.float32)),
                       torch.as_tensor(r.astype(np.float32)))
    assert got.shape == (n_dyn, n_dyn, L, L) and got.dtype == torch.float32
    assert _max_abs(got, want) / np.abs(want).max() <= TOL_DOT
    with pytest.raises(ValueError):
        ps.joint_acc(torch.zeros(3, 2, 4), torch.zeros(3, 2, 5))
    # the split over time: enough slices to fill one wave of the card
    # (132 blocks of 128 x 128 tiles), bounded rows
    assert ps._acc_slices(1_000_000, 1000) == (8, 125_000)
    assert ps._acc_slices(100_000, 200)[0] == 33


@pytest.mark.parametrize("mode", ["highest", "bf16x3", "bf16"])
def test_scan_dot_matches_jax(mode):
    rng = np.random.default_rng(21)
    a = rng.standard_normal((32, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    got = ps.scan_dot(torch.as_tensor(a), torch.as_tensor(b), mode)
    want = jps._scan_dot(jnp.asarray(a), jnp.asarray(b), None, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_DOT)
    # a precomputed weight split gives the same dot
    hilo = ps.split_bf16(torch.as_tensor(b))
    assert torch.equal(ps.scan_dot(torch.as_tensor(a), torch.as_tensor(b),
                                   mode, hilo), got)


def test_split_and_bf16x3_error_model():
    """The JAX package's split and error-model test on the port's
    functions: hi + lo reconstructs f32 to two nested bf16 roundings; the
    3-pass dot drops only lo.lo (<= K * 2^-18 at unit scale) and beats the
    1-pass dot by an order of magnitude."""
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.standard_normal((64, 64)).astype(np.float32))
    hi, lo = ps.split_bf16(x)
    jhi, jlo = jps._split_bf16(jnp.asarray(x.numpy()))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.float().numpy(),
                                  np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.float().numpy(),
                                  np.asarray(jlo.astype(jnp.float32)))
    np.testing.assert_allclose((hi.float() + lo.float()).numpy(), x.numpy(),
                               rtol=0, atol=2e-5)
    a = torch.as_tensor(rng.standard_normal((32, 64)).astype(np.float32))
    d0 = ps.scan_dot(a, x, "highest")
    d3 = ps.scan_dot(a, x, "bf16x3")
    d1 = ps.scan_dot(a, x, "bf16")
    K = x.shape[0]
    np.testing.assert_allclose(d3.numpy(), d0.numpy(), rtol=0,
                               atol=K * 2.0 ** -18)
    assert float((d3 - d0).abs().max()) < float((d1 - d0).abs().max()) / 10
    with pytest.raises(ValueError):
        ps.scan_dot(a, x, "float16")


def test_knobs_match_jax():
    """set_scan_precision / scan_mode_key / set_config_override as in the
    JAX package: the same validation, the same key, and the override's
    launch config equal to JAX's (no VMEM clamp binds at these shapes)."""
    with pytest.raises(ValueError):
        ps.set_scan_precision("float16")
    shapes = [(1_000_000, 500, 2), (100_000, 100, 2), (16, 100, 2),
              (5000, 30, 1)]
    try:
        for mode in ("bf16x3", "bf16"):
            ps.set_scan_precision(mode)
            jps.set_scan_precision(mode)
            assert ps.scan_mode_key() == jps.scan_mode_key() == (None, mode)
        ps.set_config_override((64, 8, 8))
        jps.set_config_override((64, 8, 8))
        assert ps.scan_mode_key() == ((64, 8, 8), "bf16")
        for T, L, n_dyn in shapes:
            assert ps.choose_parallel_config(T, L, n_dyn) == \
                jps.choose_parallel_config(T, L, n_dyn)
        assert ps.choose_parallel_config(100_000, 100, 2) == (64, 8, 8)
    finally:
        ps.set_scan_precision("highest")
        jps.set_scan_precision("highest")
        ps.set_config_override(None)
        jps.set_config_override(None)
    assert ps.scan_mode_key() == (None, "highest")
    for T, L, n_dyn in shapes:
        assert ps.choose_parallel_config(T, L, n_dyn) == \
            jps.choose_parallel_config(T, L, n_dyn)


@pytest.mark.parametrize("n_dyn", [1, 2])
def test_reduced_precision_passes(n_dyn):
    """The plain passes take the scan precision: K3 and K4 in bf16x3 stay
    within the bench's certificate of the f32 answer (JAX, whose reference
    passes run f32 off the TPU), bf16 within its ~1e-3; the two
    precisions really run other arithmetic; the uniform (jump) channel is
    never split, so a one-channel uniform model is the same in every
    precision; K4's recomputed priors use K3's arithmetic, so masked bins
    stay exact zeros."""
    T, L, masked = 1999, 20, (0, 7)
    tlat, tdyn = _trans_mats(L, n_dyn)
    flags = sk._detect_uniform_rows(tlat)
    ll = _ll(11, T, L, masked)
    p_init = torch.full((n_dyn, L), 1.0 / (n_dyn * L))
    cfg = ps.choose_parallel_config(T, L, n_dyn)
    want = jps.smooth_parallel(
        jnp.asarray(ll), jnp.asarray(tlat.numpy()), jnp.asarray(tdyn.numpy()),
        jnp.asarray(p_init.numpy()), 1.0, uniform_rows=flags, config=cfg,
        marginal=True)
    got = {}
    try:
        for mode, tol_lml, tol_post in (("highest", TOL_LML, TOL_ABS),
                                        ("bf16x3", TOL_LML, TOL_ABS),
                                        ("bf16", 1e-3, 1e-2)):
            ps.set_scan_precision(mode)
            out = ps.smooth_parallel(torch.as_tensor(ll), tlat, tdyn, p_init,
                                     1.0, uniform_rows=flags, config=cfg,
                                     marginal=True, want_acc=False)
            got[mode] = out
            (lat, dyn), lml = out[0], out[1]
            assert abs(float(lml) - float(want[1])) <= tol_lml * abs(
                float(want[1])), mode
            assert _max_abs(lat, want[0][0]) <= tol_post, mode
            assert _max_abs(dyn, want[0][1]) <= tol_post, mode
            assert (lat[:, list(masked)] == 0).all(), mode
    finally:
        ps.set_scan_precision("highest")
    assert not torch.equal(got["bf16x3"][0][0], got["highest"][0][0])
    assert not torch.equal(got["bf16"][0][0], got["bf16x3"][0][0])
    # a constant channel takes sum * row in f32 in every precision
    uni = torch.full((1, L, L), 1.0 / L)
    w = torch.rand(50, L)
    ins = torch.full((4, 1, L), 1.0 / L)
    outs = [ps.pfilter_pass(w, uni, torch.ones(1, 1), ins, 13, (True,), True,
                            mode)[0] for mode in ps.SCAN_PRECISIONS]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


# ---------------------------------------------------------------------------
# the one-step check that holds the K3/K4 kernels to their precision
# (testing.pscan_vs_plain); on the CPU the wrappers run the plain versions
# ---------------------------------------------------------------------------


def _pscan_case():
    return scan_case(42, 1001, 40, 2, "masked")


@pytest.mark.parametrize("scan_prec", ps.SCAN_PRECISIONS)
def test_one_step_check_same_precision(scan_prec):
    err = pscan_vs_plain(_pscan_case(), torch.device("cpu"),
                         scan_prec=scan_prec)
    assert pscan_failures(err, scan_prec) == [], err
    assert all(err[k] == 0.0 for k in STEP_TOLERANCES), err


@pytest.mark.parametrize("kern_prec, plain_prec", [
    ("bf16", "highest"), ("bf16", "bf16x3"), ("highest", "bf16"),
    ("bf16x3", "bf16"), ("bf16x3", "highest"),
])
def test_one_step_check_rejects_other_precision(kern_prec, plain_prec):
    """Control: passes run in one precision fail the check against the
    plain versions in another, on the share of entries past STEP_RTOL in
    every one-step comparison (K3 posteriors, K4 r and smoothed
    posteriors)."""
    err = pscan_vs_plain(_pscan_case(), torch.device("cpu"),
                         scan_prec=kern_prec, plain_prec=plain_prec,
                         lean=True)
    bad = pscan_failures(err, kern_prec)
    assert {"step_post_frac", "step_r_frac", "step_smooth_frac"} <= set(bad), \
        err


def test_one_step_check_rejects_truncated_operand(monkeypatch):
    """Control: a "bf16" filter pass that truncates its vector operand to
    bf16 instead of rounding it to nearest fails the one-step check."""
    a = pscan_inputs(_pscan_case(), torch.device("cpu"), scan_prec="bf16")
    good = ps.pfilter_pass_plain(a["w"], a["tlat"], a["tdyn"], a["ins"],
                                 a["tc"], a["flags"], True, "bf16")[0]

    def truncating_dot(x, b, mode, b_hilo=None):
        cut = (x.contiguous().view(torch.int32) & -65536).view(torch.float32)
        return cut @ ps.split_bf16(b)[0].float()

    monkeypatch.setattr(ps, "scan_dot", truncating_dot)
    bad = ps.pfilter_pass_plain(a["w"], a["tlat"], a["tdyn"], a["ins"],
                                a["tc"], a["flags"], True, "bf16")[0]
    monkeypatch.undo()
    assert pfilter_step_check(a, good, "bf16")["step_post_frac"] == 0.0
    step = pfilter_step_check(a, bad, "bf16")
    assert step["step_post_frac"] > STEP_TOLERANCES["step_post_frac"], step
