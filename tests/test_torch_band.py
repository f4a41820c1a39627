"""The band of nonzeros (``ops/band.py::transition_band``) that K2, K3 and
K4 read, against the JAX package's transition matrices.

The movement channel of ``poor_man_gplvm_tpu.ops.kernels.
create_transition_prob_1d`` is an RBF of integer positions, exactly 0 in
f32 far from the diagonal, so the kernels read each column through a
window of W rows.  These tests hold the band on the CPU: the band rebuilds the
dense matrix exactly, the window heights are the RBF's, the windows stay
inside the matrix, degenerate and dense channels give W = L, the bf16
split of the band is the banded split of the dense matrix, and
``smooth_parallel`` on the CPU (which takes the plain versions) neither
depends on the band nor moves from the JAX package.  The card tests hold
K4 on the band against K4 forced dense, bit for bit
(``tests/test_torch_cuda_kernels.py::test_k4_band_equals_dense``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu.ops import kernels as jkernels  # noqa: E402
from poor_man_gplvm_tpu.ops.pallas import parallel_scan as jps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import band as bd  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm, kernels  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk  # noqa: E402
from poor_man_gplvm_tpu_torch.testing import (  # noqa: E402
    band_vs_dense,
    scan_case,
)

torch.set_num_threads(1)

MOVEMENT_VARIANCES = (0.5, 1, 2, 4)
#: window height of the RBF channel (movement_variance used as the
#: lengthscale) as the port builds it: entries are exactly 0 in f32 from
#: |i - j| >= 5.5 ls.  The JAX package's matrices on the CPU are narrower
#: (XLA flushes the subnormal entries to zero; ROADMAP section 3).
RBF_WIDTH = {0.5: 11, 1: 21, 2: 41, 4: 81}
RBF_WIDTH_JAX_CPU = {0.5: 9, 1: 19, 2: 37, 4: 74}


def _jax_transitions(L, mv, custom_kernel=None):
    lat, _, dyn, _ = jkernels.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), mv, custom_kernel=custom_kernel)
    return (torch.as_tensor(np.array(lat, dtype=np.float32)),
            torch.as_tensor(np.array(dyn, dtype=np.float32)))


def _band(tlat, scan_prec="highest"):
    flags = sk._detect_uniform_rows(tlat)
    return flags, ps.transition_band(
        tlat, tlat.transpose(-1, -2).contiguous(), flags, scan_prec)


def _unband(band, L):
    """The dense (2, n_mat, L, L) matrices the band stands for."""
    two, n_mat, W, _ = band.mats.shape
    dense = torch.zeros((two * n_mat, L, L), dtype=band.mats.dtype)
    rows = band.start.reshape(-1, 1, L).long() + torch.arange(W)[None, :,
                                                                  None]
    dense.scatter_(1, rows, band.mats.reshape(-1, W, L))
    return dense.view(two, n_mat, L, L)


def _dense_width(mat):
    """The largest span of nonzero rows over the columns of ``mat``."""
    nz = mat.numpy() != 0
    first = nz.argmax(axis=0)
    last = mat.shape[0] - 1 - nz[::-1].argmax(axis=0)
    return int((last - first + 1).max())


@pytest.mark.parametrize("L", [100, 500])
@pytest.mark.parametrize("mv", MOVEMENT_VARIANCES)
def test_band_rebuilds_the_jax_transitions(L, mv):
    tlat, _ = _jax_transitions(L, mv)
    flags, band = _band(tlat)
    assert flags == (False, True)  # the jump channel takes the row sum
    assert band.mats.shape == (2, 1, band.W, L)
    assert band.W == RBF_WIDTH_JAX_CPU[mv] == _dense_width(tlat[0])
    # the windows stay inside [0, L)
    assert int(band.start.min()) >= 0
    assert int(band.start.max()) + band.W <= L
    dense = _unband(band, L)
    assert torch.equal(dense[0, 0], tlat[0])
    assert torch.equal(dense[1, 0], tlat[0].T)


@pytest.mark.parametrize("mv", MOVEMENT_VARIANCES)
def test_band_of_the_port_transitions(mv):
    L = 500
    tlat = kernels.create_transition_prob_1d(torch.arange(L), torch.arange(2),
                                             mv)[0]
    _, band = _band(tlat)
    assert band.W == RBF_WIDTH[mv] == _dense_width(tlat[0])
    assert int(band.start.max()) + band.W <= L
    assert torch.equal(_unband(band, L)[0, 0], tlat[0])


def test_zero_column_and_dense_kernel_give_full_width():
    L = 60
    tlat, _ = _jax_transitions(L, 1)
    with_zero = tlat.clone()
    with_zero[0, :, 17] = 0.0
    _, band = _band(with_zero)
    assert band.W == L and int(band.start.abs().max()) == 0
    assert torch.equal(_unband(band, L)[0, 0], with_zero[0])
    custom = np.random.default_rng(3).uniform(0.1, 1.0, (L, L))
    dense, _ = _jax_transitions(L, 1, custom_kernel=custom.astype(np.float32))
    _, band = _band(dense)
    assert band.W == L and int(band.start.abs().max()) == 0
    assert torch.equal(band.mats[0, 0], dense[0])
    assert torch.equal(band.mats[1, 0], dense[0].T)


def test_band_override_forces_dense():
    tlat, _ = _jax_transitions(100, 1)
    ps.set_band_override(True)
    try:
        _, band = _band(tlat)
    finally:
        ps.set_band_override(False)
    assert band.W == 100 and int(band.start.abs().max()) == 0
    assert torch.equal(band.mats[0, 0], tlat[0])
    assert _band(tlat)[1].W == RBF_WIDTH_JAX_CPU[1]


def test_constant_channel_has_no_band():
    flags, band = _band(_jax_transitions(40, 1)[0][1:])
    assert flags == (True,)
    assert band.W == 0 and band.mats.shape == (2, 0, 0, 40)


@pytest.mark.parametrize("scan_prec", ["bf16x3", "bf16"])
@pytest.mark.parametrize("mv", [1, 4])
def test_band_splits_equal_the_banded_split(mv, scan_prec):
    L = 100
    tlat, _ = _jax_transitions(L, mv)
    _, band = _band(tlat, scan_prec)
    hi, lo = ps.split_bf16(torch.stack([tlat[:1], tlat[:1].transpose(1, 2)]))
    rows = band.start.long()[..., None, :] + torch.arange(band.W)[:, None]
    assert torch.equal(band.hi, hi.gather(2, rows))
    assert torch.equal(band.lo, lo.gather(2, rows))
    # the window's extra entries are exact zeros in every part
    assert torch.equal(_unband(band._replace(mats=band.hi.float()), L)[0, 0],
                       hi[0, 0].float())


def test_band_vs_dense_helper_on_the_cpu():
    eq = band_vs_dense(scan_case(5, 401, 40, 2, "masked"),
                       torch.device("cpu"), "bf16x3")
    assert eq["band_equal_dense"] and eq["finite"] and eq["masked_exact_zero"]
    assert (eq["W"], eq["W_dense"]) == (21, 40)


def test_smooth_parallel_on_cpu_is_unchanged_by_the_band():
    T, L = 1999, 24
    tlat, tdyn = _jax_transitions(L, 1)
    flags = sk._detect_uniform_rows(tlat)
    ll = (np.random.default_rng(11).normal(size=(T, L)) * 3.0
          - 20.0).astype(np.float32)
    p_init = torch.full((2, L), 1.0 / (2 * L))
    cfg = ps.choose_parallel_config(T, L, 2)

    def run():
        return ps.smooth_parallel(torch.as_tensor(ll), tlat, tdyn, p_init,
                                  1.0, uniform_rows=flags, config=cfg,
                                  want_post=True)

    got = run()
    ps.set_band_override(True)
    try:
        dense = run()
    finally:
        ps.set_band_override(False)
    for a, b in zip(got[:5], dense[:5]):
        assert torch.equal(a, b)
    want = jps.smooth_parallel(
        jnp.asarray(ll), jnp.asarray(tlat.numpy()), jnp.asarray(tdyn.numpy()),
        jnp.asarray(p_init.numpy()), 1.0, uniform_rows=flags, config=cfg,
        want_post=True)
    lml = float(got[1])
    assert abs(lml - float(want[1])) <= 1e-5 * abs(float(want[1]))
    assert float((got[0] - torch.as_tensor(np.asarray(want[0]))).abs().max()) \
        <= 1e-4


@pytest.mark.parametrize("T, M, S", [(100_000, 1000, 2), (100_000, 200, 33),
                                     (20_001, 80, 132), (301, 80, 10),
                                     (1_000_000, 1000, 8)])
def test_joint_acc_slices_cover_time(T, M, S):
    got_S, rows = ps._acc_slices(T, M)
    assert got_S == S
    assert got_S * rows >= T and (got_S - 1) * rows < T
    assert rows <= ps._ACC_MAX_ROWS


# ---------------------------------------------------------------------------
# the band as K2 and K3 take it
# ---------------------------------------------------------------------------

BAND_NAMES = ("Band", "band_windows", "transition_band", "set_band_override",
              "split_bf16", "_gather_band")


@pytest.mark.parametrize("name", BAND_NAMES)
def test_band_is_one_object_in_both_modules(name):
    assert getattr(ps, name) is getattr(bd, name)


def test_band_override_set_through_either_module():
    tlat, _ = _jax_transitions(50, 1)
    for setter in (ps.set_band_override, bd.set_band_override):
        setter(True)
        try:
            assert _band(tlat)[1].W == 50
            assert bd.band_windows(tlat[:1])[1] == 50
        finally:
            setter(False)
        assert _band(tlat)[1].W == RBF_WIDTH_JAX_CPU[1]


def _pass_inputs(L=40, T=403, C=8, case="masked", n_dyn=2):
    c = scan_case(7, T, L, n_dyn, case)
    t = {k: torch.as_tensor(v) for k, v in c.items() if k != "masked"}
    flags = sk._detect_uniform_rows(t["tlat"])
    w = torch.exp(t["ll"] - t["ll"].amax(dim=1, keepdim=True)).contiguous()
    ins = torch.as_tensor(np.random.default_rng(8).dirichlet(
        np.ones(n_dyn * L), C).reshape(C, n_dyn, L).astype(np.float32))
    tlat_t = t["tlat"].transpose(-1, -2).contiguous()
    return t, flags, w, ins, -(-T // C), tlat_t


def _k3(emit, scan_prec="highest"):
    t, flags, w, ins, tc, _ = _pass_inputs()
    return lambda band: ps.pfilter_pass(w, t["tlat"], t["tdyn"], ins, tc,
                                        flags, emit, scan_prec, band=band)


def _k2(chunk):
    t, flags, w, _, _, tlat_t = _pass_inputs(T=61)
    post, prior, _ = sk.filter_scan(w, t["tlat"], t["tdyn"], t["p_init"],
                                    flags)
    filt, pri, init = (post[:-1].contiguous(), prior[1:].contiguous(),
                       post[-1].contiguous())
    if chunk:
        return lambda band: sk.smoother_chunk(filt, pri, t["tlat"],
                                              t["tdyn"], init, flags, band)
    return lambda band: sk.smoother_scan(filt, pri, tlat_t, t["tdyn"], init,
                                         flags, band)


def _k1(chunk):
    t, flags, w, _, _, _ = _pass_inputs(T=61)
    if chunk:
        return lambda band: sk.filter_chunk(t["ll"], t["tlat"], t["tdyn"],
                                            t["p_init"], 1.0, flags, band)
    return lambda band: sk.filter_scan(w, t["tlat"], t["tdyn"], t["p_init"],
                                       flags, band)


def _batched(kernel):
    """K1 or K2 over a batch of 3 ragged sequences of the same inputs."""
    t, flags, w, _, _, tlat_t = _pass_inputs(T=61)
    lengths = torch.tensor([20, 1, 17], dtype=torch.int32)
    w_b = w[:60].view(3, 20, 40)
    init = t["p_init"].expand(3, 2, 40).contiguous()
    if kernel == "k1":
        return lambda band: sk.filter_scan_batch(
            w_b, t["tlat"], t["tdyn"], init, lengths, flags, band)
    post, prior, _ = sk.filter_scan_batch(w_b, t["tlat"], t["tdyn"], init,
                                          lengths, flags)
    return lambda band: sk.smoother_scan_batch(
        post[:, :-1], prior[:, 1:], tlat_t, t["tdyn"],
        post[:, 0].contiguous(), lengths - 1, flags, band)


WRAPPERS = {
    "filter_scan": (lambda: _k1(False), "highest"),
    "filter_chunk": (lambda: _k1(True), "highest"),
    "filter_scan_batch": (lambda: _batched("k1"), "highest"),
    "smoother_scan_batch": (lambda: _batched("k2"), "highest"),
    "pfilter_finals": (lambda: _k3(False), "highest"),
    "pfilter_emit": (lambda: _k3(True), "highest"),
    "pfilter_emit_bf16x3": (lambda: _k3(True, "bf16x3"), "bf16x3"),
    "pfilter_finals_bf16": (lambda: _k3(False, "bf16"), "bf16"),
    "smoother_scan": (lambda: _k2(False), "highest"),
    "smoother_chunk": (lambda: _k2(True), "highest"),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_on_cpu_give_the_same_with_and_without_a_band(name):
    make, scan_prec = WRAPPERS[name]
    run = make()
    t, flags, _, _, _, tlat_t = _pass_inputs()
    band = bd.transition_band(t["tlat"], tlat_t, flags, scan_prec)
    assert band.W == 21
    want = [x for x in run(None) if x is not None]
    assert want and all(bool(torch.isfinite(x).all()) for x in want)
    got = [x for x in run(band) if x is not None]
    bd.set_band_override(True)
    try:
        dense = bd.transition_band(t["tlat"], tlat_t, flags, scan_prec)
        forced = [x for x in run(dense) if x is not None]
        unbanded = [x for x in run(None) if x is not None]
    finally:
        bd.set_band_override(False)
    assert dense.W == 40
    for other in (got, forced, unbanded):
        assert len(other) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(other, want))


def _bad_bands():
    t, flags, _, _, _, tlat_t = _pass_inputs()
    good = bd.transition_band(t["tlat"], tlat_t, flags, "bf16x3")
    other_L = bd.transition_band(t["tlat"][:, :30, :30].contiguous(),
                                 tlat_t[:, :30, :30].contiguous(), flags)
    both = bd.transition_band(t["tlat"], tlat_t, (False, False))
    return {
        "other_L": other_L,
        "other_channels": both,
        "W_mismatch": good._replace(W=good.W - 1),
        "start_shape": good._replace(start=good.start[:1].contiguous()),
        "not_contiguous": good._replace(
            mats=good.mats.transpose(-1, -2).contiguous().transpose(-1, -2)),
        "float64": good._replace(mats=good.mats.double()),
    }


BAD_BANDS = ("other_L", "other_channels", "W_mismatch", "start_shape",
             "not_contiguous", "float64")


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4"])
@pytest.mark.parametrize("fault", BAD_BANDS)
def test_band_of_the_wrong_shape_raises(fault, kernel):
    band = _bad_bands()[fault]
    t, flags, w, ins, tc, tlat_t = _pass_inputs()
    with pytest.raises(ValueError, match="band does not match"):
        if kernel == "k1":
            sk.filter_scan(w, t["tlat"], t["tdyn"], t["p_init"], flags, band)
        elif kernel == "k3":
            ps.pfilter_pass(w, t["tlat"], t["tdyn"], ins, tc, flags, False,
                            band=band)
        elif kernel == "k4":
            post = torch.rand(w.shape[0], 2, 40)
            ps.psmooth_pass(post, t["tlat"], tlat_t, t["tdyn"], ins, tc,
                            flags, "finals", band=band)
        else:
            x = torch.rand(9, 2, 40)
            sk.smoother_scan(x, x, tlat_t, t["tdyn"], x[0].contiguous(),
                             flags, band)


@pytest.mark.parametrize("scan_prec", ["bf16x3", "bf16"])
@pytest.mark.parametrize("kernel", ["k3", "k4"])
def test_band_of_the_wrong_precision_raises(kernel, scan_prec):
    t, flags, w, ins, tc, tlat_t = _pass_inputs()
    plain = bd.transition_band(t["tlat"], tlat_t, flags)  # no bf16 split
    assert plain.hi is None
    with pytest.raises(ValueError, match="band does not match"):
        if kernel == "k3":
            ps.pfilter_pass(w, t["tlat"], t["tdyn"], ins, tc, flags, True,
                            scan_prec, band=plain)
        else:
            post = torch.rand(w.shape[0], 2, 40)
            ps.psmooth_pass(post, t["tlat"], tlat_t, t["tdyn"], ins, tc,
                            flags, "full", scan_prec, band=plain)
    # a split band serves "highest" too: the f32 windows are what it reads
    split = bd.transition_band(t["tlat"], tlat_t, flags, scan_prec)
    ps.pfilter_pass(w, t["tlat"], t["tdyn"], ins, tc, flags, False,
                    band=split)


def _fma_columns(vec, mat, start):
    """A numpy model of the kernels' window dot (``scan_common.cuh::
    window_matvec``): out[j] = sum_k vec[start[j] + k] * mat[k, j] over k
    ascending, each term folded with one fused multiply-add (the f32
    product is exact in f64, and one rounding to f32 follows the sum)."""
    acc = np.zeros(mat.shape[1], np.float32)
    for k in range(mat.shape[0]):
        acc = (vec[start + k].astype(np.float64) * mat[k].astype(np.float64)
               + acc.astype(np.float64)).astype(np.float32)
    return acc


@pytest.mark.parametrize("half", [0, 1], ids=["push_k3", "pull_k2"])
@pytest.mark.parametrize("mv", [1, 4])
def test_window_sum_gives_the_dense_sum_bit_for_bit(mv, half):
    """K3 reads ``mats[0]`` with its dynamics-mixed carry q >= 0, K2 reads
    ``mats[1]`` with its ratios r >= 0, and bf16x3 also sums signed lo
    parts: the ascending window sum equals the ascending dense sum in
    every case, since the rows left out are exact zeros and
    fma(x, +0, a) = a."""
    L = 120
    tlat = kernels.create_transition_prob_1d(torch.arange(L), torch.arange(2),
                                             mv)[0]
    _, band = _band(tlat, "bf16x3")
    assert band.W == RBF_WIDTH[mv] < L
    dense = (tlat[0] if half == 0 else tlat[0].T).contiguous()
    d_hi, d_lo = (x.float().numpy() for x in bd.split_bf16(dense))
    start = band.start[half, 0].numpy().astype(np.int64)
    zero = np.zeros(L, np.int64)
    rng = np.random.default_rng(mv + half)
    q = rng.gamma(0.3, 1.0, L).astype(np.float32)  # >= 0, a few near 0
    q[rng.choice(L, 9, replace=False)] = 0.0
    q_hi, q_lo = (x.float().numpy() for x in bd.split_bf16(
        torch.as_tensor(q)))
    assert (q_lo < 0).any() and (d_lo < 0).any()  # the lo parts are signed
    b_f = band.mats[half, 0].numpy()
    b_hi = band.hi[half, 0].float().numpy()
    b_lo = band.lo[half, 0].float().numpy()
    # "highest": the f32 dot
    want = _fma_columns(q, dense.numpy(), zero)
    assert np.array_equal(_fma_columns(q, b_f, start), want)
    assert (want > 0).all()
    # "bf16x3": hi.hi, lo.hi and hi.lo, then (hh + lh) + hl; "bf16": hi.hi
    parts = [(_fma_columns(v, b, start), _fma_columns(v, d, zero))
             for v, b, d in ((q_hi, b_hi, d_hi), (q_lo, b_hi, d_hi),
                             (q_hi, b_lo, d_lo))]
    for got, ref in parts:
        assert np.array_equal(got, ref)
    (hh, _), (lh, _), (hl, _) = parts
    (hh_d, lh_d, hl_d) = (ref for _, ref in parts)
    assert np.array_equal((hh + lh) + hl, (hh_d + lh_d) + hl_d)


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "latent"])
def test_sequential_decode_over_host_chunks_makes_the_band_once(
        joint, monkeypatch):
    """``smooth_combined_chunked(engine='cuda')`` over several host chunks:
    the transition object makes the band of K1 and K2 at its first chunk
    and keeps it (``band_windows`` reads W to the host).  On CPU tensors no
    band is made; with the device rule lifted, exactly one, and the
    results do not move."""
    L, T, N = 30, 230, 5
    rng = np.random.default_rng(5)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = torch.as_tensor(rng.gamma(2.0, 1.0, size=(L, N))
                             .astype(np.float32))
    lat, log_lat, dyn, log_dyn = kernels.create_transition_prob_1d(
        torch.arange(L), torch.arange(2), 1)

    def trans():
        if joint:
            return hmm.JointTransition(dyn, lat, log_dyn, log_lat)
        return hmm.LatentTransition(lat[0], log_lat[0])

    calls = []
    real = bd.band_windows
    monkeypatch.setattr(bd, "band_windows",
                        lambda mats: calls.append(1) or real(mats))

    def run(tr):
        return hmm.smooth_combined_chunked(
            y, tuning, {}, tr, torch.ones(N), torch.ones(L), engine="cuda",
            n_time_per_chunk=37)  # 7 host chunks

    want = run(trans())
    assert calls == []  # CPU tensors: the plain version reads no band
    monkeypatch.setattr(hmm, "_wants_band", lambda tlat: True)
    tr = trans()
    got = run(tr)
    assert len(calls) == 1
    assert tr._band.W == 21 and tr._band.mats.shape == (2, 1, 21, L)
    run(tr)  # the same transition object: the band is kept
    assert len(calls) == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
