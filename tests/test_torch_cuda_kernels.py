"""Card tests: the CUDA scan kernels K1/K2 (sequential, unbatched and one
thread block per sequence of a batch), K3/K4 (parallel-in-time passes,
every mode, with the K5 dots in each precision) and joint_acc against
their plain versions; K1, K2, K3 and K4 on the band of nonzeros against
the same kernel forced dense, bit for bit; the batched K1/K2 against the
unbatched ones and the parallel kernels against the sequential ones, bit
for bit; K1/K2 with one transition configuration per sequence (bands of
mixed widths padded to the widest) and the norm-only K1 against their
plain versions and, bit for bit, against the unbatched kernels under each
configuration alone; K3/K4 with a validity bound n_valid other than T
(the time shards of ``parallel/spmd.py``), with a failing control; K2
with the prior recomputed (the 'filter' memory modes) against its plain
version, against K2 on K1's priors and band against dense, and the
'checkpoint' mode's peak memory against full mode's.  Also
``bf16_gemm`` (the emission and statistics products at the matmul
precisions 'high' and 'default') against its plain version, with its
one-pass control, its rows and batch entries alone bit for bit, and the
knob's products routed to it.  Also
the card's side of the ingestion layer: the naive-Bayes baseline decoders
on the card against their CPU float64 run, and the native spike binner
built in the card machine's environment against the numpy binner.

Imports no jax, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Without a CUDA card every test here skips: the kernels have no interpret
mode, and their plain versions are held against JAX in
``test_torch_scan_kernels.py`` and ``test_torch_parallel_scan.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu_torch.ops import band as bd  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import hmm  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import precision  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk  # noqa: E402
from poor_man_gplvm_tpu_torch.testing import (  # noqa: E402
    JOINT_ACC_ENTRY_RTOL,
    SCAN_CASES,
    SCAN_TOLERANCES,
    band_vs_dense,
    batch_vs_single,
    bf16_gemm_case,
    bf16_gemm_rows_alone,
    bf16_gemm_rtol,
    bf16_gemm_vs_plain,
    config_batch_vs_single,
    joint_acc_vs_plain,
    kernel_vs_plain,
    memory_mode_peaks,
    pscan_failures,
    pscan_inputs,
    pscan_nvalid_failures,
    pscan_nvalid_vs_plain,
    pscan_vs_plain,
    scan_case,
    smoother_push_vs,
    subnormal_prior_smoothers,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("L", [100, 500])
def test_kernels_match_plain(cuda, L, n_dyn, case):
    err = kernel_vs_plain(scan_case(L + n_dyn, 1001, L, n_dyn, case), cuda)
    torch.cuda.synchronize()
    for key, tol in SCAN_TOLERANCES.items():
        assert err[key] <= tol, (key, err)
    assert err["finite"], err
    assert err["masked_exact_zero"], err


def test_launch_counts(cuda):
    case = scan_case(0, 33, 40, 2, "jump")
    ll = torch.as_tensor(case["ll"], device=cuda)
    tlat = torch.as_tensor(case["tlat"], device=cuda)
    tdyn = torch.as_tensor(case["tdyn"], device=cuda)
    init = torch.as_tensor(case["p_init"], device=cuda)
    f0, s0 = sk.filter_scan.launches, sk.smoother_scan.launches
    post, prior, _ = sk.filter_chunk(ll, tlat, tdyn, init, 1.0)
    assert sk.filter_scan.launches == f0 + 1
    # a T=1 sequence hands the smoother zero rows: nothing is launched
    smooth, r = sk.smoother_chunk(post[:0], prior[:0], tlat, tdyn, post[-1])
    assert smooth.shape == (0, 2, 40) and sk.smoother_scan.launches == s0
    sk.smoother_chunk(post[:-1], prior[1:], tlat, tdyn, post[-1])
    torch.cuda.synchronize()
    assert sk.smoother_scan.launches == s0 + 1


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("L", [100, 500])
def test_batched_kernels_equal_unbatched(cuda, L, n_dyn, case):
    # one block per sequence, ragged lengths with a 1-bin sequence and an
    # odd longest one: each sequence's rows equal the unbatched kernel's on
    # that sequence alone bit for bit, and *_batch_plain to f32 rounding
    err = batch_vs_single(scan_case(L + n_dyn, 300, L, n_dyn, case), cuda)
    torch.cuda.synchronize()
    assert err["equal_single"], err
    for key in ("post_abs", "prior_abs", "smooth_abs", "r_rel"):
        assert err[key] <= SCAN_TOLERANCES[key], (key, err)
    assert err["norm_rel"] <= 1e-5, err
    assert err["finite"] and err["masked_exact_zero"], err


def test_batch_launch_counts_and_bad_inputs(cuda):
    E, Tmax, L = 3, 6, 40
    c = scan_case(1, E * Tmax, L, 2, "jump")
    tlat = torch.as_tensor(c["tlat"], device=cuda)
    tdyn = torch.as_tensor(c["tdyn"], device=cuda)
    ll = torch.as_tensor(c["ll"], device=cuda).view(E, Tmax, L)
    init = torch.as_tensor(c["p_init"], device=cuda).expand(E, 2, L)
    lengths = torch.tensor([6, 1, 4], dtype=torch.int32, device=cuda)
    f0, s0 = sk.filter_scan_batch.launches, sk.smoother_scan_batch.launches
    u0 = sk.filter_scan.launches
    post, prior, ratios = sk.filter_chunk_batch(ll, tlat, tdyn, init, lengths,
                                                1.0)
    last = post[torch.arange(E, device=cuda), (lengths - 1).long()]
    smooth, r = sk.smoother_chunk_batch(post[:, :-1], prior[:, 1:], tlat,
                                        tdyn, last, lengths - 1)
    torch.cuda.synchronize()
    assert sk.filter_scan_batch.launches == f0 + 1
    assert sk.smoother_scan_batch.launches == s0 + 1
    assert sk.filter_scan.launches == u0  # the batch is not the unbatched
    assert smooth.shape == r.shape == (E, Tmax - 1, 2, L)
    assert bool((ratios[1, 1:] == 0).all())  # past a sequence's length
    # all sequences of one bin: nothing to smooth over, nothing launched
    one = torch.ones(E, dtype=torch.int32, device=cuda)
    sm, _ = sk.smoother_chunk_batch(post[:, :0], prior[:, :0], tlat, tdyn,
                                    post[:, 0], one - 1)
    assert sm.shape == (E, 0, 2, L)
    assert sk.smoother_scan_batch.launches == s0 + 1

    w = torch.rand(E, Tmax, L, device=cuda)
    flags = (False, True)
    args = (tlat, tdyn, init.contiguous())
    with pytest.raises(TypeError, match="int32"):
        sk.filter_scan_batch(w, *args, lengths.long(), flags)
    with pytest.raises(ValueError, match="every length"):  # > Tmax
        sk.filter_scan_batch(w, *args, lengths + 1, flags)
    with pytest.raises(ValueError, match="every length"):  # length 0
        sk.filter_scan_batch(w, *args, lengths - 1, flags)
    with pytest.raises(ValueError, match="lengths is on"):
        sk.filter_scan_batch(w, *args, lengths.cpu(), flags)
    with pytest.raises(ValueError, match="shape"):
        sk.filter_scan_batch(w, *args, lengths[:2].contiguous(), flags)
    with pytest.raises(ValueError, match="contiguous"):
        sk.filter_scan_batch(w.transpose(1, 2).contiguous().transpose(1, 2),
                             *args, lengths, flags)
    filt, pri = post[:, :-1], prior[:, 1:]
    tlat_t = tlat.transpose(-1, -2).contiguous()
    with pytest.raises(ValueError, match="every length"):  # negative
        sk.smoother_scan_batch(filt, pri, tlat_t, tdyn, last, lengths - 2,
                               flags)
    with pytest.raises(ValueError, match="every length"):  # > Tmax - 1
        sk.smoother_scan_batch(filt, pri, tlat_t, tdyn, last, lengths, flags)


def test_wrappers_reject_bad_inputs(cuda):
    w = torch.rand(5, 8, device=cuda)
    tlat = torch.rand(1, 8, 8, device=cuda)
    tdyn = torch.ones(1, 1, device=cuda)
    init = torch.rand(1, 8, device=cuda)
    with pytest.raises(TypeError):
        sk.filter_scan(w.double(), tlat, tdyn, init, (False,))
    with pytest.raises(ValueError):
        sk.filter_scan(w, tlat.transpose(1, 2), tdyn, init, (False,))
    with pytest.raises(ValueError):
        sk.filter_scan(w, tlat, tdyn.cpu(), init, (False,))
    big = torch.rand(2, 1100, device=cuda)
    with pytest.raises(ValueError):
        sk.filter_scan(big, torch.rand(1, 1100, 1100, device=cuda), tdyn,
                       torch.rand(1, 1100, device=cuda), (False,))


def _assert_pscan(err, scan_prec="highest"):
    # whole passes, the one-step check and the boolean checks
    assert pscan_failures(err, scan_prec) == [], err


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("L", [100, 500])
def test_pscan_kernels_match_plain(cuda, L, n_dyn, case):
    # odd T: the last chunk is ragged and T-1 falls inside it
    err = pscan_vs_plain(scan_case(L + n_dyn, 4001, L, n_dyn, case), cuda)
    torch.cuda.synchronize()
    _assert_pscan(err)


@pytest.mark.parametrize("scan_prec", ["bf16x3", "bf16"])
@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("L", [100, 500])
def test_pscan_precisions_match_plain(cuda, L, n_dyn, scan_prec):
    # K3/K4 in every mode with the K5 dots, masked bins, odd T
    err = pscan_vs_plain(scan_case(L + n_dyn, 4001, L, n_dyn, "masked"), cuda,
                         scan_prec=scan_prec)
    torch.cuda.synchronize()
    _assert_pscan(err, scan_prec)


@pytest.mark.parametrize("kern_prec, plain_prec", [
    ("bf16", "highest"), ("bf16", "bf16x3"), ("highest", "bf16"),
    ("bf16x3", "bf16"), ("bf16x3", "highest"),
])
@pytest.mark.parametrize("L", [100, 500])
def test_pscan_check_rejects_other_precision(cuda, L, kern_prec, plain_prec):
    # control: K3/K4 run in one precision fail the one-step check against
    # the plain versions in another
    err = pscan_vs_plain(scan_case(L + 2, 4001, L, 2, "masked"), cuda,
                         scan_prec=kern_prec, plain_prec=plain_prec, lean=True)
    torch.cuda.synchronize()
    bad = pscan_failures(err, kern_prec)
    assert any(k.startswith("step_") for k in bad), err


@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("L", [100, 500])
def test_joint_acc_matches_plain(cuda, L, n_dyn):
    err = joint_acc_vs_plain(L + n_dyn, 20_001, L, n_dyn, cuda)
    torch.cuda.synchronize()
    assert err["acc_entry_rel"] <= JOINT_ACC_ENTRY_RTOL, err
    assert err["repeatable"], err


@pytest.mark.parametrize("L", [100, 500])
def test_joint_acc_one_pass_control_fails(cuda, L):
    # control: the kernel's hi.hi-only instantiation (one TF32 product)
    # breaks the per-entry limit that 3xTF32 keeps
    err = joint_acc_vs_plain(L + 2, 20_001, L, 2, cuda, passes=1)
    torch.cuda.synchronize()
    assert err["acc_entry_rel"] > JOINT_ACC_ENTRY_RTOL, err


@pytest.mark.parametrize("scan_prec", ["highest", "bf16x3", "bf16"])
@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("L", [100, 500])
def test_k4_band_equals_dense(cuda, L, n_dyn, scan_prec):
    # every mode on the band of the RBF channel (W = 21) and forced dense
    eq = band_vs_dense(scan_case(L + n_dyn, 4001, L, n_dyn, "masked"), cuda,
                       scan_prec)
    torch.cuda.synchronize()
    assert eq["band_equal_dense"], eq
    assert eq["finite"] and eq["masked_exact_zero"], eq
    assert eq["W"] == 21 and eq["W_dense"] == L, eq


@pytest.mark.parametrize("scan_prec", ["highest", "bf16x3", "bf16"])
@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("L", [100, 500])
def test_k1_k3_k2_band_equals_dense(cuda, L, n_dyn, case, scan_prec):
    # K3 finals-only and emit in every precision, K1 and K2 (f32 only) and
    # K4 on the band and forced dense: the RBF channel (W = 21), a dense channel
    # ('identical': W = L, the same code) and a lone constant channel (no
    # band at all)
    eq = band_vs_dense(scan_case(L + n_dyn, 4001, L, n_dyn, case), cuda,
                       scan_prec)
    torch.cuda.synchronize()
    by_mode = eq["equal_by_mode"]
    assert by_mode["k3_finals"] and by_mode["k3_emit"], eq
    assert by_mode.get("k1", scan_prec != "highest"), eq
    assert by_mode.get("k2", scan_prec != "highest"), eq
    assert eq["band_equal_dense"], eq
    assert eq["finite"] and eq["masked_exact_zero"], eq
    want_W = L if case == "identical" else (
        0 if (n_dyn, case) == (1, "jump") else 21)
    assert (eq["W"], eq["W_dense"]) == (want_W, L if want_W else 0), eq


def _tensors(case, dev):
    t = {k: torch.as_tensor(v, device=dev) for k, v in case.items()
         if k != "masked"}
    t["flags"] = sk._detect_uniform_rows(t["tlat"])
    t["tlat_t"] = t["tlat"].transpose(-1, -2).contiguous()
    t["w"] = torch.exp(t["ll"] - t["ll"].amax(dim=1, keepdim=True)
                       ).contiguous()
    return t


@pytest.mark.parametrize("case", ["jump", "masked"])
@pytest.mark.parametrize("L", [100, 500])
def test_parallel_kernels_bit_identical_to_sequential(cuda, L, case):
    # from the sequential kernels' own rows as boundary carries, K3 gives
    # K1's posteriors and normalisers and K4 gives K2's smoothed posteriors
    # and ratios, bit for bit: K3's step is K1's, K4's recomputed prior is
    # K1's (r = carry / prior), K4's pull is K2's
    T, C = 5001, 16
    tc = -(-T // C)
    t = _tensors(scan_case(L, T, L, 2, case), cuda)
    post, prior, s = sk.filter_scan(t["w"], t["tlat"], t["tdyn"],
                                    t["p_init"], t["flags"])
    sm_seq, r_seq = sk.smoother_scan(
        post[:-1].contiguous(), prior[1:].contiguous(), t["tlat_t"],
        t["tdyn"], post[-1].contiguous(), t["flags"])
    ins = torch.cat([t["p_init"][None],
                     post[torch.arange(1, C, device=cuda) * tc - 1]])
    post_k, norm_k, _ = ps.pfilter_pass(t["w"], t["tlat"], t["tdyn"],
                                        ins.contiguous(), tc, t["flags"],
                                        True)
    assert torch.equal(post_k, post)
    assert torch.equal(norm_k, s.clamp_min(1e-38))
    sm_full = torch.cat([sm_seq, post[-1:]])
    rows = (torch.arange(1, C + 1, device=cuda) * tc).clamp(max=T - 1)
    sm_k, r_k, _ = ps.psmooth_pass(post, t["tlat"], t["tlat_t"], t["tdyn"],
                                   sm_full[rows].contiguous(), tc,
                                   t["flags"], "full")
    torch.cuda.synchronize()
    assert torch.equal(sm_k, sm_full)
    assert torch.equal(r_k[:-1], r_seq) and bool((r_k[-1] == 0).all())


def test_k1_k2_band_raises_on_the_card_and_is_made_once(cuda, monkeypatch):
    t = _tensors(scan_case(3, 230, 40, 2, "jump"), cuda)
    args_f = (t["w"], t["tlat"], t["tdyn"], t["p_init"], t["flags"])
    post, prior, _ = sk.filter_scan(*args_f)
    args = (post[:-1].contiguous(), prior[1:].contiguous(), t["tlat_t"],
            t["tdyn"], post[-1].contiguous(), t["flags"])
    band = bd.transition_band(t["tlat"], t["tlat_t"], t["flags"])
    cpu_band = bd.transition_band(t["tlat"].cpu(), t["tlat_t"].cpu(),
                                  t["flags"])
    for kern, a in ((sk.filter_scan, args_f), (sk.smoother_scan, args)):
        want = kern(*a)
        got = kern(*a, band=band)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
        with pytest.raises(ValueError, match="band does not match"):
            kern(*a, band=band._replace(W=band.W - 1))
        with pytest.raises(ValueError, match="band does not match"):
            kern(*a, band=cpu_band)
    # a sequential decode over 7 host chunks: one band for both kernels, 7
    # launches of each
    calls = []
    real = bd.band_windows
    monkeypatch.setattr(bd, "band_windows",
                        lambda mats: calls.append(1) or real(mats))
    trans = hmm.JointTransition(Tdyn=t["tdyn"], Tlat=t["tlat"],
                                logTdyn=t["tdyn"].log(),
                                logTlat=t["tlat"].log())
    y = torch.poisson(torch.full((230, 5), 1.5, device=cuda))
    tuning = torch.rand(40, 5, device=cuda) + 0.5
    f0, s0 = sk.filter_scan.launches, sk.smoother_scan.launches
    out = hmm.smooth_combined_chunked(
        y, tuning, {}, trans, torch.ones(5, device=cuda),
        torch.ones(40, device=cuda), engine="cuda", n_time_per_chunk=37)
    torch.cuda.synchronize()
    assert len(calls) == 1 and sk.smoother_scan.launches == s0 + 7
    assert sk.filter_scan.launches == f0 + 7
    assert bool(torch.isfinite(out[0]).all())
    # and a batch of epochs on the same transition object: no further band
    lat, lml = hmm.smooth_epochs(
        y.view(10, 23, 5), torch.full((10,), 23), tuning, {}, trans,
        torch.ones(5, device=cuda), engine="cuda")
    torch.cuda.synchronize()
    assert len(calls) == 1
    assert bool(torch.isfinite(lat).all() and torch.isfinite(lml).all())


def test_pscan_kernels_empty_chunks(cuda):
    # 64 chunks of 2 rows over T=101: chunks 51..63 hold no row at all
    err = pscan_vs_plain(scan_case(5, 101, 40, 2, "masked"), cuda, C=64)
    torch.cuda.synchronize()
    _assert_pscan(err)


#: K3/K4 with a shard-local validity bound: T odd, so the last chunk is
#: ragged; n_valid 0 and 1 (a shard past, or at, the sequence's last row),
#: T - 3 (inside the last chunk), T (the default) and T + 1 (K4 only: every
#: row recurses, the last from its chunk's carry)
NV_T = 4001
NV_CASES = (0, 1, NV_T - 3, NV_T, NV_T + 1)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("nv", NV_CASES)
@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("L", [100, 500])
def test_pscan_n_valid_matches_plain(cuda, L, n_dyn, nv, dense):
    bd.set_band_override(dense)
    try:
        err = pscan_nvalid_vs_plain(
            scan_case(L + n_dyn, NV_T, L, n_dyn, "masked"), cuda, nv)
        torch.cuda.synchronize()
    finally:
        bd.set_band_override(False)
    assert not pscan_nvalid_failures(err, "highest"), err


@pytest.mark.parametrize("scan_prec", ["bf16x3", "bf16"])
@pytest.mark.parametrize("nv", [NV_T - 3, NV_T + 1])
def test_pscan_n_valid_precisions_match_plain(cuda, nv, scan_prec):
    err = pscan_nvalid_vs_plain(scan_case(502, NV_T, 500, 2, "masked"), cuda,
                                nv, scan_prec)
    torch.cuda.synchronize()
    assert not pscan_nvalid_failures(err, scan_prec), err


@pytest.mark.parametrize("nv", [1, NV_T - 3, NV_T + 1])
@pytest.mark.parametrize("L", [100, 500])
def test_pscan_n_valid_check_rejects_another_bound(cuda, L, nv):
    # control: the kernels at one bound fail against the plain versions at
    # another
    err = pscan_nvalid_vs_plain(scan_case(L + 2, NV_T, L, 2, "masked"), cuda,
                                nv, plain_n_valid=NV_T // 2)
    torch.cuda.synchronize()
    assert pscan_nvalid_failures(err, "highest"), err


def test_pscan_n_valid_launch_counts_and_range(cuda):
    a = pscan_inputs(scan_case(0, 301, 40, 2, "jump"), cuda)
    args = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
    ps.reset_launches()
    post, _, _ = ps.pfilter_pass(*args, emit=True, n_valid=300)
    ps.pfilter_pass(*args, emit=False, n_valid=301)
    bwd = (post, a["tlat"], a["tlat_t"], a["tdyn"], a["ins"], a["tc"],
           a["flags"])
    ps.psmooth_pass(*bwd, "full", n_valid=302)
    ps.psmooth_pass(*bwd, "finals", n_valid=301)
    torch.cuda.synchronize()
    assert ps.pfilter_pass.launches_by_mode == {
        "emit/highest": 1, "emit/highest/nv": 1, "finals/highest": 1}
    assert ps.psmooth_pass.launches_by_mode == {
        "full/highest": 1, "full/highest/nv": 1, "finals/highest": 1}
    for nv in (-1, 302):
        with pytest.raises(ValueError, match="n_valid"):
            ps.pfilter_pass(*args, emit=False, n_valid=nv)
    for nv in (-1, 303):
        with pytest.raises(ValueError, match="n_valid"):
            ps.psmooth_pass(*bwd, "finals", n_valid=nv)


def test_pscan_launch_counts_and_bad_inputs(cuda):
    a = pscan_inputs(scan_case(0, 301, 40, 2, "jump"), cuda)
    args = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
    ps.reset_launches()
    post, _, _ = ps.pfilter_pass(*args, emit=True)
    ps.psmooth_pass(post, a["tlat"], a["tlat_t"], a["tdyn"], a["ins"],
                    a["tc"], a["flags"], "finals")
    ps.psmooth_pass(post, a["tlat"], a["tlat_t"], a["tdyn"], a["ins"],
                    a["tc"], a["flags"], "marginal_acc", "bf16x3")
    torch.cuda.synchronize()
    assert ps.pfilter_pass.launches_by_mode == {"emit/highest": 1}
    assert ps.psmooth_pass.launches == 2
    assert ps.psmooth_pass.launches_by_mode == {
        "finals/highest": 1, "marginal_acc/bf16x3": 1}
    assert ps.joint_acc.launches == 1
    with pytest.raises(ValueError):  # chunks do not cover T
        ps.pfilter_pass(*args[:4], 1, a["flags"], emit=False)
    with pytest.raises(ValueError):
        ps.pfilter_pass(a["w"], a["tlat"], a["tdyn"], a["ins"][:, :1],
                        a["tc"], a["flags"], emit=False)
    with pytest.raises(TypeError):
        ps.psmooth_pass(post.double(), a["tlat"], a["tlat_t"], a["tdyn"],
                        a["ins"], a["tc"], a["flags"], "full")


@pytest.mark.parametrize("L", [100, 500])
def test_parallel_engine_matches_sequential(cuda, L):
    case = scan_case(L, 20_001, L, 2, "jump")
    t = {k: torch.as_tensor(v, device=cuda) for k, v in case.items()
         if k != "masked"}
    trans = hmm.JointTransition(Tdyn=t["tdyn"], Tlat=t["tlat"],
                                logTdyn=t["tdyn"].log(),
                                logTlat=t["tlat"].log())
    par = ps.smooth_parallel(t["ll"], t["tlat"], t["tdyn"], t["p_init"],
                             1.0, uniform_rows=trans.uniform_rows,
                             want_post=True)
    post, prior, ratios = trans.cuda_filter(t["ll"], t["p_init"], 1.0)
    smooth, _ = trans.cuda_smooth(post[:-1], prior[1:], post[-1])
    torch.cuda.synchronize()
    lml, lml_seq = float(par[1]), float(ratios.double().sum())
    assert abs(lml - lml_seq) <= 1e-5 * abs(lml_seq)
    assert float((par[2] - post).abs().max()) <= 1e-4
    assert float((par[0][:-1] - smooth).abs().max()) <= 1e-4


def test_subnormal_prior_gives_a_zero_ratio(cuda):
    """K2 and K4 on a prior with a subnormal entry under a carry of normal
    size: r = 0 there (``scan_common.cuh::kPriorFloor``), the row finite and
    equal to the plain versions'."""
    outs, _ = subnormal_prior_smoothers(cuda)
    want, _ = subnormal_prior_smoothers("cpu")
    torch.cuda.synchronize()
    for name, (sm, r) in outs.items():
        sm, r = sm.cpu(), r.cpu()
        assert bool(torch.isfinite(sm).all() and torch.isfinite(r).all()), name
        assert float(r[5]) == 0.0, name
        torch.testing.assert_close(sm, want[name][0], rtol=0, atol=1e-6)
        torch.testing.assert_close(r, want[name][1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["PoissonGPLVMJump1D", "GaussianGPLVM1D"])
def test_smooth_batch_full_matches_plain_and_each_sequence(cuda, name):
    """``hmm.smooth_batch_full`` (one K1 and one K2 launch for the batch)
    against its plain version, and each sequence bit for bit against the
    sequential decode of it alone."""
    import numpy as np

    import poor_man_gplvm_tpu_torch as pmt
    from poor_man_gplvm_tpu_torch.testing import (
        BATCH_FULL_TOLERANCES, batch_full_vs_plain, batch_full_vs_single,
    )

    kw = {"noise_std": 1.0} if name.startswith("Gaussian") else {}
    m = getattr(pmt, name)(30, n_latent_bin=60, tuning_lengthscale=5.0,
                           device=cuda, inference_engine="cuda", **kw)
    rng = np.random.default_rng(7)
    lat = np.clip(np.cumsum(rng.integers(-1, 2, size=(3, 301)), axis=1)
                  + 30, 0, 59)
    mean = m.tuning.cpu().numpy()[lat]
    y_b = rng.normal(mean, 1.0) if kw else rng.poisson(mean)
    f0 = sk.filter_scan_batch.launches
    s0 = sk.smoother_scan_batch.launches
    err = batch_full_vs_plain(m, y_b.astype(np.float32))
    assert sk.filter_scan_batch.launches == f0 + 1
    assert sk.smoother_scan_batch.launches == s0 + 1
    for key, tol in BATCH_FULL_TOLERANCES.items():
        assert err[key] <= tol, (key, err)
    assert batch_full_vs_single(m, y_b.astype(np.float32)) == []


@pytest.mark.parametrize("L, movement", [
    (500, (0.5, 1.0, 2.0, 4.0)),  # W = 11 ... 81 in one launch
    (100, (1.0, 4.0)),
])
def test_config_indexed_kernels_equal_each_configuration_alone(cuda, L,
                                                               movement):
    # odd lengths with a masked tail (shorter sequences in the batch), a
    # 1-bin and a 2-bin sequence; each sequence under its own configuration
    err = config_batch_vs_single(cuda, L=L, movement=movement)
    torch.cuda.synchronize()
    assert err["equal_single"], err
    assert err["norm_only_equal"], err
    assert err["shared_equal"], err
    for key in ("post_abs", "prior_abs", "smooth_abs", "r_rel"):
        assert err[key] <= SCAN_TOLERANCES[key], (key, err)
    assert err["norm_rel"] <= 1e-5 and err["finite"], err
    assert err["W"] == max(err["W_single"]), err
    if L == 500:
        assert err["W_single"] == [11, 21, 41, 81], err


def test_config_index_launch_counts_and_bad_inputs(cuda):
    from poor_man_gplvm_tpu_torch.testing import config_stack

    E, T, L = 4, 9, 40
    tlat, tdyn = config_stack(L, cuda, movement=(1.0, 2.0),
                              p_move_to_jump=(0.01, 0.02))
    flags = sk._detect_uniform_rows(tlat[0])
    w = torch.rand((E, T, L), device=cuda)
    init = torch.full((E, 2, L), 1.0 / (2 * L), device=cuda)
    lengths = torch.full((E,), T, dtype=torch.int32, device=cuda)
    cfg = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=cuda)
    sk.filter_scan_batch.launches_by_mode = {}
    sk.smoother_scan_batch.launches_by_mode = {}
    post, prior, _ = sk.filter_scan_batch(w, tlat, tdyn, init, lengths,
                                          flags, cfg=cfg)
    rows = sk.filter_scan_batch(w, tlat, tdyn, init, lengths, flags,
                                cfg=cfg, norm_only=True)
    assert rows[0] is None and rows[1] is None
    sk.smoother_scan_batch(post[:, :-1], prior[:, 1:],
                           tlat.transpose(-1, -2).contiguous(), tdyn,
                           post[:, -1].contiguous(), lengths - 1, flags,
                           cfg=cfg)
    torch.cuda.synchronize()
    assert sk.filter_scan_batch.launches_by_mode == {"cfg": 1, "norm": 1}
    assert sk.smoother_scan_batch.launches_by_mode == {"cfg": 1}
    for bad in (torch.tensor([0, 1, 2, 0], dtype=torch.int32, device=cuda),
                cfg.long(), cfg[:3], cfg.cpu()):
        with pytest.raises((ValueError, TypeError)):
            sk.filter_scan_batch(w, tlat, tdyn, init, lengths, flags,
                                 cfg=bad)
    with pytest.raises(ValueError):  # one stack is (n_dyn, L, L)
        sk.filter_scan_batch(w, tlat, tdyn, init, lengths, flags)


@pytest.mark.parametrize("kind", ["Poisson", "Gaussian"])
def test_bayes_decoders_on_the_card_equal_their_cpu_float64_run(cuda, kind):
    import numpy as np

    from poor_man_gplvm_tpu_torch import data as pdata

    rng = np.random.default_rng(0)
    K, N, T = 31, 60, 20_000
    Y = rng.integers(0, K, T)
    X = rng.poisson(rng.gamma(2.0, 1.0, (N, K))[:, Y]).astype(float)
    cls = getattr(pdata, f"{kind}BayesDecoder")
    card = cls(K).fit(torch.as_tensor(X, device=cuda),
                      torch.as_tensor(Y, device=cuda))
    lp = card.predict_log_probabilities(X)
    assert lp.is_cuda and lp.dtype == torch.float64
    ref = cls(K, device="cpu").fit(X, Y).predict_log_probabilities(X)
    assert torch.equal(torch.argmax(lp, dim=0).cpu(),
                       torch.argmax(ref, dim=0))
    assert float((lp.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-9
    assert card.predict(X).is_cuda


def test_native_binner_builds_in_the_card_environment(cuda):
    import numpy as np

    from poor_man_gplvm_tpu_torch import data as pdata
    from poor_man_gplvm_tpu_torch.data import native

    assert native.available()
    rng = np.random.default_rng(1)
    st = np.concatenate([rng.uniform(0, 200, 300_000),
                         np.arange(20_000) * 0.01])
    clu = rng.integers(0, 50, st.size)
    for kw in (dict(), dict(t_origin=0.5)):
        got = pdata.bin_spikes_sliding(st, clu, 0.01, 0.01, use_native=True,
                                       **kw)
        want = pdata.bin_spikes_sliding(st, clu, 0.01, 0.01,
                                        use_native=False, **kw)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    got = pdata.compute_spike_counts(st, clu, 0.05, 0.01, use_native=True)
    want = pdata.compute_spike_counts(st, clu, 0.05, 0.01, use_native=False)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("filt_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("n_dyn", [1, 2])
@pytest.mark.parametrize("L", [100, 500])
def test_smoother_push_matches_plain_and_k2(cuda, L, n_dyn, case,
                                            filt_dtype):
    """K2 with the prior recomputed, at an odd T (1,001 rows of K1, 1,000
    smoothed), with masked bins in the 'masked' case: within the K2
    tolerances of its plain version, bit for bit K2 on the priors K1
    wrote (f32 store), and on the band bit for bit forced dense."""
    err = smoother_push_vs(scan_case(L + n_dyn + 7, 1001, L, n_dyn, case),
                           cuda, getattr(torch, filt_dtype))
    torch.cuda.synchronize()
    for key in ("smooth_abs", "r_rel"):
        assert err[key] <= SCAN_TOLERANCES[key], (key, err)
    assert err["band_equal_dense"], err
    assert err["finite"] and err["masked_exact_zero"], err
    if filt_dtype == "float32":
        assert err["equal_k2"], err


def test_smoother_push_launch_counts(cuda):
    case = scan_case(1, 33, 40, 2, "jump")
    t = {k: torch.as_tensor(v, device=cuda) for k, v in case.items()
         if k != "masked"}
    flags = sk._detect_uniform_rows(t["tlat"])
    filt = torch.softmax(t["ll"], dim=1)[:, None].expand(33, 2, 40) / 2
    tlat_t = t["tlat"].transpose(-1, -2).contiguous()
    sk.smoother_push_scan.launches = 0
    sk.smoother_push_scan.launches_by_mode = {}
    for dtype in (torch.float32, torch.bfloat16):
        sk.smoother_push_scan(filt.to(dtype).contiguous(), t["tlat"],
                              tlat_t, t["tdyn"], t["p_init"], flags)
    sk.smoother_push_scan(filt[:0].contiguous(), t["tlat"], tlat_t,
                          t["tdyn"], t["p_init"], flags)  # nothing to do
    assert sk.smoother_push_scan.launches == 2
    assert sk.smoother_push_scan.launches_by_mode == {"f32": 1, "bf16": 1}
    with pytest.raises(TypeError):
        sk.smoother_push_scan(filt.half().contiguous(), t["tlat"], tlat_t,
                              t["tdyn"], t["p_init"], flags)


def test_checkpoint_peak_memory_below_full(cuda):
    """At T = 2e5, N = L = 500 in 8 chunks on the sequential engine,
    'checkpoint''s peak allocation stays below full mode's by at least the
    two (T, n_dyn, L) f32 arrays it does not keep (the filter posteriors
    and priors), and its posteriors are full mode's bits."""
    from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D

    T, NL, chunk = 200_000, 500, 25_000
    m = PoissonGPLVMJump1D(NL, n_latent_bin=NL, movement_variance=1,
                           tuning_lengthscale=10.0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    y = torch.poisson(m.tuning[torch.randint(0, NL, (T,), device=cuda,
                                             generator=g)] * 0.1,
                      generator=g)
    trans = m._make_transition({})[0]
    res = memory_mode_peaks(
        lambda mode: hmm.smooth_combined_chunked(
            y, m.tuning, {}, trans, m.ma_neuron_default, None,
            n_time_per_chunk=chunk, engine="cuda", memory_mode=mode),
        ("full", "checkpoint"))
    peaks = {mode: r[0] for mode, r in res.items()}
    outs = {mode: r[2] for mode, r in res.items()}
    dropped = 2 * T * 2 * NL * 4
    assert peaks["full"] - peaks["checkpoint"] >= dropped, peaks
    assert torch.equal(outs["full"][0], outs["checkpoint"][0])
    assert float(outs["full"][1]) == float(outs["checkpoint"][1])


# the emission (1e4 rows), one statistics chunk (2e4 rows) and the sweep's
# batched statistics (8 runs of 2e3 rows) at N = L = 500, cut in rows
GEMM_CASES = {"emission": (10_000, None), "statistics": (20_000, None),
              "batched": (2_000, 8)}


@pytest.mark.parametrize("kind", list(GEMM_CASES))
@pytest.mark.parametrize("level", ["high", "default"])
def test_bf16_gemm_matches_plain(cuda, level, kind):
    rows, batch = GEMM_CASES[kind]
    a, b = bf16_gemm_case(kind, rows, 500, 500, cuda, 3, batch=batch)
    err = bf16_gemm_vs_plain(a, b, level)
    assert err <= bf16_gemm_rtol(a.shape[-1]), err
    if batch:
        assert bf16_gemm_rows_alone(a, b, level, entry=5)
    else:
        assert bf16_gemm_rows_alone(a, b, level, rows=slice(37, 301))


def test_bf16_gemm_one_pass_control_fails(cuda):
    a, b = bf16_gemm_case("emission", 10_000, 500, 500, cuda, 4)
    assert bf16_gemm_vs_plain(a, b, "high") <= bf16_gemm_rtol(500)
    assert bf16_gemm_vs_plain(a, b, "high", passes=1) > bf16_gemm_rtol(500)


@pytest.mark.parametrize("level", ["high", "default"])
def test_matmul_at_a_lower_level_launches_bf16_gemm(cuda, level):
    """The knob's products on a CUDA tensor reach the kernel: one launch
    per product (an emission, the statistics, the batched statistics), the
    plain version's bits within the limit; 'highest' launches nothing."""
    from poor_man_gplvm_tpu_torch.ops import emissions, mstep

    rng = torch.Generator(device=cuda).manual_seed(0)
    y = torch.poisson(torch.rand((3_000, 40), generator=rng, device=cuda)
                      * 3, generator=rng)
    tuning = 0.1 + torch.rand((30, 40), generator=rng, device=cuda)
    lp = torch.log_softmax(torch.rand((3_000, 30), generator=rng,
                                      device=cuda), dim=-1)
    ones = torch.ones(40, device=cuda)
    keep = torch.ones(30, device=cuda)
    precision.reset_launches()
    em_hi = emissions.poisson_loglik(y, tuning, ones, keep)
    assert precision.bf16_gemm.launches == 0
    with precision.level(level):
        em_lo = emissions.poisson_loglik(y, tuning, ones, keep)
        mstep.get_statistics(lp, y)
        mstep.get_statistics_batch(torch.stack([lp, lp]), y)
    torch.cuda.synchronize()
    assert precision.bf16_gemm.launches == 3
    assert precision.bf16_gemm.launches_by_mode == {level: 3}
    assert not torch.equal(em_lo, em_hi)
