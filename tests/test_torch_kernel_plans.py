"""The launch plans and orders of sums of the two Hopper redesigns of K2
with the prior recomputed and ``joint_acc``, on the CPU.

Both kernels run only on the card; what decides their launch and their
bits is held here without one:

* ``scan_kernels.push_plan``, the Python mirror of the plan that
  ``csrc/scan_kernels.cu::push_plan_of`` makes: a cluster of
  two blocks (one consumer thread per latent column running K2's step; a
  producer block forming the priors a ring of S rows ahead) at every L, no
  threshold; threads, blocks, S and residency over L in {1, 2, 100, 101,
  500, 896, 1024}, W in {21, 81, L} and both stores (f32, bf16);
* the producer's column order for a constant channel: the producer block
  sums the same warps of 32 columns with ``warp_sum``'s butterfly and adds
  the warps' partials in ascending order, K1's tree, so its row sum is
  K1's bit for bit (a numpy model, beside a warpgroup that took each
  consumer warp w in its warp w % 4 and a contiguous split of the columns
  that is not K1's tree);
* the prior's reciprocal code (f64 reciprocal, -p, or 0) gives K2's ratio
  in each of K2's three branches;
* a numpy model of ``joint_acc``'s order on ``wgmma`` (TF32 split, each
  32-row stage's three products in a fresh sum, the stages added in f32,
  the split-K slices of ``parallel_scan._acc_slices`` added in order)
  within ``testing.JOINT_ACC_ENTRY_RTOL`` per entry of a float64 product
  and of the JAX package's marginal+acc joint on the CPU (its pure-JAX
  reference, as its own tests run it off the TPU), with the one-product
  control outside the limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu.ops.pallas import parallel_scan as jps  # noqa: E402
from poor_man_gplvm_tpu_torch import testing as tt  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk  # noqa: E402

LS = (1, 2, 100, 101, 500, 896, 1024)


# ---------------------------------------------------------------------------
# the launch plan of K2 with the prior recomputed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("wkind", ["21", "81", "L"])
@pytest.mark.parametrize("L", LS)
def test_push_plan(L, wkind, bf16):
    """For one RBF channel beside the jump channel (n_dyn 2, one band),
    both non-constant (n_dyn 2, two bands) and a latent-only model (n_dyn
    1): a cluster of two blocks, each of one thread per latent column
    (within the card's 1,024), at every L (no threshold: the producer has
    a block of its own); both halves of the band resident exactly where
    the layout with them fits at 2 stages; the most stages (2-4) that fit;
    the shared memory within the cap."""
    W = min(L, {"21": 21, "81": 81, "L": L}[wkind])
    fb = 2 if bf16 else 4
    for n_dyn, n_mat in ((2, 1), (2, 2), (1, 1)):
        p = sk.push_plan(n_dyn, n_mat, L, W, bf16)
        assert p["cluster"] == 2
        assert p["threads"] == -(-L // 32) * 32 >= L
        assert p["threads"] <= 1024 and p["threads"] % 32 == 0
        fits = sk.push_cluster_bytes(n_dyn, n_mat, L, W, fb, 2, True) <= \
            sk.RESIDENT_CAP
        assert p["resident"] == fits
        ok = [S for S in (2, 3, 4) if sk.push_cluster_bytes(
            n_dyn, n_mat, L, W, fb, S, p["resident"]) <= sk.RESIDENT_CAP]
        assert p["stages"] == max(ok)
        assert p["smem"] == sk.push_cluster_bytes(
            n_dyn, n_mat, L, W, fb, p["stages"], p["resident"])
        assert p["smem"] <= sk.RESIDENT_CAP


def test_push_plan_main_path_and_edges():
    """The 'filter' decode's chunk (n_dyn 2, one RBF band W = 21, L = 500)
    keeps both halves resident with 4 stages, f32 and bf16 stores; L =
    1,024 (the widest the kernels take) still runs one consumer thread per
    column; a dense channel at L = 500 (both halves 1 MB) reads the band
    from L2; no band at all (the latent-only jump case) is resident
    trivially."""
    for bf16 in (False, True):
        p = sk.push_plan(2, 1, 500, 21, bf16)
        assert (p["stages"], p["threads"], p["resident"]) == (4, 512, True)
    p = sk.push_plan(2, 1, 1024, 21, False)
    assert p["threads"] == 1024 and p["resident"] and p["stages"] >= 2
    p = sk.push_plan(2, 1, 500, 500, False)
    assert not p["resident"] and p["stages"] == 4
    p = sk.push_plan(1, 0, 1024, 0, False)
    assert p["resident"] and p["stages"] == 4


# ---------------------------------------------------------------------------
# the producer's column order for a constant channel
# ---------------------------------------------------------------------------


def _warp_sum(v):
    """``scan_common.cuh::warp_sum`` over 32 lanes in float32: the
    butterfly v += shfl_xor(v, o), o = 16, 8, 4, 2, 1 (every lane ends with
    the same bits)."""
    v = v.astype(np.float32).copy()
    idx = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[idx ^ o]).astype(np.float32)
    assert (v == v[0]).all()
    return v[0]


def _row_sum(partials):
    s = np.float32(0.0)
    for x in partials:
        s = np.float32(s + x)
    return s


def _k1_sum(q):
    """K1: thread j (warp j // 32, lane j % 32) holds q[j]; lane 0 of each
    warp stores its warp_sum; the partials are added in ascending warp
    order from 0."""
    nwarp = -(-len(q) // 32)
    qq = np.zeros(nwarp * 32, np.float32)
    qq[:len(q)] = q
    return _row_sum([_warp_sum(qq[32 * w:32 * w + 32]) for w in range(nwarp)])


def _producer_sum(q, threads):
    """The producer block of ``threads`` threads (the plan's): thread j
    holds column j's mixed value (0 past L), lane 0 of each warp stores
    its warp_sum, and the partials of all the block's warps are added in
    ascending order from 0."""
    qq = np.zeros(threads, np.float32)
    qq[:len(q)] = q
    return _row_sum([_warp_sum(qq[32 * w:32 * w + 32])
                     for w in range(threads // 32)])


def _warpgroup_sum(q, producers=4):
    """A producer warpgroup beside the consumers (the first design tried):
    its warp pw takes the consumers' warps w = pw, pw + 4, ... in turn,
    lane l column 32 w + l, storing warp w's partial; every producer
    thread then adds partials 0 .. nwarp - 1."""
    nwarp = -(-len(q) // 32)
    red = np.full(nwarp, np.nan, np.float32)
    for pw in range(producers):
        for w in range(pw, nwarp, producers):
            cols = 32 * w + np.arange(32)
            lane_vals = np.where(cols < len(q), q[np.minimum(cols,
                                                             len(q) - 1)], 0)
            red[w] = _warp_sum(lane_vals)
    assert not np.isnan(red).any()
    return _row_sum(red)


def _contiguous_sum(q, producers=4):
    """A producer that gives each of its 128 threads a contiguous run of
    columns: not K1's tree."""
    n = -(-len(q) // 128)
    qq = np.zeros(128 * n, np.float32)
    qq[:len(q)] = q
    per_thread = [_row_sum(qq[n * i:n * i + n]) for i in range(128)]
    return _row_sum([_warp_sum(np.array(per_thread[32 * w:32 * w + 32]))
                     for w in range(producers)])


@pytest.mark.parametrize("L", [1, 2, 33, 100, 101, 500, 896, 1024])
def test_producer_row_sum_is_k1s_tree(L):
    """On seeded mixed rows (a posterior's scale, a jump channel's share)
    the producer block's row sum of a constant channel, at the plan's
    block size, equals K1's bit for bit; so does the interleaved
    assignment a producer warpgroup would take."""
    rng = np.random.default_rng(L)
    threads = sk.push_plan(1, 0, L, 0, False)["threads"]
    for _ in range(20):
        q = (rng.dirichlet(np.ones(L)) * rng.uniform(1e-3, 1.0)).astype(
            np.float32)
        assert _producer_sum(q, threads) == _k1_sum(q)
        assert _warpgroup_sum(q) == _k1_sum(q)


def test_contiguous_columns_break_k1s_tree():
    """The control: a split of the columns into contiguous runs per thread
    gives other bits than K1 on some rows (which would break K2 push's
    bit-equality with K2 on K1's priors)."""
    rng = np.random.default_rng(0)
    differ = 0
    for _ in range(50):
        q = rng.dirichlet(np.ones(500)).astype(np.float32)
        differ += _contiguous_sum(q) != _k1_sum(q)
    assert differ > 0


def test_prior_code_gives_k2s_ratio():
    """The consumer's ratio from the producer's code (rcp_f64(p) where
    FLT_MIN <= p < 2, -p where p >= 2, 0 below FLT_MIN or NaN) takes K2's
    branch for each prior: the f64 reciprocal's product (the f32 quotient,
    ``test_torch_scan_kernels``' model), an f32 division, or 0."""
    tiny = np.float32(sk.PRIOR_FLOOR)

    def code(p):
        if not p >= tiny:
            return 0.0
        return 1.0 / float(p) if p < 2 else -float(p)

    def from_code(carry, c):
        if c > 0:
            return np.float32(float(carry) * c)
        if c < 0:
            return np.float32(carry / np.float32(-c))
        return np.float32(0.0)

    def k2(carry, p):
        if not p >= tiny:
            return np.float32(0.0)
        return np.float32(carry / p)

    carry = np.float32(0.37)
    for p in (np.float32(0.25), np.float32(3e-30), tiny, np.float32(1e-39),
              np.float32(0.0), np.float32(2.0), np.float32(7.5),
              np.float32(np.nan), np.float32(np.inf)):
        assert from_code(carry, code(p)) == k2(carry, p), p


# ---------------------------------------------------------------------------
# joint_acc's order of sums on wgmma
# ---------------------------------------------------------------------------


def _tf32(x):
    """``parallel_scan.cu::to_tf32``: round to nearest (ties away) onto
    the top 10 mantissa bits, in integer operations."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def joint_acc_model(post, r, passes=3):
    """The kernel's order: per split-K slice (``_acc_slices``), per 32-row
    stage one fresh sum of the stage's TF32 products (lo.hi + hi.lo +
    hi.hi, or hi.hi alone), modelled exact and rounded to f32, added to
    the slice's f32 sum; the slices added in order.  (n_dyn, n_dyn, L,
    L) float32."""
    T, n_dyn, L = post.shape
    M = n_dyn * L
    a = post.reshape(T, M).astype(np.float32)
    b = r.reshape(T, M).astype(np.float32)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    S, rows = ps._acc_slices(T, M)
    total = np.zeros((M, M), np.float32)
    for z in range(S):
        acc = np.zeros((M, M), np.float32)
        for t0 in range(z * rows, min(T, (z + 1) * rows), 32):
            sl = slice(t0, min(t0 + 32, (z + 1) * rows, T))
            part = ah[sl].T.astype(np.float64) @ bh[sl]
            if passes == 3:
                part += al[sl].T.astype(np.float64) @ bh[sl]
                part += ah[sl].T.astype(np.float64) @ bl[sl]
            acc = (acc + part.astype(np.float32)).astype(np.float32)
        total = (total + acc).astype(np.float32)
    return total.reshape(n_dyn, L, n_dyn, L).transpose(0, 2, 1, 3)


def _entry_rel(got, want):
    big = np.abs(want).max()
    where = np.abs(want) > tt.JOINT_ACC_FLOOR * big
    return float((np.abs(got - want)[where] / np.abs(want)[where]).max())


def _k4_inputs(seed, T, L, n_dyn):
    """``testing.joint_acc_vs_plain``'s inputs: posterior rows summing to 1,
    ratios around 1 with exact zeros."""
    rng = np.random.default_rng(seed)
    post = rng.dirichlet(np.ones(n_dyn * L), T).reshape(T, n_dyn, L)
    r = rng.gamma(2.0, 0.5, size=(T, n_dyn, L)) * (
        rng.random((T, n_dyn, L)) > 0.1)
    return post.astype(np.float32), r.astype(np.float32)


@pytest.mark.parametrize("T, L, n_dyn", [(20_001, 100, 2), (4_099, 37, 1),
                                         (33, 100, 2)])
def test_joint_acc_model_within_limit_of_float64(T, L, n_dyn):
    """The order stays within the per-entry limit of the float64 sum at the
    card tests' T = 20,001 (633 stages over 33 slices at M = 200), a
    ragged T with a partial last stage per slice and a short one; one
    TF32 product (the control) does not at T = 20,001."""
    post, r = _k4_inputs(L + n_dyn, T, L, n_dyn)
    want = np.einsum("tdi,tej->deij", post.astype(np.float64),
                     r.astype(np.float64))
    assert _entry_rel(joint_acc_model(post, r), want) <= \
        tt.JOINT_ACC_ENTRY_RTOL
    if T == 20_001:
        assert _entry_rel(joint_acc_model(post, r, passes=1), want) > \
            tt.JOINT_ACC_ENTRY_RTOL


def test_joint_acc_model_against_jax_marginal_acc():
    """The JAX package's marginal+acc pass off the TPU (its pure-JAX
    reference, as its own tests run it) on seeded K4-shaped inputs, one
    chunk: its pairwise joint against the model on its own ratios r (from
    the same pass in full mode), per entry within JOINT_ACC_ENTRY_RTOL,
    and both against float64."""
    T, L, n_dyn = 3_001, 60, 2
    post, _ = _k4_inputs(7, T, L, n_dyn)
    case = tt.scan_case(7, 2, L, n_dyn, "jump")
    tlat = case["tlat"]
    tlat_t = np.ascontiguousarray(np.swapaxes(tlat, -1, -2))
    ins = np.full((n_dyn, 1, L), 1.0 / (n_dyn * L), np.float32)
    kw = dict(C=1, block_t=T, tc_eff=T, n_valid=T + 1,
              uniform_rows=(False, True), finals_only=False)
    args = (jnp.asarray(post[:, :, None]), jnp.asarray(tlat),
            jnp.asarray(tlat_t), jnp.asarray(case["tdyn"]), jnp.asarray(ins))
    r = np.asarray(jps._psmooth_pass_ref(*args, marginal=False, **kw)[1])
    acc = np.asarray(jps._psmooth_pass_ref(*args, marginal=True,
                                           want_acc=True, **kw)[2])
    r = r[:, :, 0]
    model = joint_acc_model(post, r)
    want = np.einsum("tdi,tej->deij", post.astype(np.float64),
                     r.astype(np.float64))
    assert _entry_rel(model, acc) <= tt.JOINT_ACC_ENTRY_RTOL
    assert _entry_rel(acc, want) <= tt.JOINT_ACC_ENTRY_RTOL
    assert _entry_rel(model, want) <= tt.JOINT_ACC_ENTRY_RTOL


@pytest.mark.parametrize("T, M", [(1, 200), (31, 200), (20_001, 200),
                                  (100_000, 1_000), (100_000, 200),
                                  (300_000, 1_000)])
def test_acc_slices_cover_time_in_order(T, M):
    """The split-K slices cover [0, T) in order, each of at most
    ``_ACC_MAX_ROWS`` rows and at least one 32-row stage, with no more
    blocks than one wave of the card unless T needs more slices."""
    S, rows = ps._acc_slices(T, M)
    tiles = (-(-M // ps._ACC_TILE)) ** 2
    assert S >= 1 and S * rows >= T and (S - 1) * rows < T
    assert rows <= ps._ACC_MAX_ROWS
    assert S == 1 or rows >= ps._ACC_STAGE_ROWS or T < 2 * \
        ps._ACC_STAGE_ROWS
    assert S * tiles <= max(ps._ACC_SMS, tiles * -(-T // ps._ACC_MAX_ROWS))
