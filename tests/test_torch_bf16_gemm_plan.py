"""The launch plan of ``bf16_gemm`` (``ops/precision.py::gemm_plan``) and
its order of sums, on the CPU.

The kernel runs only on the card; what decides its bits is planned here in
plain Python and checked without one:

* the K segments of the split-K depend on K alone: the same for every M,
  N, batch and stride, cut at multiples of ``SEG_K`` from k = 0;
* the variant: TMA where A's base is 16-byte aligned and its other strides
  are positive multiples of 16 bytes (the north-star's N = L = 500), else
  cp.async (the pipeline's N = 490 and L = 101, a view at a 4-byte offset,
  a broadcast row, ``testing.padded_copy``);
* the kernel's order (per segment, per 32-wide slice a fresh sum added to
  the segment's running sum, the segments added in order), emulated in
  f32 by ``testing.bf16_gemm_emulate``, stays within
  ``testing.bf16_gemm_rtol(K)`` of max |a| @ |b| of ``matmul_plain`` and of
  the JAX package's ``_scan_dot`` at the same level, at a long K that is
  split and at short ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poor_man_gplvm_tpu.ops.pallas import parallel_scan as jps  # noqa: E402
from poor_man_gplvm_tpu_torch import testing as tt  # noqa: E402
from poor_man_gplvm_tpu_torch.ops import precision  # noqa: E402

torch.set_num_threads(1)

_MODE = {"high": "bf16x3", "default": "bf16"}
KS = (1, 31, 45, 500, 4096, 16384, 16385, 20017, 200_000)


def _plan(x, N):
    """``gemm_plan`` of x (M, K) or (B, M, K) against N columns."""
    x3 = x if x.ndim == 3 else x.unsqueeze(0)
    sa_b = x3.stride(0) if x3.shape[0] > 1 else 0
    return precision.gemm_plan(x3.shape[1], N, x3.shape[2], x3.shape[0],
                               (sa_b, x3.stride(1), x3.stride(2)),
                               x3.data_ptr())


@pytest.mark.parametrize("K", KS)
def test_segments_depend_on_k_alone(K):
    """Across M, N, batch, strides and addresses the plan's segments are
    ``k_segments(K)``: they cover [0, K) in order, cut at multiples of
    SEG_K, and there is one segment up to SPLIT_MIN_K."""
    want = precision.k_segments(K)
    assert want[0][0] == 0 and want[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(want, want[1:]))
    if K <= precision.SPLIT_MIN_K:
        assert want == [(0, K)]
    else:
        assert all(s % precision.SEG_K == 0 for s, _ in want)
        assert all(e - s == precision.SEG_K for s, e in want[:-1])
    for M, N, batch, strides, ptr in (
            (1, 1, 1, (0, K, 1), 0), (500, 500, 1, (0, K, 1), 0),
            (500, 490, 1, (0, 1, 500), 4), (101, 490, 64, (K * 101, 1, 101),
                                            16),
            (1_000_000, 500, 1, (0, K + 3, 1), 1 << 20),
            (7, 3, 5, (0, 3 * K, 3), 8)):
        plan = precision.gemm_plan(M, N, K, batch, strides, ptr)
        assert plan["segments"] == want
        assert plan["seg_k"] % precision.TILE[2] == 0
        assert -(-K // plan["seg_k"]) == len(want)
        assert plan["tile"] == precision.TILE


def _offset_view(shape):
    """A float32 tensor of ``shape`` whose base is 4 bytes past an
    allocation's (16-byte aligned) start."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1)[1:].view(shape)


CASES = {
    # name: (A, N, expected variant, expected k_fast)
    "emission y, N = 500": (lambda: torch.zeros(300, 500), 500, "tma",
                            True),
    "statistics post.T, L = 500": (lambda: torch.zeros(300, 500).T, 500,
                                   "tma", False),
    "batched post.T, L = 500": (lambda: torch.zeros(4, 300, 500)
                                .transpose(1, 2), 500, "tma", False),
    "pipeline emission y, N = 490": (lambda: torch.zeros(300, 490), 101,
                                     "cp_async", True),
    "pipeline statistics post.T, L = 101": (lambda: torch.zeros(300, 101).T,
                                            490, "cp_async", False),
    "a view at a 4-byte offset": (lambda: _offset_view((300, 500)), 500,
                                  "cp_async", True),
    "a broadcast row (ma)": (lambda: torch.broadcast_to(torch.zeros(500),
                                                        (300, 500)), 500,
                             "cp_async", True),
    "padded_copy of y": (lambda: tt.padded_copy(torch.zeros(300, 500)), 500,
                         "cp_async", True),
    "padded_copy of post.T": (lambda: tt.padded_copy(torch.zeros(300, 500)
                                                     .T), 500, "cp_async",
                              False),
    "padded_copy of a batch": (lambda: tt.padded_copy(
        torch.zeros(4, 300, 500).transpose(1, 2)), 500, "cp_async", False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_variant_follows_the_tma_rules(case):
    make, N, variant, k_fast = CASES[case]
    plan = _plan(make(), N)
    assert plan["variant"] == variant
    assert plan["a_kfast"] == k_fast


@pytest.mark.parametrize("layout", ["k_fast", "m_fast", "batched"])
def test_padded_copy_keeps_values_and_fast_axis(layout):
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(3, 40, 24)).astype(np.float32))
    x = {"k_fast": x[0], "m_fast": x[0].T, "batched": x.transpose(1, 2)}[
        layout]
    p = tt.padded_copy(x)
    assert torch.equal(p, x)
    fast = [i for i in range(x.ndim) if x.stride(i) == 1]
    assert [i for i in range(p.ndim) if p.stride(i) == 1] == fast
    assert p.data_ptr() != x.data_ptr()


def _operands(M, N, K, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.poisson(2.0, size=(K, N)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(6, 5, 20_017), (9, 4, 500), (3, 7, 45)])
@pytest.mark.parametrize("level", ["high", "default"])
def test_emulated_order_matches_plain_and_scan_dot(level, shape):
    """The kernel's order of sums, emulated in f32, against
    ``matmul_plain`` and the JAX package's ``_scan_dot`` at the level,
    within ``bf16_gemm_rtol(K)`` of max |a| @ |b|; a K = 20,017 is split
    into 5 segments, the last ragged, and no K here is a multiple of 32."""
    M, N, K = shape
    a, b = _operands(M, N, K, 11)
    ta, tb = torch.tensor(a), torch.tensor(b)
    got = tt.bf16_gemm_emulate(ta, tb, level).numpy().astype(np.float64)
    plain = precision.matmul_plain(ta, tb, level).numpy()
    jax_ = np.asarray(jps._scan_dot(jnp.asarray(a), jnp.asarray(b), None,
                                    _MODE[level]))
    scale = (np.abs(a) @ np.abs(b)).max()
    lim = tt.bf16_gemm_rtol(K)
    assert np.abs(got - plain).max() / scale <= lim
    assert np.abs(got - jax_).max() / scale <= lim
    assert len(precision.k_segments(K)) == (5 if K > 20_000 else 1)


def test_emulated_order_is_row_and_batch_independent():
    """The emulation of a row block or a batch entry alone gives the same
    bits as in the whole product: the order depends on K alone."""
    rng = np.random.default_rng(12)
    a = torch.tensor(rng.normal(size=(3, 10, 17_000)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(17_000, 6)).astype(np.float32))
    whole = tt.bf16_gemm_emulate(a, b, "high")
    assert torch.equal(tt.bf16_gemm_emulate(a[1], b, "high"), whole[1])
    assert torch.equal(tt.bf16_gemm_emulate(a[2, 3:7], b, "high"),
                       whole[2, 3:7])
