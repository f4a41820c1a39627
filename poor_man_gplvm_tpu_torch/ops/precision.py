"""The matmul precision of the emission and M-step products, and the
products themselves.

Counterpart of the JAX package's ``PRECISION`` globals
(``poor_man_gplvm_tpu/config.py:25-31``: ``ops/emissions.py``,
``ops/mstep.py``, ``ops/fit_tuning_with_basis.py``,
``experimental/gain.py``), held here in one place.  The level is module
state, set by ``config.set_matmul_precision``; the port caches no
programs, so a change takes effect at the next call.  Set it back to
``'highest'`` after a run.

Levels, with the TPU's meaning (the JAX package's ``_scan_dot``,
``ops/pallas/parallel_scan.py:126-150``; XLA on the CPU computes f32 at
every level):

* ``'highest'``: f32, TF32 off; ``matmul`` is ``torch.matmul``, the bits
  the port has always had;
* ``'high'`` (bf16x3): each operand split into bf16 hi/lo (hi the bf16
  rounding, lo the bf16 rounding of the residual), then
  ``a_hi@b_hi + a_lo@b_hi + a_hi@b_lo`` with f32 products and sums;
* ``'default'`` (bf16): both operands rounded to bf16 once, f32 products,
  sums and output.

Neither lower level is TF32.  On a CUDA tensor a lower level runs
``bf16_gemm`` (``csrc/bf16_gemm.cu``: bf16 ``wgmma`` with f32 sums and f32
output, A read in place through its strides by TMA or cp.async, B split
once per call into bf16 scratch) or raises; on a CPU tensor it runs the
plain version, ``matmul_plain``.  ``gemm_plan`` decides a launch in plain
Python: the variant (TMA where A's base and strides meet its 16-byte
rules, else cp.async, the same bits), the tile, the cluster and the K
segments.  The order of an output element's sums depends on K alone: per
32-wide slice of K a fresh tensor-core accumulator, then one f32 add; for
K above ``SPLIT_MIN_K`` each ``SEG_K`` segment (``k_segments``) summed
apart and the segments added in order.  So a row, a column block or a
batch entry gives the same bits alone as in any call that contains it.

Only the sites the JAX knob reaches call this module: the Poisson and
Gaussian emission products (``ops/emissions.py``), the statistics
``post.T @ y`` (``ops/mstep.py::get_statistics``, ``get_statistics_batch``),
``ops/fit_tuning_with_basis.py::group_spk_occupancy_chunk_neuron`` and
``experimental/gain.py``.  The HMM products, ``joint_acc``, the tuning
link, the Gaussian ridge solve, ``get_s_b`` and the mesh's sharded
statistics stay f32 at every level, as in the JAX package.
"""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.ops.band import split_bf16

__all__ = [
    "LEVELS",
    "set_level",
    "get_level",
    "level",
    "matmul",
    "matmul_plain",
    "matvec",
    "dt_contract",
    "bf16_gemm",
    "gemm_plan",
    "k_segments",
    "reset_launches",
]

#: every name the JAX knob takes, and its canonical level
LEVELS = {
    "highest": "highest", "float32": "highest",
    "high": "high", "bfloat16_3x": "high",
    "default": "default", "bfloat16": "default",
}
#: bf16 products per output term on the tensor cores, per lower level
PASSES = {"high": 3, "default": 1}

_LEVEL = "highest"


def set_level(name):
    """Set the level from any of the six JAX names (case-insensitive);
    returns the canonical ``'highest'``, ``'high'`` or ``'default'``."""
    global _LEVEL
    key = str(name).lower()
    if key not in LEVELS:
        raise ValueError(f"unknown precision {name!r}; one of "
                         f"{sorted(LEVELS)}")
    _LEVEL = LEVELS[key]
    return _LEVEL


def get_level():
    """The current canonical level."""
    return _LEVEL


class level:
    """Context manager: run with the level ``name``, then restore the one
    before it."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.saved = _LEVEL
        return set_level(self.name)

    def __exit__(self, *exc):
        set_level(self.saved)


def _split(x, lvl):
    """(hi, lo) of ``x`` as f32 tensors (lo None at 'default')."""
    if lvl == "default":
        return x.to(torch.bfloat16).float(), None
    hi, lo = split_bf16(x)
    return hi.float(), lo.float()


def matmul_plain(a, b, lvl=None):
    """The plain PyTorch version of ``a @ b`` at level ``lvl`` (default:
    the current one): the bf16 split, then f32 products in the three-term
    order of the JAX package's ``_scan_dot`` (hi.hi + lo.hi + hi.lo)."""
    lvl = _LEVEL if lvl is None else LEVELS[lvl]
    if lvl == "highest":
        return a @ b
    a_hi, a_lo = _split(a, lvl)
    b_hi, b_lo = _split(b, lvl)
    if lvl == "default":
        return a_hi @ b_hi
    return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo


def matmul(a, b, out=None):
    """``a @ b`` at the current level: a (M, K) or (B, M, K), b (K, N) or
    (B, K, N), float32.  ``'highest'`` is ``torch.matmul``; a lower level
    runs ``bf16_gemm`` on a CUDA tensor and ``matmul_plain`` on a CPU one.
    ``out``: a float32 tensor of the result's shape to write it into."""
    if _LEVEL == "highest":
        return torch.matmul(a, b, out=out)
    return bf16_gemm(a, b, PASSES[_LEVEL], out=out)


def _elementwise(fn, x, y):
    """``fn(x, y)`` of an elementwise-bound contraction at the current
    level, in the three-term form on the split operands."""
    if _LEVEL == "highest":
        return fn(x, y)
    x_hi, x_lo = _split(x, _LEVEL)
    y_hi, y_lo = _split(y, _LEVEL)
    if _LEVEL == "default":
        return fn(x_hi, y_hi)
    return fn(x_hi, y_hi) + fn(x_lo, y_hi) + fn(x_hi, y_lo)


def matvec(a, v):
    """``a @ v`` with ``v`` a vector at the current level: the gain
    model's products ``post.T @ gain`` and ``post @ tuning.sum(1)``.  A
    matrix-vector product reads each element of ``a`` once for two
    operations, so it is bound by bytes; the JAX package too computes it
    outside any Pallas kernel, and it takes the plain form on the card as
    on the CPU."""
    return _elementwise(torch.matmul, a, v)


def dt_contract(x, lam):
    """``einsum('tn,tln->tl', x, lam)`` at the current level: the per-bin
    dt emissions, a batched matrix-vector product (bound by bytes, outside
    any Pallas kernel in the JAX package too), in the plain form on the
    card as on the CPU."""
    return _elementwise(lambda p, q: torch.einsum("tn,tln->tl", p, q),
                        x, lam)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _lib():
    from poor_man_gplvm_tpu_torch.ops._build import load

    return load("bf16_gemm")


def _batched(x, B):
    """(view with a batch axis, batch stride) of a 2-D or 3-D operand."""
    if x.ndim == 2:
        return x.unsqueeze(0), 0
    if x.shape[0] not in (1, B):
        raise ValueError(f"batch sizes differ: {x.shape[0]} and {B}")
    return x, (x.stride(0) if x.shape[0] == B else 0)


#: the block tile: rows, columns and K per pipeline stage
TILE = (128, 128, 64)
#: K of one segment of the split-K (128 slices of 32), and the K above
#: which a product is split
SEG_K = 4096
SPLIT_MIN_K = 16384


def k_segments(K):
    """The segments [start, stop) of a product's K: one up to
    ``SPLIT_MIN_K``, else fixed segments of ``SEG_K`` from k = 0.  They
    depend on K alone, so an output element's sum order does too."""
    if K <= SPLIT_MIN_K:
        return [(0, K)]
    return [(s, min(s + SEG_K, K)) for s in range(0, K, SEG_K)]


def _tma_ok(M, K, batch, strides, ptr):
    """(ok, k_fast): whether TMA can load A (M, K) with element strides
    ``strides`` = (batch, row, k) from address ``ptr``: a unit stride along
    K or M, the base 16-byte aligned, the other strides multiples of 16
    bytes, and rows that do not overlap (a stride-0 broadcast row does
    not qualify)."""
    sa_b, sa_m, sa_k = strides
    if sa_k == 1 or K == 1:
        k_fast, outer, n_outer, n_inner = True, sa_m, M, K
    elif sa_m == 1 or M == 1:
        k_fast, outer, n_outer, n_inner = False, sa_k, K, M
    else:
        return False, sa_k <= sa_m
    ok = ptr % 16 == 0
    if n_outer > 1:
        ok = ok and outer % 4 == 0 and outer >= n_inner
    if batch > 1:
        ok = ok and sa_b % 4 == 0
    return ok, k_fast


def gemm_plan(M, N, K, batch, strides, ptr):
    """The launch plan of ``bf16_gemm`` for A (M, K) with element strides
    ``strides`` = (batch, row, k) at address ``ptr`` (bytes): ``variant``
    'tma' where TMA can load A, else 'cp_async' (the same bits); ``a_kfast``
    A staged K-fast (else M-fast); ``tile``; ``cluster``, the thread
    blocks along N that share A's loads (TMA with at least 3 column tiles:
    4, else 1; it changes no bit); ``segments``, the K segments
    (``k_segments``); ``seg_k``, their length as the kernel takes it (a
    multiple of TILE[2])."""
    ok, k_fast = _tma_ok(M, K, batch, strides, ptr)
    segments = k_segments(K)
    step = TILE[2]
    seg_k = (SEG_K if len(segments) > 1
             else max(step, -(-K // step) * step))
    cluster = 4 if ok and -(-N // TILE[1]) >= 3 else 1
    return {"variant": "tma" if ok else "cp_async", "a_kfast": k_fast,
            "tile": TILE, "cluster": cluster, "segments": segments,
            "seg_k": seg_k}


def _gemm(a, b, passes, out=None):
    """Launch ``bf16_gemm`` with ``passes`` bf16 products (3: 'high', 1:
    'default') on float32 CUDA tensors; returns (the f32 product, the
    plan)."""
    if a.ndim not in (2, 3) or b.ndim not in (2, 3):
        raise ValueError(f"bf16_gemm takes 2-D or 3-D operands, got "
                         f"{a.ndim}-D and {b.ndim}-D")
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, expected {a.device}")
    B = max(a.shape[0] if a.ndim == 3 else 1, b.shape[0] if b.ndim == 3
            else 1)
    a3, sa_b = _batched(a, B)
    b3, sb_b = _batched(b, B)
    M, K = a3.shape[1:]
    if b3.shape[1] != K:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    N = b3.shape[2]
    shape = (M, N) if a.ndim == 2 and b.ndim == 2 else (B, M, N)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=a.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.float32
          or out.device != a.device):
        raise ValueError(f"out must be float32 {shape} on {a.device}")
    c3 = out if out.ndim == 3 else out.unsqueeze(0)
    plan = gemm_plan(M, N, K, B, (sa_b, a3.stride(1), a3.stride(2)),
                     a3.data_ptr())
    # scratch: B's bf16 hi (and lo), K contiguous; the segments' partials
    Kp = -(-K // 8) * 8
    bsplit = torch.empty(((passes + 1) // 2, 1 if sb_b == 0 else B, N, Kp),
                         dtype=torch.bfloat16, device=a.device)
    segs = len(plan["segments"])
    part = (torch.empty((segs, B, M, N), dtype=torch.float32,
                        device=a.device) if segs > 1 else None)
    with torch.cuda.device(a.device):
        err = _lib().pmg_bf16_gemm(
            a3.data_ptr(), b3.data_ptr(), c3.data_ptr(), M, N, K, B,
            sa_b, a3.stride(1), a3.stride(2), sb_b, b3.stride(1),
            b3.stride(2), c3.stride(0), c3.stride(1), c3.stride(2), passes,
            int(plan["variant"] == "tma"), int(plan["a_kfast"]),
            plan["cluster"], plan["seg_k"], bsplit.data_ptr(),
            None if part is None else part.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bf16_gemm launch failed: cudaError {err}")
    return out, plan


def _gemm_run(a, b, passes, out=None):
    """Launch ``bf16_gemm`` with ``passes`` bf16 products (3: 'high', 1:
    'default') on float32 CUDA tensors, uncounted; returns the f32
    product."""
    return _gemm(a, b, passes, out=out)[0]


def bf16_gemm(a, b, passes, out=None):
    """``a @ b`` on the tensor cores with bf16 operands, f32 sums and f32
    output: ``passes`` 3 is 'high' (bf16x3), 1 is 'default' (bf16).  a
    (M, K) or (B, M, K), b (K, N) or (B, K, N), float32, any strides.  On
    a CPU tensor: ``matmul_plain``; on a CUDA tensor: the kernel, or
    raise.  Counts its launches in ``bf16_gemm.launches``, by level in
    ``bf16_gemm.launches_by_mode`` and by level and variant ('high/tma',
    'default/cp_async', ...) in ``bf16_gemm.launches_by_variant``."""
    lvl = {3: "high", 1: "default"}[passes]
    if a.device.type == "cpu":
        res = matmul_plain(a, b, lvl)
        return res if out is None else out.copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"bf16_gemm runs on cpu or cuda, not "
                         f"{a.device.type}")
    res, plan = _gemm(a, b, passes, out=out)
    bf16_gemm.launches += 1
    by_mode, by_var = bf16_gemm.launches_by_mode, bf16_gemm.launches_by_variant
    by_mode[lvl] = by_mode.get(lvl, 0) + 1
    key = f"{lvl}/{plan['variant']}"
    by_var[key] = by_var.get(key, 0) + 1
    return res


def reset_launches():
    """Set ``bf16_gemm``'s launch counts to 0."""
    bf16_gemm.launches = 0
    bf16_gemm.launches_by_mode = {}
    bf16_gemm.launches_by_variant = {}


reset_launches()
