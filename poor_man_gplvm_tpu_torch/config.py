"""Runtime configuration knobs (counterpart of
``poor_man_gplvm_tpu/config.py``).

``set_matmul_precision`` sets the precision of the emission and M-step
products (``ops/precision.py``, the one place the level lives), with the
JAX package's six names; ``set_scan_precision`` sets the recursion dots of
the parallel-in-time kernels K3/K4 (K5: ``'highest'``, ``'bf16x3'``,
``'bf16'``), as the JAX knob does.  Both are module state: set them back
to ``'highest'`` after a run.
"""

from __future__ import annotations

from poor_man_gplvm_tpu_torch.ops import precision

__all__ = [
    "set_matmul_precision", "get_matmul_precision", "set_scan_precision",
]


def set_matmul_precision(level):
    """Set the precision of the emission and M-step products; returns the
    canonical level (the JAX package returns its ``jax.lax.Precision``).

    ==========================  =========  ================================
    name (case-insensitive)     level      what each product computes
    ==========================  =========  ================================
    'highest', 'float32'        'highest'  f32, TF32 off (the default)
    'high', 'bfloat16_3x'       'high'     bf16x3: a_hi@b_hi + a_lo@b_hi
                                           + a_hi@b_lo, f32 sums
    'default', 'bfloat16'       'default'  one bf16 pass, f32 sums and
                                           output
    ==========================  =========  ================================

    On the card the lower levels run the tensor cores (``bf16_gemm``,
    ``csrc/bf16_gemm.cu``: wgmma, TMA, a split-K cut at fixed K), faster
    than 'highest' there (on the H100, the north-star emission 3.2 / 2.2 ms
    at 'high' / 'default' against 10.0 for f32, a statistics chunk 1.0 /
    0.6 against 1.9; ``PERF.md``); a product's bits depend on K alone, not
    on its other rows, columns or batch.  On the CPU their plain PyTorch
    version.  The
    products the knob reaches are the JAX package's: the Poisson and
    Gaussian emissions, the per-bin dt emissions, the statistics
    ``post.T @ y`` (``get_statistics``, ``get_statistics_batch``), the
    L-BFGS M-step's grouped spikes and the gain model's products.  The
    HMM recursions, ``joint_acc``, the tuning link, the Gaussian ridge
    solve, ``get_s_b`` and the mesh's sharded statistics stay f32 (the
    scan dots have their own knob, ``set_scan_precision``).  An unknown
    name raises ``ValueError``.  Takes effect at the next call."""
    return precision.set_level(level)


def get_matmul_precision():
    """The current precision of the emission and M-step products:
    ``'highest'``, ``'high'`` or ``'default'``."""
    return precision.get_level()


def set_scan_precision(mode):
    """Set the precision of the parallel-in-time scans' recursion dots
    (``'highest'`` | ``'bf16x3'`` | ``'bf16'``):
    ``ops.parallel_scan.set_scan_precision``.  Module state: set it back
    to ``'highest'`` after a run."""
    from poor_man_gplvm_tpu_torch.ops import parallel_scan

    parallel_scan.set_scan_precision(mode)
