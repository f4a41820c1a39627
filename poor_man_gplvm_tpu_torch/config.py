"""Runtime configuration knobs (counterpart of
``poor_man_gplvm_tpu/config.py``).

``set_scan_precision`` sets the recursion dots of the parallel-in-time
kernels K3/K4 (K5: ``'highest'``, ``'bf16x3'``, ``'bf16'``), as the JAX
knob does.  The matmul-precision knob of the JAX package picks the XLA
precision of the emission and M-step products; the port keeps every such
product in full f32 with TF32 off, the one setting its parity tolerances
and the Gaussian emissions' cancellation allow, so ``'highest'`` (and its
alias ``'float32'``) is the only level it takes and the lower levels
raise ``ValueError``.
"""

from __future__ import annotations

__all__ = [
    "set_matmul_precision", "get_matmul_precision", "set_scan_precision",
]

#: the JAX package's level names: the port runs the first two (full f32)
_F32_LEVELS = ("highest", "float32")
_LOWER_LEVELS = ("high", "bfloat16_3x", "default", "bfloat16")


def set_matmul_precision(level):
    """Check the precision of the emission and M-step matmuls: ``'highest'``
    or ``'float32'`` (full f32, TF32 off: what the port always runs)
    returns ``'highest'``; the JAX package's lower levels (``'high'``,
    ``'bfloat16_3x'``, ``'default'``, ``'bfloat16'``) raise ``ValueError``,
    as does an unknown name."""
    level_l = str(level).lower()
    if level_l in _F32_LEVELS:
        return "highest"
    if level_l in _LOWER_LEVELS:
        raise ValueError(
            f"matmul precision {level!r} is not supported by the port: its "
            "emission and M-step products run in full f32 with TF32 off "
            "(the parity tolerances and the Gaussian emissions need it); "
            "use 'highest'")
    raise ValueError(f"unknown precision {level!r}; one of "
                     f"{sorted(_F32_LEVELS + _LOWER_LEVELS)}")


def get_matmul_precision():
    """The precision of the emission and M-step matmuls: always
    ``'highest'``."""
    return "highest"


def set_scan_precision(mode):
    """Set the precision of the parallel-in-time scans' recursion dots
    (``'highest'`` | ``'bf16x3'`` | ``'bf16'``):
    ``ops.parallel_scan.set_scan_precision``.  Module state: set it back
    to ``'highest'`` after a run."""
    from poor_man_gplvm_tpu_torch.ops import parallel_scan

    parallel_scan.set_scan_precision(mode)
