"""poor_man_gplvm_tpu_torch — PyTorch/CUDA port of ``poor_man_gplvm_tpu``.

The port mirrors the JAX package's module paths, names and result-dict
contracts; the JAX package stays the reference it is tested against.  It
imports ``torch`` only: no jax, no triton, and no GPU is needed to import
it.  The filter/smoother scans run as hand-written CUDA kernels on a CUDA
device, built with ``nvcc`` at first use: the sequential pair K1/K2
(``csrc/scan_kernels.cu``) and the parallel-in-time pair K3/K4
(``csrc/parallel_scan.cu``) for long sequences.

Ported so far: ``PoissonGPLVMJump1D`` decoding (``decode_latent``,
``decode_latent_naive_bayes``), sampling and fitting (``fit_em``).
"""

from poor_man_gplvm_tpu_torch import convert, models, ops
from poor_man_gplvm_tpu_torch.models.jump1d import (
    AbstractGPLVMJump1D,
    PoissonGPLVMJump1D,
)
from poor_man_gplvm_tpu_torch.ops.basis import generate_basis

__all__ = [
    "AbstractGPLVMJump1D",
    "PoissonGPLVMJump1D",
    "convert",
    "generate_basis",
    "models",
    "ops",
]
