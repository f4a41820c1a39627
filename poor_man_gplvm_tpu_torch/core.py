"""Reference-compatible core module: the model classes and the basis
generation (counterpart of ``poor_man_gplvm_tpu/core.py``, the import
surface of ``poor_man_gplvm.core``)."""

from poor_man_gplvm_tpu_torch.models.jump1d import (  # noqa: F401
    AbstractGPLVMJump1D,
    GaussianGPLVMJump1D,
    PoissonGPLVMJump1D,
)
from poor_man_gplvm_tpu_torch.models.latent1d import (  # noqa: F401
    AbstractGPLVM1D,
    GaussianGPLVM1D,
    PoissonGPLVM1D,
)
from poor_man_gplvm_tpu_torch.ops.basis import generate_basis  # noqa: F401

__all__ = [
    "AbstractGPLVM1D",
    "AbstractGPLVMJump1D",
    "GaussianGPLVM1D",
    "GaussianGPLVMJump1D",
    "PoissonGPLVM1D",
    "PoissonGPLVMJump1D",
    "generate_basis",
]
