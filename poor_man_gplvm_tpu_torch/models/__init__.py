"""Model families of the port."""

from poor_man_gplvm_tpu_torch.models.jump1d import (
    AbstractGPLVMJump1D,
    GaussianGPLVMJump1D,
    PoissonGPLVMJump1D,
)
from poor_man_gplvm_tpu_torch.models.latent1d import (
    AbstractGPLVM1D,
    GaussianGPLVM1D,
    PoissonGPLVM1D,
)

__all__ = [
    "AbstractGPLVM1D",
    "AbstractGPLVMJump1D",
    "GaussianGPLVM1D",
    "GaussianGPLVMJump1D",
    "PoissonGPLVM1D",
    "PoissonGPLVMJump1D",
]
