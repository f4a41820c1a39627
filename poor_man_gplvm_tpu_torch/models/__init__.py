"""Model families of the port."""

from poor_man_gplvm_tpu_torch.models.jump1d import (
    AbstractGPLVMJump1D,
    PoissonGPLVMJump1D,
)

__all__ = ["AbstractGPLVMJump1D", "PoissonGPLVMJump1D"]
