"""Reference-compatible gain model module (counterpart of
``poor_man_gplvm_tpu/experimental/core_exp.py``, mirroring
``poor_man_gplvm.experimental.core_exp``)."""

from poor_man_gplvm_tpu_torch.experimental.gain import (  # noqa: F401
    PoissonGPLVMGain1D_gain,
)

__all__ = ["PoissonGPLVMGain1D_gain"]
