"""Batched sweeps over hyperparameter grids (``sweep``).

Counterpart of ``poor_man_gplvm_tpu/parallel``; its ``spmd`` module
(sharding over several devices) is not ported.
"""

from poor_man_gplvm_tpu_torch.parallel import sweep

__all__ = ["sweep"]
