"""Scaling over devices and hyperparameter grids.

Counterpart of ``poor_man_gplvm_tpu/parallel``: ``spmd``, inference and EM
over a ('data', 'time', 'neuron') mesh of devices, and ``sweep``, the
batched hyperparameter sweeps (``mesh=`` shards their runs).
"""

from poor_man_gplvm_tpu_torch.parallel import spmd, sweep

__all__ = ["spmd", "sweep"]
