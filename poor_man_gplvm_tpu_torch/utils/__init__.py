"""Utilities of the port: the time-series containers (``timeseries``) and
their pynapple shim (``compat``), EM checkpoints (``checkpoint``),
profiling helpers (``profiling``), the ``ResultTable`` that stands for a
pandas DataFrame (``table``), ordinary least squares (``stats``) and the
post-fit neuron sort with its numpy helpers (``sorting``, exported here as
the JAX package's ``utils`` exports them)."""

from poor_man_gplvm_tpu_torch.utils import (
    checkpoint,
    compat,
    profiling,
    sorting,
    stats,
    table,
    timeseries,
)
from poor_man_gplvm_tpu_torch.utils.sorting import (
    pca_init,
    post_fit_sort_neuron,
    post_fit_sort_neurons,
    rbf_kernel,
)
from poor_man_gplvm_tpu_torch.utils.timeseries import (
    IntervalSet,
    Ts,
    Tsd,
    TsdFrame,
    TsGroup,
)

__all__ = [
    "IntervalSet",
    "Ts",
    "Tsd",
    "TsdFrame",
    "TsGroup",
    "checkpoint",
    "compat",
    "pca_init",
    "post_fit_sort_neuron",
    "post_fit_sort_neurons",
    "profiling",
    "rbf_kernel",
    "sorting",
    "stats",
    "table",
    "timeseries",
]
