"""Utilities of the port: the time-series containers (``timeseries``) and
their pynapple shim (``compat``), EM checkpoints (``checkpoint``) and
profiling helpers (``profiling``)."""

from poor_man_gplvm_tpu_torch.utils import (
    checkpoint,
    compat,
    profiling,
    timeseries,
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
    "profiling",
    "timeseries",
]
