"""Optional-dependency shims for the time-series classes.

Counterpart of ``poor_man_gplvm_tpu/utils/compat.py``: pynapple's classes
when pynapple is installed, else the port's own minimal containers in
:mod:`poor_man_gplvm_tpu_torch.utils.timeseries` (never the JAX package's
copy).  pynapple is imported at the first call, not when this module is
imported.  ``tsdframe`` and ``tsd`` take torch tensors too (copied to the
host as numpy).  ``HAS_PYNAPPLE`` (the JAX module's flag) is read at its
first use, so reading it may import pynapple.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["timeseries_module", "is_tsdframe", "is_tsd_like", "tsdframe",
           "tsd", "to_numpy", "HAS_PYNAPPLE"]


@functools.cache
def timeseries_module():
    """The module that holds the time-series classes: ``pynapple``, or the
    port's ``utils.timeseries``."""
    try:  # pragma: no cover - environment dependent
        import pynapple as nap
    except ImportError:
        from poor_man_gplvm_tpu_torch.utils import timeseries as nap
    return nap


def __getattr__(name):
    # HAS_PYNAPPLE: whether the time-series classes are pynapple's,
    # decided at the first read rather than at import
    if name == "HAS_PYNAPPLE":
        return timeseries_module().__name__ == "pynapple"
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def to_numpy(x):
    """``x`` as a numpy array (a tensor is copied to the host)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def is_tsdframe(y):
    return isinstance(y, timeseries_module().TsdFrame)


def is_tsd_like(y):
    nap = timeseries_module()
    return isinstance(y, (nap.Tsd, nap.TsdFrame))


def tsdframe(d, t):
    return timeseries_module().TsdFrame(d=to_numpy(d), t=to_numpy(t))


def tsd(d, t):
    return timeseries_module().Tsd(d=to_numpy(d), t=to_numpy(t))
