"""Reference-compatible gain M-step module (counterpart of
``poor_man_gplvm_tpu/experimental/fit_tuning_helper_exp.py``, mirroring
``poor_man_gplvm.experimental.fit_tuning_helper_exp``)."""

from __future__ import annotations

import torch

from poor_man_gplvm_tpu_torch.experimental.gain import (  # noqa: F401
    get_gain_mstep,
    get_gain_mstep_chunk,
    get_statistics_gain,
    poisson_m_step_objective_gain,
)
from poor_man_gplvm_tpu_torch.ops.mstep import (  # noqa: F401
    gaussian_m_step_analytic,
    get_statistics,
    get_tuning_linear,
    get_tuning_softplus,
    make_adam_runner,
    poisson_m_step_objective,
    tree_l2_norm,
)

__all__ = [
    "get_tuning_linear",
    "get_tuning_softplus",
    "get_statistics",
    "get_statistics_gain",
    "gaussian_m_step_analytic",
    "get_gain_mstep",
    "get_gain_mstep_chunk",
    "get_gain_mstep_single_time",
    "poisson_m_step_objective",
    "poisson_m_step_objective_gain",
    "make_adam_runner",
    "tree_l2_norm",
]


def get_gain_mstep_single_time(y_t, log_posterior_t, tuning):
    """Gain MLE at one timepoint: total spikes / total expected rate
    (reference experimental/fit_tuning_helper_exp.py:79-103), on the
    device of ``log_posterior_t`` (as ``get_gain_mstep``)."""
    log_posterior_t = torch.as_tensor(log_posterior_t, dtype=torch.float32)
    dev = log_posterior_t.device
    y_t = torch.as_tensor(y_t, dtype=torch.float32, device=dev)
    tuning = torch.as_tensor(tuning, dtype=torch.float32, device=dev)
    expected_rate = torch.sum(torch.exp(log_posterior_t)[:, None] * tuning,
                              dim=0)
    return torch.sum(y_t) / (torch.sum(expected_rate) + 1e-20)
