"""Reference-compatible kernel module (counterpart of
``poor_man_gplvm_tpu/gp_kernel.py``, mirroring ``poor_man_gplvm.gp_kernel``).
The transition matrices are made on the device of their latent-bin
argument."""

import torch

from poor_man_gplvm_tpu_torch.ops.kernels import (  # noqa: F401
    create_transition_prob_1d,
    create_transition_prob_latent_1d,
    discrete_transition_kernel,
    get_custom_kernel_rbf_plus_isolated,
    rbf_kernel,
    rbf_kernel_multi_d,
    uniform_kernel,
)


def get_log(val):
    """Log with the reference's -inf clamp (reference gp_kernel.py:8-12):
    exact zeros map to -10000 instead of -inf.  A tensor stays on its
    device; anything else becomes an f32 tensor on the CPU."""
    log_val = torch.log(torch.as_tensor(val, dtype=torch.float32))
    return torch.where(torch.isneginf(log_val),
                       torch.full_like(log_val, -10000.0), log_val)
