"""Experimental models (reference poor_man_gplvm/experimental/): the gain
model (``gain``) and the reference-compatible modules ``core_exp``,
``decoder_exp``, ``fit_tuning_helper_exp`` and ``test_exp``."""

from poor_man_gplvm_tpu_torch.experimental import (  # noqa: F401
    core_exp,
    decoder_exp,
    fit_tuning_helper_exp,
    test_exp,
)
from poor_man_gplvm_tpu_torch.experimental.gain import (
    PoissonGPLVMGain1D_gain,
    get_gain_mstep,
    get_gain_mstep_chunk,
    get_statistics_gain,
    poisson_m_step_objective_gain,
    shuffle_and_decode_gain,
)

__all__ = [
    "core_exp",
    "decoder_exp",
    "fit_tuning_helper_exp",
    "test_exp",
    "PoissonGPLVMGain1D_gain",
    "get_gain_mstep",
    "get_gain_mstep_chunk",
    "get_statistics_gain",
    "poisson_m_step_objective_gain",
    "shuffle_and_decode_gain",
]
