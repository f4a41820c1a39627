"""Experimental models (reference poor_man_gplvm/experimental/): the gain
model.  The JAX package's ``core_exp``, ``decoder_exp``,
``fit_tuning_helper_exp`` and ``test_exp`` modules (its drop-in shims) are
not ported yet."""

from poor_man_gplvm_tpu_torch.experimental.gain import (
    PoissonGPLVMGain1D_gain,
    get_gain_mstep,
    get_gain_mstep_chunk,
    get_statistics_gain,
    poisson_m_step_objective_gain,
    shuffle_and_decode_gain,
)

__all__ = [
    "PoissonGPLVMGain1D_gain",
    "get_gain_mstep",
    "get_gain_mstep_chunk",
    "get_statistics_gain",
    "poisson_m_step_objective_gain",
    "shuffle_and_decode_gain",
]
