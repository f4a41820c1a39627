"""Reference-compatible legacy per-neuron M-step module (counterpart of
``poor_man_gplvm_tpu/fit_tuning_with_basis.py``, mirroring
``poor_man_gplvm.fit_tuning_with_basis``): the batched L-BFGS of
``ops.fit_tuning_with_basis``."""

from poor_man_gplvm_tpu_torch.ops.fit_tuning_with_basis import (  # noqa: F401
    gaussian_logprior,
    get_log_poisson_p_y_given_params_oneneuron_grouped,
    get_log_poisson_p_y_joint_params_oneneuron_grouped,
    get_log_prior_params,
    get_s_b,
    glm_get_tuning,
    group_spk_occupancy_chunk_neuron,
    m_step_get_tuning_all_neuron_grouped,
)
