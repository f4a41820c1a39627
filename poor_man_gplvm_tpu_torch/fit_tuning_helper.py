"""Reference-compatible M-step module (counterpart of
``poor_man_gplvm_tpu/fit_tuning_helper.py``, mirroring
``poor_man_gplvm.fit_tuning_helper``)."""

from poor_man_gplvm_tpu_torch.ops.mstep import (  # noqa: F401
    gaussian_m_step_analytic,
    get_statistics,
    get_tuning_linear,
    get_tuning_softplus,
    make_adam_runner,
    make_adam_runner_cached,
    poisson_m_step_objective,
    poisson_m_step_objective_smoothness,
    tree_l2_norm,
)
