"""Numerics core of the port: kernels, basis, emissions, HMM engines,
the M-step, and the hand-written CUDA scan kernels."""

from poor_man_gplvm_tpu_torch.ops import (
    basis,
    emissions,
    hmm,
    kernels,
    mstep,
    parallel_scan,
    scan_kernels,
)
from poor_man_gplvm_tpu_torch.ops.basis import generate_basis
from poor_man_gplvm_tpu_torch.ops.emissions import (
    MASK_NEG,
    RATE_FLOOR,
    get_loglikelihood_ma_all,
    get_naive_bayes_ma,
    get_naive_bayes_ma_chunk,
    poisson_lgamma_term,
    poisson_loglik,
)
from poor_man_gplvm_tpu_torch.ops.hmm import (
    JOINT_ACC_INIT,
    JointTransition,
    LatentTransition,
    auto_chunk_size,
    engine_resolves_parallel,
    compute_transition_posterior_prob,
    compute_transition_posterior_prob_latent,
    prob_to_log,
    smooth_batch_full,
    smooth_combined_chunked,
    smooth_epochs,
)
from poor_man_gplvm_tpu_torch.ops.kernels import (
    create_transition_prob_1d,
    rbf_gram,
    uniform_gram,
)
from poor_man_gplvm_tpu_torch.ops.mstep import (
    AdamState,
    get_statistics,
    get_tuning_linear,
    get_tuning_softplus,
    make_adam_runner,
    poisson_m_step_objective,
)
from poor_man_gplvm_tpu_torch.ops.parallel_scan import (
    choose_parallel_config,
    pfilter_pass,
    psmooth_pass,
    smooth_parallel,
)
from poor_man_gplvm_tpu_torch.ops.scan_kernels import (
    filter_chunk,
    filter_chunk_batch,
    filter_scan,
    filter_scan_batch,
    smoother_chunk,
    smoother_chunk_batch,
    smoother_scan,
    smoother_scan_batch,
)

__all__ = [
    "basis", "emissions", "hmm", "kernels", "mstep", "parallel_scan",
    "scan_kernels",
    "generate_basis", "MASK_NEG", "RATE_FLOOR", "get_loglikelihood_ma_all",
    "get_naive_bayes_ma", "get_naive_bayes_ma_chunk", "poisson_lgamma_term",
    "poisson_loglik", "JOINT_ACC_INIT", "JointTransition", "LatentTransition",
    "auto_chunk_size", "engine_resolves_parallel",
    "compute_transition_posterior_prob",
    "compute_transition_posterior_prob_latent", "prob_to_log",
    "smooth_batch_full", "smooth_combined_chunked", "smooth_epochs",
    "create_transition_prob_1d", "rbf_gram",
    "uniform_gram", "AdamState", "get_statistics", "get_tuning_linear",
    "get_tuning_softplus", "make_adam_runner", "poisson_m_step_objective",
    "choose_parallel_config", "pfilter_pass", "psmooth_pass",
    "smooth_parallel", "filter_chunk", "filter_chunk_batch", "filter_scan",
    "filter_scan_batch", "smoother_chunk", "smoother_chunk_batch",
    "smoother_scan", "smoother_scan_batch",
]
