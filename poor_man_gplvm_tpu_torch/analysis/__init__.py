"""Post-fit analysis layer: correlograms (``ccg``), distance structure
(``distance``), posterior analyses (``posterior``), the pre/post
regression (``regression``), the reactivation analyses
(``reactivation``) and trial structure (``trial``).

Counterpart of ``poor_man_gplvm_tpu/analysis``, in the port's own copy:
no JAX, and no pandas, matplotlib or seaborn at import.  The analyses take
the port's results (tensors on the card, or its ``TsdFrame``s) and compute
on the host in numpy, as the JAX package does, but the reactivation
nulls, which decode their shuffles through the batched K1/K2 kernels on
the card.  Where a JAX function returns a DataFrame or Series this returns
``utils.table.ResultTable``.
"""

from poor_man_gplvm_tpu_torch.analysis import (  # noqa: F401
    ccg,
    distance,
    posterior,
    reactivation,
    regression,
    trial,
)
from poor_man_gplvm_tpu_torch.analysis.ccg import (
    compute_acg_counts,
    compute_ccg_counts,
    theta_skipping_index,
)
from poor_man_gplvm_tpu_torch.analysis.distance import (
    compute_distance_lag,
    distance_vs_label_regression,
    get_transmat_and_shuffle,
    interpolate_compute_dist_mat,
    interpolate_stacks,
    labels_to_transition_matrix,
    shuffle_test_distance_vs_label,
    w1_cdf_distance_matrix,
)
from poor_man_gplvm_tpu_torch.analysis.posterior import (
    get_consecutive_pv_distance,
    get_peri_event_with_shuffle,
    get_posterior_weighted_average,
    get_sequence_occurence,
    get_state_interval,
    shift_timestamp,
)
from poor_man_gplvm_tpu_torch.analysis.reactivation import (
    aggregate_within_ripple_per_epoch,
    circular_shuffle_column_independently,
    circular_shuffle_spikes_within_epoch_and_decode,
    decode_pre_post,
    decode_ripple_epochs,
    generate_homogeneous_poisson_surrogate_data,
    random_reassign_prepost_latent_difference,
)
from poor_man_gplvm_tpu_torch.analysis.regression import fit_time_prepost_interaction
from poor_man_gplvm_tpu_torch.analysis.trial import (
    get_event_phase_in_trial,
    plot_event_range,
)

__all__ = [
    "aggregate_within_ripple_per_epoch",
    "compute_acg_counts",
    "compute_ccg_counts",
    "theta_skipping_index",
    "circular_shuffle_column_independently",
    "circular_shuffle_spikes_within_epoch_and_decode",
    "compute_distance_lag",
    "decode_pre_post",
    "decode_ripple_epochs",
    "distance_vs_label_regression",
    "fit_time_prepost_interaction",
    "generate_homogeneous_poisson_surrogate_data",
    "get_consecutive_pv_distance",
    "get_event_phase_in_trial",
    "get_peri_event_with_shuffle",
    "get_posterior_weighted_average",
    "get_sequence_occurence",
    "get_state_interval",
    "get_transmat_and_shuffle",
    "interpolate_compute_dist_mat",
    "interpolate_stacks",
    "labels_to_transition_matrix",
    "plot_event_range",
    "random_reassign_prepost_latent_difference",
    "shift_timestamp",
    "shuffle_test_distance_vs_label",
    "w1_cdf_distance_matrix",
    "ccg",
    "distance",
    "posterior",
    "reactivation",
    "regression",
    "trial",
]
