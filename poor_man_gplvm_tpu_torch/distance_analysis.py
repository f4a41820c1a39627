"""Reference-compatible distance-analysis module (the JAX package's
``distance_analysis``): the distance analyses of ``analysis.distance``."""

from poor_man_gplvm_tpu_torch.analysis.distance import (  # noqa: F401
    compute_distance_lag,
    distance_vs_label_regression,
    get_transmat_and_shuffle,
    interpolate_compute_dist_mat,
    interpolate_stacks,
    labels_to_transition_matrix,
    shuffle_test_distance_vs_label,
    w1_cdf_distance_matrix,
)
