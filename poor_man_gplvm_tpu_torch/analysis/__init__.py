"""Post-fit analysis layer: the reactivation analyses (``reactivation``).

Counterpart of ``poor_man_gplvm_tpu/analysis``.  Its other modules
(``ccg``, ``distance``, ``posterior``, ``regression``, ``trial``) are
numpy-only layers over a fit's results and are not copied into the port:
they use no JAX themselves and work wherever the JAX package is installed,
on numpy arrays from either package.
"""

from poor_man_gplvm_tpu_torch.analysis import reactivation
from poor_man_gplvm_tpu_torch.analysis.reactivation import (
    aggregate_within_ripple_per_epoch,
    circular_shuffle_column_independently,
    circular_shuffle_spikes_within_epoch_and_decode,
    decode_pre_post,
    decode_ripple_epochs,
    generate_homogeneous_poisson_surrogate_data,
    random_reassign_prepost_latent_difference,
)

__all__ = [
    "aggregate_within_ripple_per_epoch",
    "circular_shuffle_column_independently",
    "circular_shuffle_spikes_within_epoch_and_decode",
    "decode_pre_post",
    "decode_ripple_epochs",
    "generate_homogeneous_poisson_surrogate_data",
    "random_reassign_prepost_latent_difference",
    "reactivation",
]
