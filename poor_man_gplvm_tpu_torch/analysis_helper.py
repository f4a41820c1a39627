"""Reference-compatible analysis module (the JAX package's
``analysis_helper``): the posterior analyses and the pre/post regression of
``analysis``."""

from poor_man_gplvm_tpu_torch.analysis.posterior import (  # noqa: F401
    get_consecutive_pv_distance,
    get_peri_event_with_shuffle,
    get_posterior_weighted_average,
    get_sequence_occurence,
    get_state_interval,
    shift_timestamp,
)
from poor_man_gplvm_tpu_torch.analysis.regression import (  # noqa: F401
    fit_time_prepost_interaction,
)
