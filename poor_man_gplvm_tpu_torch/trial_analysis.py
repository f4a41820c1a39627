"""Reference-compatible trial-analysis module (the JAX package's
``trial_analysis``): the trial helpers of ``analysis.trial``."""

from poor_man_gplvm_tpu_torch.analysis.trial import (  # noqa: F401
    get_event_phase_in_trial,
    plot_event_range,
)
