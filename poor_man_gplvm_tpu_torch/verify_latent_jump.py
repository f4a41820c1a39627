"""Reference-compatible jump-verification module (counterpart of
``poor_man_gplvm_tpu/verify_latent_jump.py``, mirroring
``poor_man_gplvm.verify_latent_jump``)."""

from poor_man_gplvm_tpu_torch.validation import (  # noqa: F401
    get_contrast_axis_and_proj,
    segment_trial_by_jump,
)
