"""Reference-compatible jump-analysis module (counterpart of
``poor_man_gplvm_tpu/jump_analysis.py``; the reference's
``poor_man_gplvm.jump_analysis`` is an imports-only placeholder).  The
jump analyses live in ``validation`` (segmentation, contrast axes) and
``selection`` (consensus metrics)."""

from poor_man_gplvm_tpu_torch.selection import (  # noqa: F401
    get_jump_consensus,
    get_jump_consensus_shuffle,
)
from poor_man_gplvm_tpu_torch.validation import (  # noqa: F401
    get_contrast_axis_and_proj,
    segment_trial_by_jump,
)
