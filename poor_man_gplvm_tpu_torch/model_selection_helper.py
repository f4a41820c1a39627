"""Reference-compatible model-selection module (counterpart of
``poor_man_gplvm_tpu/model_selection_helper.py``, mirroring
``poor_man_gplvm.model_selection_helper``): the port's ``selection``."""

from poor_man_gplvm_tpu_torch.selection import *  # noqa: F401,F403
from poor_man_gplvm_tpu_torch.selection import (  # noqa: F401
    default_fit_kwargs,
    model_class_dict,
)
