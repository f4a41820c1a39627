"""Reference-compatible reactivation module (counterpart of
``poor_man_gplvm_tpu/reactivation_analysis.py``, mirroring
``poor_man_gplvm.reactivation_analysis``)."""

from poor_man_gplvm_tpu_torch.analysis.reactivation import *  # noqa: F401,F403
