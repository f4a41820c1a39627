"""Reference-compatible initializer module (counterpart of
``poor_man_gplvm_tpu/initializer.py``, mirroring
``poor_man_gplvm.initializer``)."""

from poor_man_gplvm_tpu_torch.initializers import (  # noqa: F401
    init_with_label_1D,
    init_with_pca,
)
