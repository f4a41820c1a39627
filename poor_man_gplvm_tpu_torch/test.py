"""Reference-compatible statistical-validation module (counterpart of
``poor_man_gplvm_tpu/test.py``, mirroring ``poor_man_gplvm.test``: manual
model validation, not unit tests)."""

from poor_man_gplvm_tpu_torch.validation import (  # noqa: F401
    circular_shuffle_data,
    compute_entropy,
    shuffle_and_decode,
    test_one_model,
)
