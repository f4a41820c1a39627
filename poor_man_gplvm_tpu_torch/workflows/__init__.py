"""Dataset-specific post-fit workflows
(reference poor_man_gplvm/post_fit_workflow/): the port's own copy of
``poor_man_gplvm_tpu/workflows``, on the fits and decodes the port makes
on the card."""

from poor_man_gplvm_tpu_torch.workflows import ach_dataset, tmaze_dataset

__all__ = ["ach_dataset", "tmaze_dataset"]
