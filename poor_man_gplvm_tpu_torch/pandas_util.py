"""Reference-compatible pandas utilities (the JAX package's
``pandas_util``, itself mirroring ``poor_man_gplvm.pandas_util``); works
on a ``ResultTable`` without pandas."""

from poor_man_gplvm_tpu_torch.utils.pandas_util import filter_df_with_spec  # noqa: F401
