"""Reference-compatible plotting module (the JAX package's
``plot_helper``, itself mirroring ``poor_man_gplvm.plot_helper``; plotly
helpers raise a clear ImportError when plotly is absent)."""

from poor_man_gplvm_tpu_torch.plotting import *  # noqa: F401,F403
