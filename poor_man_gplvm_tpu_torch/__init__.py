"""poor_man_gplvm_tpu_torch — PyTorch/CUDA port of ``poor_man_gplvm_tpu``.

The port mirrors the JAX package's module paths, names and result-dict
contracts; the JAX package stays the reference it is tested against.  It
imports ``torch`` only: no jax, no triton, and no GPU is needed to import
it.  The filter/smoother scans run as hand-written CUDA kernels on a CUDA
device, built with ``nvcc`` at first use: the sequential pair K1/K2
(``csrc/scan_kernels.cu``) and the parallel-in-time pair K3/K4
(``csrc/parallel_scan.cu``) for long sequences.

Ported: the four concrete model classes of the JAX package,
``PoissonGPLVMJump1D``, ``GaussianGPLVMJump1D``, ``PoissonGPLVM1D`` and
``GaussianGPLVM1D``, with their abstract bases: decoding
(``decode_latent``, ``decode_latent_naive_bayes``,
``decode_latent_epochs``), sampling and fitting (``fit_em``, with
checkpoint/resume), on the engines ``'prob'``, ``'log'``, ``'cuda'`` and
``'cuda_parallel'``; the initial posteriors of ``initializers``; the
circular-shuffle validation of ``validation``; the time-series
containers (``utils.timeseries``, or pynapple's where it is installed)
that ``t_l``/TsdFrame inputs and results use; the batched sweeps of
``parallel.sweep`` and the model selection of ``selection`` (K1/K2 with
one transition configuration per sequence, the norm-only K1 for the
downsampled log-marginals); the gain model of ``experimental``; and the
legacy per-neuron L-BFGS M-step of ``ops.fit_tuning_with_basis``.
"""

from poor_man_gplvm_tpu_torch import (
    convert,
    experimental,
    initializers,
    models,
    ops,
    parallel,
    selection,
    utils,
    validation,
)
from poor_man_gplvm_tpu_torch.models.jump1d import (
    AbstractGPLVMJump1D,
    GaussianGPLVMJump1D,
    PoissonGPLVMJump1D,
)
from poor_man_gplvm_tpu_torch.models.latent1d import (
    AbstractGPLVM1D,
    GaussianGPLVM1D,
    PoissonGPLVM1D,
)
from poor_man_gplvm_tpu_torch.ops.basis import generate_basis
from poor_man_gplvm_tpu_torch.utils.timeseries import (
    IntervalSet,
    Ts,
    Tsd,
    TsdFrame,
    TsGroup,
)

__all__ = [
    "AbstractGPLVM1D",
    "AbstractGPLVMJump1D",
    "GaussianGPLVM1D",
    "GaussianGPLVMJump1D",
    "IntervalSet",
    "PoissonGPLVM1D",
    "PoissonGPLVMJump1D",
    "Ts",
    "Tsd",
    "TsdFrame",
    "TsGroup",
    "convert",
    "experimental",
    "generate_basis",
    "initializers",
    "models",
    "ops",
    "parallel",
    "selection",
    "utils",
    "validation",
]
