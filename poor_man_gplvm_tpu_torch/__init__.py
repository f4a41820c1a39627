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
downsampled log-marginals); the gain model of ``experimental``; the
legacy per-neuron L-BFGS M-step of ``ops.fit_tuning_with_basis``; the
reactivation analyses of ``analysis.reactivation`` (the within-epoch
shuffle null as one K1 and one K2 launch per batch of shuffles); and the
JAX package's drop-in surface: the modules ``core``, ``decoder``,
``decoder_latentonly``, ``gp_kernel``, ``fit_tuning_helper``,
``fit_tuning_with_basis``, ``initializer``, ``jump_analysis``,
``model_selection_helper``, ``reactivation_analysis``, ``test``,
``verify_latent_jump``, ``config`` and ``experimental.{core_exp,
decoder_exp, fit_tuning_helper_exp, test_exp}``, under the same names.
A script written against the JAX package's functional decoder runs
unchanged: those entry points take ``device="cuda"`` (inputs moved there;
without a card it raises) and ``engine=None`` (``'cuda'`` on the card,
``'prob'`` on the CPU), and read the JAX engine names ``'pallas'`` and
``'pallas_parallel'`` as ``'cuda'`` and ``'cuda_parallel'``.

The session-ingestion layer is the port's own copy too: ``data`` (the
Kilosort/CellExplorer/behavior loaders, which read without pandas, the
binners with the native C++ spike binner built at first use, unit
filters and sorting, burst detection, blocked CV, and the naive-Bayes
baseline decoders, which compute in float64 on the card), the analyses
of ``analysis`` (``ccg``, ``distance``, ``posterior``, ``regression``,
``trial``) with their root modules ``analysis_helper``,
``distance_analysis`` and ``trial_analysis``, and ``utils.stats`` and
``utils.sorting``.  Where a JAX function returns a DataFrame or Series
they return ``utils.table.ResultTable``.

The post-fit layer too: ``plotting`` (matplotlib, seaborn, sklearn and
plotly imported by the functions that draw with them), the T-maze and
ACh workflows of ``workflows`` on the port's fits and decodes,
``utils.pandas_util`` (on a ``ResultTable`` without pandas) and the root
modules ``pandas_util`` and ``plot_helper``.  With them the port has a
counterpart of every module of the JAX package.
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
from poor_man_gplvm_tpu_torch.config import (
    get_matmul_precision,
    set_matmul_precision,
    set_scan_precision,
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

# the JAX package's reference-compatible submodule surface
from poor_man_gplvm_tpu_torch import (  # noqa: E402,F401
    analysis,
    analysis_helper,
    config,
    core,
    data,
    decoder,
    decoder_latentonly,
    distance_analysis,
    fit_tuning_helper,
    fit_tuning_with_basis,
    gp_kernel,
    initializer,
    jump_analysis,
    model_selection_helper,
    pandas_util,
    plot_helper,
    plotting,
    reactivation_analysis,
    test,
    trial_analysis,
    verify_latent_jump,
    workflows,
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
    "analysis",
    "analysis_helper",
    "config",
    "convert",
    "core",
    "data",
    "decoder",
    "decoder_latentonly",
    "distance_analysis",
    "experimental",
    "fit_tuning_helper",
    "fit_tuning_with_basis",
    "generate_basis",
    "get_matmul_precision",
    "gp_kernel",
    "initializer",
    "initializers",
    "jump_analysis",
    "model_selection_helper",
    "models",
    "ops",
    "pandas_util",
    "parallel",
    "plot_helper",
    "plotting",
    "reactivation_analysis",
    "selection",
    "set_matmul_precision",
    "set_scan_precision",
    "test",
    "trial_analysis",
    "utils",
    "validation",
    "verify_latent_jump",
    "workflows",
]
