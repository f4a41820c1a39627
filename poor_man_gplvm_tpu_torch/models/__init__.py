"""Model families of the port.

The classes answer, at class level, what a family is: their constructor
defaults (``ctor_defaults``), their transition (``transition_of``), tuning
link (``tuning_link``), emission and M-step hyperparameter keys, a
bucket's M-step (``m_step_batch``), ``observation_model``,
``has_dynamics`` and ``init_plus_uniform``.  The batched grid fit
(``parallel/sweep.py``) and model selection ask them, by the JAX
package's class names (``model_class_dict``).
"""

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

__all__ = [
    "AbstractGPLVM1D",
    "AbstractGPLVMJump1D",
    "GaussianGPLVM1D",
    "GaussianGPLVMJump1D",
    "PoissonGPLVM1D",
    "PoissonGPLVMJump1D",
    "model_class_dict",
    "resolve_model_class",
]

model_class_dict = {
    "poisson": PoissonGPLVMJump1D,
    "gaussian": GaussianGPLVMJump1D,
    "poisson_latentonly": PoissonGPLVM1D,
    "gaussian_latentonly": GaussianGPLVM1D,
}


def resolve_model_class(model_class_str):
    """The class of one of ``model_class_dict``'s names (not built: a
    constructor runs the basis SVD); any other name raises ``ValueError``."""
    if model_class_str not in model_class_dict:
        raise ValueError(f"Invalid model class: {model_class_str}")
    return model_class_dict[model_class_str]
