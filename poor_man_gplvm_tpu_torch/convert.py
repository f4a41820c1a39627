"""Carry a JAX model's weights and optimizer state into a port model.

The JAX package and the port build their tuning bases by SVD, whose
singular vectors are defined only up to sign (and order, for equal
singular values).  Loading the JAX model's ``tuning_basis`` together with
its ``params`` makes both packages compute the same tuning curves, and so
the same decode.  An optax Adam state carried across with
``adam_state_from_jax`` lets a fit continue from where the JAX one stopped,
and ``checkpoint_state_from_jax`` turns a whole EM checkpoint of the JAX
package into the port's, so that ``fit_em(resume=True)`` continues a fit
the JAX package checkpointed.  Everything crosses as numpy arrays: this
module imports neither jax, optax nor the JAX package (unpickling a JAX
checkpoint needs optax, where the caller has it).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_model", "load_jax_state", "adam_state_from_jax",
           "checkpoint_state_from_jax"]


def state_from_model(model):
    """``{'params', 'tuning_basis', 'tuning'}`` of a model of either package
    as float32 numpy arrays."""
    return {
        k: np.asarray(getattr(model, k), dtype=np.float32)
        for k in ("params", "tuning_basis", "tuning")
    }


def load_jax_state(model, params, tuning_basis, tuning=None):
    """Load ``params`` (n_basis, N) and ``tuning_basis`` (L, n_basis) into
    the port ``model`` (in place, on its device) and return it.  ``tuning``
    (L, N) is taken as given when passed, else recomputed through the
    model's link function."""
    params = np.asarray(params, dtype=np.float32)
    tuning_basis = np.asarray(tuning_basis, dtype=np.float32)
    n_basis, n_neuron = params.shape
    if n_neuron != model.n_neuron:
        raise ValueError(f"params has {n_neuron} neurons, model has "
                         f"{model.n_neuron}")
    if tuning_basis.shape != (model.n_latent_bin, n_basis):
        raise ValueError(
            f"tuning_basis must be ({model.n_latent_bin}, {n_basis}), got "
            f"{tuning_basis.shape}"
        )
    model.params = torch.tensor(params, device=model.device)
    model.tuning_basis = torch.tensor(tuning_basis, device=model.device)
    model.n_basis = n_basis
    if tuning is None:
        model.tuning = model.get_tuning(model.params, {}, model.tuning_basis)
    else:
        tuning = np.asarray(tuning, dtype=np.float32)
        if tuning.shape != (model.n_latent_bin, n_neuron):
            raise ValueError(f"tuning must be ({model.n_latent_bin}, "
                             f"{n_neuron}), got {tuning.shape}")
        model.tuning = torch.tensor(tuning, device=model.device)
    return model


def _find_adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax state: ``optax.adam`` gives a
    tuple (ScaleByAdamState, EmptyState); found by its fields, so optax
    need not be imported."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _find_adam_state(part)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state, device="cuda"):
    """The port's ``AdamState`` from an optax ``optax.adam`` state (or its
    ``ScaleByAdamState``): count as int32, mu and nu as float32, on
    ``device`` (the card by default; without one that raises, and
    ``device='cpu'`` keeps it on the CPU)."""
    from poor_man_gplvm_tpu_torch.models.base import resolve_device
    from poor_man_gplvm_tpu_torch.ops.mstep import AdamState

    device = resolve_device(device)
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in opt_state")
    return AdamState(
        count=torch.tensor(np.asarray(adam.count, dtype=np.int32),
                           device=device),
        mu=torch.tensor(np.asarray(adam.mu, dtype=np.float32), device=device),
        nu=torch.tensor(np.asarray(adam.nu, dtype=np.float32), device=device),
    )


def checkpoint_state_from_jax(state, device="cuda"):
    """The port's EM checkpoint state from the JAX package's (the dict its
    ``EMCheckpointer.restore`` returns): ``step`` as an int, ``params`` and
    ``log_posterior`` as float32 tensors on ``device``, ``opt_state``
    through ``adam_state_from_jax`` (None stays None: a ridge M-step has no
    optimizer state) and ``rng``, the JAX key, as a numpy array (neither
    package restores it).  Save it with the port's
    ``utils.checkpoint.EMCheckpointer`` and resume with ``fit_em(
    checkpoint_dir=..., resume=True)``; load the JAX model's
    ``tuning_basis`` first (``load_jax_state``), since ``params`` are
    weights on that basis."""
    from poor_man_gplvm_tpu_torch.models.base import resolve_device

    device = resolve_device(device)
    opt_state = state.get("opt_state")
    return {
        "step": int(state["step"]),
        "params": torch.tensor(np.asarray(state["params"], dtype=np.float32),
                               device=device),
        "opt_state": None if opt_state is None
        else adam_state_from_jax(opt_state, device=device),
        "log_posterior": torch.tensor(
            np.asarray(state["log_posterior"], dtype=np.float32),
            device=device),
        "rng": np.asarray(state.get("rng")),
    }
