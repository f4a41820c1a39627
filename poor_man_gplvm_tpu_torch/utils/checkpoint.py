"""EM checkpoint/resume.

Counterpart of ``poor_man_gplvm_tpu/utils/checkpoint.py``, in its step
layout: one directory ``step_<8 digits>`` per saved EM iteration, holding
``state.pkl``, a pickled dict ``{"step", "params", "opt_state",
"log_posterior", "rng"}`` (``fit_em(checkpoint_dir=..., resume=...)``
writes and reads it).

``state.pkl`` holds plain numpy arrays only, so that it unpickles without
torch or optax: a tensor is stored as its numpy array, the port's
``AdamState`` (any named tuple) as the dict of its fields, and a
``torch.Generator`` as its ``get_state()``.  The card's machine has no
orbax, so ``use_orbax=True`` raises (the JAX package falls back to pickle
silently when orbax is missing).
"""

from __future__ import annotations

import os
import pickle

import torch

__all__ = ["EMCheckpointer", "to_host"]


def to_host(state):
    """``state`` with every tensor as a numpy array, every named tuple as
    the dict of its fields and every ``torch.Generator`` as its state
    (uint8 numpy), recursively through dicts, lists and tuples."""
    if torch.is_tensor(state):
        return state.detach().cpu().numpy()
    if isinstance(state, torch.Generator):
        return state.get_state().numpy()
    if isinstance(state, dict):
        return {k: to_host(v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return {k: to_host(v) for k, v in zip(state._fields, state)}
    if isinstance(state, (list, tuple)):
        return type(state)(to_host(v) for v in state)
    return state


class EMCheckpointer:
    """Step-indexed checkpoint store for EM states (see the module
    docstring).  ``use_orbax=True`` raises ``ValueError``."""

    def __init__(self, directory, use_orbax=False):
        if use_orbax:
            raise ValueError(
                "use_orbax=True: the port stores checkpoints as pickled "
                "numpy only (orbax is not a dependency of the port)")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _step_path(self, step):
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step, state):
        """Persist one EM step's state (copied to the host first).  The
        file is written under a temporary name and renamed into place, so
        an interrupted save leaves no partial ``state.pkl``."""
        state = to_host(state)
        path = self._step_path(step)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(path, "state.pkl"))

    def restore(self, step=None, template=None):
        """The state of ``step`` (default: the latest), or None when the
        store is empty.  ``template`` is accepted and ignored, as by the
        JAX package's pickle backend: the pickle keeps the structure."""
        del template
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        with open(os.path.join(self._step_path(step), "state.pkl"),
                  "rb") as f:
            return pickle.load(f)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(steps)
