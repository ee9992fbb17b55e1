"""Read the JAX package's checkpoints without JAX or optax
(counterpart of metapde_tpu/train/checkpoints.py, read side).

A checkpoint is a pickled dict: ``step``, ``params`` and ``inner_lrs`` (trees
of numpy arrays), and optimizer states, which pickle optax classes such as
``optax._src.transform.ScaleByAdamState``. Deployment never uses the
optimizer states, so the unpickler maps every class of optax, jax, jaxlib,
flax or chex to an inert placeholder (a tuple subclass that keeps whatever
it is given). Checkpoints written under numpy 2 name ``numpy._core.*``; under
numpy 1.x those names are read from ``numpy.core.*``.
"""

import os
import pickle
import re
from typing import Optional

import numpy as np

BEST_NAME = "checkpoint_best.pickle"
_FOREIGN = ("optax", "jax", "jaxlib", "flax", "chex")


class InertPlaceholder(tuple):
    """Stands in for a class of a package the port does not import."""

    def __new__(cls, *args):
        return super().__new__(cls, args)

    def __setstate__(self, state):
        self.__dict__["state"] = state


class _CheckpointUnpickler(pickle.Unpickler):
    _placeholders = {}

    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            key = f"{module}.{name}"
            if key not in self._placeholders:
                self._placeholders[key] = type(name, (InertPlaceholder,),
                                               {"__module__": module})
            return self._placeholders[key]
        if module.startswith("numpy._core") and int(np.__version__.split(".")[0]) < 2:
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def load_checkpoint(fname: str) -> dict:
    """The checkpoint dict; params and inner_lrs stay numpy trees (convert
    them with interop.params_from_numpy)."""
    with open(fname, "rb") as f:
        return _CheckpointUnpickler(f).load()


def latest_checkpoint(path: str) -> Optional[str]:
    """Highest-numbered checkpoint_step_* (or reference model_step_*) file."""
    if not os.path.isdir(path):
        return None
    cands = [f for f in os.listdir(path)
             if "checkpoint_step" in f or "model_step" in f]
    if not cands:
        return None
    steps = [int(re.findall(r"[0-9]+", f)[-1]) for f in cands]
    return os.path.join(path, cands[int(np.argmax(steps))])


def best_checkpoint(path: str) -> Optional[str]:
    """checkpoint_best.pickle if present."""
    fname = os.path.join(path, BEST_NAME)
    return fname if os.path.exists(fname) else None
