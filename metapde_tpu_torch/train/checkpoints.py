"""Checkpoints both packages read (counterpart of
metapde_tpu/train/checkpoints.py).

A checkpoint is a pickled dict. The keys the JAX package reads keep its
layout: ``step`` (an int), ``params`` and ``inner_lrs`` (trees of numpy
arrays), and ``best_metric`` in the best checkpoint. The JAX package also
writes optax optimizer states, its PRNG key and its eval-task keys
(``opt_state``, ``lr_opt_state``, ``prng_key``, ``gt_key``,
``gt_points_key``). The port never writes those: the JAX driver would take
them for optax states and JAX keys. Its own state goes under keys the JAX
package never reads: ``torch_opt_state`` and ``torch_lr_opt_state`` (the
optimizers' dict states as numpy trees), ``torch_rng_state`` (the training
generator's state), ``torch_eval_seed`` (the eval tasks' seed) and
``torch_next_step`` (the step a resume starts at). Nothing in a port
checkpoint needs torch or the port to unpickle.

Reading: the JAX package's optimizer states pickle optax classes such as
``optax._src.transform.ScaleByAdamState`` (and, for ranger, the JAX
package's own ``LookaheadState``). The unpickler maps every class of optax,
jax, jaxlib, flax, chex or metapde_tpu to an inert placeholder (a tuple
subclass that keeps whatever it is given), so reading never imports them;
train/optimizers.from_jax_state rebuilds a state from those placeholders.
Checkpoints written under numpy 2 name ``numpy._core.*``; under numpy 1.x
those names are read from ``numpy.core.*``.
"""

import dataclasses
import json
import math
import os
import pickle
import re
from typing import Optional

import numpy as np
import torch

BEST_NAME = "checkpoint_best.pickle"
_FOREIGN = ("optax", "jax", "jaxlib", "flax", "chex", "metapde_tpu")
# keys the JAX driver reads as optax states and JAX PRNG keys
JAX_ONLY_KEYS = ("opt_state", "lr_opt_state", "prng_key", "gt_key", "gt_points_key")


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


def _to_host(tree):
    """Tensors -> numpy arrays, through dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def _dump(fname: str, record: dict):
    bad = [k for k in record if k in JAX_ONLY_KEYS]
    if bad:
        raise ValueError(f"the port does not write the JAX package's keys {bad}")
    with open(fname, "wb") as f:
        pickle.dump(_to_host(record), f, protocol=pickle.HIGHEST_PROTOCOL)


def save_checkpoint(path: str, step: int, state: dict):
    """Write checkpoint_step_{step}.pickle under `path`."""
    fname = os.path.join(path, f"checkpoint_step_{step}.pickle")
    _dump(fname, {"step": int(step), **state})
    return fname


# per-path cache of the current best metric, so tracking does not unpickle
# the best checkpoint at every validation
_BEST_METRIC_CACHE = {}


def save_best_checkpoint(path: str, step: int, metric: float, state: dict):
    """Write or overwrite checkpoint_best.pickle when `metric` improves.
    Non-finite metrics are never tracked, and a stored non-finite best
    counts as none. Returns the filename when written, else None."""
    if not math.isfinite(metric):
        return None
    fname = os.path.join(path, BEST_NAME)
    prev = _BEST_METRIC_CACHE.get(fname)
    if prev is None and os.path.exists(fname):
        try:
            prev = load_checkpoint(fname).get("best_metric")
        except Exception:
            prev = None
        if prev is not None and not math.isfinite(prev):
            prev = None
    if prev is not None and not (metric < prev):
        _BEST_METRIC_CACHE[fname] = prev
        return None
    _dump(fname, {"step": int(step), "best_metric": float(metric), **state})
    _BEST_METRIC_CACHE[fname] = float(metric)
    return fname


def config_drift(expt_dir: str, cfg, sections=("task", "model", "solver")):
    """"section.field: old -> new" for each field of `sections` that differs
    between `expt_dir`/config.json and `cfg`; fields present on one side
    only are schema growth, not drift. A missing or unreadable config.json
    gives an empty list."""
    try:
        with open(os.path.join(expt_dir, "config.json")) as f:
            old = json.load(f)
    except (OSError, ValueError):
        return []
    new = dataclasses.asdict(cfg)

    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = v
        return out

    drifts = []
    for sec in sections:
        a, b = flat(old.get(sec, {}) or {}), flat(new.get(sec, {}) or {})
        for k in sorted(set(a) & set(b)):
            if a[k] != b[k]:
                drifts.append(f"{sec}.{k}: {a[k]!r} -> {b[k]!r}")
    return drifts
