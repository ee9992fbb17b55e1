"""Content-addressed ground-truth cache (counterpart of
metapde_tpu/train/gt_cache.py), in the port's own format and directory.

An entry is an .npz of the ground truth's fields (a NamedTuple of the
port's solvers, e.g. fem_poisson.PoissonGroundTruth) plus its type's name.
Its key is the sha256 of the PDE name, the resolution, the PDE's
gt_version, the gt-affecting non-default TaskConfig fields
(task_cache_extra) and the task params' f32 bytes. The port draws eval
tasks on a host generator, so a CPU run and a card run of the same config
hit the same entry.

What differs from the JAX package, on purpose:
- The JAX entries pickle a JAX treedef and are keyed on threefry key bytes;
  the port can read neither, and writes nothing into a JAX cache directory:
  callers give it `gt_cache_torch/` where the JAX package uses `gt_cache/`.
- A failed solve raises. The JAX cache retries a failed device solve on the
  CPU; the port does not, so a fault of the device is never hidden.
Kept: the atomic write (temp file + os.replace) and the delete-and-re-solve
of an entry that cannot be read.
"""

import dataclasses
import hashlib
import importlib
import os
import zipfile

import numpy as np
import torch

from ..pdes.registry import solve_many

# TaskConfig fields that change what sample_params/solve produce for given
# task params or seed (the JAX package's list, copied)
_GT_TASK_FIELDS = (
    "vary_source", "vary_bc", "vary_geometry", "vary_ic", "bc_scale",
    "fixed_num_pdes", "num_tsteps", "max_reynolds", "burgers_formulation",
    "burgers_gt_solver", "max_holes", "max_hole_size", "domain",
)
_TYPE_KEY = "__type__"


def task_cache_extra(task_cfg) -> dict:
    """The gt-affecting TaskConfig fields that differ from their defaults,
    for the cache key: growing TaskConfig never invalidates a cache, and
    runs differing in such a field never share an entry."""
    default = type(task_cfg)()
    out = {}
    for f in _GT_TASK_FIELDS:
        v, d = getattr(task_cfg, f), getattr(default, f)
        if dataclasses.is_dataclass(v):
            v, d = dataclasses.asdict(v), dataclasses.asdict(d)
        if v != d:
            out[f] = v
    return out


def cache_key(pde_name: str, hparams: dict, params) -> str:
    h = hashlib.sha256()
    h.update(pde_name.encode())
    h.update(repr(sorted(hparams.items())).encode())
    for leaf in params:
        h.update(np.asarray(torch.as_tensor(leaf).detach().cpu(), np.float32).tobytes())
    return h.hexdigest()[:24]


def _save_atomic(path: str, arrays: dict) -> None:
    """Write an .npz so that readers see either nothing or a whole entry."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _gt_type(name: str):
    module, _, qualname = name.rpartition(".")
    if not module.startswith("metapde_tpu_torch."):
        raise KeyError(f"ground-truth type {name!r} is not the port's")
    return getattr(importlib.import_module(module), qualname)


class GroundTruthCache:
    """Ground truths under `cache_dir`; counts its hits and solves."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        self.hits = 0
        self.solves = 0
        os.makedirs(cache_dir, exist_ok=True)

    def path(self, pde, params, resolution: int, extra_hparams=None) -> str:
        hparams = {"resolution": resolution, "gt_version": getattr(pde, "gt_version", 1),
                   **(extra_hparams or {})}
        return os.path.join(self.cache_dir,
                            f"{pde.name}_{cache_key(pde.name, hparams, params)}.npz")

    def get_or_solve(self, pde, params, resolution: int, extra_hparams=None):
        """The cached ground truth of task `params` at `resolution`, on the
        params' device; solved with pde.solve and stored on a miss."""
        return self.get_or_solve_many(pde, [params], resolution, extra_hparams)[0]

    def get_or_solve_many(self, pde, params_list, resolution: int, extra_hparams=None):
        """The ground truths of several tasks: the cached ones read, the
        misses solved together by pde.solve_batched when the family has it
        (else one pde.solve each), and stored one entry per task."""
        paths = [self.path(pde, p, resolution, extra_hparams) for p in params_list]
        gts = [self._read(path, p[0].device) for path, p in zip(paths, params_list)]
        misses = [i for i, gt in enumerate(gts) if gt is None]
        self.hits += len(gts) - len(misses)
        if misses:
            solved = solve_many(pde, [params_list[i] for i in misses], resolution)
            for i, gt in zip(misses, solved):
                self.solves += 1
                arrays = {k: v.detach().cpu().numpy() for k, v in gt._asdict().items()}
                arrays[_TYPE_KEY] = np.asarray(f"{type(gt).__module__}.{type(gt).__qualname__}")
                _save_atomic(paths[i], arrays)
                gts[i] = gt
        return gts

    def _read(self, path, device):
        """The entry at `path` on `device`, or None (an unreadable entry is
        deleted)."""
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                stored = {k: z[k] for k in z.files}
            gt_type = _gt_type(str(stored.pop(_TYPE_KEY)))
            return gt_type(**{k: torch.as_tensor(v, device=device) for k, v in stored.items()})
        except (OSError, ValueError, EOFError, KeyError, TypeError, AttributeError,
                ImportError, zipfile.BadZipFile) as e:
            print(f"gt_cache: corrupt entry {path} ({type(e).__name__}); "
                  "deleting and re-solving", flush=True)
            os.remove(path)
            return None
