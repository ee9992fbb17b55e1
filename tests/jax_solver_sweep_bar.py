"""The JAX package's solver sweep on the port's tasks: the bar of
chip_smoke.py's solver_baseline phase.

    env JAX_PLATFORMS=cpu python tests/jax_solver_sweep_bar.py [--n_eval=4] [--ref=32] \
        [--resolutions=4,8,16]

Draws the tasks and validation coords as the port's
train/baseline_driver.run draws them (a host generator seeded cfg.seed:
the tasks, then each task's coords), solves each task with the JAX
package's float64 reference at --ref and its production solve at each
resolution, and prints one JSON line: rel_mse per resolution by the JAX
baseline driver's formula (metapde_tpu/train/baseline_driver.py:104-107).
Not a test: a float64 solve at 32 takes ~40 s on a CPU.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.solvers import fem_poisson as j_fem
from metapde_tpu_torch.config import Config
from metapde_tpu_torch.pdes import get_pde


def main(argv):
    opts = {"n_eval": 4, "ref": 32, "resolutions": "4,8,16"}
    for a in argv:
        name, _, value = a[2:].partition("=")
        opts[name] = value
    cfg = Config()
    pde, j_pde = get_pde(cfg.task), j_get_pde(JConfig().task)
    gen = torch.Generator().manual_seed(cfg.seed)
    tasks = [pde.sample_params(gen) for _ in range(int(opts["n_eval"]))]
    coords = [pde.sample_validation_points(gen, cfg.task.validation_points, tp)
              for tp in tasks]
    j_tasks = [tuple(jnp.asarray(a.numpy()) for a in tp) for tp in tasks]
    j_coords = [jnp.asarray(c.numpy()) for c in coords]

    def values(gt, x):
        return np.asarray(jax.vmap(lambda p: j_pde.evaluate_gt(gt, p))(x), np.float64)

    refs = [values(j_fem.solve_x64(tp, resolution=int(opts["ref"])), x).reshape(-1, 1)
            for tp, x in zip(j_tasks, j_coords)]
    rows = {}
    for res in map(int, opts["resolutions"].split(",")):
        errs = []
        for tp, x, ref in zip(j_tasks, j_coords, refs):
            v = values(j_fem.solve(tp, resolution=res), x).reshape(ref.shape)
            normalizer = np.mean(ref ** 2, axis=0, keepdims=True).mean()
            errs.append(float(np.mean((v - ref) ** 2 / max(normalizer, 1e-12))))
        rows[str(res)] = {"rel_mse": float(np.mean(errs)), "per_task": errs}
    print(json.dumps({"n_eval": int(opts["n_eval"]), "ref": int(opts["ref"]), "rows": rows}))


if __name__ == "__main__":
    main(sys.argv[1:])
