"""The JAX package's f32 Poisson solves on the port's tasks: the bar of
chip_smoke.py's ground_truth_mg phase and the Krylov counts behind its
gt_convergence bar.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_gt_floor_bar.py

- Resolution 32 (multigrid): ground_truth_mg's task (the first eval task
  of Config().seed + 7919, a host draw) solved by the JAX package's
  fem_poisson.solve and by the port's float64 solve_x64 to a Newton
  tolerance of 1e-13: JAX's f32 field's distance from it over the grid's
  largest |value| (the smoke holds each f32 solve to 3x that).
- Resolution 8 (Jacobi): gt_convergence's task (the first of seed 0).
- At both, the BiCGStab iterations of each Newton step, counted by
  wrapping the preconditioner that jax.scipy.sparse.linalg.bicgstab
  applies (twice an iteration, and nowhere else) in an ordered debug
  callback, and the final residual.

Prints one JSON line a resolution. Not a test: the float64 solve at 32
takes about a minute on a CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metapde_tpu.solvers import fem_poisson as j_fem
from metapde_tpu_torch.config import Config
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.solvers import fem_poisson

EVENTS = []
_BICGSTAB = jax.scipy.sparse.linalg.bicgstab


def _counted_bicgstab(A, b, M, **kw):
    jax.debug.callback(lambda: EVENTS.append("solve"), ordered=True)

    def counted_M(v):
        jax.debug.callback(lambda: EVENTS.append("preconditioned"), ordered=True)
        return M(v)

    return _BICGSTAB(A, b, M=counted_M, **kw)


def _krylov_per_newton_step():
    steps = []
    for e in EVENTS:
        if e == "solve":
            steps.append(0)
        else:
            steps[-1] += 1
    return [n // 2 for n in steps]


def main():
    # metapde_tpu/solvers/newton.py looks the solver up at trace time
    jax.scipy.sparse.linalg.bicgstab = _counted_bicgstab
    pde = get_pde(Config().task)
    for resolution, seed in ((32, Config().seed + 7919), (8, 0)):
        task = pde.sample_params(torch.Generator().manual_seed(seed))
        EVENTS.clear()
        theirs = j_fem.solve(tuple(jnp.asarray(a.numpy()) for a in task), resolution=resolution)
        u = np.asarray(theirs.u_grid, np.float64)
        row = {"resolution": resolution, "task_seed": seed,
               "krylov_per_newton_step": _krylov_per_newton_step(),
               "residual_norm": float(theirs.residual_norm)}
        if resolution == 32:
            ref = fem_poisson.solve_x64(task, resolution=resolution, rel_tol=1e-13,
                                        max_newton_steps=40, krylov_tol=1e-12)
            ref = ref.u_grid.numpy()
            row["f32_vs_x64"] = float(np.abs(u - ref).max() / np.abs(ref).max())
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
