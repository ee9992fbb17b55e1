"""The TD-Burgers FEM ground truth (task.burgers_gt_solver=fem):
metapde_tpu.solvers.fem_td_burgers against
metapde_tpu_torch.solvers.fem_td_burgers on the same task params.

- solve at resolution 64 with 11 output times (7 implicit-Euler substeps
  an output time, a damped Newton-BiCGStab solve each): u_grid within 1e-5
  of the grid's largest |u| (measured 8.8e-8: both stop at iterates inside
  the same Newton tolerance); t_grid and the nodes equal JAX's bit for bit.
- evaluate (nodes on the walls) against the JAX evaluate on the same
  ground truth: within 1e-7 (measured 0).
- the td_burgers family with burgers_gt_solver=fem solves and evaluates
  through this module and has no float64 reference, as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metapde_tpu.pdes.burgers_formulations import default as j_default
from metapde_tpu.solvers import fem_td_burgers as j_fem
from metapde_tpu_torch.config import TaskConfig
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.pdes.burgers_formulations import default
from metapde_tpu_torch.solvers import fem_td_burgers, newton

torch.set_num_threads(2)

TASK = (np.array([98.95334], np.float32), np.array([0.7, -1.3], np.float32))


def _jax_solve():
    return j_fem.solve(tuple(jnp.asarray(a) for a in TASK), resolution=64, num_tsteps=11,
                       ic_fn=j_default.ic_fn)


def test_solve_matches_jax_at_resolution_64():
    j = _jax_solve()
    newton.newton_krylov.steps = 0
    t = fem_td_burgers.solve(tuple(torch.tensor(a) for a in TASK), resolution=64,
                             num_tsteps=11, ic_fn=default.ic_fn)
    ju = np.asarray(j.u_grid)
    assert t.u_grid.shape == ju.shape == (11, 65)
    assert float(np.abs(t.u_grid.numpy() - ju).max() / np.abs(ju).max()) <= 1e-5
    assert newton.newton_krylov.steps >= 70  # at least one Newton step a substep
    np.testing.assert_array_equal(t.t_grid.numpy(), np.asarray(j.t_grid))
    np.testing.assert_array_equal(t.x_grid.numpy(), np.asarray(j.x_grid))


def test_evaluate_matches_jax_on_the_same_ground_truth():
    j = _jax_solve()
    gt = fem_td_burgers.BurgersGroundTruth(*(torch.tensor(np.asarray(a)) for a in j))
    rng = np.random.default_rng(3)
    xt = rng.uniform(-0.05, 1.05, (500, 2)).astype(np.float32)
    xt[:4] = [[0.0, 0.0], [1.0, 1.0], [0.0, 0.5], [1.0, 1.3]]
    je = np.asarray(jax.vmap(lambda x: j_fem.evaluate(j, x))(xt))
    te = fem_td_burgers.evaluate(gt, torch.tensor(xt)).numpy()
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-7)


def test_the_family_dispatches_to_fem():
    pde = get_pde(TaskConfig(pde="td_burgers", burgers_gt_solver="fem", num_tsteps=3))
    assert pde.solve_ref is None and pde.evaluate_gt is fem_td_burgers.evaluate
    params = pde.sample_params(torch.Generator().manual_seed(0))
    (gt,) = pde.solve_batched([params], resolution=8)
    one = pde.solve(params, resolution=8)
    assert gt.u_grid.shape == (3, 9) and torch.equal(gt.u_grid, one.u_grid)
