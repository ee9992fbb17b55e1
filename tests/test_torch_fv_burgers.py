"""The TD-Burgers FV ground truth: metapde_tpu.solvers.fv_burgers against
metapde_tpu_torch.solvers.fv_burgers, on the same task params (numpy from a
seed, Re and IC coefficients in the task distribution's ranges).

- godunov_flux (the closed form) equals the JAX package's case split bit
  for bit, zeros and ties included; n_substeps is the JAX one.
- solve against JAX: u_grid within 1e-5 of the grid's largest |u| at
  resolution 128 with 11 output times (measured 1.8e-6), and within 5e-5
  at bm7_5's 512 with 201 (one task; measured 1.4e-5). The gap is not the
  port's arithmetic order: started from JAX's own initial values, the port
  still differs after one output time, because XLA fuses multiply-adds
  over the 22,200 RK stages and the port does not; the IC's f32 sines also
  differ from XLA's by an ulp at ~25% of the centers. t_grid and x_grid
  equal JAX's bit for bit.
- evaluate against the JAX evaluate on the same ground truth, walls and
  out-of-range times included: within 1e-7 (measured 0).
- a batched solve equals per-task solves bit for bit; solve_x64 against
  JAX's float64 solve within 1e-10 of the max (measured ~1e-14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.pdes.burgers_formulations import default as j_default
from metapde_tpu.solvers import fv_burgers as j_fv
from metapde_tpu_torch.pdes.burgers_formulations import default
from metapde_tpu_torch.solvers import fv_burgers

torch.set_num_threads(2)


def _tasks(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(np.array([100.0 * rng.uniform(0.8, 1.0)], np.float32),
             rng.uniform(-2.0, 2.0, 2).astype(np.float32)) for _ in range(n)]


def _jax_solve(task, res, nt, x64=False):
    fn = j_fv.solve_x64 if x64 else j_fv.solve
    return fn(tuple(jnp.asarray(a) for a in task), resolution=res, num_tsteps=nt,
              max_reynolds=100.0, ic_fn=j_default.ic_fn)


def _solve(task, res, nt, x64=False):
    fn = fv_burgers.solve_x64 if x64 else fv_burgers.solve
    return fn(tuple(torch.tensor(a) for a in task), resolution=res, num_tsteps=nt,
              max_reynolds=100.0, ic_fn=default.ic_fn)


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def test_godunov_flux_equals_the_case_split_bit_for_bit():
    rng = np.random.default_rng(1)
    ul = rng.normal(0.0, 2.0, 4000).astype(np.float32)
    ur = rng.normal(0.0, 2.0, 4000).astype(np.float32)
    edges = np.array([0.0, -0.0, 1.5, -1.5, 0.0, 2.0, -2.0], np.float32)
    ul = np.concatenate([ul, edges, edges[::-1], ul[:7]])
    ur = np.concatenate([ur, edges[::-1], edges, ul[:7]])  # ties ul == ur
    j = np.asarray(j_fv._godunov_flux(jnp.asarray(ul), jnp.asarray(ur)))
    t = fv_burgers.godunov_flux(torch.tensor(ul), torch.tensor(ur)).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


@pytest.mark.parametrize("args", [(512, 1.0, 1.0, 100.0, 0.4, 5.0, 201),
                                  (128, 1.0, 1.0, 100.0, 0.4, 5.0, 11),
                                  (100, 2.0, 0.5, 40.0, 0.3, 5.0, 7)])
def test_n_substeps_is_jax_s(args):
    assert fv_burgers.n_substeps(*args) == j_fv._n_substeps(*args)


def test_bm7_5_step_count():
    """resolution 512, 201 output times, max_reynolds 100: 7,400 SSP-RK3
    steps, 37 an output segment."""
    assert fv_burgers.n_substeps(512, 1.0, 1.0, 100.0, 0.4, 5.0, 201) == (7400, 37)


@pytest.mark.parametrize("i", range(3))
def test_solve_matches_jax_at_resolution_128(i):
    task = _tasks(3)[i]
    j, t = _jax_solve(task, 128, 11), _solve(task, 128, 11)
    assert t.u_grid.shape == (11, 130)
    assert _rel(t.u_grid.numpy(), j.u_grid) <= 1e-5
    np.testing.assert_array_equal(t.t_grid.numpy(), np.asarray(j.t_grid))
    np.testing.assert_array_equal(t.x_grid.numpy(), np.asarray(j.x_grid))


def test_solve_matches_jax_at_bm7_5_resolution():
    task = _tasks(1, seed=5)[0]
    j, t = _jax_solve(task, 512, 201), _solve(task, 512, 201)
    assert t.u_grid.shape == (201, 514)
    assert _rel(t.u_grid.numpy(), j.u_grid) <= 5e-5
    np.testing.assert_array_equal(t.t_grid.numpy(), np.asarray(j.t_grid))


def test_evaluate_matches_jax_on_the_same_ground_truth():
    j = _jax_solve(_tasks(1, seed=2)[0], 128, 11)
    gt = fv_burgers.BurgersGroundTruth(*(torch.tensor(np.asarray(a)) for a in j))
    rng = np.random.default_rng(3)
    xt = rng.uniform(-0.05, 1.05, (600, 2)).astype(np.float32)
    xt[:6] = [[0.0, 0.0], [1.0, 1.0], [0.0, 0.5], [1.0, 0.3], [0.5 / 128, 0.95], [0.5, 1.2]]
    je = np.asarray(jax.vmap(lambda x: j_fv.evaluate(j, x))(xt))
    te = fv_burgers.evaluate(gt, torch.tensor(xt)).numpy()
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-7)


def test_evaluate_at_the_walls_gives_the_boundary_values():
    """The half-cell mapping: u(xmin) is the mean of the ghost and the first
    center, i.e. the wall value (ghost = 2 bc - center), not the ghost."""
    task = _tasks(1, seed=4)[0]
    gt = _solve(task, 64, 11)
    t = torch.tensor(gt.t_grid.numpy())
    walls = torch.stack([torch.cat([torch.zeros(11), torch.ones(11)]), torch.cat([t, t])], 1)
    bc = default.ic_fn(torch.tensor([0.0, 1.0]), tuple(torch.tensor(a) for a in task))
    vals = fv_burgers.evaluate(gt, walls)
    np.testing.assert_allclose(vals[:11].numpy(), float(bc[0]), atol=1e-6)
    np.testing.assert_allclose(vals[11:].numpy(), float(bc[1]), atol=1e-6)


def test_batched_solve_equals_per_task_solves_bit_for_bit():
    tasks = [tuple(torch.tensor(a) for a in task) for task in _tasks(3, seed=6)]
    kw = dict(resolution=128, num_tsteps=11, max_reynolds=100.0, ic_fn=default.ic_fn)
    batched = fv_burgers.solve_batched(tasks, **kw)
    for task, b in zip(tasks, batched):
        one = fv_burgers.solve(task, **kw)
        for x, y in zip(one, b):
            assert torch.equal(x, y)


def test_stacked_evaluate_equals_per_task_evaluate():
    tasks = [tuple(torch.tensor(a) for a in task) for task in _tasks(2, seed=7)]
    gts = fv_burgers.solve_batched(tasks, resolution=64, num_tsteps=11, max_reynolds=100.0,
                                   ic_fn=default.ic_fn)
    xt = torch.rand(2, 50, 2, generator=torch.Generator().manual_seed(0))
    stacked = fv_burgers.BurgersGroundTruth(torch.stack([g.u_grid for g in gts]),
                                            gts[0].x_grid, gts[0].t_grid)
    both = fv_burgers.evaluate(stacked, xt)
    for i, gt in enumerate(gts):
        assert torch.equal(both[i], fv_burgers.evaluate(gt, xt[i]))


def test_solve_x64_matches_jax_float64():
    task = _tasks(1, seed=8)[0]
    with jax.enable_x64(True):
        j = _jax_solve(task, 128, 11, x64=True)
        ju = np.asarray(j.u_grid)
    t = _solve(task, 128, 11, x64=True)
    assert t.u_grid.dtype == torch.float64 and ju.dtype == np.float64
    assert _rel(t.u_grid.numpy(), ju) <= 1e-10
