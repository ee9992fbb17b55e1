"""The steady-Burgers FEM ground truth and the rect-lattice multigrid:
metapde_tpu.solvers.{fem_steady_burgers,multigrid} against the PyTorch port
on JAX's task params (sbi10_2's distribution: up to 4 pores, Re <= 10).

- solve at resolution 8 and 16 against JAX's u_grid: within 1e-4 of the
  grid's largest |u|. The f32 Newton of both stops at rel_tol 2e-5 of the
  initial residual (it stalls below ~2e-5), so the two iterates differ by
  the Krylov solves' round-off inside that tolerance (measured 6e-8 to
  1.2e-7 of the scale at resolution 8, 16 and 48); coords, alive flags and
  the final residual norm (both below 1e-5) agree.
- solve_x64 at resolution 8 against JAX's solve_x64: within 1e-8 of the
  scale (both at Newton rel_tol 1e-9).
- evaluate (P1 on the snapped mesh) on JAX's ground truth against JAX's
  evaluate at 500 points, outside pores included: within 1e-6 of the scale.
- Zero inlet and outlet amplitudes give u = 0 exactly.
- precond "mg" (the rect V-cycle, vector_dim 2) converges to the Jacobi
  solution: within 1e-4 of the scale, in fewer Krylov iterations.
- The rect V-cycle at resolution 16 (levels 16 and 8) against JAX's
  make_rect_mg_preconditioner on the same right-hand sides: within 1e-5 of
  the output's largest |value|, scalar and vector_dim 2; it is linear
  (1e-5) and contracts the residual of interior rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import TaskConfig as JTaskConfig
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.solvers import fem_steady_burgers as j_fsb
from metapde_tpu.solvers import multigrid as j_mg
from metapde_tpu_torch.solvers import fem_steady_burgers as fsb
from metapde_tpu_torch.solvers import multigrid as mg
from metapde_tpu_torch.solvers import newton

torch.set_num_threads(2)

J_PDE = j_get_pde(JTaskConfig(pde="steady_burgers", max_holes=4, max_hole_size=0.3,
                              max_reynolds=10.0))


def _task(seed):
    jp = J_PDE.sample_params(jax.random.PRNGKey(seed))
    return jp, tuple(torch.tensor(np.asarray(a)) for a in jp)


@pytest.mark.parametrize("res, seed", [(8, 0), (8, 1), (16, 2)])
def test_solve_matches_jax(res, seed):
    jp, tp = _task(seed)
    jg, tg = j_fsb.solve(jp, resolution=res), fsb.solve(tp, resolution=res)
    ju = np.asarray(jg.u_grid)
    assert tg.u_grid.shape == ju.shape == (res + 1, res + 1, 2)
    np.testing.assert_allclose(tg.u_grid.numpy(), ju, rtol=0, atol=1e-4 * np.abs(ju).max())
    np.testing.assert_allclose(tg.coords_grid.numpy(), np.asarray(jg.coords_grid), atol=1e-6)
    np.testing.assert_array_equal(tg.alive_grid.numpy(), np.asarray(jg.alive_grid))
    np.testing.assert_array_equal(tg.elem_alive.numpy(), np.asarray(jg.elem_alive))
    assert float(tg.residual_norm) < 1e-5 and float(jg.residual_norm) < 1e-5


def test_solve_x64_matches_jax():
    jp, tp = _task(3)
    jg, tg = j_fsb.solve_x64(jp, resolution=8), fsb.solve_x64(tp, resolution=8)
    ju = np.asarray(jg.u_grid)
    assert tg.u_grid.dtype == torch.float64
    np.testing.assert_allclose(tg.u_grid.numpy(), ju, rtol=0, atol=1e-8 * np.abs(ju).max())


def test_evaluate_matches_jax():
    jp, _ = _task(4)
    jg = j_fsb.solve(jp, resolution=16)
    tg = fsb.SteadyBurgersGroundTruth(*(torch.tensor(np.asarray(a)) for a in jg))
    x = np.random.default_rng(0).uniform(-1, 1, (500, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p: j_fsb.evaluate(jg, p))(x))
    got = fsb.evaluate(tg, torch.tensor(x)).numpy()
    assert got.shape == want.shape == (500, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_zero_inlet_and_outlet_give_zero_flow():
    _, tp = _task(5)
    tp = (tp[0], torch.zeros_like(tp[1]), tp[2], tp[3])
    assert torch.equal(fsb.solve(tp, resolution=8).u_grid, torch.zeros(9, 9, 2))


def test_multigrid_preconditioner_reaches_the_jacobi_solution():
    _, tp = _task(6)
    counts = {}
    grids = {}
    for precond in ("jacobi", "mg"):
        newton.bicgstab.iterations = 0
        grids[precond] = fsb.solve(tp, resolution=16, precond=precond).u_grid
        counts[precond] = newton.bicgstab.iterations
    scale = float(grids["jacobi"].abs().max())
    assert float((grids["mg"] - grids["jacobi"]).abs().max()) <= 1e-4 * scale
    assert counts["mg"] < counts["jacobi"], counts


def _rect_pair(seed, res, coeff, vector_dim):
    jp, tp = _task(seed)
    box = (-1.0, 1.0, -1.0, 1.0)
    j_m = j_mg.make_rect_mg_preconditioner(jp[2], jp[3], res, *box, coeff=coeff,
                                           vector_dim=vector_dim)
    t_m = mg.make_rect_mg_preconditioner(tp[2], tp[3], res, *box, coeff=coeff,
                                         vector_dim=vector_dim)
    return j_m, t_m


@pytest.mark.parametrize("vector_dim", [1, 2])
def test_rect_vcycle_matches_jax(vector_dim):
    j_m, t_m = _rect_pair(7, 16, 0.25, vector_dim)
    b = np.random.default_rng(1).standard_normal(17 * 17 * vector_dim).astype(np.float32)
    want = np.asarray(j_m(jnp.asarray(b)))
    got = t_m(torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_rect_vcycle_is_linear_and_contracting():
    _, tp = _task(8)
    levels = mg.rect_levels(tp[2], tp[3], 16, -1.0, 1.0, -1.0, 1.0)
    assert [lv.m for lv in levels] == [17, 9]
    m = mg.make_rect_mg_preconditioner(tp[2], tp[3], 16, -1.0, 1.0, -1.0, 1.0)
    g = torch.Generator().manual_seed(2)
    x, y = torch.randn(289, generator=g), torch.randn(289, generator=g)
    lin = m(2.0 * x - 3.0 * y)
    np.testing.assert_allclose(lin.numpy(), (2.0 * m(x) - 3.0 * m(y)).numpy(), rtol=0,
                               atol=1e-5 * float(lin.abs().max()))
    interior = ~levels[0].bdry_mask
    b = torch.where(interior, x, torch.zeros_like(x))
    r = b - levels[0].apply(m(b))
    assert float(torch.linalg.norm(r[interior])) < 0.5 * float(torch.linalg.norm(b))
