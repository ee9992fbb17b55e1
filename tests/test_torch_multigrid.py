"""Multigrid ground truth: metapde_tpu.solvers.{multigrid, newton,
fem_poisson} against the port, on task params from a numpy seed.

Bars and what they were measured at (CPU, f32 unless said):
- restriction / prolongation: 1e-6 of the largest |value| (the same
  weights, sums in another order).
- the level operator (the port assembles it once into a CSR matrix; the JAX
  package gathers and scatters with segment_sum) and its diagonal: 1e-5 of
  the largest |value|.
- one V-cycle at resolution 8 against the JAX V-cycle: 1e-5 of the largest
  |value| (measured 3.0e-7); linear to 1e-5; it contracts the residual of
  the unit-coefficient operator below 0.4 at resolution 16, the JAX
  package's own bar (tests/test_multigrid.py).
- the mg solve at resolution 8 (precond="mg" forced): u_grid within 1e-4
  (measured 2.4e-7); both stop at the same Newton step.
- solve_x64 (float64, resolution 4): 1e-9 (measured 7e-11); evaluate_cubic
  on a shared f32 grid: 1e-5 of the largest |value| (measured 1.05e-6: each
  value is a 16-term weighted sum in f32, summed in another order);
  solve_richardson (resolution 2 and 4, float64): 1e-9.
The JAX solves are taken once per file (module-scoped fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.solvers import fem_poisson as j_fem
from metapde_tpu.solvers import multigrid as j_mg
from metapde_tpu_torch.solvers import fem_poisson, multigrid, newton

torch.set_num_threads(2)


def _task(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, 3)).astype(np.float32),
            rng.uniform(-1, 1, 5).astype(np.float32),
            rng.uniform(-0.2, 0.2, 2).astype(np.float32))


def _t(task):
    return tuple(torch.tensor(a) for a in task)


def _j(task):
    return tuple(jnp.asarray(a) for a in task)


def _close(actual, expected, tol):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape
    err = np.abs(actual - expected).max() / max(np.abs(expected).max(), 1e-30)
    assert err <= tol, err


def _j_linear_operator(geo, resolution):
    """The JAX package's unit-coefficient stiffness operator (finest level),
    as tests/test_multigrid.py builds it."""
    tris_np, nr, nt = j_fem.mesh_topology(resolution)
    tris = jnp.asarray(tris_np)
    n = 1 + nr * nt
    coords = j_fem.node_coords(jnp.asarray(geo), nr, nt)
    gradphi, area, _ = j_fem._element_geometry(coords, tris)
    bdry = jnp.zeros((n,), bool).at[jnp.arange(1 + (nr - 1) * nt, n)].set(True)

    def apply(u):
        grad_u = jnp.einsum("ek,ekd->ed", u[tris], gradphi)
        flux = jnp.einsum("e,ed,ekd->ek", area, grad_u, gradphi)
        r = jax.ops.segment_sum(flux.reshape(-1), tris.reshape(-1), num_segments=n)
        return jnp.where(bdry, u, r)

    return apply, n


@pytest.fixture(scope="module")
def jax_mg_solve():
    task = _task(0)
    return task, j_fem.solve(_j(task), resolution=8, precond="mg")


@pytest.mark.parametrize("res", [4, 8])
def test_transfers_match_jax(res):
    geo = _task(1)[2]
    t_levels = multigrid.polar_levels(torch.tensor(geo), res)
    fine, coarse = t_levels[0], t_levels[1]
    rng = np.random.default_rng(2)
    u_f = rng.normal(size=1 + fine.nr * fine.nt).astype(np.float32)
    u_c = rng.normal(size=1 + coarse.nr * coarse.nt).astype(np.float32)
    j_fine = j_mg.Level(None, None, fine.nr, fine.nt, None)
    j_coarse = j_mg.Level(None, None, coarse.nr, coarse.nt, None)
    _close(multigrid.restrict(torch.tensor(u_f), fine, coarse),
           j_mg.restrict(jnp.asarray(u_f), j_fine, j_coarse), 1e-6)
    _close(multigrid.prolong(torch.tensor(u_c), coarse, fine),
           j_mg.prolong(jnp.asarray(u_c), j_coarse, j_fine), 1e-6)


def test_level_operator_matches_jax():
    geo = _task(3)[2]
    level = multigrid.polar_levels(torch.tensor(geo), 8)[0]
    j_apply, n = _j_linear_operator(geo, 8)
    u = np.random.default_rng(4).normal(size=n).astype(np.float32)
    _close(level.apply(torch.tensor(u)), j_apply(jnp.asarray(u)), 1e-5)
    # the diagonal is the operator's own, on the interior rows
    e = torch.zeros(n)
    for i in (0, 1, 77, n - 1):
        e.zero_()
        e[i] = 1.0
        np.testing.assert_allclose(float(level.apply(e)[i]), float(level.diag[i]), rtol=1e-5)


@pytest.mark.parametrize("sweeps", [2, 3])
def test_vcycle_matches_jax(sweeps):
    geo = _task(5)[2]
    kw = dict(pre_sweeps=sweeps, post_sweeps=sweeps)
    M = multigrid.make_polar_mg_preconditioner(torch.tensor(geo), 8, **kw)
    j_M = j_mg.make_polar_mg_preconditioner(jnp.asarray(geo), 8, **kw)
    v = np.random.default_rng(6).normal(size=1 + 32 * 128).astype(np.float32)
    _close(M(torch.tensor(v)), j_M(jnp.asarray(v)), 1e-5)


def test_vcycle_is_linear():
    M = multigrid.make_polar_mg_preconditioner(torch.tensor([0.1, -0.05]), 8)
    gen = torch.Generator().manual_seed(1)
    u, v = torch.randn(1 + 32 * 128, generator=gen), torch.randn(1 + 32 * 128, generator=gen)
    _close(M(2.0 * u - 3.0 * v), 2.0 * M(u) - 3.0 * M(v), 1e-5)


def test_vcycle_contracts_the_residual():
    geo = torch.tensor([0.05, 0.02])
    M = multigrid.make_polar_mg_preconditioner(geo, 16)
    A = multigrid.polar_levels(geo, 16)[0]
    b = torch.randn(1 + 64 * 256, generator=torch.Generator().manual_seed(0))
    b = b.masked_fill(A.bdry_mask, 0.0)
    ratio = float(torch.linalg.norm(b - A.apply(M(b))) / torch.linalg.norm(b))
    assert ratio < 0.4, ratio


def test_coarse_matrix_equals_the_coarse_sweeps():
    """The dense coarse map is the 40 damped-Jacobi sweeps it replaces."""
    coarse = multigrid.polar_levels(torch.tensor([0.07, -0.1]), 4)[-1]
    C = multigrid.coarse_sweep_matrix(coarse, 40, 0.7)
    b = torch.randn(C.shape[0], generator=torch.Generator().manual_seed(2))
    _close(C @ b, multigrid._smooth(coarse, None, b, 40, 0.7 / coarse.diag), 1e-5)


def test_mg_solve_matches_jax(jax_mg_solve):
    task, j_gt = jax_mg_solve
    newton.bicgstab.iterations, newton.newton_krylov.steps = 0, 0
    t_gt = fem_poisson.solve(_t(task), resolution=8, precond="mg")
    assert newton.newton_krylov.steps >= 1 and newton.bicgstab.iterations >= 1
    np.testing.assert_allclose(t_gt.u_grid.numpy(), np.asarray(j_gt.u_grid), atol=1e-4)
    assert float(t_gt.residual_norm) < 10 * max(float(j_gt.residual_norm), 1e-6)


def test_newton_falls_back_to_the_preconditioned_rhs(monkeypatch):
    """A Krylov solve that diverged is replaced by precond_apply(rhs): with
    an exact inverse as the preconditioner, one Newton step solves a linear
    system."""
    rng = np.random.default_rng(7)
    a = torch.tensor(np.eye(6) * 3 + rng.normal(scale=0.2, size=(6, 6)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=6), dtype=torch.float32)
    monkeypatch.setattr(newton, "bicgstab",
                        lambda A, rhs, **kw: torch.full_like(rhs, float("nan")))
    res = newton.newton_krylov(lambda u: a @ u - b, torch.zeros(6), max_steps=1,
                               precond_apply=lambda v: torch.linalg.solve(a, v))
    np.testing.assert_allclose((a @ res.u).numpy(), b.numpy(), atol=1e-5)
    assert res.iterations == 1


def test_solve_x64_matches_jax():
    task = _task(8)
    j_gt = j_fem.solve_x64(_j(task), resolution=4)
    t_gt = fem_poisson.solve_x64(_t(task), resolution=4)
    assert t_gt.u_grid.dtype == torch.float64
    np.testing.assert_allclose(t_gt.u_grid.numpy(), np.asarray(j_gt.u_grid), rtol=0, atol=1e-9)


def test_evaluate_cubic_matches_jax_on_a_shared_grid():
    rng = np.random.default_rng(9)
    geo = _task(9)[2]
    u_grid = rng.normal(size=(4 * 4 + 1, 16 * 4)).astype(np.float32)
    x = rng.uniform(-1.3, 1.3, (500, 2)).astype(np.float32)
    j_gt = j_fem.PoissonGroundTruth(jnp.asarray(u_grid), jnp.asarray(geo), jnp.zeros(()))
    t_gt = fem_poisson.PoissonGroundTruth(torch.tensor(u_grid), torch.tensor(geo), None)
    j_vals = np.asarray(jax.vmap(lambda p: j_fem.evaluate_cubic(j_gt, p))(x))
    _close(fem_poisson.evaluate_cubic(t_gt, torch.tensor(x)), j_vals, 1e-5)


def test_solve_richardson_matches_jax():
    task = _task(10)
    j_gt = j_fem.solve_richardson(_j(task), resolution=2)
    t_gt = fem_poisson.solve_richardson(_t(task), resolution=2)
    np.testing.assert_allclose(t_gt.u_grid.numpy(), np.asarray(j_gt.u_grid), rtol=0, atol=1e-9)
    with pytest.raises(ValueError):
        fem_poisson.solve_richardson(_t(task), resolution=1)
