"""The port's matrix-free elasticity cascade (solvers/fem_elasticity.py::
solve, solve_x64) and newton.cg against the JAX package's solve, solve_x64
and jax.scipy.sparse.linalg.cg, on the JAX package's own test cases
(tests/test_elasticity.py's uniform compression, tests/test_x64_oracles.py's
PRNGKey(1) task), with those tests' assertions re-run on the port's
results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import DomainConfig, TaskConfig
from metapde_tpu.pdes import get_pde
from metapde_tpu.solvers import fem_elasticity as jfe
from metapde_tpu_torch.solvers import fem_elasticity as tfe
from metapde_tpu_torch.solvers import newton

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _to_torch(params):
    return tuple(torch.from_numpy(np.array(a)) for a in params)


@pytest.fixture(scope="module")
def uniform():
    pj = (jnp.zeros((2,)), jnp.asarray([1.0, 1.0]), jnp.zeros((1, 5)), jnp.int32(0))
    kw = dict(resolution=12, load_steps=2, newton_steps=15)
    return (np.asarray(jfe.solve(pj, **kw).u_grid), np.asarray(jfe.solve_x64(pj, **kw).u_grid),
            tfe.solve(_to_torch(pj), **kw), tfe.solve_x64(_to_torch(pj), **kw))


@pytest.fixture(scope="module")
def pored():
    dom = DomainConfig(xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0)
    cfg = TaskConfig(pde="hyper_elasticity", domain=dom, max_holes=5, max_hole_size=0.5,
                     vary_source=False, vary_bc=False)
    pj = get_pde(cfg).sample_params(jax.random.PRNGKey(1))
    return pj, jfe.solve(pj, resolution=12), jfe.solve_x64(pj, resolution=12)


def test_uniform_compression_against_jax(uniform):
    uj, uj64, gt, gt64 = uniform
    u = gt.u_grid.numpy()
    # tests/test_elasticity.py::test_solver_no_holes_uniform_compression's bars
    assert np.isfinite(u).all()
    assert np.allclose(u[:, -1, 1], -0.12, atol=1e-6)
    assert np.allclose(u[:, 0, :], 0.0, atol=1e-6)
    assert -0.08 < float(u[6, 6, 1]) < -0.04
    # the JAX package's float32 Newton stalls at |g| 1.5e-4, 1.45e-4 of max
    # |u| from its float64 solve; the port's, whose line search compares
    # float64 energies, reaches the float64 solution, so the two float32
    # solves differ by JAX's own float32 error
    assert _rel(u, uj64) < 1e-5
    assert _rel(u, uj) < 2e-4
    # float64: the same minimiser to rounding
    assert gt64.u_grid.dtype == torch.float64
    assert _rel(gt64.u_grid.numpy(), uj64) < 1e-10


def test_pored_task_and_x64_against_jax(pored):
    pj, gj, gj64 = pored
    pt = _to_torch(pj)
    gt, gt64 = tfe.solve(pt, resolution=12), tfe.solve_x64(pt, resolution=12)
    assert _rel(gt.u_grid.numpy(), gj.u_grid) < 1e-3
    assert gt64.u_grid.dtype == torch.float64
    assert _rel(gt64.u_grid.numpy(), gj64.u_grid) < 1e-6
    assert float(gt64.final_energy) == pytest.approx(float(gj64.final_energy), rel=1e-10)
    # tests/test_x64_oracles.py's bar between the float32 and float64 paths
    assert _rel(gt.u_grid.numpy(), gt64.u_grid.numpy()) < 2e-2
    for name in ("coords_grid", "alive_grid", "elem_alive", "bounds"):
        np.testing.assert_allclose(getattr(gt64, name).numpy(), np.asarray(getattr(gj64, name)),
                                   atol=1e-12, err_msg=name)
    assert float(gt.final_gnorm) < 1e-5


def test_refine_stage_against_jax(pored):
    """The chain 12 -> 24 (the P1 prolongation and the full-load Newton of
    _refine_stage): uniform compression in float64 against JAX's; the
    PRNGKey(1) task in float32 with tests/test_elasticity.py::
    test_solver_with_pores_converges's bars. (That task's float64 chain to 24
    meets an indefinite Hessian where CG stops at maxiter: whether Newton
    stalls there turns on rounding, in the JAX package too, so its iterates
    are not compared.)"""
    pj = (jnp.zeros((2,)), jnp.asarray([1.0, 1.0]), jnp.zeros((1, 5)), jnp.int32(0))
    kw = dict(resolution=24, load_steps=2, newton_steps=15)
    uj64 = np.asarray(jfe.solve_x64(pj, **kw).u_grid)
    gt64 = tfe.solve_x64(_to_torch(pj), **kw)
    assert gt64.u_grid.shape == (25, 25, 2)
    assert _rel(gt64.u_grid.numpy(), uj64) < 1e-6
    gt = tfe.solve(_to_torch(pored[0]), resolution=24)
    u = gt.u_grid.numpy()
    assert np.isfinite(u).all() and np.abs(u).max() < 0.5 and float(gt.final_energy) < 1e3
    v = tfe.evaluate(gt, torch.tensor([0.5, 0.01]))
    assert float(torch.linalg.norm(v)) < 0.02


def test_hessian_vector_product_is_the_energy_jvp_of_its_gradient(pored):
    """The closed-form element Hessians applied matrix-free equal forward-
    over-reverse autodiff of the port's energy, and the gradient equals
    autograd's; float64."""
    pt = tuple(a.double() if a.is_floating_point() else a for a in _to_torch(pored[0]))
    prob = tfe._torch_problem(pt, 12, 0.0, 1.0, 0.0, 1.0)
    gen = torch.Generator().manual_seed(0)
    z = 0.02 * torch.randn(2 * prob["n_nodes"], generator=gen, dtype=torch.float64)
    v = torch.randn(z.shape, generator=gen, dtype=torch.float64)
    g, hvp = prob["grad_hess"](z, -0.1)
    grad = lambda zz: torch.func.grad(lambda q: prob["energy"](q, -0.1))(zz)
    np.testing.assert_allclose(g.numpy(), grad(z).numpy(), atol=1e-12)
    np.testing.assert_allclose(hvp(v).numpy(), torch.func.jvp(grad, (z,), (v,))[1].numpy(),
                               atol=1e-10)
    # and JAX's energy at the same z
    jp = jfe._build_problem(tuple(jnp.asarray(np.asarray(a)) for a in pored[0]), 12,
                            0.0, 1.0, 0.0, 1.0)
    e_jax = float(jp["energy"](jnp.asarray(z.numpy(), jnp.float32), -0.1))
    assert float(prob["energy"](z, -0.1)) == pytest.approx(e_jax, rel=1e-5)


@pytest.mark.parametrize("tol,maxiter", [(1e-5, 200), (1e-12, 7), (1e-3, 100)])
def test_cg_equals_jax_cg(tol, maxiter):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((24, 24))
    A = a @ a.T + 0.5 * np.eye(24)
    b = rng.standard_normal(24)
    want = jax.scipy.sparse.linalg.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=tol,
                                      maxiter=maxiter)[0]
    with jax.enable_x64(True):
        want64 = jax.scipy.sparse.linalg.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                                            tol=tol, maxiter=maxiter)[0]
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    before = newton.cg.iterations
    got64 = newton.cg(lambda x: At @ x, bt, tol=tol, maxiter=maxiter)
    assert 0 < newton.cg.iterations - before <= maxiter
    # CG's iterates drift apart with the rounding of its products (the
    # matrix's condition number is 173): 3.3e-8 after 20 iterations
    np.testing.assert_allclose(got64.numpy(), np.asarray(want64), atol=1e-6)
    got = newton.cg(lambda x: At.float() @ x, bt.float(), tol=tol, maxiter=maxiter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-4)
