"""FEM ground truth: metapde_tpu.solvers.fem_poisson against its PyTorch port.

Shared task params from a numpy seed. Mesh and geometry agree to f32
round-off (1e-6). The two Newton-BiCGStab solves run the same algorithm but
sum in other orders, and in f32 their Krylov solves end at their iteration
cap, so each lands at its own iterate inside the Newton tolerance. Their
u_grids (|u| up to ~1) differ by ~1e-6 to ~3e-5 at resolution 8 and by up
to ~2.2e-3 at resolution 16 (task seed 2, one thread; the difference moves
with the thread count, i.e. with the summation order), so the bars are
1e-4 at resolution 8 and 5e-3 at 16. The port's precond="auto" takes the
multigrid from 16 up where the JAX package's takes it from 32, so these
comparisons give the port the JAX package's choice. Bilinear evaluation on a
shared grid agrees to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.solvers import fem_poisson as j_fem
from metapde_tpu_torch.solvers import fem_poisson, newton

torch.set_num_threads(1)


def _task(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, 3)).astype(np.float32),
            rng.uniform(-1, 1, 5).astype(np.float32),
            rng.uniform(-0.2, 0.2, 2).astype(np.float32))


def _t(task):
    return tuple(torch.tensor(a) for a in task)


@pytest.mark.parametrize("res", [2, 8, 16])
def test_mesh_topology_matches_jax(res):
    t_tris, t_nr, t_nt = fem_poisson.mesh_topology(res)
    j_tris, j_nr, j_nt = j_fem.mesh_topology(res)
    assert (t_nr, t_nt) == (j_nr, j_nt)
    np.testing.assert_array_equal(t_tris, j_tris)


def test_geometry_matches_jax():
    geo = _task(0)[2]
    tris, nr, nt = j_fem.mesh_topology(4)
    j_coords = j_fem.node_coords(jnp.asarray(geo), nr, nt)
    t_coords = fem_poisson.node_coords(torch.tensor(geo), nr, nt)
    np.testing.assert_allclose(t_coords.numpy(), np.asarray(j_coords), atol=1e-6)
    j_geom = j_fem._element_geometry(j_coords, jnp.asarray(tris))
    t_geom = fem_poisson._element_geometry(t_coords, torch.tensor(tris, dtype=torch.long))
    for a, b in zip(t_geom, j_geom):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("res, tol, seed", [(8, 1e-4, 0), (8, 1e-4, 1), (16, 5e-3, 2)])
def test_u_grid_matches_jax(res, tol, seed):
    task = _task(seed)
    j_gt = j_fem.solve(tuple(jnp.asarray(a) for a in task), resolution=res)
    t_gt = fem_poisson.solve(_t(task), resolution=res, precond=j_fem._auto_precond(res))
    assert t_gt.u_grid.shape == j_gt.u_grid.shape
    np.testing.assert_allclose(t_gt.u_grid.numpy(), np.asarray(j_gt.u_grid), atol=tol)
    assert float(t_gt.residual_norm) < 10 * max(float(j_gt.residual_norm), 1e-6)


def test_evaluate_matches_jax_on_a_shared_grid():
    task = _task(3)
    rng = np.random.default_rng(4)
    u_grid = rng.normal(size=(4 * 4 + 1, 16 * 4)).astype(np.float32)
    x = rng.uniform(-1.3, 1.3, (500, 2)).astype(np.float32)
    j_gt = j_fem.PoissonGroundTruth(jnp.asarray(u_grid), jnp.asarray(task[2]), jnp.zeros(()))
    t_gt = fem_poisson.PoissonGroundTruth(torch.tensor(u_grid), torch.tensor(task[2]), None)
    j_vals = np.asarray(jax.vmap(lambda p: j_fem.evaluate(j_gt, p))(x))
    np.testing.assert_allclose(fem_poisson.evaluate(t_gt, torch.tensor(x)).numpy(),
                               j_vals, atol=1e-6)


def test_res32_builds_the_mg_preconditioner(monkeypatch):
    """Resolution 32 takes the multigrid preconditioner under
    precond="auto" (3 pre- and 3 post-sweeps, as the JAX solve sets them);
    tests/test_torch_multigrid.py holds the mg solve against the JAX
    package. The spy stops the solve once the preconditioner is built."""
    built = []

    def spy(geo_params, resolution, **kw):
        built.append((resolution, kw))
        raise StopIteration

    monkeypatch.setattr(fem_poisson, "make_polar_mg_preconditioner", spy)
    with pytest.raises(StopIteration):
        fem_poisson.solve(_t(_task(0)), resolution=32)
    assert built == [(32, {"pre_sweeps": 3, "post_sweeps": 3})]
    # from 16 up (the JAX package: from 32; fem_poisson._auto_precond says why)
    assert fem_poisson._auto_precond(8) == "jacobi" and fem_poisson._auto_precond(16) == "mg"
    assert fem_poisson._auto_precond(64) == "mg" and fem_poisson._auto_precond(17) == "jacobi"
    with pytest.raises(ValueError):
        fem_poisson.solve(_t(_task(0)), resolution=2, precond="ilu")


def test_solve_leaves_the_tf32_flags_as_it_found_them():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        seen = []
        orig = fem_poisson._solve_impl

        def spy(*a):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return orig(*a)

        fem_poisson._solve_impl = spy
        try:
            fem_poisson.solve(_t(_task(0)), resolution=2)
        finally:
            fem_poisson._solve_impl = orig
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("maxiter", [3, 200])
def test_bicgstab_matches_jax(maxiter):
    """Same iterates as jax.scipy.sparse.linalg.bicgstab on a nonsymmetric,
    Jacobi-preconditioned system, including when maxiter stops it early."""
    rng = np.random.default_rng(5)
    n = 40
    a = (np.eye(n) * 4 + rng.normal(scale=0.3, size=(n, n))).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    minv = (1.0 / np.diag(a)).astype(np.float32)
    j_x, _ = jax.scipy.sparse.linalg.bicgstab(
        lambda v: jnp.asarray(a) @ v, jnp.asarray(b), tol=1e-6, maxiter=maxiter,
        M=lambda v: v * jnp.asarray(minv))
    ta, tm = torch.tensor(a), torch.tensor(minv)
    t_x = newton.bicgstab(lambda v: ta @ v, torch.tensor(b), tol=1e-6, maxiter=maxiter,
                          M=lambda v: v * tm)
    np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), rtol=1e-4, atol=1e-5)
    if maxiter == 200:
        np.testing.assert_allclose(a @ t_x.numpy(), b, atol=1e-4)


def test_bicgstab_cuda_graph_flag_keeps_the_cpu_path():
    """cuda_graph=True replays a captured iteration only for a CUDA tensor:
    on the CPU it is the eager loop, with the same iterate and iteration
    count bit for bit."""
    rng = np.random.default_rng(6)
    n = 40
    a = torch.tensor((np.eye(n) * 4 + rng.normal(scale=0.3, size=(n, n))).astype(np.float32))
    b = torch.tensor(rng.normal(size=n).astype(np.float32))
    out = {}
    for flag in (False, True):
        newton.bicgstab.iterations = 0
        x = newton.bicgstab(lambda v: a @ v, b, tol=1e-6, maxiter=200, cuda_graph=flag)
        out[flag] = (x, newton.bicgstab.iterations)
    assert torch.equal(out[True][0], out[False][0]) and out[True][1] == out[False][1] > 0
