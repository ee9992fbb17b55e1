"""The sparse-direct neo-Hookean ground truth:
metapde_tpu.solvers.fem_elasticity against
metapde_tpu_torch.solvers.fem_elasticity, in float64.

- _elem_fns (the port's closed forms) against the JAX package's jax.grad
  and jax.hessian of the same element density, on numpy-seeded elements
  with J on both sides of the 0.05 clamp: values, gradients and Hessians
  within 1e-12 of each array's largest entry (measured ~2e-16).
- solve_direct at resolution 8 on a task JAX draws from em7_9's family
  (5 x 5 pores, Young's modulus frozen): u_grid within 1e-6 of its largest
  |value|, final_energy rtol 1e-8, the snapped mesh equal (measured: u_grid
  4.7e-9 of its max, energy 3.7e-16; JAX stops at |g| 6.1e-9, where its
  line search finds no lower energy, and the port at 9.1e-9, both under
  the 1e-8 tolerance).
- No pores: the solid block under the -0.12 top displacement, from the
  affine warm start: mid-height v ~ -0.06, energy below 0.05.
- solve_warm: from the resolution-8 solution to 12, |g| < 1e-5, on the
  same branch (energies within half of each other's, fields within 5e-2
  relative mse); ref=True returns float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.solvers import fem_elasticity as j_fe
from metapde_tpu_torch.config import TaskConfig, load_run_config
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.solvers import fem_elasticity as fe

from test_torch_hyper_elasticity import EM7_9, _gen, _t

torch.set_num_threads(2)


def test_element_functions_match_jax_s_autodiff():
    rng = np.random.default_rng(0)
    n = 400
    ue = rng.normal(0.0, 0.3, (n, 6))
    gphi = rng.normal(0.0, 1.0, (n, 3, 2))
    mods = np.asarray([0.3656, 18.16])
    with jax.enable_x64(True):
        j_val, j_grad, j_hess = j_fe._elem_fns(jnp.float64)
        ref = [np.asarray(f(jnp.asarray(ue), jnp.asarray(gphi), jnp.asarray(mods)))
               for f in (j_val, j_grad, j_hess)]
    ours = [f(ue, gphi, tuple(mods)) for f in fe._elem_fns()]
    F = np.eye(2) + np.einsum("ekd,ekg->edg", ue.reshape(n, 3, 2), gphi)
    J = F[:, 0, 0] * F[:, 1, 1] - F[:, 0, 1] * F[:, 1, 0]
    assert (J < 0.05).sum() > 20 and (J > 0.05).sum() > 20  # both sides of the clamp
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())


@pytest.fixture(scope="module")
def res8():
    """A JAX task of em7_9's family and both packages' resolution-8 solves."""
    j_pde = j_get_pde(j_load_run_config(str(EM7_9)).task)
    jp = j_pde.sample_params(jax.random.PRNGKey(4))
    j_gt = j_fe.solve_direct(jp, resolution=8, out_dtype=jnp.float64)
    tp = tuple(_t(a) for a in jp)
    gt = fe.solve_direct(tp, resolution=8, out_dtype=torch.float64)
    return tp, gt, j_gt


def test_solve_direct_matches_jax_at_resolution_8(res8):
    _, gt, j_gt = res8
    assert gt.u_grid.dtype == torch.float64
    u, ju = gt.u_grid.numpy(), np.asarray(j_gt.u_grid)
    assert u.shape == ju.shape == (9, 9, 2)
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-6 * np.abs(ju).max())
    np.testing.assert_allclose(float(gt.final_energy), float(j_gt.final_energy), rtol=1e-8)
    for name in ("coords_grid", "alive_grid", "elem_alive", "bounds"):
        np.testing.assert_allclose(getattr(gt, name).numpy(), np.asarray(getattr(j_gt, name)),
                                   rtol=0, atol=1e-7, err_msg=name)
    assert float(gt.final_gnorm) < 1e-8 and float(j_gt.final_gnorm) < 1e-8
    assert 0.0 < float((1 - gt.elem_alive).mean()) < 0.9  # pores cut the lattice


def test_no_pores_affine_compression():
    pde = get_pde(TaskConfig(pde="hyper_elasticity", max_holes=0, max_hole_size=0.5,
                             vary_source=False, vary_bc=False))
    gt = fe.solve_direct(pde.sample_params(_gen(0)), resolution=12)
    assert gt.u_grid.dtype == torch.float32
    v = fe.evaluate(gt, torch.tensor([0.5, 0.5]))
    assert bool(torch.isfinite(v).all())
    assert abs(float(v[1]) + 0.06) < 0.02, v
    assert float(gt.final_energy) < 0.05


def test_solve_warm_tracks_the_branch(res8):
    tp, _, _ = res8
    pde = get_pde(load_run_config(str(EM7_9)).task)
    g8 = pde.solve(tp, resolution=8)
    g12 = pde.solve_warm(tp, 12, g8)
    assert pde.effective_resolution(tp, 12) == g12.u_grid.shape[0] - 1
    assert float(g12.final_gnorm) < 1e-5
    assert abs(float(g12.final_energy) - float(g8.final_energy)) < 0.5 * abs(
        float(g8.final_energy)) + 1e-4
    pts = pde.sample_validation_points(_gen(11), 256, tp, g12)
    v8, v12 = fe.evaluate(g8, pts), fe.evaluate(g12, pts)
    assert float(((v8 - v12) ** 2).mean() / (v12 ** 2).mean()) < 5e-2
    assert pde.solve_warm(tp, 12, g12, ref=True).u_grid.dtype == torch.float64
