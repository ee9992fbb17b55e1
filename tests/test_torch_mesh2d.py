"""The pore-snapped lattice: metapde_tpu.solvers.mesh2d against
metapde_tpu_torch.solvers.mesh2d on the same pore layouts, made with numpy
from a seed.

- mesh_topology and node_coords: equal.
- snapped_geometry at resolutions 8 and 12 on em7_9's 5 x 5 pore lattice
  (circles near the wall bound) and on star-shaped pores (c1, c2 != 0, so
  the reference's swapped atan2 angle matters): coords, area, gradphi,
  elem_alive and node_alive within 1e-6 of the largest |value| (float32,
  both sides; measured: equal, bit for bit).
- evaluate_p1 at 400 random points of a random nodal field (with dead
  elements): values within 1e-6 of the largest (measured: equal); its
  Jacobian in x (torch.func.jacfwd) against jax.jacfwd within 1e-5 of the
  largest entry (measured: equal) at the 294 points away from the
  lattice's cell and diagonal lines, where the piecewise-constant
  gradient jumps and either side is right.
- no pores: the lattice unmoved, every element alive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from metapde_tpu.solvers import mesh2d as j_mesh2d
from metapde_tpu_torch.solvers import mesh2d

torch.set_num_threads(2)


def _lattice_pores(seed, star=False):
    """A 5 x 5 pore lattice on [0, 1]^2 (em7_9's layout), radii near the
    wall bound, shape coefficients zero (circles) or random (stars)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 1.0, 5)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    php = np.zeros((25, 5), np.float32)
    php[:, 2], php[:, 3] = xx.reshape(-1), yy.reshape(-1)
    php[:, 4] = rng.uniform(0.03, 0.115)
    if star:
        php[:, :2] = rng.uniform(-0.1, 0.1, (25, 2))
    return php


def _geometries(res, php, nh=25):
    tris = j_mesh2d.mesh_topology(res)
    c0 = j_mesh2d.node_coords(res, 0.0, 1.0, 0.0, 1.0).astype(np.float32)
    on_rect = (np.isclose(c0[:, 0], 0) | np.isclose(c0[:, 0], 1)
               | np.isclose(c0[:, 1], 0) | np.isclose(c0[:, 1], 1))
    j = j_mesh2d.snapped_geometry(jnp.asarray(tris), jnp.asarray(c0), jnp.asarray(php),
                                  jnp.int32(nh), 1.0 / res, boundary_fixed=jnp.asarray(on_rect))
    t = mesh2d.snapped_geometry(tris, torch.tensor(c0), torch.tensor(php),
                                torch.tensor(nh, dtype=torch.int32), 1.0 / res,
                                boundary_fixed=torch.tensor(on_rect))
    return j, t


def test_topology_and_coords_equal_jax_s():
    for res in (3, 8, 12):
        np.testing.assert_array_equal(mesh2d.mesh_topology(res), j_mesh2d.mesh_topology(res))
        np.testing.assert_array_equal(mesh2d.node_coords(res, 0.0, 1.0, -1.0, 2.0),
                                      j_mesh2d.node_coords(res, 0.0, 1.0, -1.0, 2.0))


@pytest.mark.parametrize("res", [8, 12])
@pytest.mark.parametrize("star", [False, True])
def test_snapped_geometry_matches_jax(res, star):
    j, t = _geometries(res, _lattice_pores(res, star))
    assert 0 < float(t.elem_alive.sum()) < t.elem_alive.numel()
    for name in ("coords", "area", "gradphi", "elem_alive", "node_alive"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * scale, err_msg=name)


def test_no_pores_leave_the_lattice_alone():
    _, t = _geometries(16, np.zeros((1, 5), np.float32), nh=0)
    np.testing.assert_allclose(t.coords.numpy(), mesh2d.node_coords(16, 0, 1, 0, 1), atol=1e-7)
    assert bool((t.elem_alive == 1).all()) and bool((t.node_alive == 1).all())
    assert float((t.area * t.elem_alive).sum()) == pytest.approx(1.0, abs=1e-6)


def _field(res, seed):
    """Snapped geometry at `res`, a random nodal field on it, and points."""
    j, t = _geometries(res, _lattice_pores(seed))
    rng = np.random.default_rng(seed)
    m = res + 1
    u = rng.standard_normal((m, m, 2)).astype(np.float32)
    bounds = np.asarray([0.0, 1.0, 0.0, 1.0], np.float32)
    x = rng.uniform(0.0, 1.0, (400, 2)).astype(np.float32)
    jargs = (jnp.asarray(u), j.coords.reshape(m, m, 2), j.elem_alive, jnp.asarray(bounds))
    targs = (torch.tensor(u), t.coords.reshape(m, m, 2), t.elem_alive, torch.tensor(bounds))
    return jargs, targs, x


@pytest.mark.parametrize("res", [8, 12])
def test_evaluate_p1_matches_jax(res):
    jargs, targs, x = _field(res, res + 1)
    jv = np.asarray(jax.vmap(lambda p: j_mesh2d.evaluate_p1(*jargs, p))(jnp.asarray(x)))
    tv = mesh2d.evaluate_p1(*targs, torch.tensor(x)).numpy()
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6 * np.abs(jv).max())
    # one point, no batch axis
    np.testing.assert_allclose(mesh2d.evaluate_p1(*targs, torch.tensor(x[0])).numpy(), jv[0],
                               atol=1e-6)


def test_evaluate_p1_jacobian_matches_jax_jacfwd():
    jargs, targs, x = _field(12, 5)
    # keep points away from the lattice's cell and diagonal lines, where the
    # piecewise-constant gradient jumps and either triangle is right
    f = x * 12
    frac = f - np.floor(f)
    away = (np.minimum(frac, 1 - frac).min(axis=1) > 0.05) & (np.abs(frac[:, 0] - frac[:, 1]) > 0.05)
    x = x[away]
    jj = np.asarray(jax.vmap(jax.jacfwd(lambda p: j_mesh2d.evaluate_p1(*jargs, p)))(
        jnp.asarray(x)))
    tj = vmap(jacfwd(lambda p: mesh2d.evaluate_p1(*targs, p)))(torch.tensor(x)).numpy()
    assert tj.shape == jj.shape == (len(x), 2, 2)
    np.testing.assert_allclose(tj, jj, rtol=0, atol=1e-5 * np.abs(jj).max())
