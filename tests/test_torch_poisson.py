"""Poisson task family: metapde_tpu.pdes.poisson against its PyTorch port.

The losses are compared on shared task params, field params and points
(JAX draws them; numpy carries them over), to rtol 1e-5 in f32. torch's
generators give other numbers than JAX's keys, so the samplers are compared
by their support and their spatial histograms (40 x 256 points per arm,
36 cells: per-cell Monte-Carlo std <= 6e-3, bar 0.02 as in
tests/test_fast_sampler.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.config import TaskConfig as JTaskConfig
from metapde_tpu.models import make_field as j_make_field
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.pdes import poisson as j_poisson
from metapde_tpu_torch.config import FieldConfig, TaskConfig
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.models import make_field
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.pdes import poisson

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_sample_params_shapes_and_ranges():
    src, bc, geo = get_pde(TaskConfig()).sample_params(_gen(0))
    assert src.shape == (2, 3) and bc.shape == (5,) and geo.shape == (2,)
    assert float(geo.abs().max()) <= 0.2 and float(bc.abs().max()) <= 1.0


@pytest.mark.parametrize("factor, idx", [("vary_source", 0), ("vary_bc", 1),
                                         ("vary_geometry", 2)])
def test_vary_flags_freeze_factors(factor, idx):
    pde = get_pde(TaskConfig(**{factor: False}))
    p1, p2 = pde.sample_params(_gen(1)), pde.sample_params(_gen(2))
    for i in range(3):
        same = torch.equal(p1[i], p2[i])
        assert same == (i == idx)


def test_fixed_num_pdes_pins_every_task():
    pde = get_pde(TaskConfig(fixed_num_pdes=1, seed=3))
    p1, p2 = pde.sample_params(_gen(1)), pde.sample_params(_gen(2))
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


def test_boundary_points_on_star_and_domain_points_inside():
    pde = get_pde(TaskConfig())
    params = pde.sample_params(_gen(0))
    bdry, dom = pde.sample_points(_gen(1), 128, params)
    assert bdry.shape == (128, 2) and dom.shape == (128, 2)
    c1, c2 = params[2]
    theta = torch.atan2(bdry[:, 1], bdry[:, 0])
    np.testing.assert_allclose(torch.linalg.norm(bdry, dim=1).numpy(),
                               poisson.radius(theta, c1, c2).numpy(), atol=1e-5)
    theta = torch.atan2(dom[:, 1], dom[:, 0])
    assert bool((torch.linalg.norm(dom, dim=1) <= poisson.radius(theta, c1, c2) + 1e-5).all())


def test_is_in_hole_keeps_the_reference_quirk():
    geo = np.array([0.15, -0.1], np.float32)
    xy = np.random.default_rng(0).uniform(-1.3, 1.3, (2000, 2)).astype(np.float32)
    j = np.asarray(jax.vmap(j_poisson.is_in_hole, in_axes=(0, None))(xy, geo))
    t = poisson.is_in_hole(_t(xy), _t(geo)).numpy()
    np.testing.assert_array_equal(t, j)


def _hist2d(pts, bins=6, lo=-1.5, hi=1.5):
    h, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=bins, range=[[lo, hi], [lo, hi]])
    return h.ravel() / len(pts)


@pytest.mark.parametrize("with_replacement", [False, True])
def test_samplers_match_jax_in_distribution(with_replacement):
    j_pde = j_get_pde(JTaskConfig(sample_with_replacement=with_replacement))
    t_pde = get_pde(TaskConfig(sample_with_replacement=with_replacement))
    j_params = j_pde.sample_params(jax.random.PRNGKey(3))
    t_params = tuple(_t(a) for a in j_params)
    keys = jax.random.split(jax.random.PRNGKey(7), 40)
    j_b, j_d = jax.vmap(lambda k: j_pde.sample_points(k, 256, j_params))(keys)
    gen = _gen(11)
    t_draws = [t_pde.sample_points(gen, 256, t_params) for _ in range(40)]
    t_b = torch.cat([b for b, _ in t_draws]).numpy()
    t_d = torch.cat([d for _, d in t_draws]).numpy()
    for j, t in ((np.asarray(j_b).reshape(-1, 2), t_b), (np.asarray(j_d).reshape(-1, 2), t_d)):
        assert np.max(np.abs(_hist2d(j) - _hist2d(t))) < 0.02
    # support: every domain point is inside the star
    assert not bool(poisson.is_in_hole(torch.tensor(t_d), t_params[2]).any())
    # the JAX package draws domain points WITH replacement when the flag is
    # False (replace=not sample_with_replacement); the port keeps that
    one = t_pde.sample_points_in_domain(_gen(5), 1024, t_params).numpy()
    j_one = np.asarray(j_pde.sample_points_in_domain(jax.random.PRNGKey(5), 1024, j_params))
    for pts in (one, j_one):
        has_dups = len(np.unique(pts, axis=0)) < len(pts)
        assert has_dups == (not with_replacement)


@pytest.mark.parametrize("with_replacement", [False, True])
def test_batched_sampler_matches_jax_in_distribution(with_replacement):
    """sample_points_batched (the training draws: several sets for several
    tasks at once) against the JAX sampler, per task, by the same histogram
    bar: 2 tasks x 20 sets x 256 points per arm and task."""
    cfg = dict(sample_with_replacement=with_replacement)
    j_pde, t_pde = j_get_pde(JTaskConfig(**cfg)), get_pde(TaskConfig(**cfg))
    j_tasks = [j_pde.sample_params(jax.random.PRNGKey(s)) for s in (3, 4)]
    stacked = tuple(torch.stack([_t(p[i]) for p in j_tasks]) for i in range(3))
    t_b, t_d = t_pde.sample_points_batched(_gen(11), 256, stacked, 20)
    assert t_b.shape == t_d.shape == (2, 20, 256, 2)
    for i, j_params in enumerate(j_tasks):
        keys = jax.random.split(jax.random.PRNGKey(7 + i), 20)
        j_b, j_d = jax.vmap(lambda k: j_pde.sample_points(k, 256, j_params))(keys)
        for j, t in ((j_b, t_b[i]), (j_d, t_d[i])):
            j, t = np.asarray(j).reshape(-1, 2), t.reshape(-1, 2).numpy()
            assert np.max(np.abs(_hist2d(j) - _hist2d(t))) < 0.02
        assert not bool(poisson.is_in_hole(t_d[i].reshape(-1, 2), stacked[2][i]).any())
        c1, c2 = stacked[2][i]
        theta = torch.atan2(t_b[i, ..., 1], t_b[i, ..., 0])
        np.testing.assert_allclose(torch.linalg.norm(t_b[i], dim=-1).numpy(),
                                   poisson.radius(theta, c1, c2).numpy(), atol=1e-5)
        # the inverted flag, as the per-task sampler keeps it: each set of 256
        # from 768 candidates repeats a point only when drawn with replacement
        dups = [len(np.unique(d, axis=0)) < len(d) for d in t_d[i].numpy()]
        assert any(dups) == (not with_replacement)


@pytest.mark.parametrize("n", [64, 256])
def test_losses_match_jax_on_shared_points(n):
    j_pde, t_pde = j_get_pde(JTaskConfig()), get_pde(TaskConfig())
    j_params = j_pde.sample_params(jax.random.PRNGKey(0))
    j_points = j_pde.sample_points(jax.random.PRNGKey(1), n, j_params)
    kw = dict(num_layers=3, layer_size=64)
    j_field, t_field = j_make_field(JFieldConfig(**kw)), make_field(FieldConfig(**kw))
    fp = j_field.init(jax.random.PRNGKey(2))
    t_fp = params_from_numpy(jax.tree_util.tree_map(np.asarray, fp))
    j_bl, j_dl = j_pde.loss_fn(j_field.bind(fp), j_points, j_params)
    t_bl, t_dl = t_pde.loss_fn(t_field.bind(t_fp), tuple(_t(p) for p in j_points),
                               tuple(_t(a) for a in j_params))
    np.testing.assert_allclose(float(t_bl["boundary_loss"]), float(j_bl["boundary_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(t_dl["domain_loss"]), float(j_dl["domain_loss"]),
                               rtol=1e-5)


class _ConstField:
    """u = 0.5 everywhere, with its (value, grad, Hessian-diag) path."""

    def __call__(self, x):
        return torch.full(x.shape[:-1], 0.5)

    def vhd(self, x):
        return self(x), torch.zeros_like(x), torch.zeros_like(x)


def test_loss_zero_for_constant_field_and_zero_source():
    pde = get_pde(TaskConfig())
    src, bc, geo = pde.sample_params(_gen(0))
    params = (torch.zeros_like(src), bc, geo)
    points = pde.sample_points(_gen(1), 64, params)
    _, dl = pde.loss_fn(_ConstField(), points, params)
    assert float(dl["domain_loss"]) == 0.0


def test_operator_branch_equals_vhd_branch():
    """A field without .vhd takes the autodiff weighted-Laplacian branch
    (ops/operators.py), which equals the vhd branch
    (tests/test_torch_operators.py holds it against the JAX package)."""
    pde = get_pde(TaskConfig())
    params = pde.sample_params(_gen(0))
    points = pde.sample_points(_gen(1), 8, params)
    field = make_field(FieldConfig(num_layers=2, layer_size=16))
    fp = field.init(_gen(2))
    plain = pde.loss_fn(lambda x: field.apply(fp, x), points, params)
    fused = pde.loss_fn(field.bind(fp), points, params)
    for a, b in zip(plain, fused):
        for k in a:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5)


@pytest.mark.parametrize("name", ["poisson3d", "steady_burgers"])
def test_other_families_are_not_ported(name):
    """The two families this test once found refused now build, with the
    JAX package's name, in_dim, out_dim and scalar."""
    j_pde = j_get_pde(JTaskConfig(pde=name))
    pde = get_pde(TaskConfig(pde=name))
    assert (pde.name, pde.in_dim, pde.out_dim, pde.scalar) == (
        j_pde.name, j_pde.in_dim, j_pde.out_dim, j_pde.scalar)


def test_source_and_bc_match_jax():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(2, 3)).astype(np.float32)
    bc = rng.uniform(-1, 1, 5).astype(np.float32)
    x = rng.uniform(-1, 1, (100, 2)).astype(np.float32)
    np.testing.assert_allclose(
        poisson.source(_t(src), _t(x)).numpy(),
        np.asarray(jax.vmap(lambda p: j_poisson.source(jnp.asarray(src), p))(x)), rtol=1e-6)
    np.testing.assert_allclose(
        poisson.boundary_conditions(_t(bc), _t(x)).numpy(),
        np.asarray(jax.vmap(lambda p: j_poisson.boundary_conditions(jnp.asarray(bc), p))(x)),
        rtol=1e-6, atol=1e-7)
