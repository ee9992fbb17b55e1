"""Differential operators (ops/operators.py) and the operator branch of the
Poisson loss: metapde_tpu against metapde_tpu_torch on shared inputs.

Fields are SIRENs with the JAX package's init carried over (omega 30, so
second derivatives reach ~1e3) and analytic functions; points come from a
numpy seed. Each operator is held to the JAX one at 1e-5 of the largest
|value| (at least 1), in f32 on both sides. The Poisson loss through the
operator branch (a field without .vhd) is held to the JAX loss at rtol
1e-5, and its gradient with respect to the field params, which ordinary
autograd takes through the torch.func transforms, to 1e-4 of each leaf's
scale (a third derivative of the sine chain, summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.config import TaskConfig as JTaskConfig
from metapde_tpu.models import make_field as j_make_field
from metapde_tpu.ops import operators as j_ops
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu_torch.config import FieldConfig, TaskConfig
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.models import make_field
from metapde_tpu_torch.ops import operators as ops
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(2)

TOL = 1e-5


def _field(out_dim=1, seed=0, layers=2, width=32):
    kw = dict(num_layers=layers, layer_size=width, in_dim=2, out_dim=out_dim,
              squeeze_scalar=out_dim == 1)
    j_field, t_field = j_make_field(JFieldConfig(**kw)), make_field(FieldConfig(**kw))
    j_params = j_field.init(jax.random.PRNGKey(seed))
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params))
    return (lambda x: j_field.apply(j_params, x)), (lambda x: t_field.apply(t_params, x))


def _points(n=64, seed=1):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (n, 2)).astype(np.float32)


def _close(actual, expected):
    actual, expected = actual.detach().numpy(), np.asarray(expected)
    assert actual.shape == expected.shape
    scale = max(np.abs(expected).max(), 1.0)
    assert np.abs(actual - expected).max() <= TOL * scale


ANALYTIC = {
    "quadratic": (lambda x: x[0] ** 2 + 3.0 * x[1] ** 2,
                  lambda x: x[0] ** 2 + 3.0 * x[1] ** 2),
    "trig": (lambda x: jnp.sin(x[0]) * jnp.cos(2.0 * x[1]),
             lambda x: torch.sin(x[0]) * torch.cos(2.0 * x[1])),
}


@pytest.mark.parametrize("u", ["siren", "quadratic", "trig"])
@pytest.mark.parametrize("op", ["laplacian", "hessian_diag", "weighted_laplacian"])
def test_scalar_operators_match_jax(op, u):
    j_u, t_u = _field() if u == "siren" else ANALYTIC[u]
    j_w = lambda x: 1.0 + 0.1 * j_u(x) ** 2
    t_w = lambda x: 1.0 + 0.1 * t_u(x) ** 2
    extra = ((j_w,), (t_w,)) if op == "weighted_laplacian" else ((), ())
    for x in _points(8):
        _close(getattr(ops, op)(t_u, *extra[1], torch.tensor(x)),
               getattr(j_ops, op)(j_u, *extra[0], jnp.asarray(x)))


def test_weighted_laplacian_is_the_product_rule():
    """div(w grad u) = w lap u + grad w . grad u, on a SIREN field."""
    _, t_u = _field(seed=2)
    t_w = lambda x: 1.0 + 0.1 * t_u(x) ** 2
    x = torch.tensor(_points(1)[0])
    gu, gw = torch.func.grad(t_u)(x), torch.func.grad(t_w)(x)
    expected = t_w(x) * ops.laplacian(t_u, x) + gw @ gu
    np.testing.assert_allclose(float(ops.weighted_laplacian(t_u, t_w, x)), float(expected),
                               rtol=1e-5)


def test_divergences_match_jax():
    j_v, t_v = _field(out_dim=2, seed=3)
    j_t, t_t = _field(out_dim=4, seed=4)
    j_tensor = lambda x: j_t(x).reshape(2, 2)
    t_tensor = lambda x: t_t(x).reshape(2, 2)
    for x in _points(8, seed=5):
        _close(ops.divergence(t_v, torch.tensor(x)), j_ops.divergence(j_v, jnp.asarray(x)))
        _close(ops.divergence_tensor(t_tensor, torch.tensor(x)),
               j_ops.divergence_tensor(j_tensor, jnp.asarray(x)))


def test_vmapped_operators_match_jax():
    j_u, t_u = _field(seed=6)
    j_v, t_v = _field(out_dim=2, seed=7)
    j_t, t_t = _field(out_dim=4, seed=8)
    x = _points(128, seed=9)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    j_w = lambda y: 1.0 + 0.1 * j_u(y) ** 2
    t_w = lambda y: 1.0 + 0.1 * t_u(y) ** 2
    _close(ops.vmap_laplacian(tx, t_u), j_ops.vmap_laplacian(jx, j_u))
    _close(ops.vmap_laplacian(tx, t_u, t_w), j_ops.vmap_laplacian(jx, j_u, j_w))
    _close(ops.vmap_weighted_laplacian(tx, t_u, t_w), j_ops.vmap_weighted_laplacian(jx, j_u, j_w))
    _close(ops.vmap_divergence(tx, t_v), j_ops.vmap_divergence(jx, j_v))
    _close(ops.vmap_divergence_tensor(tx, lambda y: t_t(y).reshape(2, 2)),
           j_ops.vmap_divergence_tensor(jx, lambda y: j_t(y).reshape(2, 2)))


def _poisson_inputs(seed=10):
    rng = np.random.default_rng(seed)
    task = (rng.normal(size=(2, 3)).astype(np.float32),
            rng.uniform(-1, 1, 5).astype(np.float32),
            rng.uniform(-0.2, 0.2, 2).astype(np.float32))
    bnd = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    dom = rng.uniform(-0.7, 0.7, (96, 2)).astype(np.float32)
    return task, (bnd, dom)


def test_operator_branch_of_the_poisson_loss_matches_jax():
    """loss_fn on a plain callable (no .vhd) takes vmap_weighted_laplacian in
    both packages; the port's operator branch also equals its vhd branch."""
    kw = dict(num_layers=3, layer_size=64, in_dim=2)
    j_field, t_field = j_make_field(JFieldConfig(**kw)), make_field(FieldConfig(**kw))
    j_params = j_field.init(jax.random.PRNGKey(11))
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params))
    task, pts = _poisson_inputs()
    j_pde, t_pde = j_get_pde(JTaskConfig()), get_pde(TaskConfig())
    t_task, t_pts = tuple(map(torch.tensor, task)), tuple(map(torch.tensor, pts))

    j_b, j_d = j_pde.loss_fn(lambda x: j_field.apply(j_params, x),
                             tuple(map(jnp.asarray, pts)), tuple(map(jnp.asarray, task)))
    leaves = [p.requires_grad_() for p in tree_leaves(t_params)]
    t_b, t_d = t_pde.loss_fn(lambda x: t_field.apply(t_params, x), t_pts, t_task)
    np.testing.assert_allclose(float(t_b["boundary_loss"]), float(j_b["boundary_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(t_d["domain_loss"]), float(j_d["domain_loss"]), rtol=1e-5)
    _, v_d = t_pde.loss_fn(t_field.bind(t_params), t_pts, t_task)
    np.testing.assert_allclose(float(t_d["domain_loss"]), float(v_d["domain_loss"]), rtol=1e-5)

    # the gradient the MAML inner loop takes, through the torch.func transforms
    t_grads = torch.autograd.grad(t_d["domain_loss"], leaves)
    j_grads = jax.grad(lambda p: j_pde.loss_fn(
        lambda x: j_field.apply(p, x), tuple(map(jnp.asarray, pts)),
        tuple(map(jnp.asarray, task)))[1]["domain_loss"])(j_params)
    for a, b in zip(t_grads, jax.tree_util.tree_leaves(j_grads)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * max(np.abs(b).max(), 1e-3))
