"""The port's small modules against the JAX package's: ops/fourier.py's
whiten / dewhiten, models/field.py's divergence-free field,
models/gradient_conditioned.py, and utils/debugging.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.models import make_div_free_field as j_make_div_free_field
from metapde_tpu.models.gradient_conditioned import \
    make_gradient_conditioned_field as j_make_gc
from metapde_tpu.ops import dewhiten as j_dewhiten
from metapde_tpu.ops import whiten as j_whiten
from metapde_tpu_torch.config import FieldConfig
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.models import make_div_free_field
from metapde_tpu_torch.models.gradient_conditioned import make_gradient_conditioned_field
from metapde_tpu_torch.ops import dewhiten, whiten
from metapde_tpu_torch.utils.debugging import KeyLineage, dgrad, djit
from metapde_tpu_torch.utils.trees import global_norm, tree_leaves

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("mean,std", [(True, True), (True, False), (False, True),
                                      (False, False)])
def test_whiten_dewhiten_equal_jax(mean, std):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 3)).astype(np.float32)
    m = rng.standard_normal(3).astype(np.float32) if mean else None
    s = (rng.random(3) + 0.5).astype(np.float32) if std else None
    w = whiten(torch.tensor(x), m, s)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_whiten(jnp.asarray(x), m, s)), rtol=1e-6)
    np.testing.assert_allclose(dewhiten(w, m, s).numpy(),
                               np.asarray(j_dewhiten(j_whiten(jnp.asarray(x), m, s), m, s)),
                               rtol=1e-6)
    np.testing.assert_allclose(dewhiten(w, m, s).numpy(), x, rtol=1e-5, atol=1e-6)


def test_div_free_field_equals_jax_and_is_divergence_free():
    j_field = j_make_div_free_field(JFieldConfig(num_layers=2, layer_size=32, out_dim=2))
    field = make_div_free_field(FieldConfig(num_layers=2, layer_size=32, out_dim=2))
    assert field.cfg.in_dim == 2 and field.cfg.out_dim == 1
    j_params = j_field.init(jax.random.PRNGKey(0))
    params = params_from_numpy(_np(j_params))
    x = np.random.default_rng(1).uniform(-1, 1, (64, 2)).astype(np.float32)
    want = np.asarray(j_field.apply(j_params, jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    v = field.apply(params, xt)
    np.testing.assert_allclose(v.detach().numpy(), want, atol=1e-5 * np.abs(want).max())
    # divergence: d v_x / dx + d v_y / dy, by autograd through create_graph
    div = sum(torch.autograd.grad(v[:, i].sum(), xt, create_graph=True)[0][:, i]
              for i in range(2))
    assert float(div.abs().max()) < 1e-4 * float(v.abs().max())
    # single points, and it trains: the loss reaches the params
    np.testing.assert_allclose(field.apply(params, torch.tensor(x[0])).detach().numpy(),
                               want[0], atol=1e-5 * np.abs(want).max())
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = (field.apply(params, torch.tensor(x)) ** 2).mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert sum(float(g.abs().sum()) for g in grads if g is not None) > 0


@pytest.mark.parametrize("first_order", [False, True], ids=["second_order", "first_order"])
@pytest.mark.parametrize("learned_lrs", [False, True], ids=["fixed_lrs", "learned_lrs"])
def test_gradient_conditioned_field_equals_jax(first_order, learned_lrs):
    kw = dict(num_layers=2, layer_size=16, siren=False, log_scale=False, in_dim=1, out_dim=1)
    gc_kw = dict(inner_steps=3, inner_lr=0.05, learned_lrs=learned_lrs, first_order=first_order)
    j_gc = j_make_gc(JFieldConfig(**kw), **gc_kw)
    gc = make_gradient_conditioned_field(FieldConfig(**kw), **gc_kw)
    j_params = j_gc.init(jax.random.PRNGKey(0))
    if learned_lrs:
        j_params["log_lrs"] = jnp.asarray([0.1, -0.2, 0.3])
    params = params_from_numpy(_np(j_params))
    x = np.linspace(0, 1, 16, dtype=np.float32)[:, None]
    target = np.sin(3 * x[:, 0])
    j_loss = lambda f: jnp.mean((f(jnp.asarray(x)) - target) ** 2)
    t_loss = lambda f: torch.mean((f(torch.tensor(x)) - torch.tensor(target)) ** 2)

    want = np.asarray(j_gc.apply(j_params, j_loss, jnp.asarray(x)))
    out = gc.apply(params, t_loss, torch.tensor(x))
    assert out.shape == (16,)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
    # the outer gradient through the adaptation
    j_grad = jax.grad(lambda p: jnp.mean(j_gc.apply(p, j_loss, jnp.asarray(x)) ** 2))(j_params)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    grads = torch.autograd.grad(torch.mean(gc.apply(params, t_loss, torch.tensor(x)) ** 2),
                                leaves)
    for a, b in zip(jax.tree_util.tree_leaves(j_grad), grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5 * max(
            1.0, float(np.abs(np.asarray(a)).max())))
    # tests/test_utils.py::test_gradient_conditioned_field's bars
    from metapde_tpu_torch.models.siren import field_apply

    with torch.no_grad():
        base_loss = float(t_loss(lambda y: field_apply(params["base"], y, gc.cfg)))
    assert float(torch.mean((out - torch.tensor(target)) ** 2)) < base_loss
    assert float(global_norm(dict(zip(range(len(grads)), grads)))) > 0


def test_debugging_helpers(capsys):
    mm = djit(lambda a, b: a @ b, name="mm")
    mm(torch.ones(2, 3), torch.ones(3, 4))
    mm(torch.ones(2, 3), torch.ones(3, 4))
    mm(torch.ones(5, 3), torch.ones(3, 4))
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["[djit] first call of mm with (((2, 3), (3, 4)), {})", "[djit] mm -> (2, 4)",
                     "[djit] first call of mm with (((5, 3), (3, 4)), {})", "[djit] mm -> (5, 4)"]
    g = dgrad(lambda x: (x ** 3).sum())
    np.testing.assert_allclose(g(torch.tensor([1.0, 2.0])).numpy(), [3.0, 12.0])
    assert "grad(<lambda>)" in capsys.readouterr().out
    # tests/test_utils.py::test_key_lineage_checker, with generator states
    kl = KeyLineage()
    gen = torch.Generator().manual_seed(0)
    k1, k2 = kl.split(gen, where="a")
    with pytest.raises(RuntimeError):
        kl.split(torch.Generator().manual_seed(0), where="b")  # the same state again
    kl.use(k1)
    with pytest.raises(RuntimeError):
        kl.use(k1)  # not drawn from since: the same state
    torch.rand(1, generator=k2)
    kl.use(k2)
    assert torch.rand(1, generator=k1) != torch.rand(1, generator=k2)
