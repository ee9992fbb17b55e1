"""MAML inner loop: metapde_tpu.meta.maml against its PyTorch port.

Shared params (the JAX init, carried over), learned inner LRs (numpy seed),
task params and collocation points (drawn by JAX). The JAX loss fns ignore
their key and use those points, as deployment's get_final_model does.
Tolerance: 1e-5 relative to each params leaf's scale after 1 and 5 steps
(f32, sums in other orders), rtol 1e-5 on the losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.config import TaskConfig as JTaskConfig
from metapde_tpu.meta import maml as j_maml
from metapde_tpu.models import make_field as j_make_field
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.utils import trees as j_trees
from metapde_tpu_torch.config import FieldConfig, TaskConfig
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.meta import maml
from metapde_tpu_torch.models import make_field
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.utils import trees
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

STEPS = 5
INNER_LR = 1e-4


def _setup(n_points=128, clip=100.0):
    kw = dict(num_layers=3, layer_size=64)
    j_field, t_field = j_make_field(JFieldConfig(**kw)), make_field(FieldConfig(**kw))
    j_pde, t_pde = j_get_pde(JTaskConfig()), get_pde(TaskConfig())
    j_task = j_pde.sample_params(jax.random.PRNGKey(0))
    j_pts = j_pde.sample_points(jax.random.PRNGKey(1), n_points, j_task)
    t_task = tuple(torch.tensor(np.asarray(a)) for a in j_task)
    t_pts = tuple(torch.tensor(np.asarray(p)) for p in j_pts)
    j_params = j_field.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    lrs = jax.tree_util.tree_map(
        lambda x: rng.normal(0.5, 1.0, (STEPS,) + x.shape).astype(np.float32), j_params)

    def j_loss(key, fp):
        bl, dl = j_pde.loss_fn(j_field.bind(fp), j_pts, j_task)
        return 100.0 * bl["boundary_loss"] + dl["domain_loss"], {}

    def t_loss(fp):
        bl, dl = t_pde.loss_fn(t_field.bind(fp), t_pts, t_task)
        return 100.0 * bl["boundary_loss"] + dl["domain_loss"], {}

    j_def = j_maml.MamlDef(inner_opt=optax.sgd(INNER_LR), make_task_loss_fns=None,
                           inner_steps=STEPS, n_batch_tasks=1, softplus_lrs=True,
                           outer_loss_decay=0.1, inner_grad_clip=clip, remat=False)
    t_def = maml.MamlDef(inner_lr=INNER_LR, inner_steps=STEPS, softplus_lrs=True,
                         outer_loss_decay=0.1, inner_grad_clip=clip)
    np_params = jax.tree_util.tree_map(np.asarray, j_params)
    return (j_def, j_params, lrs, j_loss), (t_def, params_from_numpy(np_params),
                                             params_from_numpy(lrs), t_loss)


def _close_trees(t_tree, j_tree, rel=1e-5):
    a, b = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=0,
                                   atol=rel * max(np.abs(y).max(), 1e-3))


@pytest.mark.parametrize("clip", [100.0, 1e-3])
def test_inner_step_matches_jax(clip):
    (j_def, jp, jl, j_loss), (t_def, tp, tl, t_loss) = _setup(clip=clip)
    lr0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), jl)
    j_new, _, j_l = j_maml.maml_inner_step(j_def, jax.random.PRNGKey(9), jp,
                                           j_def.inner_opt.init(jp), j_loss, lr0)
    t_new, t_l = maml.maml_inner_step(t_def, tp, t_loss, trees.tree_map(lambda x: x[0], tl))
    np.testing.assert_allclose(float(t_l), float(j_l), rtol=1e-5)
    _close_trees(t_new, j_new)


@pytest.mark.parametrize("learned", [True, False])
def test_five_step_rollout_matches_jax(learned):
    (j_def, jp, jl, j_loss), (t_def, tp, tl, t_loss) = _setup()
    j_lrs = jax.tree_util.tree_map(jnp.asarray, jl) if learned else None
    j_final, (j_meta, j_losses) = j_maml.single_task_rollout(
        j_def, jax.random.PRNGKey(9), jp, j_loss, j_lrs, outer_loss_fn=j_loss)
    t_final, (t_meta, t_losses) = maml.single_task_rollout(
        t_def, tp, t_loss, tl if learned else None, outer_loss_fn=t_loss)
    assert t_losses.shape == (STEPS + 1,)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-5)
    np.testing.assert_allclose(float(t_meta), float(j_meta), rtol=1e-5)
    _close_trees(t_final, j_final)


def test_outer_loss_decay_semantics():
    """meta_loss = sum_t decay^(T-1-t) * outer(theta_t) along the trajectory."""
    (_, _, _, _), (t_def, tp, tl, t_loss) = _setup(n_points=32)
    seen = []

    def outer(fp):
        loss = t_loss(fp)[0]
        seen.append(float(loss))
        return loss, {}

    _, (meta, _) = maml.single_task_rollout(t_def, tp, t_loss, tl, outer_loss_fn=outer)
    want = sum(l * 0.1 ** (STEPS - 1 - t) for t, l in enumerate(seen))
    np.testing.assert_allclose(float(meta), want, rtol=1e-5)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=5).astype(np.float32)]}
    t_tree = params_from_numpy(tree)
    np.testing.assert_allclose(float(trees.global_norm(t_tree)),
                               float(j_trees.global_norm(tree)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        t_c, t_n = trees.clip_by_global_norm(t_tree, max_norm)
        j_c, j_n = j_trees.clip_by_global_norm(tree, max_norm)
        np.testing.assert_allclose(float(t_n), float(j_n), rtol=1e-6)
        _close_trees(t_c, j_c, rel=1e-6)
