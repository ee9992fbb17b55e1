"""The LEAP engine: metapde_tpu.meta.leap against metapde_tpu_torch.meta.leap
on shared inputs.

Params come from the JAX init (carried over with interop.params_from_numpy);
task params and collocation points are drawn by JAX, following its key
chain, and handed to the port in the order meta/leap.py documents (set 0:
the loss at the init; for step k, set 2k - 1 the gradient's k1 and set 2k
the k2 of the loss after the step).

- The increment and the manifold norm, over all 8 settings of norm,
  stabilize and loss_in_distance: rtol 1e-6 on random f32 inputs (one
  arithmetic, op for op; measured worst 1.2e-7).
- single_task_rollout and multi_task_grad_and_losses at 2 layers of 32,
  3 tasks, 3 Adam steps, 128 points: losses rtol 1e-5 (measured 3.5e-7);
  final params within 1e-4 of each leaf's scale (measured 1.9e-7). The
  meta-gradient depends on the setting. With loss_in_distance off it is a
  sum of parameter steps: within 1e-4 of each leaf's scale (measured
  1.2e-5). In the paper's setting (norm, loss_in_distance and stabilize
  on) every increment carries d_loss = loss_after - loss_before, a
  difference of two losses of ~28.6 that is ~0.02-0.05: f32 losses that
  agree to 1e-7 (4e-6 absolute, sums in other orders) give d_loss to
  ~1e-4, and an accumulator whose increments cancel across steps carries
  that further. Bars there: 1e-3 of the tree's norm (measured 3.9e-5 over
  3 tasks) and 2e-2 of each leaf's scale (measured 2.0e-4 over 3 tasks in the
  driver's setting;
  one task: 4.0e-4 on the weights and 9.1e-3 on the scalar log_out_scale).
- The batched rollout against a per-task loop of single_task_rollout
  (batched and one-task products round differently): final params within
  1e-6 of each leaf's scale, the accumulator, which carries d_loss, within
  1e-4 (measured 2.7e-6 on the scalar log_out_scale).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.meta import leap as j_leap
from metapde_tpu.train import leap_driver as j_driver
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.meta import leap
from metapde_tpu_torch.parallel.mesh import Mesh
from metapde_tpu_torch.parallel.sharding import shard_task_loss_points
from metapde_tpu_torch.train import leap_driver
from metapde_tpu_torch.utils.trees import tree_leaves, tree_map

torch.set_num_threads(2)

SMALL = ["--model.num_layers=2", "--model.layer_size=32", "--leap.bsize=3",
         "--leap.inner_steps=3", "--task.inner_points=128"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close_trees(t_tree, j_tree, rel, tree_rel=None):
    """Every leaf within `rel` of its scale (the largest |value|, at least
    1e-3); with tree_rel, the whole difference within tree_rel of the
    tree's norm."""
    a, b = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=0,
                                   atol=rel * max(np.abs(y).max(), 1e-3))
    if tree_rel is not None:
        diff = np.sqrt(sum(float(((x.detach().numpy() - np.asarray(y)) ** 2).sum())
                           for x, y in zip(a, b)))
        norm = np.sqrt(sum(float((np.asarray(y) ** 2).sum()) for y in b))
        assert diff <= tree_rel * norm, (diff, norm)


# (loss_in_distance, leaf bar, tree bar) of the meta-gradient; see above
GRAD_BARS = {"paper": (True, 2e-2, 1e-3), "no_loss_in_distance": (False, 1e-4, None)}


def _builds(argv=SMALL):
    jc = j_driver.build(j_parse_overrides(JConfig(), argv))
    tc = leap_driver.build(parse_overrides(Config(), argv), "cpu")
    return jc, tc


def jax_task_draws(j_pde, n, key, inner_steps, task_params=None):
    """The points JAX's single_task_rollout(key) draws through a loss fn
    that samples n points from its key, as [2K + 1] sets per point kind;
    without task_params, the task comes first from split(key) as in
    single_task_grad_and_losses. Returns (task params, points)."""
    if task_params is None:
        task_key, key = jax.random.split(key, 2)
        task_params = j_pde.sample_params(task_key)
    loss0_key, inner_key = jax.random.split(key, 2)
    keys = [loss0_key]
    for k in jax.random.split(inner_key, inner_steps):
        keys += list(jax.random.split(k, 2))
    sets = [j_pde.sample_points(k, n, task_params) for k in keys]
    points = tuple(torch.stack([_t(s[j]) for s in sets]) for j in range(2))
    return tuple(_t(a) for a in task_params), points


def jax_batch(j_pde, n, key, bsize, inner_steps):
    """multi_task_grad_and_losses(key)'s draws as a leap.TaskBatch."""
    draws = [jax_task_draws(j_pde, n, k, inner_steps) for k in jax.random.split(key, bsize)]
    return leap.TaskBatch(tuple(torch.stack(x) for x in zip(*(d[0] for d in draws))),
                          tuple(torch.stack(x) for x in zip(*(d[1] for d in draws))))


SETTINGS = list(itertools.product([False, True], repeat=3))


@pytest.mark.parametrize("norm,stabilize,loss_in_distance", SETTINGS)
def test_increment_and_norm_match_jax(norm, stabilize, loss_in_distance):
    jc, tc, _, _, _ = _single_setup()
    j_def = jc["leap_def"]._replace(norm=norm, stabilize=stabilize,
                                    loss_in_distance=loss_in_distance)
    t_def = tc["leap_def"]._replace(norm=norm, stabilize=stabilize,
                                    loss_in_distance=loss_in_distance)
    rng = np.random.default_rng(7)
    like = _np(jc["init_params"])

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda x: (scale * rng.standard_normal((2,) + x.shape)).astype(np.float32), like)

    params, grad = draw(1.0), draw(10.0)
    new_params = jax.tree_util.tree_map(lambda p: p + np.float32(1e-3) * rng.standard_normal(
        p.shape).astype(np.float32), params)
    loss, new_loss = (rng.uniform(1.0, 2.0, 2).astype(np.float32) for _ in range(2))
    t_inc = leap.get_meta_grad_increment(t_def, params_from_numpy(new_params),
                                         params_from_numpy(params), _t(new_loss), _t(loss),
                                         params_from_numpy(grad))
    t_norm = leap.compute_global_norm(t_def, params_from_numpy(new_params),
                                      params_from_numpy(params), _t(new_loss - loss))
    for i in range(2):
        task = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(x[i]), tree)
        j_inc = j_leap.get_meta_grad_increment(j_def, task(new_params), task(params),
                                               new_loss[i], loss[i], task(grad))
        for a, b in zip(tree_leaves(t_inc), jax.tree_util.tree_leaves(j_inc)):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)
        j_norm = j_leap.compute_global_norm(j_def, task(new_params), task(params),
                                            new_loss[i] - loss[i])
        np.testing.assert_allclose(float(t_norm[i]), float(j_norm), rtol=1e-6)


_SETUPS = {}


def _single_setup(loss_in_distance=True):
    """(jc, tc, j_def, n, jitted JAX sampler): the JAX leap_def's task loss
    draws n points from its key, as the driver's does; built once per
    setting (JAX compiles are the slow part of this file)."""
    if loss_in_distance not in _SETUPS:
        jc, tc = _builds(SMALL + [f"--leap.loss_in_distance={loss_in_distance}"])
        j_pde, j_field, j_loss = jc["pde"], jc["field"], jc["loss_fn"]
        n = 128
        sample_points = jax.jit(j_pde.sample_points, static_argnums=1)

        def make_task_loss_fn(key):
            tp = j_pde.sample_params(key)
            return lambda k, fp: j_loss(j_field.bind(fp), sample_points(k, n, tp), tp)

        j_def = jc["leap_def"]._replace(make_task_loss_fn=make_task_loss_fn)
        _SETUPS[loss_in_distance] = (jc, tc, j_def, n, j_pde._replace(sample_points=sample_points))
    return _SETUPS[loss_in_distance]


@pytest.mark.parametrize("setting", sorted(GRAD_BARS))
def test_single_task_rollout_matches_jax(setting):
    lid, leaf_bar, tree_bar = GRAD_BARS[setting]
    jc, tc, j_def, n, j_pde = _single_setup(lid)
    key = jax.random.PRNGKey(4)
    task_key, rollout_key = jax.random.split(key)
    tp = j_pde.sample_params(task_key)
    j_final, j_accum, j_losses = jax.jit(
        lambda k, p: j_leap.single_task_rollout(j_def, k, p, j_def.make_task_loss_fn(task_key)))(
        rollout_key, jc["init_params"])
    t_tp, pts = jax_task_draws(j_pde, n, rollout_key, j_def.inner_steps, tp)
    t_final, t_accum, t_losses = leap.single_task_rollout(
        tc["leap_def"], tc["task_loss"], leap.TaskBatch(t_tp, pts),
        params_from_numpy(_np(jc["init_params"])))
    assert t_losses.shape == (j_def.inner_steps + 1,)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-5)
    _close_trees(t_final, j_final, 1e-4)
    _close_trees(t_accum, j_accum, leaf_bar, tree_bar)


def test_multi_task_grad_and_losses_matches_jax():
    """The driver's setting (the paper's): norm, loss_in_distance and
    stabilize on."""
    _, leaf_bar, tree_bar = GRAD_BARS["paper"]
    jc, tc, j_def, n, j_pde = _single_setup()
    key = jax.random.PRNGKey(5)
    j_grad, j_losses = jax.jit(lambda k, p: j_leap.multi_task_grad_and_losses(j_def, k, p))(
        key, jc["init_params"])
    batch = jax_batch(j_pde, n, key, j_def.n_batch_tasks, j_def.inner_steps)
    t_grad, t_losses = leap.multi_task_grad_and_losses(
        tc["leap_def"], tc["task_loss"], batch, params_from_numpy(_np(jc["init_params"])))
    assert t_losses.shape == (3, 4)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-5)
    _close_trees(t_grad, j_grad, leaf_bar, tree_bar)
    # single_task_grad_and_losses is its T = 1 case
    one = leap.TaskBatch(*(tree_map(lambda x: x[0], part) for part in batch))
    g0, l0 = leap.single_task_grad_and_losses(tc["leap_def"], tc["task_loss"], one,
                                              params_from_numpy(_np(jc["init_params"])))
    np.testing.assert_allclose(l0.numpy(), np.asarray(j_losses[0]), rtol=1e-5)


def test_batched_rollout_equals_a_per_task_loop():
    jc, tc, j_def, n, j_pde = _single_setup()
    batch = jax_batch(j_pde, n, jax.random.PRNGKey(6), 3, j_def.inner_steps)
    init = params_from_numpy(_np(jc["init_params"]))
    final, accum, losses = leap.rollout(tc["leap_def"], tc["task_loss"], batch, init)
    for i in range(3):
        one = leap.TaskBatch(*(tree_map(lambda x: x[i], part) for part in batch))
        f_i, a_i, l_i = leap.single_task_rollout(tc["leap_def"], tc["task_loss"], one, init)
        np.testing.assert_allclose(losses[i].numpy(), l_i.numpy(), rtol=1e-6)
        for tree, tree_i, bar in ((final, f_i, 1e-6), (accum, a_i, 1e-4)):
            for a, b in zip(tree_leaves(tree), tree_leaves(tree_i)):
                scale = max(float(b.abs().max()), 1e-3)
                np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=0, atol=bar * scale)
    # deployment's rollout (no accumulator): the same final params from the
    # gradient sets alone
    grad_sets = tuple(p[:, 1::2] for p in batch.points)
    dep, none_a, none_l = leap.rollout(tc["leap_def"], tc["task_loss"],
                                       leap.TaskBatch(batch.task_params, grad_sets), init,
                                       accumulate=False)
    assert none_a is None and none_l is None
    for a, b in zip(tree_leaves(dep), tree_leaves(final)):
        assert torch.equal(a, b)


def test_rollout_refuses_a_wrong_number_of_point_sets():
    jc, tc, j_def, n, j_pde = _single_setup()
    batch = jax_batch(j_pde, n, jax.random.PRNGKey(6), 1, j_def.inner_steps)
    init = params_from_numpy(_np(jc["init_params"]))
    with pytest.raises(ValueError, match="point sets"):
        leap.rollout(tc["leap_def"], tc["task_loss"], batch, init, accumulate=False)


def test_pt_shards_average_to_the_rollouts_first_loss():
    """pt sharding's premise for LEAP: the rollout's loss at the init is the
    mean of the losses on the n_pt equal parts of the point sets."""
    jc, tc, j_def, n, j_pde = _single_setup()
    batch = jax_batch(j_pde, n, jax.random.PRNGKey(1), 2, j_def.inner_steps)
    init = params_from_numpy(_np(jc["init_params"]))
    vloss = torch.func.vmap(tc["task_loss"], in_dims=(None, 0, 0))
    full = leap.rollout(tc["leap_def"], tc["task_loss"], batch, init)[2][:, 0]
    parts = [vloss(init, tuple(p[:, 0] for p in shard_task_loss_points(
        batch.points, Mesh({"dp": 1, "pt": 4}, 0, j, None, None, "gloo"))),
        batch.task_params)[0] for j in range(4)]
    np.testing.assert_allclose(torch.stack(parts).mean(0).numpy(), full.numpy(), rtol=1e-5)
