"""Meta-training: metapde_tpu.meta.maml and metapde_tpu.train.maml_driver
against the port's training side, on shared inputs.

Params come from the JAX init (carried over with interop.params_from_numpy)
or from the committed p30k_f32_s1 checkpoint; learned LRs from a numpy seed;
task params and collocation points are drawn by JAX and handed to the port.

- Meta-gradients (single_task_grad_and_losses, multi_task_grad_and_losses):
  the JAX loss fns ignore their key and use one fixed point set per task
  (drawn from the task key), as tests/test_torch_maml.py does; the port gets
  that set at every step. Bars: every meta-gradient leaf within 1e-4 of
  its leaf's scale (the largest |value|, at least 1e-3); losses and
  meta-losses rtol 1e-5. f32 on both sides, sums in other orders, and the
  second-order terms of a 2-3 step unroll.
- One outer step (step_core against the JAX build()["train_step"], and 3
  steps against train_step_many): the test replays JAX's key chain to get
  JAX's own draws and passes them to the port. Bars: params and inner LRs
  within 1e-5 of each leaf's scale; meta-grad norm rtol 1e-4; per-task
  meta-losses rtol 1e-5.
- remat=True equals remat=False bit for bit.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.meta import maml as j_maml
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import maml_driver as j_driver
from metapde_tpu_torch.config import Config, load_run_config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.meta import maml
from metapde_tpu_torch.parallel.mesh import Mesh
from metapde_tpu_torch.parallel.sharding import shard_task_loss_points
from metapde_tpu_torch.train import checkpoints, maml_driver, optimizers
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(2)

RUN_DIR = Path(__file__).resolve().parents[1] / "results_poisson_maml" / "p30k_f32_s1"
SMALL = ["--model.num_layers=2", "--model.layer_size=32", "--maml.bsize=3",
         "--maml.inner_steps=2", "--task.inner_points=64", "--task.outer_points=64"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close_trees(t_tree, j_tree, rel):
    a, b = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=0,
                                   atol=rel * max(np.abs(y).max(), 1e-3))


def _builds(argv):
    jc = j_driver.build(j_parse_overrides(JConfig(), argv))
    tc = maml_driver.build(parse_overrides(Config(), argv), "cpu")
    return jc, tc


def _batch(tasks):
    """[(task_params, inner sets, outer sets)] from JAX -> maml.TaskBatch."""
    def stack_sets(sets):
        return tuple(torch.stack([torch.stack([_t(s[j]) for s in task]) for task in sets])
                     for j in range(2))

    return maml.TaskBatch(
        task_params=tuple(torch.stack([_t(tp[j]) for tp, _, _ in tasks]) for j in range(3)),
        inner_points=stack_sets([inner for _, inner, _ in tasks]),
        outer_points=stack_sets([outer for _, _, outer in tasks]))


def _jax_draws(j_pde, cfg, key):
    """The draws of JAX's key chain for one outer step: split(key, bsize);
    per task split(.., 3) -> task_key, rollout_key, outer_loss_key; per
    inner step split(.., 3) -> k1 (inner points), k2 (outer points), k3
    (the next key); the last key feeds the final inner loss and
    outer_loss_key the outer aux set."""
    tasks = []
    for tk in jax.random.split(key, cfg.maml.bsize):
        task_key, rollout_key, outer_loss_key = jax.random.split(tk, 3)
        tp = j_pde.sample_params(task_key)
        inner, outer, k = [], [], rollout_key
        for _ in range(cfg.maml.inner_steps):
            k1, k2, k = jax.random.split(k, 3)
            inner.append(j_pde.sample_points(k1, cfg.task.inner_points, tp))
            outer.append(j_pde.sample_points(k2, cfg.task.outer_points, tp))
        inner.append(j_pde.sample_points(k, cfg.task.inner_points, tp))
        outer.append(j_pde.sample_points(outer_loss_key, cfg.task.outer_points, tp))
        tasks.append((tp, inner, outer))
    return _batch(tasks)


# --- meta-gradients on fixed per-task points --------------------------------

def _fixed_point_setup(bsize=3, steps=3, learned=True):
    argv = SMALL + [f"--maml.bsize={bsize}", f"--maml.inner_steps={steps}"]
    jc, tc = _builds(argv)
    j_pde, j_field, j_loss = jc["pde"], jc["field"], jc["loss_fn"]
    n = 64

    def make_task_loss_fns(task_key):
        tp = j_pde.sample_params(task_key)
        pts_in = j_pde.sample_points(jax.random.fold_in(task_key, 1), n, tp)
        pts_out = j_pde.sample_points(jax.random.fold_in(task_key, 2), n, tp)
        inner = lambda key, fp: j_loss(j_field.bind(fp), pts_in, tp)
        outer = lambda key, fp: j_loss(j_field.bind(fp), pts_out, tp)
        return inner, outer

    j_def = jc["maml_def"]._replace(make_task_loss_fns=make_task_loss_fns, remat=False)
    jp = jc["init_params"]
    rng = np.random.default_rng(3)
    lrs = jax.tree_util.tree_map(
        lambda x: rng.normal(0.5, 1.0, (steps,) + x.shape).astype(np.float32), jp)

    def task_draws(key):
        task_key = jax.random.split(key, 3)[0]
        tp = j_pde.sample_params(task_key)
        pin = j_pde.sample_points(jax.random.fold_in(task_key, 1), n, tp)
        pout = j_pde.sample_points(jax.random.fold_in(task_key, 2), n, tp)
        return tp, [pin] * (steps + 1), [pout] * (steps + 1)

    t_lrs = params_from_numpy(lrs) if learned else None
    j_lrs = jax.tree_util.tree_map(jnp.asarray, lrs) if learned else None
    return (j_def, jp, j_lrs), (tc["maml_def"], tc["task_loss"], params_from_numpy(_np(jp)),
                                t_lrs), task_draws


@pytest.mark.parametrize("learned", [True, False])
def test_single_task_meta_gradient_matches_jax(learned):
    (j_def, jp, j_lrs), (t_def, t_loss, tp, t_lrs), task_draws = _fixed_point_setup(
        learned=learned)
    key = jax.random.PRNGKey(5)
    j_grad, j_losses, (j_meta, j_aux) = j_maml.single_task_grad_and_losses(
        j_def, key, jp, j_lrs)
    tpar, inner, outer = task_draws(key)
    task = maml.TaskBatch(tuple(_t(a) for a in tpar),
                          tuple(torch.stack([_t(s[j]) for s in inner]) for j in range(2)),
                          tuple(torch.stack([_t(s[j]) for s in outer]) for j in range(2)))
    t_grad, t_losses, (t_meta, t_aux) = maml.single_task_grad_and_losses(
        t_def._replace(remat=False), t_loss, task, tp, t_lrs)
    _close_trees(t_grad, j_grad, 1e-4)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-5)
    np.testing.assert_allclose(float(t_meta), float(j_meta), rtol=1e-5)
    for k in j_aux:
        np.testing.assert_allclose(float(t_aux[k]), float(j_aux[k]), rtol=1e-5)


@pytest.mark.parametrize("learned", [True, False])
def test_multi_task_meta_gradient_matches_jax(learned):
    (j_def, jp, j_lrs), (t_def, t_loss, tp, t_lrs), task_draws = _fixed_point_setup(
        learned=learned)
    key = jax.random.PRNGKey(6)
    j_grad, j_losses, (j_meta, j_aux) = j_maml.multi_task_grad_and_losses(
        j_def, key, jp, j_lrs)
    batch = _batch([task_draws(k) for k in jax.random.split(key, j_def.n_batch_tasks)])
    t_grad, t_losses, (t_meta, t_aux) = maml.multi_task_grad_and_losses(
        t_def._replace(remat=False), t_loss, batch, tp, t_lrs)
    _close_trees(t_grad, j_grad, 1e-4)
    assert t_losses.shape == (3, 4)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-5)
    np.testing.assert_allclose(t_meta.numpy(), np.asarray(j_meta), rtol=1e-5)
    for k in j_aux:
        np.testing.assert_allclose(t_aux[k].numpy(), np.asarray(j_aux[k]), rtol=1e-5)


@pytest.mark.parametrize("learned", [True, False])
def test_remat_equals_no_remat_bit_for_bit(learned):
    (_, _, _), (t_def, t_loss, tp, t_lrs), task_draws = _fixed_point_setup(learned=learned)
    batch = _batch([task_draws(k) for k in jax.random.split(jax.random.PRNGKey(8), 3)])
    outs = [maml.multi_task_grad_and_losses(t_def._replace(remat=r), t_loss, batch, tp, t_lrs)
            for r in (False, True)]
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a, b)


def test_first_order_losses_equal_the_meta_gradient_run():
    """need_grad=False (validation_losses) gives the same losses and
    meta-losses as the differentiated unroll, with no meta-gradient."""
    (_, _, _), (t_def, t_loss, tp, t_lrs), task_draws = _fixed_point_setup()
    batch = _batch([task_draws(k) for k in jax.random.split(jax.random.PRNGKey(9), 3)])
    g, losses, (meta, _) = maml.multi_task_grad_and_losses(t_def, t_loss, batch, tp, t_lrs)
    g0, losses0, (meta0, _) = maml.multi_task_grad_and_losses(
        t_def, t_loss, batch, tp, t_lrs, need_grad=False)
    assert g0 is None and g is not None
    np.testing.assert_allclose(losses0.numpy(), losses.numpy(), rtol=1e-6)
    np.testing.assert_allclose(meta0.numpy(), meta.numpy(), rtol=1e-6)


def test_pt_shards_average_to_the_full_loss():
    """pt sharding's premise (parallel/sharding.py): each task's loss on
    its full point set is the mean of its losses on n_pt equal parts."""
    tc = maml_driver.build(parse_overrides(Config(), SMALL), "cpu")
    batch = tc["draw_all"](torch.Generator().manual_seed(2))
    vloss = torch.func.vmap(tc["task_loss"], in_dims=(None, 0, 0))
    full = vloss(tc["init_params"], _set0(batch.outer_points), batch.task_params)[0]
    parts = [vloss(tc["init_params"], _set0(shard_task_loss_points(
        batch.outer_points, Mesh({"dp": 1, "pt": 4}, 0, j, None, None, "gloo"))),
        batch.task_params)[0] for j in range(4)]
    np.testing.assert_allclose(torch.stack(parts).mean(0).numpy(), full.numpy(), rtol=1e-5)


def _set0(points):
    return tuple(p[:, 0] for p in points)


# --- outer steps against the JAX driver --------------------------------------

def _start(tc, jc):
    j_state = (jc["init_params"], jc["inner_lrs"], jc["outer_opt"].init(jc["init_params"]),
               jc["lr_opt"].init(jc["inner_lrs"]))
    tp, tl = params_from_numpy(_np(jc["init_params"])), params_from_numpy(_np(jc["inner_lrs"]))
    return j_state, (tp, tl, tc["outer_opt"].init(tp), tc["lr_opt"].init(tl))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_step_core_matches_jax_train_step(n_steps):
    """1 step: JAX train_step(key); 3 steps: JAX train_step_many(key, 3),
    whose step keys are split(key, 3). Default config: learned LRs, remat."""
    jc, tc = _builds(SMALL)
    cfg = j_parse_overrides(JConfig(), SMALL)
    j_state, t_state = _start(tc, jc)
    key = jax.random.PRNGKey(11)
    if n_steps == 1:
        out = jc["train_step"](key, *j_state)
        j_gn, keys = out[6], [key]
    else:
        out = jc["train_step_many"](key, *j_state, n_steps=3)
        j_gn, keys = out[6], list(jax.random.split(key, 3))
    for k in keys:
        t_out = tc["step_core"](_jax_draws(jc["pde"], cfg, k), *t_state)
        t_state = t_out[:4]
    _close_trees(t_state[0], out[0], 1e-5)
    _close_trees(t_state[1], out[1], 1e-5)
    np.testing.assert_allclose(float(t_out[6]), float(j_gn), rtol=1e-4)
    np.testing.assert_allclose(t_out[5][0].numpy(), np.asarray(out[5][0]), rtol=1e-5)
    np.testing.assert_allclose(t_out[4].numpy(), np.asarray(out[4]), rtol=1e-5)
    assert int(t_state[2]["count"]) == n_steps


def test_one_step_from_the_jax_30k_checkpoint_matches_jax():
    """Resume p30k_f32_s1 (3x64, K = 5, bc_weight 100, Adam at step 30001
    with its optax states) in both packages and take one outer step on the
    same draws (bsize 2 and 64 points to keep the CPU time low)."""
    argv = ["--maml.bsize=2", "--task.inner_points=64", "--task.outer_points=64"]
    j_cfg = j_parse_overrides(j_load_run_config(str(RUN_DIR)), argv)
    t_cfg = parse_overrides(load_run_config(str(RUN_DIR)), argv)
    jc, tc = j_driver.build(j_cfg), maml_driver.build(t_cfg, "cpu")
    fname = str(RUN_DIR / "checkpoint_step_30001.pickle")
    js, ts = j_ckpt.load_checkpoint(fname), checkpoints.load_checkpoint(fname)
    j_state = tuple(jax.tree_util.tree_map(jnp.asarray, js[k])
                    for k in ("params", "inner_lrs", "opt_state", "lr_opt_state"))
    t_state = (params_from_numpy(ts["params"]), params_from_numpy(ts["inner_lrs"]),
               optimizers.from_jax_state("adam", ts["opt_state"]),
               optimizers.from_jax_state("adam", ts["lr_opt_state"]))
    key = jax.random.PRNGKey(12)
    out = jc["train_step"](key, *j_state)
    t_out = tc["step_core"](_jax_draws(jc["pde"], j_cfg, key), *t_state)
    _close_trees(t_out[0], out[0], 1e-5)
    _close_trees(t_out[1], out[1], 1e-5)
    np.testing.assert_allclose(float(t_out[6]), float(out[6]), rtol=1e-4)
    np.testing.assert_allclose(t_out[5][0].numpy(), np.asarray(out[5][0]), rtol=1e-5)
    assert int(t_out[2]["count"]) == 30002
