"""The optimizer deployment protocol (deploy.optimizer):
metapde_tpu.train.deploy.make_opt_final_model against
metapde_tpu_torch.train.deploy.make_opt_final_model, for MAML's model (a
(params, learned LRs) pair, the LRs unused) and LEAP's (params), on shared
inputs: JAX's params and task params, and the points JAX's final_model
draws from its key (the first of split(key)).

Bars: the adapted params within 1e-4 of each leaf's scale after k = 4
steps at deploy.inner_lr 1e-3, 2 layers of 32 and 128 points (measured
4.7e-7 for adam, 1.0e-6 for rmsprop, whose first steps are close to
lr * sign(g), and 1.8e-7 for sgd). f32 on both sides, sums in other
orders.
"""

import jax
import pytest
import torch

import test_torch_leap as tl  # noqa: E402
from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.train import deploy as j_deploy
from metapde_tpu.train import leap_driver as j_leap_driver
from metapde_tpu.train import maml_driver as j_maml_driver
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.train import deploy, leap_driver, maml_driver
from metapde_tpu_torch.utils.trees import tree_leaves, tree_map

torch.set_num_threads(2)

SMALL = ["--model.num_layers=2", "--model.layer_size=32", "--task.inner_points=128",
         "--maml.inner_steps=2", "--leap.inner_steps=2"]
K = 4
DRIVERS = {"maml": (j_maml_driver, maml_driver), "leap": (j_leap_driver, leap_driver)}


def _setup(algo, optimizer):
    argv = SMALL + [f"--deploy.optimizer={optimizer}", "--deploy.inner_lr=1e-3"]
    j_drv, t_drv = DRIVERS[algo]
    jc = j_drv.build(j_parse_overrides(JConfig(), argv))
    tc = t_drv.build(parse_overrides(Config(), argv), "cpu")
    if algo == "maml":
        j_model = (jc["init_params"], jc["inner_lrs"])
        t_model = tuple(params_from_numpy(tl._np(m)) for m in j_model)
    else:
        j_model = jc["init_params"]
        t_model = params_from_numpy(tl._np(j_model))
    return jc, tc, j_model, t_model


def _tasks(j_pde, n):
    """Two tasks, their final_model keys and the points those keys draw
    ([T, 1, n, 2] per kind)."""
    keys = jax.random.split(jax.random.PRNGKey(21), 2)
    tps = [j_pde.sample_params(k) for k in jax.random.split(jax.random.PRNGKey(22), 2)]
    pts = [j_pde.sample_points(jax.random.split(k)[0], n, tp) for k, tp in zip(keys, tps)]
    task_params = tuple(torch.stack([tl._t(tp[j]) for tp in tps]) for j in range(3))
    points = tuple(torch.stack([tl._t(p[j])[None] for p in pts]) for j in range(2))
    return keys, tps, task_params, points


@pytest.mark.parametrize("algo,optimizer", [("maml", "adam"), ("leap", "adam"),
                                            ("leap", "rmsprop"), ("leap", "sgd")])
def test_make_opt_final_model_matches_jax(algo, optimizer):
    jc, tc, j_model, t_model = _setup(algo, optimizer)
    cfg = j_parse_overrides(JConfig(), SMALL + [f"--deploy.optimizer={optimizer}",
                                                "--deploy.inner_lr=1e-3"])
    j_final = j_deploy.make_opt_final_model(jc["pde"], jc["loss_fn"], jc["field"], cfg.task,
                                            cfg.deploy, model_is_pair=algo == "maml")
    t_final = deploy.make_opt_final_model(tc["pde"], tc["loss_fn"], tc["field"], cfg.task,
                                          cfg.deploy, model_is_pair=algo == "maml")
    keys, tps, task_params, points = _tasks(jc["pde"], cfg.task.inner_points)
    ours = t_final(None, t_model, task_params, K, points)
    for i, (key, tp) in enumerate(zip(keys, tps)):
        ref = jax.jit(lambda k, m, t: j_final(k, m, t, K))(key, j_model, tp)
        tl._close_trees(tree_map(lambda x: x[i], ours), ref, 1e-4)
    # the driver deploys through it when deploy.optimizer is set
    drv = tc["deploy_final_model"](None, t_model, tuple(a[0] for a in task_params), K,
                                   tuple(p[0] for p in points))
    for a, b in zip(tree_leaves(drv), tree_leaves(ours)):
        torch.testing.assert_close(a, b[0], rtol=1e-6, atol=1e-7)


def test_k0_returns_the_init_for_every_task():
    jc, tc, j_model, t_model = _setup("maml", "adam")
    cfg = parse_overrides(Config(), SMALL + ["--deploy.optimizer=adam"])
    final = deploy.make_opt_final_model(tc["pde"], tc["loss_fn"], tc["field"], cfg.task,
                                        cfg.deploy, model_is_pair=True)
    _, _, task_params, _ = _tasks(jc["pde"], 8)
    out = final(None, t_model, task_params, 0)
    for a, b in zip(tree_leaves(out), tree_leaves(t_model[0])):
        assert a.shape == (2,) + tuple(b.shape) and torch.equal(a[1], b)


def test_draw_sets_draws_each_task_from_its_own_generator():
    """A task's draw does not depend on the other tasks of the batch."""
    cfg = parse_overrides(Config(), [])
    tc = leap_driver.build(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    tps = [tc["pde"].sample_params(gen) for _ in range(3)]
    stacked = tuple(torch.stack(x) for x in zip(*tps))
    gens = lambda: [torch.Generator().manual_seed(10 + i) for i in range(3)]
    all3 = deploy.draw_sets(tc["pde"], gens(), 16, stacked, 2)
    last = deploy.draw_sets(tc["pde"], gens()[2:], 16, tuple(a[2:] for a in stacked), 2)
    assert all3[0].shape == (3, 2, 16, 2)
    for a, b in zip(all3, last):
        assert torch.equal(a[2:], b)
