"""The plain-PINN driver on the paper's other two families, TD-Burgers and
hyperelasticity (pipeline/deployment_burgers.sh, deployment_elasticity.sh):
metapde_tpu.train.nn_driver against metapde_tpu_torch.train.nn_driver on
shared inputs.

Params come from the JAX init or from the committed tpu_run1 checkpoints
(8x64, learned inner LRs); the collocation points are the ones JAX's key
chain draws (tests/test_torch_nn_driver.py gives the chain), on JAX's
pinned task, handed to the port.

Bars, f32 on both sides with sums in other orders:
- step_core against JAX's train_step, 2 steps: loss, aux terms and grad
  norm rtol 1e-5 (Burgers) and 1e-4 (hyperelasticity: its loss sums six
  point kinds through per-point Jacobians); Adam-updated params within
  1e-5 of each leaf's scale (its largest |value|, at least 1e-3).
- get_grad_norms: values and norms rtol 1e-4; a term that does not reach
  a leaf (hyperelasticity's edge terms) gives that leaf a zero gradient,
  as JAX does (the port raised there before).
- The pinned task: the config both drivers run is the same JSON; every
  factor the scripts freeze (vary_source, vary_bc) is JAX's draw bit for
  bit; the factors left to vary come from a torch generator seeded
  task.seed + seed (the port does not replay JAX's threefry), so one seed
  gives one task whatever generator the family is handed, two seeds two.
- maml_warmup from tpu_run1's learned LRs (5 steps, cut to 3) on JAX's
  rollout draws: within 1e-5 of each leaf's scale.
- A tiny run() on each family writes the metrics.jsonl keys of the JAX
  package's sweep rows (results_*_deploy/deploy_leap_seed_1), Burgers'
  per_time_step_error with one finite entry per output time, and calls
  the siren_fused wrapper once per validation (hyperelasticity's task and
  its mirror in that one call).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.train import nn_driver as j_driver
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.ops import siren_fused
from metapde_tpu_torch.pdes import frozen
from metapde_tpu_torch.train import checkpoints, nn_driver
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FAMILY = {
    # pipeline/deployment_burgers.sh's task flags
    "td_burgers": ["--task.pde=td_burgers", "--task.domain.xmin=0.0",
                   "--task.max_reynolds=100", "--task.vary_source=false",
                   "--task.vary_bc=false"],
    # pipeline/deployment_elasticity.sh's task flags (its LEAP command)
    "hyper_elasticity": ["--task.pde=hyper_elasticity", "--task.domain.xmin=0.0",
                         "--task.domain.ymin=0.0", "--task.max_holes=5",
                         "--task.max_hole_size=0.5", "--task.vary_source=false",
                         "--task.vary_bc=false"],
}
INIT = {"td_burgers": REPO / "results_burgers_maml" / "tpu_run1",
        "hyper_elasticity": REPO / "results_elasticity_maml" / "tpu_run1"}
SWEEP_ROWS = {"td_burgers": REPO / "results_burgers_deploy" / "deploy_leap_seed_1",
              "hyper_elasticity": REPO / "results_elasticity_deploy" / "deploy_leap_seed_1"}
SMALL = ["--model.num_layers=2", "--model.layer_size=16", "--maml.bsize=2",
         "--task.outer_points=128", "--task.inner_points=128", "--maml.outer_lr=1e-3",
         "--seed=3"]
LEAF_TOL = 1e-5
RTOL = {"td_burgers": 1e-5, "hyper_elasticity": 1e-4}
GRAD_NORM_RTOL = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _close_trees(t_tree, j_tree, rel):
    a, b = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=0,
                                   atol=rel * max(np.abs(y).max(), 1e-3))


def _builds(argv):
    jc = j_driver.build(j_parse_overrides(JConfig(), argv))
    tc = nn_driver.build(parse_overrides(Config(), argv), "cpu")
    return jc, tc


def _jax_task(jc):
    """JAX's pinned task (any key gives it)."""
    return jc["pde"].sample_params(jax.random.PRNGKey(0))


def _batch(jc, sets):
    """JAX's task and per-kind stacks [sets, n, ...] of its point sets."""
    return nn_driver.Batch(tuple(_t(a) for a in _jax_task(jc)),
                           tuple(torch.stack([_t(s[j]) for s in sets])
                                 for j in range(len(sets[0]))))


def _step_points(jc, key):
    """The point sets JAX's batch_loss_fn draws from `key`."""
    cfg, pde = jc["cfg"], jc["pde"]
    return _batch(jc, [pde.sample_points(jax.random.split(k, 2)[1], cfg.task.outer_points,
                                         _jax_task(jc))
                       for k in jax.random.split(key, cfg.maml.bsize)])


@pytest.mark.parametrize("family", list(FAMILY))
def test_step_core_matches_jax_train_step(family):
    jc, tc = _builds(FAMILY[family] + SMALL + ["--maml.grad_clip=1.0"])
    jp, jo = jc["init_params"], jc["opt"].init(jc["init_params"])
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    to = tc["opt"].init(tp)
    key = jax.random.PRNGKey(11)
    for _ in range(2):
        key, sk = jax.random.split(key)
        jp, jo, j_loss, j_aux, j_gn = jc["train_step"](sk, jp, jo)
        tp, to, t_loss, t_aux, t_gn = tc["step_core"](_step_points(jc, sk), tp, to)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=RTOL[family])
        np.testing.assert_allclose(float(t_gn), float(j_gn), rtol=RTOL[family])
        assert sorted(t_aux) == sorted(j_aux)
        for k in j_aux:
            np.testing.assert_allclose(float(t_aux[k]), float(j_aux[k]), rtol=RTOL[family],
                                       err_msg=k)
        _close_trees(tp, jp, LEAF_TOL)


@pytest.mark.parametrize("family", list(FAMILY))
def test_get_grad_norms_matches_jax(family):
    jc, tc = _builds(FAMILY[family] + SMALL)
    jp = jc["init_params"]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    key = jax.random.PRNGKey(5)
    ours = tc["get_grad_norms"](_step_points(jc, key), tp)
    theirs = jc["get_grad_norms"](key, jp)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_allclose([float(v) for v in ours[k]],
                                   [float(v) for v in theirs[k]], rtol=GRAD_NORM_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("family", list(FAMILY))
def test_pinned_task_freezes_jax_s_factors_and_one_seed_gives_one_task(family):
    argv = FAMILY[family] + ["--seed=5", "--task.seed=2", "--task.n_eval=8"]
    ours = nn_driver.single_task_config(parse_overrides(Config(), argv))
    jc = j_driver.build(j_parse_overrides(JConfig(), argv))
    assert ours.to_json() == jc["cfg"].to_json()
    assert (ours.task.seed, ours.task.n_eval, ours.task.fixed_num_pdes) == (7, 1, 1)
    tc = nn_driver.build(parse_overrides(Config(), argv), "cpu")
    j_task = [np.asarray(a) for a in _jax_task(jc)]
    t_task = [a.numpy() for a in tc["task_params"]]
    assert [a.shape for a in t_task] == [a.shape for a in j_task]
    if family == "td_burgers":
        # (Reynolds number, initial-condition params): the first frozen
        np.testing.assert_array_equal(t_task[0].view(np.uint32), j_task[0].view(np.uint32))
        np.testing.assert_array_equal(t_task[0], 100.0 * frozen.uniform((1,), 0.8, 1.0).numpy())
        assert np.all(np.abs(t_task[1]) <= 2.0)
    else:
        # (source, bc, geometry): the first two frozen at JAX's zero-key draws
        for a, b in zip(t_task[:2], j_task[:2]):
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    # one seed pins one task whatever generator the family is handed
    other = tc["pde"].sample_params(torch.Generator().manual_seed(12345))
    for a, b in zip(tc["task_params"], other):
        assert torch.equal(a, b)
    again = nn_driver.build(parse_overrides(Config(), argv[:-3] + ["--seed=6", "--task.seed=2"]),
                            "cpu")
    assert not all(torch.equal(a, b) for a, b in zip(tc["task_params"], again["task_params"]))


@pytest.mark.parametrize("family", list(FAMILY))
def test_maml_warmup_matches_jax_on_its_rollout_draws(family):
    """tpu_run1's init and learned LRs (5 steps) cut to 3 inner steps, 64
    points a step, at the checkpoint's 8x64."""
    argv = FAMILY[family] + ["--model.num_layers=8", "--model.layer_size=64",
                             "--maml.inner_steps=3", "--task.inner_points=64",
                             "--task.bc_weight=1.0", "--maml.inner_lr=1e-4", "--seed=1"]
    jc, tc = _builds(argv)
    state = checkpoints.load_checkpoint(str(INIT[family] / "checkpoint_step_60001.pickle"))
    j_params = jax.tree_util.tree_map(jax.numpy.asarray, state["params"])
    j_lrs = jax.tree_util.tree_map(jax.numpy.asarray, state["inner_lrs"])
    assert jax.tree_util.tree_leaves(j_lrs)[0].shape[0] == 5
    key = jax.random.PRNGKey(21)
    j_final = jc["maml_warmup"](key, j_params, j_lrs)

    pde, tp = jc["pde"], _jax_task(jc)
    k, sets = jax.random.split(key)[1], []
    for _ in range(3):
        k1, _, k = jax.random.split(k, 3)
        sets.append(pde.sample_points(k1, 64, tp))
    sets.append(pde.sample_points(k, 64, tp))
    t_final = tc["maml_warmup"](None, params_from_numpy(state["params"]),
                                params_from_numpy(state["inner_lrs"]), batch=_batch(jc, sets))
    _close_trees(t_final, j_final, LEAF_TOL)
    # the warm-up moved the init
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(t_final), tree_leaves(params_from_numpy(state["params"])))) > 1e-6


TINY = {"td_burgers": ["--task.num_tsteps=11", "--solver.ground_truth_resolution=32",
                       "--task.validation_points=256"],
        "hyper_elasticity": ["--solver.ground_truth_resolution=8",
                             "--task.validation_points=64"]}


@pytest.mark.parametrize("family", list(FAMILY))
def test_run_writes_the_jax_sweep_s_keys_one_inference_call_a_validation(
        family, tmp_path, monkeypatch):
    calls = []
    wrapper = siren_fused.siren_apply_fused_batched

    def counted(params, x, cfg, shared=False):
        calls.append(tuple(x.shape))
        return wrapper(params, x, cfg, shared=shared)

    monkeypatch.setattr(siren_fused, "siren_apply_fused_batched", counted)
    argv = FAMILY[family] + SMALL + TINY[family] + [
        "--train.outer_steps=4", "--train.log_every=2", "--train.val_every=2",
        "--train.checkpoint_every=0", "--train.viz_every=0",
        "--model.use_pallas_inference=true", f"--train.out_dir={tmp_path}",
        "--train.expt_name=run"]
    nn_driver.run(parse_overrides(Config(), argv), device="cpu")
    recs = [json.loads(l) for l in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 2]
    jax_keys = sorted(json.loads((SWEEP_ROWS[family] / "metrics.jsonl").read_text()
                                 .splitlines()[0]))
    assert sorted(recs[0]) == jax_keys
    for r in recs:
        assert np.isfinite(r["val_rel_err"]) and np.isfinite(r["loss"])
        if family == "td_burgers":
            assert len(r["per_time_step_error"]) == 11
            assert all(np.isfinite(r["per_time_step_error"]))
        else:
            assert r["per_time_step_error"] is None
    # one wrapper call a validation: Burgers' task, or the elasticity task
    # and its mirror as two sets of one model
    assert len(calls) == len(recs)
    assert calls[0][0] == (1 if family == "td_burgers" else 2)
