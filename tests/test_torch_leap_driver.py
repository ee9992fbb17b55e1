"""LEAP meta-training and deployment: metapde_tpu.train.leap_driver against
metapde_tpu_torch.train.leap_driver, and the port's run() and CLI.

Shared inputs as in test_torch_leap.py: JAX's params, JAX's key chain
replayed to get its own draws, handed to the port.

- One outer step (step_core against the JAX train_step, and 3 steps
  against train_step_many) at 2 layers of 32, bsize 3, 3 inner steps, 128
  points, from a fresh Adam: params within 1e-4 of each leaf's scale
  (measured 1.1e-8 after one step, 5.8e-7 after three: a fresh Adam's
  first step is lr * sign(g), which the meta-gradient's d_loss noise,
  test_torch_leap.py, flipped for no element here); meta-grad norm rtol
  1e-4 (measured 2.5e-7), losses rtol 1e-5 (measured 2.0e-7).
- One outer step from lp2_4's checkpoint_step_60000.pickle (5x64, Adam at
  step 60000 with its optax state) in both packages, cut to bsize 2, 3
  inner steps and 64 points: params within 1e-5 of each leaf's scale
  (measured 6.8e-8), meta-grad norm rtol 1e-4 (measured 0), losses rtol
  1e-5 (measured 1.5e-6).
- make_coef_func_batched (one batched rollout, one inference call) against
  the JAX package's vmapped make_coef_func on lp2_4 at k = 0 and 3, on the
  inner points JAX's get_final_model draws, with the plain version of the
  kernel on the port's side (the Pallas kernel in interpret mode on JAX's):
  within 2e-4 of the values' scale (measured 4.4e-5 at k = 0 and 5.9e-6 at
  k = 3). The trained 5x64 chain (omega 30 in every layer) is ill
  conditioned in f32: on these points JAX's own forward is 1.3e-4 of the
  scale from a float64 forward, and the port's 1.4e-4.
- run() writes the JAX run's files; the JAX leap_driver.run loads the
  port's checkpoint (params, and a fresh optimizer: the port writes no
  opt_state); 2 + 2 steps with a resume equal 4 steps bit for bit; run()
  resumes lp2_4 with its Adam state.
"""

import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_leap as tl  # the JAX key-chain replay helpers  # noqa: E402
from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import leap_driver as j_driver
from metapde_tpu_torch.cli import leap_pde
from metapde_tpu_torch.config import Config, load_run_config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.train import checkpoints, leap_driver, optimizers
from metapde_tpu_torch.train.validation import task_generator
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(2)

LP2_4 = Path(__file__).resolve().parents[1] / "results_poisson_leap" / "lp2_4"
LP2_4_CKPT = LP2_4 / "checkpoint_step_60000.pickle"
TINY = ["--task.inner_points=32", "--task.validation_points=32", "--task.n_eval=2",
        "--solver.ground_truth_resolution=4", "--leap.bsize=2", "--leap.inner_steps=2",
        "--model.num_layers=2", "--model.layer_size=16", "--train.viz_every=0",
        "--train.log_every=1", "--train.checkpoint_every=2"]
FILES = ("log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle")


def _start(tc, jc):
    jp = jc["init_params"]
    tp = params_from_numpy(tl._np(jp))
    return (jp, jc["outer_opt"].init(jp)), (tp, tc["outer_opt"].init(tp))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_step_core_matches_jax_train_step(n_steps):
    jc, tc = tl._builds()
    cfg = j_parse_overrides(JConfig(), tl.SMALL)
    j_state, t_state = _start(tc, jc)
    key = jax.random.PRNGKey(11)
    if n_steps == 1:
        out = jc["train_step"](key, *j_state)
        j_losses, j_gn, keys = out[2], out[3], [key]
    else:
        out = jc["train_step_many"](key, *j_state, n_steps=3)
        j_losses, j_gn, keys = out[2], out[3], list(jax.random.split(key, 3))
    for k in keys:
        batch = tl.jax_batch(jc["pde"], cfg.task.inner_points, k, cfg.leap.bsize,
                             cfg.leap.inner_steps)
        t_out = tc["step_core"](batch, *t_state)
        t_state = t_out[:2]
    tl._close_trees(t_state[0], out[0], 1e-4)
    np.testing.assert_allclose(float(t_out[3]), float(j_gn), rtol=1e-4)
    np.testing.assert_allclose(t_out[2].numpy(), np.asarray(j_losses), rtol=1e-5)
    assert int(t_state[1]["count"]) == n_steps


def _lp2_4_cfgs(argv):
    return (j_parse_overrides(j_load_run_config(str(LP2_4)), argv),
            parse_overrides(load_run_config(str(LP2_4)), argv))


def test_one_step_from_the_lp2_4_checkpoint_matches_jax():
    """Both packages resume lp2_4 (5x64, bc_weight 100, Adam at step 60000
    with its optax state) and take one outer step on the same draws."""
    j_cfg, t_cfg = _lp2_4_cfgs(["--leap.bsize=2", "--leap.inner_steps=3",
                                "--task.inner_points=64"])
    jc, tc = j_driver.build(j_cfg), leap_driver.build(t_cfg, "cpu")
    js, ts = j_ckpt.load_checkpoint(str(LP2_4_CKPT)), checkpoints.load_checkpoint(str(LP2_4_CKPT))
    j_state = tuple(jax.tree_util.tree_map(jnp.asarray, js[k]) for k in ("params", "opt_state"))
    t_state = (params_from_numpy(ts["params"]), optimizers.from_jax_state("adam", ts["opt_state"]))
    assert len(tree_leaves(t_state[0])) == 14  # 5 hidden layers, the output, two scales
    key = jax.random.PRNGKey(12)
    out = jc["train_step"](key, *j_state)
    batch = tl.jax_batch(jc["pde"], 64, key, 2, 3)
    t_out = tc["step_core"](batch, *t_state)
    tl._close_trees(t_out[0], out[0], 1e-5)
    np.testing.assert_allclose(float(t_out[3]), float(out[3]), rtol=1e-4)
    np.testing.assert_allclose(t_out[2].numpy(), np.asarray(out[2]), rtol=1e-5)
    assert int(t_out[1]["count"]) == 60001


def _jax_deploy_points(j_pde, key, k, n, task_params):
    """The inner points JAX's get_final_model(key, .., k) draws: per step,
    the first of split(split(split(key)[1], k)[j])."""
    inner_key = jax.random.split(key)[1]
    sets = [j_pde.sample_points(jax.random.split(ik)[0], n, task_params)
            for ik in jax.random.split(inner_key, k)]
    return tuple(torch.stack([tl._t(s[j]) for s in sets]) for j in range(2))


@pytest.mark.parametrize("k", [0, 3])
def test_make_coef_func_batched_matches_jax_vmapped_make_coef_func(k):
    j_cfg, t_cfg = _lp2_4_cfgs(["--task.inner_points=64", "--model.use_pallas_inference=true"])
    jc, tc = j_driver.build(j_cfg), leap_driver.build(t_cfg, "cpu")
    state = checkpoints.load_checkpoint(str(LP2_4_CKPT))
    j_params = jax.tree_util.tree_map(jnp.asarray, state["params"])
    j_pde = jc["pde"]
    j_tasks = [j_pde.sample_params(kk) for kk in jax.random.split(jax.random.PRNGKey(7919), 2)]
    coords = jnp.stack([j_pde.sample_validation_points(jax.random.PRNGKey(50 + i), 64, tp)
                        for i, tp in enumerate(j_tasks)])
    keys = jax.random.split(jax.random.PRNGKey(0), 2)  # JAX validation's keys
    j_coefs = jax.jit(jax.vmap(lambda key, tp, c: jc["make_coef_func"](
        key, j_params, tp, c, inner_steps=k)))(
        keys, jax.tree_util.tree_map(lambda *x: jnp.stack(x), *j_tasks), coords)
    t_tasks = [tuple(tl._t(a) for a in tp) for tp in j_tasks]
    points = None
    if k:
        per_task = [_jax_deploy_points(j_pde, key, k, 64, tp) for key, tp in zip(keys, j_tasks)]
        points = tuple(torch.stack(x) for x in zip(*per_task))
    t_coefs = tc["make_coef_func_batched"](
        [task_generator(i) for i in range(2)], params_from_numpy(state["params"]), t_tasks,
        tl._t(coords), inner_steps=k, points=points)
    j_coefs = np.asarray(j_coefs)
    assert t_coefs.shape == j_coefs.shape == (2, 64)
    np.testing.assert_allclose(t_coefs.numpy(), j_coefs, rtol=0,
                               atol=2e-4 * np.abs(j_coefs).max())


def test_batched_deployment_equals_per_task_deployment():
    """make_coef_func_batched's one batched rollout against make_coef_func
    task by task, each on its own generator's draws: within 1e-5 of the
    values' scale (batched and one-task products round differently)."""
    tc = leap_driver.build(parse_overrides(load_run_config(str(LP2_4)), [
        "--task.inner_points=64"]), "cpu")
    state = checkpoints.load_checkpoint(str(LP2_4_CKPT))
    params = params_from_numpy(state["params"])
    gen = torch.Generator().manual_seed(3)
    tasks = [tc["pde"].sample_params(gen) for _ in range(2)]
    coords = torch.stack([tc["pde"].sample_validation_points(gen, 64, tp) for tp in tasks])
    batched = tc["make_coef_func_batched"]([task_generator(i) for i in range(2)], params,
                                           tasks, coords, inner_steps=3)
    per_task = torch.stack([tc["make_coef_func"](task_generator(i), params, tasks[i], coords[i],
                                                 inner_steps=3) for i in range(2)])
    assert batched.shape == (2, 64)
    scale = float(per_task.abs().max())
    np.testing.assert_allclose(batched.numpy(), per_task.numpy(), rtol=0, atol=1e-5 * scale)


# --- run() -------------------------------------------------------------------

def _cfg(tmp_path, expt, steps, *extra):
    return parse_overrides(Config(), TINY + [
        f"--train.outer_steps={steps}", f"--train.out_dir={tmp_path}",
        f"--train.expt_name={expt}", *extra])


def _records(run_dir):
    return [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_run_writes_files_the_jax_leap_run_loads(tmp_path):
    """The port's run dir has the JAX run's files and metrics keys; its
    checkpoints hold the JAX-read keys in the JAX layout and none of the
    JAX-only ones; the JAX leap_driver.run loads its params and starts a
    fresh optimizer (there is no opt_state to resume)."""
    leap_driver.run(_cfg(tmp_path, "a", 3), device="cpu")
    run = tmp_path / "a"
    for f in FILES + ("checkpoint_step_2.pickle", "checkpoint_step_3.pickle"):
        assert (run / f).exists(), f
    recs = _records(run)
    assert [r["step"] for r in recs] == [0, 1, 2]
    jax_keys = sorted(json.loads((LP2_4 / "metrics.jsonl").read_text().splitlines()[0]))
    assert sorted(recs[0]) == jax_keys
    assert all(np.isfinite([r["meta_loss"], r["val_meta_loss"], r["val_rel_err"]]).all()
               for r in recs)
    assert len(recs[0]["per_step_losses"]) == 3  # K + 1
    with open(run / "checkpoint_step_3.pickle", "rb") as f:
        state = pickle.load(f)  # plain pickle: nothing of torch or the port
    assert not set(checkpoints.JAX_ONLY_KEYS) & set(state)
    assert state["step"] == 3 and isinstance(state["step"], int)
    assert "inner_lrs" not in state
    assert all(l.dtype == np.float32 for l in tree_leaves(state["params"]))

    j_cfg = j_parse_overrides(JConfig(), TINY + [
        "--train.outer_steps=1", f"--train.out_dir={tmp_path}", "--train.expt_name=j",
        f"--train.load_model_from_expt={run}"])
    j_params = j_driver.run(j_cfg)
    text = (tmp_path / "j" / "log.txt").read_text()
    assert "loaded checkpoint" in text and "resuming optimizer state" not in text
    assert [r["step"] for r in _records(tmp_path / "j")] == [0]
    # the JAX run took one step from the port's params with a fresh Adam
    # (a first Adam step moves each element by lr * sign(g) or not at all)
    lr = j_cfg.leap.outer_lr
    for a, b in zip(tree_leaves(state["params"]), jax.tree_util.tree_leaves(j_params)):
        assert np.abs(np.asarray(b) - a).max() <= 1.01 * lr


def test_two_plus_two_steps_with_a_resume_equal_four_steps(tmp_path):
    p4 = leap_driver.run(_cfg(tmp_path, "whole", 4), device="cpu")
    leap_driver.run(_cfg(tmp_path, "first", 2), device="cpu")
    p = leap_driver.run(_cfg(tmp_path, "second", 4,
                             f"--train.load_model_from_expt={tmp_path / 'first'}"),
                        device="cpu")
    for a, b in zip(tree_leaves(p), tree_leaves(p4)):
        assert torch.equal(a, b)
    assert "resuming optimizer state at step 2" in (tmp_path / "second" / "log.txt").read_text()
    whole, second = _records(tmp_path / "whole"), _records(tmp_path / "second")
    assert [r["step"] for r in second] == [2, 3]
    for a, b in zip(whole[2:], second):
        assert a["val_rel_err"] == b["val_rel_err"] and a["meta_loss"] == b["meta_loss"]


def test_run_resumes_lp2_4_with_its_adam_state(tmp_path):
    cfg = parse_overrides(Config(), [
        f"--from_run={LP2_4}", "--train.outer_steps=60002", "--train.log_every=1",
        "--train.val_every=0", "--train.viz_every=0", "--leap.bsize=1",
        "--leap.inner_steps=2", "--task.inner_points=32", "--task.validation_points=32",
        "--task.n_eval=1", "--solver.ground_truth_resolution=4",
        f"--train.out_dir={tmp_path}", "--train.expt_name=r"])
    leap_driver.run(cfg, device="cpu")
    text = (tmp_path / "r" / "log.txt").read_text()
    assert "resuming optimizer state at step 60001" in text
    assert [r["step"] for r in _records(tmp_path / "r")] == [60001]
    state = checkpoints.load_checkpoint(str(tmp_path / "r" / "checkpoint_step_60002.pickle"))
    assert int(state["torch_opt_state"]["count"]) == 60001  # one step after 60000


def test_cli_trains_on_the_cpu_and_refuses_unported_options(tmp_path):
    base = TINY + [f"--train.out_dir={tmp_path}", "--device=cpu"]
    leap_pde.main(base + ["--train.outer_steps=1", "--train.expt_name=cli"])
    assert all((tmp_path / "cli" / f).exists() for f in FILES)
    # viz_every and profile_dir, which the port once refused, are accepted
    # and ignored, as the JAX LEAP driver ignores them
    leap_pde.main(base + ["--train.outer_steps=2", "--train.expt_name=viz",
                          "--train.viz_every=1", f"--train.profile_dir={tmp_path / 'prof'}",
                          "--train.profile_steps=1"])
    assert not (tmp_path / "prof").exists()
    assert not list((tmp_path / "viz").glob("viz_*"))
    # every family is ported; an unknown name raises as the JAX registry does
    with pytest.raises(ValueError, match="unrecognized pde"):
        leap_pde.main(base + ["--train.outer_steps=1", "--train.expt_name=bad",
                              "--task.pde=heat"])
