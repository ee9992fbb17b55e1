"""The plain-PINN driver: metapde_tpu.train.nn_driver against
metapde_tpu_torch.train.nn_driver, on shared inputs.

Params come from the JAX init (carried over with interop.params_from_numpy)
or from the committed tpu_run6b checkpoint; the collocation points are the
ones JAX's key chain draws, recomputed here and handed to the port:
- a step: split(key, bsize), then per set split(.., 2)[1] draws
  task.outer_points points of the pinned task (batch_loss_fn);
- the MAML warm-up: split(key)[1] is the rollout key; per inner step
  split(.., 3) -> k1 (task.inner_points points), k3 (the next key); the
  last key feeds the final loss.

Bars, each f32 on both sides with sums in other orders:
- step_core against JAX's train_step (clip off and on), 2 steps: loss, aux
  and grad norm rtol 1e-5; Adam-updated params within 1e-5 of each leaf's
  scale (its largest |value|, at least 1e-3).
- get_grad_norms: values and norms rtol 1e-5.
- maml_warmup against JAX's: within 1e-5 of each leaf's scale.
- a tiny run(): the metrics.jsonl keys of a JAX run, single and multi-start;
  a multi-start checkpoint holds one model that the JAX package's loader
  reads.
"""

import json
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import nn_driver as j_driver
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.train import checkpoints, nn_driver
from metapde_tpu_torch.utils.trees import tree_leaves, tree_map, tree_stack

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TPU_RUN6B = REPO / "results_poisson_maml" / "tpu_run6b"
JAX_DEPLOY = REPO / "results_poisson_deploy" / "deploy_maml_seed_1"
SMALL = ["--model.num_layers=2", "--model.layer_size=16", "--maml.bsize=2",
         "--task.outer_points=64", "--task.inner_points=64", "--maml.outer_lr=1e-3",
         "--seed=3"]
LEAF_TOL = 1e-5
RTOL = 1e-5


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
    return nn_driver.Batch(tuple(_t(a) for a in _jax_task(jc)),
                           tuple(torch.stack([_t(s[j]) for s in sets]) for j in range(2)))


def _step_points(jc, key):
    """JAX's task and the point sets its batch_loss_fn draws from `key`."""
    cfg, pde = jc["cfg"], jc["pde"]
    sets = [pde.sample_points(jax.random.split(k, 2)[1], cfg.task.outer_points, _jax_task(jc))
            for k in jax.random.split(key, cfg.maml.bsize)]
    return _batch(jc, sets)


def test_single_task_config_folds_the_seed_as_jax():
    argv = ["--seed=5", "--task.seed=2", "--task.n_eval=8"]
    ours = nn_driver.single_task_config(parse_overrides(Config(), argv))
    theirs = j_driver.build(j_parse_overrides(JConfig(), argv))["cfg"]
    assert ours.to_json() == theirs.to_json()
    assert (ours.task.seed, ours.task.n_eval, ours.task.fixed_num_pdes) == (7, 1, 1)


def test_the_seed_picks_the_task_and_a_host_draw_pins_it():
    """Different seeds fine-tune different tasks; one seed gives one task,
    whatever generator the family is handed."""
    a = nn_driver.build(parse_overrides(Config(), SMALL[:-1] + ["--seed=1"]), "cpu")
    b = nn_driver.build(parse_overrides(Config(), SMALL[:-1] + ["--seed=2"]), "cpu")
    a2 = nn_driver.build(parse_overrides(Config(), SMALL[:-1] + ["--seed=1"]), "cpu")
    assert not all(torch.equal(x, y) for x, y in zip(a["task_params"], b["task_params"]))
    for x, y in zip(a["task_params"], a2["task_params"]):
        assert torch.equal(x, y)
    other = a["pde"].sample_params(torch.Generator().manual_seed(12345))
    for x, y in zip(a["task_params"], other):
        assert torch.equal(x, y)


@pytest.mark.parametrize("grad_clip", [1e9, 1.0], ids=["clip_off", "clip_on"])
def test_step_core_matches_jax_train_step(grad_clip):
    jc, tc = _builds(SMALL + [f"--maml.grad_clip={grad_clip}"])
    jp, jo = jc["init_params"], jc["opt"].init(jc["init_params"])
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    to = tc["opt"].init(tp)
    key = jax.random.PRNGKey(11)
    for _ in range(2):
        key, sk = jax.random.split(key)
        jp, jo, j_loss, j_aux, j_gn = jc["train_step"](sk, jp, jo)
        tp, to, t_loss, t_aux, t_gn = tc["step_core"](_step_points(jc, sk), tp, to)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=RTOL)
        np.testing.assert_allclose(float(t_gn), float(j_gn), rtol=RTOL)
        assert sorted(t_aux) == sorted(j_aux)
        for k in j_aux:
            np.testing.assert_allclose(float(t_aux[k]), float(j_aux[k]), rtol=RTOL)
        _close_trees(tp, jp, LEAF_TOL)
    # the clip acted (or not) on both sides alike
    assert (float(j_gn) > grad_clip) == (grad_clip == 1.0)


def test_get_grad_norms_matches_jax():
    jc, tc = _builds(SMALL)
    jp = jc["init_params"]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    key = jax.random.PRNGKey(5)
    ours = tc["get_grad_norms"](_step_points(jc, key), tp)
    theirs = jc["get_grad_norms"](key, jp)
    assert sorted(ours) == sorted(theirs) == ["boundary_loss", "domain_loss"]
    for k in theirs:
        np.testing.assert_allclose([float(v) for v in ours[k]],
                                   [float(v) for v in theirs[k]], rtol=RTOL)


def test_maml_warmup_matches_jax_on_its_rollout_draws():
    """tpu_run6b's init and learned LRs (5 steps) cut to 3 inner steps."""
    argv = ["--maml.inner_steps=3", "--task.inner_points=64", "--task.bc_weight=1.0",
            "--seed=1"]
    jc, tc = _builds(argv)
    state = checkpoints.load_checkpoint(str(TPU_RUN6B / "checkpoint_step_500001.pickle"))
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
        tree_leaves(t_final), tree_leaves(params_from_numpy(state["params"])))) > 1e-4


def test_candidate_0_trains_on_the_single_start_stream():
    """ms_train_step_many's candidate 0 (the exact init, on the training
    generator) equals train_step_many, bit for bit; the other candidates
    move apart."""
    cfg = parse_overrides(Config(), SMALL)
    single, multi = nn_driver.build(cfg, "cpu"), nn_driver.build(cfg, "cpu")
    p = single["init_params"]
    out = single["train_step_many"](single["generator"], p, single["opt"].init(p), 3)
    from metapde_tpu_torch.train.multistart import jitter_leaves

    cands = [p, jitter_leaves(torch.Generator().manual_seed(1), p, 0.05), p]
    gens = [multi["generator"], torch.Generator().manual_seed(7),
            torch.Generator().manual_seed(8)]
    ms = multi["ms_train_step_many"](gens, tree_stack(cands),
                                     tree_stack([multi["opt"].init(c) for c in cands]), 3)
    for a, b in zip(tree_leaves(ms[0]), tree_leaves(out[0])):
        assert torch.equal(a[0], b)
        assert not torch.equal(a[1], b) and not torch.equal(a[2], b)
    assert torch.equal(ms[5][0], out[5])


def test_ms_scores_select_the_least_loss_and_never_a_nan():
    tc = nn_driver.build(parse_overrides(Config(), SMALL), "cpu")
    p = tc["init_params"]
    bad = tree_map(lambda x: torch.full_like(x, float("nan")), p)
    scaled = tree_map(lambda x: 3.0 * x, p)
    params_k = tree_stack([scaled, bad, p])
    scores = tc["ms_scores"](torch.Generator().manual_seed(0), params_k)
    assert scores.shape == (3,) and torch.isinf(scores[1])
    # one common draw: the score is the candidate's total loss on it
    again = tc["ms_scores"](torch.Generator().manual_seed(0), tree_stack([p]))
    assert float(again[0]) == float(scores[2])
    assert int(torch.argmin(scores)) == (0 if float(scores[0]) < float(scores[2]) else 2)


TINY = ["--model.num_layers=3", "--model.layer_size=64", "--maml.bsize=2",
        "--task.outer_points=64", "--task.inner_points=64", "--task.validation_points=64",
        "--solver.ground_truth_resolution=4", "--train.outer_steps=4", "--train.log_every=2",
        "--train.checkpoint_every=0", "--train.viz_every=0", "--maml.inner_steps=2",
        "--task.bc_weight=1.0", f"--train.load_model_from_expt={TPU_RUN6B}"]


def _records(run_dir):
    return [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_run_resumes_a_jax_checkpoint_with_the_maml_warmup(tmp_path):
    """From tpu_run6b's JAX checkpoint: its inner LRs drive the warm-up, the
    run dir holds the JAX run's files and metrics keys, the final
    checkpoint the params in the JAX layout and no JAX-only key."""
    cfg = parse_overrides(Config(), TINY + [f"--train.out_dir={tmp_path}",
                                            "--train.expt_name=w"])
    nn_driver.run(cfg, maml_warmup=True, device="cpu")
    run = tmp_path / "w"
    text = (run / "log.txt").read_text()
    assert "loaded checkpoint" in text and "applied MAML warm-up adaptation" in text
    assert "note: differs from loaded run's config: task.n_eval: 4 -> 1" in text
    assert "ground truth at resolution 4: 1 solved, 0 read" in text
    assert "siren_fused launches 0" in text  # the CPU takes the plain version
    recs = _records(run)
    assert [r["step"] for r in recs] == [0, 2]
    jax_keys = sorted(json.loads(JAX_DEPLOY.joinpath("metrics.jsonl").read_text()
                                 .splitlines()[0]))
    assert sorted(recs[0]) == jax_keys
    with open(run / "checkpoint_step_4.pickle", "rb") as f:
        state = pickle.load(f)  # plain pickle: nothing of torch or the port
    assert not set(checkpoints.JAX_ONLY_KEYS) & set(state)
    ref = checkpoints.load_checkpoint(str(TPU_RUN6B / "checkpoint_step_500001.pickle"))
    assert ([(a.dtype, a.shape) for a in tree_leaves(state["params"])]
            == [(a.dtype, a.shape) for a in tree_leaves(ref["params"])])
    assert int(state["torch_opt_state"]["count"]) == 4
    # a second run of the same seed and out_dir reads its ground truth
    nn_driver.run(parse_overrides(Config(), TINY + [f"--train.out_dir={tmp_path}",
                                                    "--train.expt_name=again"]), device="cpu")
    again = (tmp_path / "again" / "log.txt").read_text()
    assert "1 solved" not in again and "0 solved, 1 read" in again
    assert "applied MAML warm-up" not in again


def test_multistart_run_matches_the_jax_keys_and_saves_one_model(tmp_path):
    """3 candidates: the metrics rows carry the JAX run's keys (ms_* too);
    the final checkpoint holds one unstacked model and 3 scores, and the
    JAX package's loader reads it."""
    ms = ["--deploy.n_starts=3", "--deploy.jitter=0.05"]
    argv = TINY + ms + [f"--train.out_dir={tmp_path}"]
    nn_driver.run(parse_overrides(Config(), argv + ["--train.expt_name=t"]), device="cpu")
    j_driver.run(j_parse_overrides(JConfig(), argv + ["--train.expt_name=j"]))
    ours, theirs = _records(tmp_path / "t"), _records(tmp_path / "j")
    assert [r["step"] for r in ours] == [r["step"] for r in theirs] == [0, 2]
    assert sorted(ours[0]) == sorted(theirs[0])
    assert {"ms_best_idx", "ms_train_best_idx", "ms_score_best"} <= set(ours[0])
    state = j_ckpt.load_checkpoint(str(tmp_path / "t" / "checkpoint_step_4.pickle"))
    j_state = j_ckpt.load_checkpoint(str(tmp_path / "j" / "checkpoint_step_4.pickle"))
    assert ([np.shape(a) for a in jax.tree_util.tree_leaves(state["params"])]
            == [np.shape(a) for a in jax.tree_util.tree_leaves(j_state["params"])])
    assert len(state["ms_scores"]) == 3 and 0 <= state["ms_best_idx"] < 3
    text = (tmp_path / "t" / "log.txt").read_text()
    assert "multi-start fine-tune: 3 candidates, jitter=0.05" in text
    assert "multi-start selection: best candidate" in text
