"""The Poisson MAML deployment slice, JAX package against its PyTorch port.

Both packages load the committed p30k_f32_s1 checkpoint with their own
loaders, then deploy it on the same two tasks: same task params, the same
inner points (the ones JAX's get_final_model draws), the same validation
coords. Each side adapts the full-width 3x64 SIREN with k = 5 learned-LR
steps, solves the FEM ground truth at resolution 8 and computes the
validation metrics; the port's validation evaluates both tasks in one
batched inference, as the JAX package's vmap does.

Tolerance: rtol 1e-3 on the metrics and 1e-4 (relative to each leaf's
scale) on the adapted params. The two sides sum in other orders (f32), and
the two ground-truth solves stop at different iterates of the same
Newton-BiCGStab inside its tolerance (gt values differ by up to ~3e-5 at
res 8, bar 1e-4).
"""

import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.solvers import fem_poisson as j_fem
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import maml_driver as j_driver
from metapde_tpu.train.validation import make_validation_fn as j_make_validation_fn
from metapde_tpu_torch.cli import deploy_bench
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy, params_to_numpy
from metapde_tpu_torch.ops import siren_fused
from metapde_tpu_torch.solvers import fem_poisson
from metapde_tpu_torch.train import checkpoints, maml_driver
from metapde_tpu_torch.train.validation import make_validation_fn, task_generator
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

RUN_DIR = Path(__file__).resolve().parents[1] / "results_poisson_maml" / "p30k_f32_s1"
CKPT = RUN_DIR / "checkpoint_best.pickle"
OVERRIDES = ["--model.use_pallas_inference=true", "--task.n_eval=2",
             "--task.inner_points=256", "--task.validation_points=256"]
K = 5
RES = 8


def _np_leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def test_checkpoint_loaders_agree():
    j_state = j_ckpt.load_checkpoint(str(CKPT))
    t_state = checkpoints.load_checkpoint(str(CKPT))
    assert t_state["step"] == j_state["step"]
    for key in ("params", "inner_lrs"):
        a, b = _np_leaves(j_state[key]), [np.asarray(l) for l in tree_leaves(t_state[key])]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # optimizer states come back as inert placeholders, never as optax objects
    assert all(isinstance(o, checkpoints.InertPlaceholder) for o in t_state["opt_state"])


def test_params_roundtrip_through_interop():
    state = checkpoints.load_checkpoint(str(CKPT))
    back = params_to_numpy(params_from_numpy(state["params"]))
    for x, y in zip(tree_leaves(state["params"]), tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_deploy_slice_matches_jax():
    jc = j_driver.build(j_parse_overrides(JConfig(), OVERRIDES))
    tc = maml_driver.build(parse_overrides(Config(), OVERRIDES), "cpu")
    j_pde, t_pde = jc["pde"], tc["pde"]

    j_state = j_ckpt.load_checkpoint(str(CKPT))
    j_model = jax.tree_util.tree_map(jnp.asarray, (j_state["params"], j_state["inner_lrs"]))
    t_state = checkpoints.load_checkpoint(str(CKPT))
    t_model = (params_from_numpy(t_state["params"]),
               params_from_numpy(t_state["inner_lrs"]))

    # shared tasks, validation coords and inner points, all drawn by JAX
    task_keys = jax.random.split(jax.random.PRNGKey(7919), 2)
    j_tasks = [j_pde.sample_params(k) for k in task_keys]
    t_tasks = [tuple(torch.tensor(np.asarray(a)) for a in tp) for tp in j_tasks]
    coords = jnp.stack([j_pde.sample_validation_points(jax.random.PRNGKey(50 + i), 256, tp)
                        for i, tp in enumerate(j_tasks)])
    val_keys = jax.random.split(jax.random.PRNGKey(0), 2)  # JAX validation's keys
    inner_pts = [j_pde.sample_points(jax.random.split(k)[0], 256, tp)
                 for k, tp in zip(val_keys, j_tasks)]

    # ground truth on each side
    j_gts = [j_fem.solve(tp, resolution=RES) for tp in j_tasks]
    j_vals = jnp.stack([jax.vmap(lambda x: j_fem.evaluate(g, x))(c)[:, None]
                        for g, c in zip(j_gts, coords)])
    t_coords = torch.tensor(np.asarray(coords))
    t_gts = [fem_poisson.solve(tp, resolution=RES) for tp in t_tasks]
    t_vals = torch.stack([fem_poisson.evaluate(g, c)[:, None] for g, c in zip(t_gts, t_coords)])
    # both solves stop inside the Newton tolerance (relative residual 8e-5 at res 8)
    np.testing.assert_allclose(t_vals.numpy(), np.asarray(j_vals), atol=1e-4)

    # k-step adaptation on shared inner points
    for tp_j, tp_t, pts, key in zip(j_tasks, t_tasks, inner_pts, val_keys):
        j_fp = jc["get_final_model"](key, j_model, tp_j, K)
        t_pts = tuple(torch.tensor(np.asarray(p)) for p in pts)
        t_fp = tc["get_final_model"](None, t_model, tp_t, K, points=t_pts)
        for a, b in zip(_np_leaves(j_fp), tree_leaves(t_fp)):
            scale = max(np.abs(a).max(), 1e-3)
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4 * scale)

    # validation metrics through each package's validation function
    j_val = j_make_validation_fn(
        j_pde, partial(jc["make_coef_func"], inner_steps=K), 2)(
        j_model, jax.tree_util.tree_map(lambda *x: jnp.stack(x), *j_tasks), coords, j_vals)
    # per point kind [T, 1, n, ...]: one set per task, as deployment draws
    t_pts = tuple(torch.tensor(np.stack([np.asarray(pts[j]) for pts in inner_pts]))[:, None]
                  for j in range(len(inner_pts[0])))
    t_coef = partial(tc["make_coef_func_batched"], inner_steps=K, points=t_pts)
    t_val = make_validation_fn(t_pde, t_coef, 2)(t_model, t_tasks, t_coords, t_vals)
    for name in ("mse", "rel_err", "rel_err_std", "rel_err_median", "rel_err_p90"):
        np.testing.assert_allclose(float(getattr(t_val, name)),
                                   float(getattr(j_val, name)), rtol=1e-3, err_msg=name)


def _small_deployment():
    """The committed checkpoint on two host-drawn tasks, 64 points each."""
    tc = maml_driver.build(parse_overrides(Config(), OVERRIDES[:2] + [
        "--task.inner_points=64", "--task.validation_points=64"]), "cpu")
    state = checkpoints.load_checkpoint(str(CKPT))
    model = (params_from_numpy(state["params"]), params_from_numpy(state["inner_lrs"]))
    gen = torch.Generator().manual_seed(3)
    tasks = [tc["pde"].sample_params(gen) for _ in range(2)]
    coords = torch.stack([tc["pde"].sample_validation_points(gen, 64, tp) for tp in tasks])
    return tc, model, tasks, coords


@pytest.mark.parametrize("k", [0, 2])
def test_validation_call_makes_one_batched_inference(k, monkeypatch):
    """One validation call is one call of the batched kernel wrapper for
    all tasks: on the shared init at k = 0, on stacked params at k >= 1."""
    tc, model, tasks, coords = _small_deployment()
    calls = []
    orig = siren_fused.siren_apply_fused_batched
    monkeypatch.setattr(siren_fused, "siren_apply_fused_batched",
                        lambda p, x, cfg, shared=False:
                        calls.append((tuple(x.shape), shared)) or orig(p, x, cfg, shared))
    val_fn = make_validation_fn(
        tc["pde"], partial(tc["make_coef_func_batched"], inner_steps=k), 2)
    val = val_fn(model, tasks, coords, torch.ones(2, 64, 1))
    assert calls == [((2, 64, 2), k == 0)]
    assert torch.isfinite(val.rel_err)


@pytest.mark.parametrize("k", [0, 2])
def test_bf16_validation_call_makes_one_f32_kernel_call(k, monkeypatch):
    """Under the flagship's compute_dtype="bfloat16" the kernel gate still
    takes inference (as the JAX dispatcher, whose Pallas kernel computes in
    f32): one batched wrapper call per validation call, on f32 inputs and
    params; the adaptation before it runs the bf16 chain."""
    tc = maml_driver.build(parse_overrides(Config(), OVERRIDES[:2] + [
        "--task.inner_points=64", "--task.validation_points=64",
        "--model.compute_dtype=bfloat16"]), "cpu")
    _, model, tasks, coords = _small_deployment()
    calls = []
    orig = siren_fused.siren_apply_fused_batched
    monkeypatch.setattr(siren_fused, "siren_apply_fused_batched",
                        lambda p, x, cfg, shared=False: calls.append(
                            (x.dtype, {t.dtype for t in tree_leaves(p)}))
                        or orig(p, x, cfg, shared))
    val_fn = make_validation_fn(
        tc["pde"], partial(tc["make_coef_func_batched"], inner_steps=k), 2)
    val = val_fn(model, tasks, coords, torch.ones(2, 64, 1))
    assert calls == [(torch.float32, {torch.float32})]
    assert torch.isfinite(val.rel_err)


@pytest.mark.parametrize("k", [0, 2])
def test_batched_coefs_equal_per_task_coefs_bit_for_bit(k):
    tc, model, tasks, coords = _small_deployment()
    batched = tc["make_coef_func_batched"](
        [task_generator(i) for i in range(2)], model, tasks, coords, inner_steps=k)
    per_task = torch.stack([
        tc["make_coef_func"](task_generator(i), model, tasks[i], coords[i], inner_steps=k)
        for i in range(2)])
    assert batched.shape == (2, 64)
    assert torch.equal(batched, per_task)


def test_deploy_bench_cli_on_cpu(tmp_path):
    """The port's CLI end to end on the CPU, small: rows for every k, finite,
    written into the run dir under the port's own name, and adaptation
    lowers the error."""
    run_dir = tmp_path / "p30k_f32_s1"
    run_dir.mkdir()
    (run_dir / "checkpoint_best.pickle").write_bytes(CKPT.read_bytes())
    rows = deploy_bench.main([
        "--device=cpu", "--algo=maml", f"--train.load_model_from_expt={run_dir}",
        "--model.use_pallas_inference=true", "--solver.ground_truth_resolution=4",
        "--task.n_eval=2", "--task.validation_points=128", "--task.inner_points=128",
        "--inner-steps-list=0,2", "--checkpoint=best", "--repeats=1"])
    assert [r["inner_steps"] for r in rows] == [0, 2]
    assert all(np.isfinite(v) for r in rows for v in r.values() if isinstance(v, float))
    assert rows[1]["val_rel_err_median"] < rows[0]["val_rel_err_median"]
    assert (run_dir / "deploy_bench_torch_n2_best.jsonl").exists()
    assert rows[0]["device"] == "cpu"


def test_deploy_bench_leaves_the_jax_rows_alone(tmp_path):
    """A JAX-named deploy_bench_n2_best.jsonl in the run dir survives a port
    run byte for byte: the port writes deploy_bench_torch_n2_best.jsonl."""
    run_dir = tmp_path / "p30k_f32_s1"
    run_dir.mkdir()
    (run_dir / "checkpoint_best.pickle").write_bytes(CKPT.read_bytes())
    jax_rows = b'{"inner_steps": 0, "val_rel_err": 0.5}\n'
    (run_dir / "deploy_bench_n2_best.jsonl").write_bytes(jax_rows)
    deploy_bench.main([
        "--device=cpu", "--algo=maml", f"--train.load_model_from_expt={run_dir}",
        "--solver.ground_truth_resolution=4", "--task.n_eval=2",
        "--task.validation_points=64", "--task.inner_points=64",
        "--inner-steps-list=0", "--checkpoint=best", "--repeats=1"])
    assert (run_dir / "deploy_bench_n2_best.jsonl").read_bytes() == jax_rows
    ours = (run_dir / "deploy_bench_torch_n2_best.jsonl").read_text().splitlines()
    assert [json.loads(l)["inner_steps"] for l in ours] == [0]


def test_bf16_deploy_writes_its_own_rows(tmp_path):
    """As the JAX CLI's suffix: a bf16 bench never overwrites the f32 rows."""
    run_dir = tmp_path / "p30k_f32_s1"
    run_dir.mkdir()
    (run_dir / "checkpoint_best.pickle").write_bytes(CKPT.read_bytes())
    f32_rows = b'{"inner_steps": 0}\n'
    (run_dir / "deploy_bench_torch_n2_best.jsonl").write_bytes(f32_rows)
    rows = deploy_bench.main([
        "--device=cpu", "--algo=maml", f"--train.load_model_from_expt={run_dir}",
        "--model.compute_dtype=bfloat16", "--solver.ground_truth_resolution=4",
        "--task.n_eval=2", "--task.validation_points=64", "--task.inner_points=64",
        "--inner-steps-list=1", "--checkpoint=best", "--repeats=1"])
    assert (run_dir / "deploy_bench_torch_n2_best.jsonl").read_bytes() == f32_rows
    ours = (run_dir / "deploy_bench_torch_bfloat16_n2_best.jsonl").read_text().splitlines()
    assert [json.loads(l)["inner_steps"] for l in ours] == [1]
    assert np.isfinite(rows[0]["val_rel_err"])


def test_deploy_bench_raises_for_unported_options(tmp_path):
    base = ["--device=cpu", f"--train.load_model_from_expt={tmp_path}"]
    with pytest.raises(ValueError, match="--algo"):
        deploy_bench.main(base + ["--algo=reptile"])
    # every family of the JAX package is ported; an unknown name raises
    # ValueError, as the JAX registry does
    with pytest.raises(ValueError, match="unrecognized pde"):
        deploy_bench.main(base + ["--task.pde=heat"])
    with pytest.raises(ValueError, match="unrecognized pde"):
        deploy_bench.main(base + ["--algo=leap", "--task.pde=heat"])


LEAP_RUN = Path(__file__).resolve().parents[1] / "results_poisson_leap" / "lp2_4"
LEAP_JAX_ROWS = ("deploy_bench.jsonl", "deploy_bench_bfloat16.jsonl")


def _leap_copy(tmp_path):
    """A copy of lp2_4 (its checkpoint, config and the JAX CLI's rows)."""
    run_dir = tmp_path / "lp2_4"
    run_dir.mkdir()
    for f in ("checkpoint_step_60000.pickle", "config.json") + LEAP_JAX_ROWS:
        (run_dir / f).write_bytes((LEAP_RUN / f).read_bytes())
    return run_dir


LEAP_SMALL = ["--device=cpu", "--algo=leap", "--model.use_pallas_inference=true",
              "--solver.ground_truth_resolution=4", "--task.n_eval=2",
              "--task.validation_points=64", "--task.inner_points=64", "--repeats=1"]


def test_leap_deploy_bench_on_cpu_leaves_the_jax_rows_alone(tmp_path):
    """--algo=leap on a copy of lp2_4 at its 5x64 width: rows for every k
    in deploy_bench_torch_n2.jsonl, finite, adaptation lowers the error,
    and the JAX CLI's rows in the run dir stay byte for byte."""
    run_dir = _leap_copy(tmp_path)
    rows = deploy_bench.main(LEAP_SMALL + [f"--from_run={run_dir}", "--inner-steps-list=0,3"])
    assert [r["inner_steps"] for r in rows] == [0, 3]
    assert rows[0]["checkpoint"] == "checkpoint_step_60000.pickle"
    assert all(np.isfinite(v) for r in rows for v in r.values() if isinstance(v, float))
    assert rows[1]["val_rel_err_median"] < rows[0]["val_rel_err_median"]
    ours = (run_dir / "deploy_bench_torch_n2.jsonl").read_text().splitlines()
    assert [json.loads(l)["inner_steps"] for l in ours] == [0, 3]
    for f in LEAP_JAX_ROWS:
        assert (run_dir / f).read_bytes() == (LEAP_RUN / f).read_bytes()


@pytest.mark.parametrize("algo", ["maml", "leap"])
def test_optimizer_deploy_writes_its_own_rows(algo, tmp_path):
    """deploy.optimizer under either algo: its own file name, as the JAX
    CLI's suffix, and the protocol in every row."""
    if algo == "leap":
        run_dir, best = _leap_copy(tmp_path), ""
        args = LEAP_SMALL + [f"--from_run={run_dir}"]
    else:
        run_dir, best = tmp_path / "p30k_f32_s1", "_best"
        run_dir.mkdir()
        (run_dir / "checkpoint_best.pickle").write_bytes(CKPT.read_bytes())
        args = ["--device=cpu", "--algo=maml", f"--train.load_model_from_expt={run_dir}",
                "--checkpoint=best", "--solver.ground_truth_resolution=4", "--task.n_eval=2",
                "--task.validation_points=64", "--task.inner_points=64", "--repeats=1"]
    rows = deploy_bench.main(args + ["--deploy.optimizer=adam", "--inner-steps-list=0,2"])
    assert [r["deploy_optimizer"] for r in rows] == ["adam", "adam"]
    assert all(np.isfinite(r["val_rel_err"]) for r in rows)
    ours = (run_dir / f"deploy_bench_torch_adam_n2{best}.jsonl").read_text().splitlines()
    assert [json.loads(l)["inner_steps"] for l in ours] == [0, 2]
    assert not (run_dir / f"deploy_bench_torch_n2{best}.jsonl").exists()


def test_profile_deploy_on_cpu_reports_no_device_numbers(tmp_path):
    from metapde_tpu_torch.cli import profile_deploy

    assert profile_deploy._busy_us([(0, 2), (1, 3), (5, 6)]) == 4
    # a copy of the run dir: the ground-truth cache goes beside it
    run_dir = tmp_path / "p30k_f32_s1"
    run_dir.mkdir()
    (run_dir / "checkpoint_best.pickle").write_bytes(CKPT.read_bytes())
    rows = profile_deploy.main([
        "--device=cpu", f"--train.load_model_from_expt={run_dir}", "--checkpoint=best",
        "--task.n_eval=1", "--solver.ground_truth_resolution=2",
        "--task.validation_points=64", "--task.inner_points=64", "--inner-steps-list=0,1"])
    assert [r["k"] for r in rows] == [0, 1]
    for r in rows:
        assert r["wall_ms_per_task"] > 0
        assert r["device_busy_ms_per_task"] is None and r["device_idle_share"] is None
