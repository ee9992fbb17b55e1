"""The port's solution plots (train/viz.py), train.viz_every and
train.profile_dir in the training loop (train/loop.py), against the JAX
package: the block boundaries of each driver, the panels' values on shared
tasks, model and inner points, and the plot files a run writes."""

import dataclasses
import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.solvers import fem_poisson as j_fem
from metapde_tpu.train import maml_driver as j_driver
from metapde_tpu.train import viz as j_viz
from metapde_tpu_torch.cli import leap_pde, maml_pde
from metapde_tpu_torch.config import Config, load_run_config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.solvers import fem_poisson, fv_burgers
from metapde_tpu_torch.train import loop, maml_driver, viz

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TINY = ["--task.inner_points=32", "--task.outer_points=32", "--task.validation_points=32",
        "--task.n_eval=2", "--solver.ground_truth_resolution=4", "--maml.bsize=2",
        "--maml.inner_steps=2", "--model.num_layers=2", "--model.layer_size=16",
        "--train.log_every=1"]


def _have_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _jax_blocks(train, spc, resume, plots):
    """The block sizes of the JAX drivers' loops, transcribed: the MAML
    driver's _next_boundary (maml_driver.py:411-419) ends a block at
    log/viz/checkpoint boundaries, the LEAP driver's (leap_driver.py:290-296)
    at log/checkpoint ones."""
    everies = ((train.log_every, train.viz_every, train.checkpoint_every) if plots
               else (train.log_every, train.checkpoint_every))

    def _next_boundary(step):
        n = train.outer_steps - step
        for every in everies:
            if every and every > 0:
                n = min(n, every - step % every)
        return max(1, min(n, spc))

    out, step = [], resume
    while step < train.outer_steps:
        block = _next_boundary(step) if spc > 1 else 1
        out.append(block)
        step += block
    return out


def _port_blocks(cfg, resume, plots):
    out, step = [], resume
    everies = loop.boundaries(cfg, plots)
    while step < cfg.train.outer_steps:
        block = loop.next_block(cfg, step, everies)
        out.append(block)
        step += block
    return out


@pytest.mark.parametrize("plots", [True, False], ids=["maml", "leap"])
def test_block_sequences_equal_the_jax_drivers(plots):
    grid = itertools.product((1, 2, 3, 5, 10), (0, 1, 3, 7), (0, 2, 5, 10_000), (0, 4, 10),
                             (1, 7, 23), (0, 3, 10))
    n = 0
    for spc, log_every, viz_every, ckpt_every, outer, resume in grid:
        cfg = Config()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, steps_per_call=spc, log_every=log_every, viz_every=viz_every,
            checkpoint_every=ckpt_every, outer_steps=outer))
        assert _port_blocks(cfg, resume, plots) == _jax_blocks(cfg.train, spc, resume, plots)
        n += 1
    assert n == 5 * 4 * 4 * 3 * 3 * 3


def test_trace_covers_iterations_1_to_profile_steps(tmp_path):
    """profile_dir: the trace starts at the top of iteration 1 (0 is the
    warm-up) and stops at the top of iteration 1 + profile_steps."""
    logged = []
    trace = loop.Trace(str(tmp_path), 2, torch.device("cpu"), logged.append)
    for it in range(5):
        trace.iteration()
        with torch.profiler.record_function(f"iteration_{it}"):
            torch.ones(8).sum()
    trace.stop()
    names = {e["name"] for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {n for n in names if n.startswith("iteration_")} == {"iteration_1", "iteration_2"}
    assert {n for n in names if n.startswith("loop_iteration_")} == {
        "loop_iteration_1", "loop_iteration_2"}
    assert logged == [f"wrote profiler trace to {tmp_path}"]
    # training that ends inside the window stops the trace at the end
    trace = loop.Trace(str(tmp_path / "short"), 5, torch.device("cpu"), logged.append)
    for _ in range(3):
        trace.iteration()
    trace.stop()
    assert (tmp_path / "short" / "trace.json").exists() and len(logged) == 1


def test_trace_shows_the_program_s_spans_in_each_iteration(tmp_path):
    """profile_dir turns the recorder on for the traced iterations, and its
    spans enter the trace nested in their loop iteration."""
    cfg = parse_overrides(Config(), [
        "--task.pde=poisson3d", "--task.inner_points=64", "--task.outer_points=64",
        "--task.validation_points=64", "--task.n_eval=2", "--model.num_layers=2",
        "--model.layer_size=16", "--maml.bsize=2", "--maml.inner_steps=2",
        "--train.outer_steps=3", "--train.log_every=10", "--train.viz_every=0",
        f"--train.out_dir={tmp_path}", "--train.expt_name=r",
        f"--train.profile_dir={tmp_path / 'prof'}", "--train.profile_steps=1"])
    maml_driver.run(cfg, "cpu")
    events = [e for e in json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    it = [e for e in events if e["name"].startswith("loop_iteration_")]
    assert [e["name"] for e in it] == ["loop_iteration_1"]
    lo, hi = it[0]["ts"], it[0]["ts"] + it[0]["dur"]
    for name in ("draw.sample", "maml.meta_backward", "outer_update"):
        found = [e for e in events if e["name"] == name]
        assert len(found) == 1, name
        assert lo <= found[0]["ts"] and found[0]["ts"] + found[0]["dur"] <= hi, name


def _jax_model_and_port(overrides):
    jc = j_driver.build(j_parse_overrides(JConfig(), overrides))
    tc = maml_driver.build(parse_overrides(Config(), overrides), "cpu")
    j_model = (jc["init_params"], jc["inner_lrs"])
    t_model = tuple(params_from_numpy(jax.tree_util.tree_map(np.asarray, m)) for m in j_model)
    return jc, tc, j_model, t_model


def _adapt(tc, t_model, inner_pts):
    """The port's adaptation of task i on the inner points JAX's
    get_final_model(PRNGKey(0), ...) draws."""
    def adapt(i, task_params, k):
        pts = tuple(torch.tensor(np.asarray(p)) for p in inner_pts[i])
        return tc["get_final_model"](None, t_model, task_params, k, points=pts)
    return adapt


def test_poisson_panels_equal_jax():
    overrides = ["--task.inner_points=64", "--model.num_layers=2", "--model.layer_size=32"]
    jc, tc, j_model, t_model = _jax_model_and_port(overrides)
    j_pde = jc["pde"]
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    j_tasks = [j_pde.sample_params(k) for k in keys]
    j_gts = [j_fem.solve(tp, resolution=8) for tp in j_tasks]
    t_tasks = [tuple(torch.tensor(np.asarray(a)) for a in tp) for tp in j_tasks]
    t_gts = [fem_poisson.PoissonGroundTruth(*(torch.tensor(np.asarray(f)) for f in g))
             for g in j_gts]
    k1 = jax.random.split(jax.random.PRNGKey(0))[0]
    inner_pts = [j_pde.sample_points(k1, 64, tp) for tp in j_tasks]
    xx, yy, truth, values = viz.solution_panels(
        tc["pde"], t_gts, t_tasks, _adapt(tc, t_model, inner_pts), tc["field"].apply,
        inner_steps_list=(0, 2), n_tasks=2)
    for i, (tp, gt) in enumerate(zip(j_tasks, j_gts)):
        pts, j_truth, j_xx, _ = j_viz._eval_grid_2d(j_pde, tp, gt)
        np.testing.assert_allclose(xx, j_xx)
        np.testing.assert_allclose(truth[i].numpy(), j_truth, atol=1e-5)
        for k in (0, 2):
            final = jc["get_final_model"](jax.random.PRNGKey(0), j_model, tp, k)
            want = np.asarray(jc["field"].apply(final, pts))
            tol = 1e-5 if k == 0 else 1e-4 * np.abs(want).max()
            np.testing.assert_allclose(values[k][i].numpy(), want, atol=tol)


def test_burgers_panels_equal_jax(tmp_path):
    overrides = ["--task.pde=td_burgers", "--task.num_tsteps=11", "--task.inner_points=64",
                 "--solver.ground_truth_resolution=32", "--model.num_layers=2",
                 "--model.layer_size=16"]
    jc, tc, j_model, t_model = _jax_model_and_port(overrides)
    j_pde = jc["pde"]
    tp = j_pde.sample_params(jax.random.PRNGKey(5))
    gt = j_pde.solve(tp, resolution=32)
    t_tp = tuple(torch.tensor(np.asarray(a)) for a in tp)
    t_gt = fv_burgers.BurgersGroundTruth(*(torch.tensor(np.asarray(f)) for f in gt))
    k1 = jax.random.split(jax.random.PRNGKey(0))[0]
    inner_pts = [j_pde.sample_points(k1, 64, tp)]
    adapt = _adapt(tc, t_model, inner_pts)
    # plot_burgers_time_series' values, as the JAX function computes them
    xs = np.linspace(float(gt.x_grid[0]), float(gt.x_grid[-1]), 128)
    xx, tt = np.meshgrid(xs, np.asarray(gt.t_grid))
    pts = jnp.asarray(np.stack([xx.reshape(-1), tt.reshape(-1)], 1), jnp.float32)
    j_truth = np.asarray(jax.vmap(lambda x: j_pde.evaluate_gt(gt, x))(pts)).reshape(xx.shape)
    for k in (0, 2):
        t_xx, t_tt, truth, vals = viz.burgers_panels(tc["pde"], t_gt, t_tp, adapt, k,
                                                     tc["field"].apply)
        np.testing.assert_allclose(t_xx, xx)
        np.testing.assert_allclose(t_tt, tt)
        np.testing.assert_allclose(truth.numpy(), j_truth, atol=1e-5)
        final = jc["get_final_model"](jax.random.PRNGKey(0), j_model, tp, k)
        want = np.asarray(jc["field"].apply(final, pts)).reshape(xx.shape)
        tol = 1e-5 if k == 0 else 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(vals.numpy(), want, atol=tol)
    # the drawings: the JAX file names, nothing without matplotlib (or PIL)
    args = (tc["pde"], t_gt, t_tp, adapt, 2, tc["field"].apply)
    png = viz.plot_burgers_time_series(str(tmp_path), *args, step=7)
    gif = viz.plot_burgers_time_series_gif(str(tmp_path), *args, step=7, frame_stride=5)
    if _have_matplotlib():
        assert png == f"{tmp_path}/viz_ts_step_7.png" and gif == f"{tmp_path}/viz_ts_step_7.gif"
        assert (tmp_path / "viz_ts_step_7.gif").stat().st_size > 0
    else:
        assert png is None and gif is None


def test_maml_run_writes_the_jax_runs_viz_files(tmp_path):
    """viz_every = 1 on a 3-step run in blocks of 2: both drivers render at
    the same steps, under the same names (nothing without matplotlib)."""
    args = TINY + ["--train.outer_steps=3", "--train.steps_per_call=2",
                   "--train.viz_every=1", "--train.checkpoint_every=0"]
    j_driver.run(j_parse_overrides(JConfig(), args + [f"--train.out_dir={tmp_path}",
                                                      "--train.expt_name=jax"]))
    maml_pde.main(args + ["--device=cpu", f"--train.out_dir={tmp_path}",
                          "--train.expt_name=port"])
    names = lambda d: sorted(p.name for p in (tmp_path / d).glob("viz*"))
    assert names("port") == names("jax")
    if _have_matplotlib():
        assert names("port") == ["viz_step_0.png", "viz_step_1.png", "viz_step_2.png"]


def test_default_viz_every_and_lp2_4_config_run(tmp_path):
    """The port's default viz_every (10,000) and expt_name, and lp2_4's own
    config.json (viz_every 10,000) cut to a tiny width, run to the end
    through the CLIs (they raised NotImplementedError before)."""
    assert Config().train.viz_every == 10_000 and Config().train.expt_name == "default"
    maml_pde.main(TINY[:-1] + ["--device=cpu", "--train.outer_steps=2",
                               f"--train.out_dir={tmp_path}"])
    assert (tmp_path / "default" / "checkpoint_step_2.pickle").exists()
    run = REPO / "results_poisson_leap" / "lp2_4"
    assert load_run_config(str(run)).train.viz_every == 10_000
    leap_pde.main(["--device=cpu", f"--from_run={run}", "--train.load_model_from_expt=null",
                   "--train.outer_steps=2",
                   "--train.log_every=1", "--leap.bsize=2", "--leap.inner_steps=2",
                   "--model.num_layers=2", "--model.layer_size=16",
                   "--task.inner_points=32", "--task.validation_points=32", "--task.n_eval=1",
                   "--solver.ground_truth_resolution=4", f"--train.out_dir={tmp_path}",
                   "--train.expt_name=lp"])
    assert (tmp_path / "lp" / "checkpoint_step_2.pickle").exists()
