"""The port's meta-training loop (train/maml_driver.run, cli/maml_pde,
cli/train_bench) on the CPU at a tiny size, and the files it writes, read
by the JAX package.

- run() writes log.txt, metrics.jsonl (the JAX run()'s key set),
  config.json, checkpoint_best.pickle and periodic and final checkpoints;
  a checkpoint holds the JAX-read keys with the JAX layout and none of the
  keys only the JAX package writes.
- The JAX package's load_checkpoint and deploy_bench --checkpoint=best read
  the port's checkpoint; the JAX run() resumes from the port's run dir.
- 2 + 2 steps with a resume equal 4 uninterrupted steps bit for bit.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from metapde_tpu_torch.cli import maml_pde, train_bench
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.train import checkpoints, maml_driver
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(2)

TINY = ["--task.inner_points=32", "--task.outer_points=32", "--task.validation_points=32",
        "--task.n_eval=2", "--solver.ground_truth_resolution=4", "--maml.bsize=2",
        "--maml.inner_steps=2", "--model.num_layers=2", "--model.layer_size=16",
        "--train.viz_every=0", "--train.log_every=1", "--train.checkpoint_every=2"]
FILES = ("log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle")


def _cfg(tmp_path, expt, steps, *extra):
    return parse_overrides(Config(), TINY + [
        f"--train.outer_steps={steps}", f"--train.out_dir={tmp_path}",
        f"--train.expt_name={expt}", *extra])


def _records_of(fname):
    return [json.loads(l) for l in fname.read_text().splitlines()]


def _records(run_dir):
    return _records_of(run_dir / "metrics.jsonl")


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """One port run of 4 outer steps in blocks of 2 (the default)."""
    tmp = tmp_path_factory.mktemp("port")
    maml_driver.run(_cfg(tmp, "a", 4, "--train.steps_per_call=2", "--train.log_every=2"),
                     device="cpu")
    return tmp / "a"


def test_run_writes_the_jax_run_files(port_run):
    for f in FILES + ("checkpoint_step_1.pickle", "checkpoint_step_3.pickle",
                      "checkpoint_step_4.pickle"):
        assert (port_run / f).exists(), f
    recs = _records(port_run)
    assert [r["step"] for r in recs] == [1, 3]
    for r in recs:
        assert np.isfinite([r["meta_loss"], r["val_meta_loss"], r["val_rel_err"]]).all()
    with open(port_run / "checkpoint_step_4.pickle", "rb") as f:
        state = pickle.load(f)  # plain pickle: nothing of torch or the port
    assert not set(checkpoints.JAX_ONLY_KEYS) & set(state)
    assert state["step"] == 4 and state["torch_next_step"] == 4
    assert isinstance(state["step"], int)
    init = maml_driver.build(_cfg(port_run, "x", 1), "cpu")["init_params"]
    assert [(l.dtype, l.shape) for l in tree_leaves(state["params"])] == [
        (np.dtype("float32"), tuple(t.shape)) for t in tree_leaves(init)]
    assert all(l.shape[0] == 2 for l in tree_leaves(state["inner_lrs"]))
    best = checkpoints.load_checkpoint(str(port_run / "checkpoint_best.pickle"))
    assert np.isfinite(best["best_metric"]) and best["step"] in (1, 3)


def test_jax_package_reads_and_resumes_the_port_run(port_run, tmp_path):
    """load_checkpoint and deploy_bench --checkpoint=best of the JAX package
    read the port's checkpoints; the JAX run() resumes from the port's run
    dir for one step, and its metrics.jsonl has the port's key set."""
    from metapde_tpu.cli import deploy_bench as j_deploy_bench
    from metapde_tpu.config import Config as JConfig
    from metapde_tpu.config import parse_overrides as j_parse_overrides
    from metapde_tpu.train import checkpoints as j_ckpt
    from metapde_tpu.train import maml_driver as j_driver

    state = j_ckpt.load_checkpoint(j_ckpt.latest_checkpoint(str(port_run)))
    assert state["step"] == 4
    j_deploy_bench.main([
        "--algo=maml", f"--train.load_model_from_expt={port_run}", "--checkpoint=best",
        "--inner-steps-list=0,1", "--repeats=1", *TINY])
    rows = _records_of(port_run / "deploy_bench_n2_best.jsonl")
    assert [r["inner_steps"] for r in rows] == [0, 1]
    assert rows[0]["checkpoint"] == "checkpoint_best.pickle"
    assert all(np.isfinite(r["val_rel_err"]) for r in rows)
    j_cfg = j_parse_overrides(JConfig(), TINY + [
        "--train.outer_steps=1", f"--train.out_dir={tmp_path}", "--train.expt_name=j",
        f"--train.load_model_from_expt={port_run}"])
    j_driver.run(j_cfg)
    text = (tmp_path / "j" / "log.txt").read_text()
    assert "loaded checkpoint" in text
    j_recs = _records(tmp_path / "j")
    assert j_recs and sorted(j_recs[0]) == sorted(_records(port_run)[0])


def test_two_plus_two_steps_with_a_resume_equal_four_steps(tmp_path):
    """Optimizer states, the training generator and the eval tasks ride in
    the checkpoint, so a resumed run continues the same trajectory."""
    p4, l4 = maml_driver.run(_cfg(tmp_path, "whole", 4), device="cpu")
    maml_driver.run(_cfg(tmp_path, "first", 2), device="cpu")
    p, l = maml_driver.run(_cfg(tmp_path, "second", 4,
                                f"--train.load_model_from_expt={tmp_path / 'first'}"),
                           device="cpu")
    for a, b in zip(tree_leaves((p, l)), tree_leaves((p4, l4))):
        assert torch.equal(a, b)
    text = (tmp_path / "second" / "log.txt").read_text()
    assert "resuming optimizer state at step 2" in text
    whole, second = _records(tmp_path / "whole"), _records(tmp_path / "second")
    assert [r["step"] for r in second] == [2, 3]
    for a, b in zip(whole[2:], second):
        assert a["val_rel_err"] == b["val_rel_err"] and a["meta_loss"] == b["meta_loss"]


def test_resume_from_the_jax_30k_checkpoint_restores_its_optimizer_states(tmp_path):
    """A JAX run dir: params, inner LRs and Adam states carry over, and the
    step count continues from the JAX checkpoint's."""
    from pathlib import Path

    run_dir = Path(__file__).resolve().parents[1] / "results_poisson_maml" / "p30k_f32_s1"
    cfg = parse_overrides(Config(), [
        f"--from_run={run_dir}", "--train.outer_steps=30003", "--train.log_every=1",
        "--train.val_every=0",
        "--maml.bsize=1", "--task.inner_points=32", "--task.outer_points=32",
        "--task.validation_points=32", "--task.n_eval=1",
        "--solver.ground_truth_resolution=4", f"--train.out_dir={tmp_path}",
        "--train.expt_name=r"])
    maml_driver.run(cfg, device="cpu")
    text = (tmp_path / "r" / "log.txt").read_text()
    assert "resuming optimizer state at step 30002" in text
    assert [r["step"] for r in _records(tmp_path / "r")] == [30002]
    state = checkpoints.load_checkpoint(str(tmp_path / "r" / "checkpoint_step_30003.pickle"))
    assert int(state["torch_opt_state"]["count"]) == 30002  # one step after 30001


def test_cli_trains_on_the_cpu_and_refuses_unported_options(tmp_path):
    base = TINY + [f"--train.out_dir={tmp_path}", "--device=cpu"]
    maml_pde.main(base + ["--train.outer_steps=2", "--train.expt_name=cli"])
    assert all((tmp_path / "cli" / f).exists() for f in FILES)
    # viz_every and profile_dir, which the port once refused, now run as the
    # JAX MAML driver runs them: plots at the viz boundaries, a trace of
    # loop iterations 1 .. profile_steps
    maml_pde.main(base + ["--train.outer_steps=3", "--train.expt_name=viz",
                          "--train.viz_every=2", f"--train.profile_dir={tmp_path / 'prof'}",
                          "--train.profile_steps=1"])
    assert (tmp_path / "prof" / "trace.json").exists()
    assert "wrote profiler trace" in (tmp_path / "viz" / "log.txt").read_text()
    pngs = sorted(p.name for p in (tmp_path / "viz").glob("viz_step_*.png"))
    assert pngs == (["viz_step_0.png", "viz_step_2.png"] if _have_matplotlib() else [])
    # every family is ported; an unknown name raises as the JAX registry does
    with pytest.raises(ValueError, match="unrecognized pde"):
        maml_pde.main(base + ["--train.outer_steps=1", "--train.expt_name=bad",
                              "--task.pde=heat"])


def _have_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def test_train_bench_prints_its_line_on_the_cpu(capsys):
    row = train_bench.main(["--device=cpu", "--block=2", "--blocks=1", "--maml.bsize=2",
                            "--maml.inner_steps=2", "--task.inner_points=32",
                            "--task.outer_points=32", "--model.num_layers=2",
                            "--model.layer_size=16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == row
    assert row["outer_steps_per_s"] > 0 and row["draw_s_per_step"] > 0
    assert row["residual_pt_evals_per_s"] == pytest.approx(
        row["outer_steps_per_s"] * 2 * (2 * 32 + 3 * 32))
    # no card: the device columns are not measured
    assert row["device_busy_ms_per_step"] is None and row["kernels_per_step"] is None
    # bench.py's flagship is bf16; the CPU has no bf16 GEMM with an f32 output
    assert row["config"]["compute_dtype"] == "bfloat16" and row["config"]["remat"] is False
    assert row["bf16_gemm"] == "upcast" and row["bf16_gemm_support"]["kernel"] is not True


def test_train_bench_times_the_f32_variant_on_request(capsys):
    row = train_bench.main(["--device=cpu", "--block=1", "--blocks=1", "--maml.bsize=2",
                            "--maml.inner_steps=1", "--task.inner_points=16",
                            "--task.outer_points=16", "--model.num_layers=2",
                            "--model.layer_size=8", "--model.compute_dtype=null"])
    assert row["config"]["compute_dtype"] is None
    assert row["bf16_gemm"] is None and row["bf16_gemm_support"] is None
    assert row["outer_steps_per_s"] > 0
