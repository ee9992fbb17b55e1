"""Sharded training through the entry points, on gloo ranks on the CPU:
the launcher (python -m torch.distributed.run) with cli/maml_pde and
cli/leap_pde, cli/distributed_smoke, and cli/nn_pde, which ignores the
mesh as the JAX driver does.

- cli/maml_pde on 2 ranks (dp = 2), 3 outer steps, then a resume to 4 on
  2 ranks, against the same runs in one process: one set of the JAX run's
  files (rank 0 alone writes), the same metrics.jsonl steps, meta_loss and
  val_rel_err within rtol 1e-4, the final params within 1e-4 of each
  leaf's scale; the JAX package reads the sharded run's checkpoint.
- cli/leap_pde on 2 ranks (pt = 2) against one process, the same bars.
- cli/distributed_smoke --device=cpu (a 2 x 2 mesh and the one-process
  reference, gloo) exits 0 with ok.
- cli/nn_pde with --mesh.n_task_shards=2 writes the metrics of the run
  without it.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu_torch.cli import leap_pde, maml_pde, nn_pde
from metapde_tpu_torch.train import checkpoints
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
COMMON = ["--task.inner_points=32", "--task.validation_points=32", "--task.n_eval=2",
          "--solver.ground_truth_resolution=4", "--model.num_layers=2",
          "--model.layer_size=16", "--train.viz_every=0", "--train.log_every=1",
          "--train.checkpoint_every=2", "--device=cpu"]
MAML = COMMON + ["--task.outer_points=32", "--maml.bsize=2", "--maml.inner_steps=2"]
LEAP = COMMON + ["--leap.bsize=2", "--leap.inner_steps=2"]
# "tb": the TensorBoard mirror of metrics.jsonl (train/metrics.py), as the JAX run writes it
RUN_FILES = {"log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle", "tb"}
TIMEOUT = 240


def _spawn(cmd):
    return subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _finish(proc):
    """Wait for proc; at the deadline SIGTERM its group (the launcher ends
    its workers on SIGTERM), then SIGKILL."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        finally:
            os.killpg(proc.pid, signal.SIGKILL)
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


def _launch(entry, flags):
    return _spawn([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node=2", "-m", f"metapde_tpu_torch.cli.{entry}", *flags])


def _records(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def _run_flags(out, expt, steps, *extra):
    return [f"--train.out_dir={out}", f"--train.expt_name={expt}",
            f"--train.outer_steps={steps}", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    smoke = _spawn([sys.executable, "-m", "metapde_tpu_torch.cli.distributed_smoke",
                    "--device=cpu", "--maml.bsize=4", "--timed_steps=1"])
    maml_run = _launch("maml_pde", MAML + ["--mesh.n_task_shards=2"]
                       + _run_flags(tmp / "sharded", "m", 3))
    leap_run = _launch("leap_pde", LEAP + ["--mesh.n_point_shards=2"]
                       + _run_flags(tmp / "sharded", "l", 3))
    # the same runs in this process meanwhile
    maml_pde.main(MAML + _run_flags(tmp / "one", "m", 3))
    leap_pde.main(LEAP + _run_flags(tmp / "one", "l", 3))
    _finish(maml_run)
    resumed = _launch("maml_pde", MAML + ["--mesh.n_task_shards=2"] + _run_flags(
        tmp / "sharded", "r", 4, f"--train.load_model_from_expt={tmp / 'sharded' / 'm'}"))
    maml_pde.main(MAML + _run_flags(tmp / "one", "r", 4,
                                    f"--train.load_model_from_expt={tmp / 'one' / 'm'}"))
    _finish(resumed)
    _finish(leap_run)
    smoke_out = _finish(smoke)
    return {"tmp": tmp, "smoke": json.loads(smoke_out.strip().splitlines()[-1])}


@pytest.mark.parametrize("expt,last", [("m", 3), ("r", 4), ("l", 3)])
def test_sharded_cli_run_equals_the_one_process_run(runs, expt, last):
    sharded, one = runs["tmp"] / "sharded" / expt, runs["tmp"] / "one" / expt
    recs, ref = _records(sharded), _records(one)
    assert [r["step"] for r in recs] == [r["step"] for r in ref]
    for a, b in zip(recs, ref):
        for k in ("meta_loss", "val_rel_err"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4)
    final = f"checkpoint_step_{last}.pickle"
    got, want = (checkpoints.load_checkpoint(str(d / final)) for d in (sharded, one))
    for x, y in zip(tree_leaves(got["params"]), tree_leaves(want["params"])):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-4 * max(np.abs(y).max(), 1e-3))


@pytest.mark.parametrize("expt,mesh", [("m", "{'dp': 2, 'pt': 1}"), ("l", "{'dp': 1, 'pt': 2}"),
                                       ("r", "{'dp': 2, 'pt': 1}")])
def test_rank_zero_alone_writes_the_run_files(runs, expt, mesh):
    run = runs["tmp"] / "sharded" / expt
    names = {p.name for p in run.iterdir()}
    assert RUN_FILES <= names
    assert {n for n in names - RUN_FILES if not n.startswith("checkpoint_step_")} == set()
    log = (run / "log.txt").read_text()
    assert log.count("mesh: ") == 1 and f"mesh: {mesh} (dp x pt), backend gloo" in log
    assert log.count("ground truth at resolution 4") == 1
    if expt == "r":
        assert "resuming optimizer state at step 3" in log


def test_the_jax_package_reads_the_sharded_checkpoint(runs):
    fname = str(runs["tmp"] / "sharded" / "m" / "checkpoint_step_3.pickle")
    state = j_ckpt.load_checkpoint(fname)
    ours = checkpoints.load_checkpoint(fname)
    for part in ("params", "inner_lrs"):
        a, b = tree_leaves(state[part]), tree_leaves(ours[part])
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_distributed_smoke_agrees_on_the_cpu(runs):
    line = runs["smoke"]
    assert line["ok"], line
    (row,) = line["meshes"]
    assert row["mesh"] == "2x2" and row["rank0"]["backend"] == "gloo"
    assert row["meta_grad_leaf_err"] <= 1e-4 and row["rank0"]["collectives_per_step"]["calls"]


def test_nn_pde_ignores_the_mesh(tmp_path):
    """The JAX nn_driver never reads cfg.mesh: a mesh flag trains as without."""
    flags = ["--device=cpu", "--model.num_layers=2", "--model.layer_size=16",
             "--maml.bsize=2", "--task.inner_points=32", "--task.validation_points=32",
             "--solver.ground_truth_resolution=4", "--train.outer_steps=3",
             "--train.log_every=1", "--train.viz_every=0", f"--train.out_dir={tmp_path}"]
    nn_pde.main(flags + ["--train.expt_name=plain"])
    nn_pde.main(flags + ["--train.expt_name=mesh", "--mesh.n_task_shards=2",
                         "--mesh.n_point_shards=2"])
    a, b = _records(tmp_path / "plain"), _records(tmp_path / "mesh")
    assert [r["step"] for r in a] == [r["step"] for r in b]
    for x, y in zip(a, b):
        assert x["val_rel_err"] == y["val_rel_err"]
