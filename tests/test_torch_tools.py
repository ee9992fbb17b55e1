"""The port's host and measurement tools against the JAX package's:
cli/roofline (its FLOP count against the dot_general FLOPs of JAX's jaxpr
of the same step, its JSON line), cli/train_curves (JAX's own test cases),
cli/probe_table and cli/paper_plots on committed run artifacts, and
cli/solution_viz end to end on the CPU."""

import argparse
import glob
import json
import math
import os
from pathlib import Path

import jax
import pytest
import torch

from metapde_tpu.cli import paper_plots as j_paper_plots
from metapde_tpu.cli import probe_table as j_probe_table
from metapde_tpu.cli import roofline as j_roofline
from metapde_tpu.cli import train_curves as j_train_curves
from metapde_tpu.train import analysis as j_analysis
from metapde_tpu_torch.cli import (maml_pde, paper_plots, probe_table, roofline, solution_viz,
                                   train_curves)
from metapde_tpu_torch.train import analysis

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ROOF = dict(pde="poisson", points=64, fast_sampler=False, num_layers=2, layer_size=16,
            compute_dtype="", bsize=2, inner_steps=2, unroll=1, no_remat=False, bf16=False)


def _dot_flops(jaxpr) -> float:
    """dot_general FLOPs (2 x output size x contracted size) of a jaxpr,
    through its sub-jaxprs, scans counted `length` times, a cond by its
    largest branch."""
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            out = eqn.outvars[0].aval.shape
            total += 2.0 * math.prod(out) * math.prod(lhs[d] for d in lc)
            continue
        if eqn.primitive.name == "while":
            raise AssertionError("a while loop: its trip count is not static")
        subs = []
        for v in eqn.params.values():
            for item in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(item, jax.extend.core.ClosedJaxpr):
                    subs.append(item.jaxpr)
                elif isinstance(item, jax.extend.core.Jaxpr):
                    subs.append(item)
        if not subs:
            continue
        counts = [_dot_flops(s) for s in subs]
        flops = max(counts) if eqn.primitive.name == "cond" else sum(counts)
        total += flops * eqn.params.get("length", 1) if eqn.primitive.name == "scan" else flops
    return total


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_roofline_matmul_flops_match_the_jax_jaxpr(remat):
    cfg = dict(ROOF, no_remat=not remat)
    step, args = j_roofline.build_step(argparse.Namespace(**cfg), unroll=cfg["inner_steps"])
    want = _dot_flops(jax.make_jaxpr(lambda *a: step(*a, n_steps=1))(*args).jaxpr)
    c, state = roofline.build_step(argparse.Namespace(**cfg), torch.device("cpu"))
    got = roofline.matmul_flops_per_step(c, state)
    assert want > 0 and abs(got / want - 1.0) < 0.2, (got, want)


def test_roofline_prints_its_line_on_the_cpu(capsys):
    row = roofline.main(["--device=cpu", "--layer_size=16", "--num_layers=2", "--bsize=2",
                         "--points=32", "--inner_steps=2", "--block=1", "--blocks=1",
                         "--no_remat"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row
    assert set(row) == {"metric", "pde", "device", "nvidia_smi", "config", "steps_per_sec",
                        "ms_per_step", "matmul_gflops_per_step", "sustained_tflops"}
    assert row["device"] == "cpu" and row["steps_per_sec"] > 0
    # the MFU needs a card in PEAKS; the XLA byte counts have no counterpart
    assert "mfu_vs_bf16_peak" not in row and "mb_accessed_per_step" not in row
    assert roofline.PEAKS["NVIDIA H100 80GB HBM3"]["bf16_tflops"] == 989.4
    with pytest.raises(SystemExit):
        roofline.main(["--device=cpu", "--bf16"])


def _write_run(path, records):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "metrics.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return str(path)


T0 = 1000.0
CURVES = {  # tests/test_train_curves.py's cases
    "compile_and_gap": [{"step": i * 1000, "time": t, "val_rel_err": e} for i, (t, e) in
                        enumerate(zip([T0, T0 + 300, T0 + 310, T0 + 320, T0 + 5320, T0 + 5330],
                                      [1.0, 0.5, 0.6, 0.2, 0.1, 0.15]))],
    "duplicate_timestamps": [{"step": i * 1000, "time": 42.0, "val_rel_err": 1.0 / (i + 1)}
                             for i in range(4)],
    "short_run": [{"step": 0, "time": 5.0, "val_rel_err": 0.3}],
}


@pytest.mark.parametrize("case", sorted(CURVES))
def test_train_curves_equal_jax(tmp_path, case):
    run = _write_run(tmp_path / "run", CURVES[case])
    got = train_curves.wallclock_curve(run)
    assert got == j_train_curves.wallclock_curve(run)
    if case == "compile_and_gap":
        assert abs(got[-1][0] - 60.0) < 1e-9 and got[-1][1] == 0.1


def test_train_curves_on_committed_runs_and_figure(tmp_path):
    runs = [str(REPO / "results_poisson_maml" / f"p30k_f32_s{s}") for s in (1, 2, 3)]
    for r in runs:
        assert train_curves.wallclock_curve(r) == j_train_curves.wallclock_curve(r)
    pytest.importorskip("matplotlib")
    out = train_curves.make_figure("t", [(f"s{i}", r) for i, r in enumerate(runs)],
                                   str(tmp_path / "c.png"))
    assert os.path.getsize(out) > 0


def test_probe_table_on_the_committed_probes(capsys):
    base = str(REPO / "results_poisson_maml")
    got = probe_table.run(base, "p30k_fast_s", "p30k_f32_s", (1, 2, 3))
    want = j_probe_table.run(base, "p30k_fast_s", "p30k_f32_s", (1, 2, 3))
    assert got == want and len(got) == 3
    assert all("final_ratio_a_over_b" in r for r in got)


def test_paper_plots_curves_equal_jax(tmp_path):
    for algo in ("maml", "leap"):
        pattern = str(REPO / "results_poisson_deploy" / f"deploy_{algo}_seed_*")
        got = paper_plots._finetune_median_curve(pattern)
        assert got and got == j_paper_plots._finetune_median_curve(pattern)
        paths = sorted(glob.glob(pattern))
        assert analysis.accuracy_vs_time(paths) == j_analysis.accuracy_vs_time(paths)
    deploy = REPO / "results_poisson_maml" / "tpu_run6b"
    rows = sorted(deploy.glob("deploy_bench*.jsonl"))
    assert rows
    assert paper_plots._load_deploy(str(rows[0])) == j_paper_plots._load_deploy(str(rows[0]))
    pytest.importorskip("matplotlib")
    out = paper_plots.make_figure(
        "Poisson", str(REPO / "baselines" / "poisson"), [("MAML", str(rows[0]))],
        [("ref", 1.0, 1e-4)], str(tmp_path / "p.png"),
        finetunes=[("MAML fine-tune", str(REPO / "results_poisson_deploy" /
                                          "deploy_maml_seed_*"))])
    assert os.path.getsize(out) > 0


def test_solution_viz_end_to_end_on_the_cpu(tmp_path):
    """A tiny run, then the CLI on its checkpoint: the PNG where matplotlib
    is installed, None without it."""
    flags = ["--task.inner_points=32", "--task.outer_points=32", "--task.validation_points=32",
             "--task.n_eval=2", "--solver.ground_truth_resolution=4", "--maml.bsize=2",
             "--maml.inner_steps=2", "--model.num_layers=2", "--model.layer_size=16"]
    maml_pde.main(flags + ["--device=cpu", "--train.outer_steps=1", "--train.viz_every=0",
                           f"--train.out_dir={tmp_path}", "--train.expt_name=r"])
    out = tmp_path / "fig" / "sol.png"
    fname = solution_viz.main(flags + ["--device=cpu", f"--train.load_model_from_expt={tmp_path / 'r'}",
                                       "--inner-steps-list=0,2", f"--out={out}", "--n-tasks=2"])
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert fname is None
    else:
        assert fname == str(out) and out.stat().st_size > 0
    assert list((tmp_path / "gt_cache_torch").glob("*.npz"))
