"""The sweep runner and the readers of its runs: cli/sweep, train/analysis
and cli/time_to_ref of the port against the JAX package's, which the port
copies (it imports nothing of the JAX package).

- sweep --dry_run: the JAX package's commands with the port's module
  (metapde_tpu_torch.cli.<driver>), the flags after `--` (--device too)
  passed through, the seed-suffixed expt_name; a failed job exits 1.
- analysis and time_to_ref: the JAX package's answers, exactly, on the same
  synthetic metrics.jsonl files (pure Python on both sides).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from metapde_tpu.cli import sweep as j_sweep
from metapde_tpu.cli import time_to_ref as j_time_to_ref
from metapde_tpu.train import analysis as j_analysis
from metapde_tpu_torch.cli import sweep, time_to_ref
from metapde_tpu_torch.train import analysis

REPO = Path(__file__).resolve().parents[1]


def _dry(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("driver", ["nn_pde", "nn_pde_maml", "maml_pde"])
def test_dry_run_names_the_port_and_passes_the_device(driver, capsys):
    argv = [f"--driver={driver}", "--seeds=1,2,3", "--dry_run", "--", "--device=cpu",
            "--task.pde=poisson", "--train.expt_name=deploy"]
    ours = _dry(sweep.main, argv, capsys)
    theirs = _dry(j_sweep.main, argv, capsys)
    assert len(ours) == 3
    assert ours == [l.replace(f"metapde_tpu.cli.{driver}",
                              f"metapde_tpu_torch.cli.{driver}") for l in theirs]
    for s, line in zip((1, 2, 3), ours):
        words = line.split()
        assert words[1:3] == ["-m", f"metapde_tpu_torch.cli.{driver}"]
        assert f"--seed={s}" in words and f"--train.expt_name=deploy_seed_{s}" in words
        assert "--device=cpu" in words and "--train.expt_name=deploy" not in words


def test_default_expt_name_and_a_failed_job_exit_code(capsys):
    line = _dry(sweep.main, ["--dry_run"], capsys)[0]
    assert line.split()[2:5] == ["metapde_tpu_torch.cli.nn_pde", "--seed=0",
                                 "--train.expt_name=sweep_seed_0"]
    with pytest.raises(SystemExit) as exc:
        sweep.main(["--driver=no_such_driver", "--seeds=1,2", "--concurrency=2"])
    assert exc.value.code == 1
    assert "sweep done: 0/2 succeeded" in capsys.readouterr().out


def test_sweep_runs_as_a_module(tmp_path):
    """python -m metapde_tpu_torch.cli.sweep: the job commands it prints
    are the ones sweep.commands builds."""
    out = subprocess.run([sys.executable, "-m", "metapde_tpu_torch.cli.sweep",
                          "--driver=nn_pde_maml", "--seeds=4", "--dry_run", "--",
                          "--device=cpu"], capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == sweep.commands("nn_pde_maml", [4], ["--device=cpu"])[0]


def _write_run(path, rows):
    path.mkdir(parents=True)
    with open(path / "metrics.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write("\n")


@pytest.fixture()
def runs(tmp_path):
    """Three seeds of a deployment sweep and a two-dir continuation chain,
    with rows the readers skip (no val_rel_err, a malformed line)."""
    for s, scale in ((1, 1.0), (2, 0.5), (3, 2.0)):
        rows = [{"step": i * 5, "time": 1.0 + i, "loss": 1.0 / (i + 1),
                 "val_rel_err": scale * (0.8 if i == 0 else 1e-2 / i),
                 "step_time": 0.5 if i == 0 else 0.01 * s} for i in range(10)]
        rows.insert(3, {"step": 12, "loss": 0.3, "step_time": 0.02})
        _write_run(tmp_path / f"deploy_seed_{s}", rows)
    _write_run(tmp_path / "chain_a", [{"step": i, "val_rel_err": 1.0 / (i + 1),
                                       "step_time": 0.1} for i in range(0, 50, 10)])
    _write_run(tmp_path / "chain_b", [{"step": i, "val_rel_err": 0.5 / (i + 1),
                                       "step_time": 0.2} for i in range(30, 90, 10)])
    with open(tmp_path / "chain_b" / "metrics.jsonl", "a") as f:
        f.write("{not json\n")
    (tmp_path / "base").mkdir()
    (tmp_path / "base" / "errors_by_resolution.json").write_text(json.dumps(
        {"4": {"rel_mse": 3e-4, "time_per_solve": 0.1}}))
    return tmp_path


def test_analysis_matches_jax(runs, capsys):
    seeds = [str(runs / f"deploy_seed_{s}") for s in (1, 2, 3)]
    for p in seeds:
        assert analysis.load_run(p) == j_analysis.load_run(p)
        assert analysis.summarize(p) == j_analysis.summarize(p)
    assert analysis.accuracy_vs_time(seeds) == j_analysis.accuracy_vs_time(seeds)
    pattern = str(runs / "deploy_seed_*")
    assert analysis.sweep_summary(pattern) == j_analysis.sweep_summary(pattern)
    assert analysis.sweep_summary(pattern)["n_seeds"] == 3
    assert analysis.sweep_summary(str(runs / "nothing_*")) == {
        "pattern": str(runs / "nothing_*"), "n_seeds": 0}
    assert analysis.load_baseline(str(runs / "base")) == j_analysis.load_baseline(
        str(runs / "base"))
    assert analysis.load_baseline(str(runs)) is None
    argv = [seeds[0], pattern]
    assert _dry(analysis.main, argv, capsys) == _dry(j_analysis.main, argv, capsys)


def test_time_to_ref_matches_jax(runs, capsys):
    chain = f"{runs / 'chain_a'}+{runs / 'chain_b'}"
    for metric in ("val_rel_err", "loss"):
        assert time_to_ref.scan_chain(chain, metric) == j_time_to_ref.scan_chain(chain, metric)
    globbed = str(runs / "deploy_seed_*")
    assert time_to_ref.scan_chain(globbed, "val_rel_err") == j_time_to_ref.scan_chain(
        globbed, "val_rel_err")
    rows = time_to_ref.scan_chain(chain, "val_rel_err")
    for target in (1e-1, 1e-2, 1e-9):
        assert time_to_ref.time_to_target(rows, target) == j_time_to_ref.time_to_target(
            rows, target)
    for secs in (None, 30.0, 600.0, 20000.0):
        assert time_to_ref.fmt_h(secs) == j_time_to_ref.fmt_h(secs)
    argv = ["--json", f"--row=chain:{chain}:1e-2:note", f"--row=missing:{runs / 'x'}:1e-2"]
    assert _dry(time_to_ref.main, argv, capsys) == _dry(j_time_to_ref.main, argv, capsys)
    md = _dry(time_to_ref.main, argv[1:], capsys)
    assert len(md) == 4 and "no metrics found" in md[3]


def test_time_to_ref_has_no_default_table(capsys):
    with pytest.raises(SystemExit):
        time_to_ref.main([])
    assert not hasattr(time_to_ref, "DEFAULT_ROWS")
