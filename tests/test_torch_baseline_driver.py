"""The classical-solver sweep: metapde_tpu.train.baseline_driver and
metapde_tpu.cli.gt_convergence against the port's, on shared inputs.

The JAX sweep's tasks and validation coords are recomputed from its key
chain (PRNGKey(seed) -> key, gt_key, pts_key; the tasks from
split(gt_key, n_eval), the coords from split(pts_key, n_eval)) and handed
to the port's `sweep`, which solves them with its own P1 solver against
its own float64 reference at resolution 8. gt_convergence's tasks are
split(PRNGKey(seed), n_tasks) and task i's points PRNGKey(1000 + i); the
port's run gets them through its family's samplers.

Bar: rel_mse per resolution rtol 1e-3. Both sides solve in f32 to
Newton tolerances that scale with the grid, so their solutions differ by
~1e-6 of the field, three orders below the discretization error that
rel_mse measures at resolutions 2 and 4; the references agree to float64
rounding.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from metapde_tpu.cli import gt_convergence as j_gt_convergence
from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.train import baseline_driver as j_baseline
from metapde_tpu_torch.cli import gt_convergence, solver_baseline
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.train import baseline_driver

torch.set_num_threads(2)

SMALL = ["--task.pde=poisson", "--task.n_eval=2", "--task.validation_points=256",
         "--solver.ground_truth_resolution=8"]
RTOL = 1e-3


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def jax_sweep(tmp_path_factory):
    """The JAX sweep's results and its tasks and coords, replayed."""
    tmp = tmp_path_factory.mktemp("jax")
    cfg = j_parse_overrides(JConfig(), SMALL + [f"--train.out_dir={tmp}",
                                                "--train.expt_name=sweep"])
    results = j_baseline.run(cfg, spatial_resolutions=(2, 4, 8))
    pde = j_get_pde(cfg.task)
    _, gt_key, pts_key = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    tasks = [pde.sample_params(k) for k in jax.random.split(gt_key, cfg.task.n_eval)]
    coords = [pde.sample_validation_points(k, cfg.task.validation_points, tp, None)
              for k, tp in zip(jax.random.split(pts_key, cfg.task.n_eval), tasks)]
    return dict(results=results, tasks=[tuple(_t(a) for a in tp) for tp in tasks],
                coords=[_t(c) for c in coords])


def test_sweep_matches_the_jax_sweep_on_its_tasks(jax_sweep):
    pde = get_pde(parse_overrides(Config(), SMALL).task)
    tasks, coords = jax_sweep["tasks"], jax_sweep["coords"]
    ref_vals = [baseline_driver._values(pde, pde.solve_ref(tp, resolution=8), c)
                for tp, c in zip(tasks, coords)]
    ours = baseline_driver.sweep(pde, tasks, coords, ref_vals, (2, 4, 8), 8)
    theirs = jax_sweep["results"]
    # resolutions at or above the reference's are skipped
    assert set(ours) == set(theirs) == {"2", "4"}
    for res in ("2", "4"):
        assert set(ours[res]) == set(theirs[res])
        np.testing.assert_allclose(ours[res]["rel_mse"], theirs[res]["rel_mse"], rtol=RTOL)
        np.testing.assert_allclose(ours[res]["rel_mse_median"], theirs[res]["rel_mse_median"],
                                   rtol=RTOL)
        assert ours[res]["time_per_solve"] > 0
    assert ours["4"]["rel_mse"] < ours["2"]["rel_mse"]


def test_cli_writes_errors_by_resolution(tmp_path):
    rows = solver_baseline.main(["--device=cpu", "--task.pde=poisson", "--task.n_eval=1",
                                 "--task.validation_points=64",
                                 "--solver.ground_truth_resolution=4", "--resolutions=2,4,8",
                                 f"--train.out_dir={tmp_path}", "--train.expt_name=cli"])
    assert set(rows) == {"2"}
    saved = json.loads((tmp_path / "cli" / "errors_by_resolution.json").read_text())
    assert saved == rows
    log = (tmp_path / "cli" / "log.txt").read_text()
    assert "reference solves at resolution 4 (x64 path)" in log


def test_richardson_needs_solve_hi(tmp_path):
    cfg = parse_overrides(Config(), ["--task.pde=td_burgers", f"--train.out_dir={tmp_path}",
                                     "--train.expt_name=x"])
    with pytest.raises(SystemExit):
        baseline_driver.run(cfg, spatial_resolutions=(4,), oracle="richardson", device="cpu")
    with pytest.raises(SystemExit):
        gt_convergence.run(cfg, [4], 8, n_tasks=1, oracle="richardson", device="cpu")
    poisson = baseline_driver.oracle_pde(get_pde(Config().task), "richardson", "poisson")
    assert poisson.solve_ref is poisson.solve_hi is poisson.solve


def test_td_burgers_time_axis_labels():
    """axis2=("num_tsteps", ...) reaches the solve as a keyword; each label
    and entry carries its value, as the JAX sweep writes them."""
    cfg = parse_overrides(Config(), ["--task.pde=td_burgers", "--task.num_tsteps=9",
                                     "--task.domain.xmin=0.0"])
    pde = get_pde(cfg.task)
    gen = torch.Generator().manual_seed(0)
    tasks = [pde.sample_params(gen)]
    coords, ref_vals = baseline_driver.reference(pde, tasks, gen, 63, 64)
    rows = baseline_driver.sweep(pde, tasks, coords, ref_vals, (16, 64),
                                 64, axis2=("num_tsteps", (5, 9)))
    assert sorted(rows) == ["16,num_tsteps=5", "16,num_tsteps=9"]
    assert [rows[k]["num_tsteps"] for k in sorted(rows)] == [5, 9]
    assert all(np.isfinite(r["rel_mse"]) for r in rows.values())


def test_gt_convergence_matches_jax_on_its_tasks(monkeypatch, capsys):
    cfg_args = ["--task.pde=poisson"]
    theirs = j_gt_convergence.run(j_parse_overrides(JConfig(), cfg_args), [2, 4], 8,
                                  n_tasks=1, n_points=256, seed=0)
    j_pde = j_get_pde(JConfig().task)
    j_task = j_pde.sample_params(jax.random.split(jax.random.PRNGKey(0), 1)[0])
    j_pts = j_pde.sample_validation_points(jax.random.PRNGKey(1000), 256, j_task, None)
    port_pde = get_pde(Config().task)
    shared = port_pde._replace(
        sample_params=lambda gen: tuple(_t(a) for a in j_task),
        sample_validation_points=lambda gen, n, params, gt=None: _t(j_pts))
    monkeypatch.setattr(gt_convergence, "get_pde", lambda task_cfg: shared)
    capsys.readouterr()
    ours = gt_convergence.main(["--device=cpu", *cfg_args, "--resolutions=2,4",
                                "--ref_resolution=8", "--n_tasks=1", "--n_points=256",
                                "--per_task"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["task"] for l in lines if "task" in l] == [0, 0]
    assert lines[-1]["rel_mse_by_resolution"].keys() == {"2", "4"}
    assert [r["resolution"] for r in ours] == [r["resolution"] for r in theirs] == [2, 4]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["rel_mse"], b["rel_mse"], rtol=RTOL)
