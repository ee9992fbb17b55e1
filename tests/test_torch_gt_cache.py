"""The port's ground-truth cache (train/gt_cache.py) and its callers:
get_ground_truth, run() and cli/deploy_bench.

- task_cache_extra is the JAX package's, field for field.
- An entry is written on a miss and read on a hit; another resolution or
  another gt-affecting task field is another entry; a corrupt entry is
  deleted and solved again; an interrupted write leaves no entry; a solve
  that fails raises and writes nothing (no CPU retry).
- run() caches in <out_dir>/gt_cache_torch, and a resumed run() solves
  nothing; deploy_bench caches in gt_cache_torch/ beside the run dir and
  leaves the JAX CLI's gt_cache/ pickles byte for byte, without opening them.
"""

import builtins
import shutil
from pathlib import Path

import pytest
import torch

from metapde_tpu.config import DomainConfig as JDomainConfig
from metapde_tpu.config import TaskConfig as JTaskConfig
from metapde_tpu.train.gt_cache import task_cache_extra as j_task_cache_extra
from metapde_tpu_torch.cli import deploy_bench
from metapde_tpu_torch.config import Config, DomainConfig, TaskConfig, parse_overrides
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.solvers.fem_poisson import PoissonGroundTruth
from metapde_tpu_torch.train import gt_cache, maml_driver
from metapde_tpu_torch.train.gt_cache import GroundTruthCache, task_cache_extra
from metapde_tpu_torch.train.validation import get_ground_truth

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RUN_DIR = REPO / "results_poisson_maml" / "p30k_f32_s1"
JAX_CACHE = REPO / "results_poisson_maml" / "gt_cache"


class FakePde:
    name = "fake"
    gt_version = 1

    def __init__(self, fail=False):
        self.solves = 0
        self.fail = fail

    def solve(self, params, resolution):
        if self.fail:
            raise RuntimeError("solver fault")
        self.solves += 1
        return PoissonGroundTruth(u_grid=params[0] * resolution, geo_params=params[1],
                                  residual_norm=torch.tensor(1e-6))


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(3, 4, generator=g), torch.randn(2, generator=g))


@pytest.mark.parametrize("kw", [
    {}, {"max_reynolds": 50.0}, {"vary_bc": False, "bc_scale": 2.0},
    {"domain": "moved"}, {"inner_points": 9999, "n_eval": 3, "sample_with_replacement": True},
])
def test_task_cache_extra_is_the_jax_one(kw):
    if kw.get("domain") == "moved":
        t, j = (TaskConfig(domain=DomainConfig(xmin=0.0)),
                JTaskConfig(domain=JDomainConfig(xmin=0.0)))
    else:
        t, j = TaskConfig(**kw), JTaskConfig(**kw)
    assert task_cache_extra(t) == j_task_cache_extra(j)


def test_miss_then_hit(tmp_path):
    cache, pde, p = GroundTruthCache(str(tmp_path)), FakePde(), _params()
    g1 = cache.get_or_solve(pde, p, 4)
    g2 = cache.get_or_solve(pde, p, 4)
    assert pde.solves == 1 and (cache.solves, cache.hits) == (1, 1)
    assert type(g2) is PoissonGroundTruth
    for a, b in zip(g1, g2):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert [f.suffix for f in tmp_path.iterdir()] == [".npz"]


def test_resolution_and_task_fields_key_the_entry(tmp_path):
    cache, pde, p = GroundTruthCache(str(tmp_path)), FakePde(), _params()
    cache.get_or_solve(pde, p, 4)
    cache.get_or_solve(pde, p, 8)
    cache.get_or_solve(pde, p, 4, extra_hparams={"bc_scale": 2.0})
    cache.get_or_solve(pde, _params(1), 4)
    assert pde.solves == 4 and len(list(tmp_path.iterdir())) == 4
    cache.get_or_solve(pde, p, 4, extra_hparams={"bc_scale": 2.0})
    assert pde.solves == 4


def test_corrupt_entry_is_deleted_and_solved_again(tmp_path, capsys):
    cache, pde, p = GroundTruthCache(str(tmp_path)), FakePde(), _params()
    path = Path(cache.path(pde, p, 4))
    path.write_bytes(b"PK\x03\x04 truncated")
    g = cache.get_or_solve(pde, p, 4)
    assert pde.solves == 1 and "corrupt entry" in capsys.readouterr().out
    assert torch.equal(GroundTruthCache(str(tmp_path)).get_or_solve(pde, p, 4).u_grid, g.u_grid)
    assert pde.solves == 1


class Interrupted(Exception):
    pass


def test_interrupted_write_leaves_no_entry(tmp_path, monkeypatch):
    cache, pde, p = GroundTruthCache(str(tmp_path)), FakePde(), _params()

    def dies(f, **arrays):
        f.write(b"PK partial")
        raise Interrupted

    monkeypatch.setattr(gt_cache.np, "savez", dies)
    with pytest.raises(Interrupted):
        cache.get_or_solve(pde, p, 4)
    assert not Path(cache.path(pde, p, 4)).exists()
    monkeypatch.undo()
    cache.get_or_solve(pde, p, 4)
    assert pde.solves == 2 and Path(cache.path(pde, p, 4)).exists()


def test_a_failed_solve_raises_and_writes_nothing(tmp_path):
    cache = GroundTruthCache(str(tmp_path))
    with pytest.raises(RuntimeError, match="solver fault"):
        cache.get_or_solve(FakePde(fail=True), _params(), 4)
    assert list(tmp_path.iterdir()) == []


def test_get_ground_truth_reads_the_cache(tmp_path):
    pde = get_pde(TaskConfig())
    gen = torch.Generator().manual_seed(3)
    tasks = [pde.sample_params(gen) for _ in range(2)]
    bundles = [get_ground_truth(pde, tasks, torch.Generator().manual_seed(4), 16, 4,
                                cache_dir=str(tmp_path)) for _ in range(2)]
    assert [(b.solves, b.cache_hits) for b in bundles] == [(2, 0), (0, 2)]
    assert torch.equal(bundles[0].gt_vals, bundles[1].gt_vals)
    plain = get_ground_truth(pde, tasks, torch.Generator().manual_seed(4), 16, 4)
    assert (plain.solves, plain.cache_hits) == (2, 0)
    assert torch.equal(plain.gt_vals, bundles[0].gt_vals)


def test_resumed_run_solves_nothing(tmp_path):
    argv = ["--task.inner_points=32", "--task.outer_points=32", "--task.validation_points=32",
            "--task.n_eval=2", "--solver.ground_truth_resolution=4", "--maml.bsize=2",
            "--maml.inner_steps=2", "--model.num_layers=2", "--model.layer_size=16",
            "--train.viz_every=0", "--train.log_every=1", "--train.checkpoint_every=1",
            f"--train.out_dir={tmp_path}"]
    maml_driver.run(parse_overrides(Config(), argv + [
        "--train.outer_steps=1", "--train.expt_name=a"]), device="cpu")
    maml_driver.run(parse_overrides(Config(), argv + [
        "--train.outer_steps=2", "--train.expt_name=b",
        f"--train.load_model_from_expt={tmp_path / 'a'}"]), device="cpu")
    cache_dir = tmp_path / "gt_cache_torch"

    def gt_lines(expt):
        return [l for l in (tmp_path / expt / "log.txt").read_text().splitlines()
                if l.startswith("ground truth")]

    assert gt_lines("a") == [f"ground truth at resolution 4: 2 solved, 0 read from {cache_dir}"]
    assert gt_lines("b") == [f"ground truth at resolution 4: 0 solved, 2 read from {cache_dir}"]
    assert len(list(cache_dir.glob("poisson_*.npz"))) == 2


def test_deploy_bench_leaves_the_jax_cache_alone(tmp_path, monkeypatch):
    """A port deploy on a copy of the family dir: the JAX CLI's gt_cache/
    pickles stay byte for byte and are never opened; the port's entries go
    to gt_cache_torch/."""
    run_dir = tmp_path / "p30k_f32_s1"
    run_dir.mkdir()
    shutil.copy(RUN_DIR / "checkpoint_best.pickle", run_dir)
    jax_cache = tmp_path / "gt_cache"
    jax_cache.mkdir()
    pickles = sorted(JAX_CACHE.glob("*.pickle"))[:3]
    assert pickles
    for f in pickles:
        shutil.copy(f, jax_cache)
    before = {f.name: f.read_bytes() for f in jax_cache.iterdir()}
    opened = []
    real_open = builtins.open
    monkeypatch.setattr(builtins, "open",
                        lambda file, *a, **k: opened.append(str(file)) or real_open(file, *a, **k))
    deploy_bench.main([
        "--device=cpu", "--algo=maml", f"--train.load_model_from_expt={run_dir}",
        "--solver.ground_truth_resolution=4", "--task.n_eval=2",
        "--task.validation_points=64", "--task.inner_points=64",
        "--inner-steps-list=0", "--checkpoint=best", "--repeats=1"])
    monkeypatch.undo()
    assert not [f for f in opened if "gt_cache" in f and "gt_cache_torch" not in f]
    assert {f.name: f.read_bytes() for f in jax_cache.iterdir()} == before
    assert len(list((tmp_path / "gt_cache_torch").glob("poisson_*.npz"))) == 2
