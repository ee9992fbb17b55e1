"""The port stands alone: no JAX, no optax, nothing of metapde_tpu; its
own config copy equals the JAX package's; entry points refuse a missing
CUDA device instead of falling back; chip_smoke.py fails without a card and
prints no result; no binary or large file in the package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from metapde_tpu_torch import config as config_mod
from metapde_tpu_torch import device as device_mod
from metapde_tpu_torch.cli import deploy_bench, leap_pde, maml_pde, train_bench
from metapde_tpu_torch.train import leap_driver, maml_driver

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "metapde_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "metapde_tpu")


def _modules():
    out = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert "metapde_tpu_torch.cli.deploy_bench" in mods
    # the walk reaches every family and solver module
    assert {"metapde_tpu_torch.pdes.steady_burgers", "metapde_tpu_torch.pdes.poisson3d",
            "metapde_tpu_torch.solvers.fem_steady_burgers",
            "metapde_tpu_torch.solvers.interpolation",
            # the last modules of the JAX package
            "metapde_tpu_torch.train.viz", "metapde_tpu_torch.cli.solution_viz",
            "metapde_tpu_torch.utils.tb_writer", "metapde_tpu_torch.utils.tensorboard_logger",
            "metapde_tpu_torch.utils.debugging", "metapde_tpu_torch.cli.roofline",
            "metapde_tpu_torch.cli.pde_check", "metapde_tpu_torch.cli.train_curves",
            "metapde_tpu_torch.cli.probe_table", "metapde_tpu_torch.cli.paper_plots",
            "metapde_tpu_torch.models.field",
            "metapde_tpu_torch.models.gradient_conditioned"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imported_names(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_chip_smoke_imports_nothing_of_jax():
    names = _imported_names(REPO / "chip_smoke.py")
    assert "metapde_tpu_torch.cli" in names
    assert not [n for n in names if _forbidden(n)]
    # and the port modules it names import nothing of JAX either
    ours = [n for n in names if n.startswith("metapde_tpu_torch")]
    code = ("import importlib, sys\n"
            f"for m in {ours!r}: importlib.import_module(m)\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_package_source_imports_are_clean():
    for path in PACKAGE.rglob("*.py"):
        bad = [n for n in _imported_names(path) if _forbidden(n)]
        assert not bad, (path, bad)


@pytest.mark.parametrize("algo", ["maml", "leap"])
def test_entry_point_refuses_missing_cuda(algo, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli, driver = {"maml": (maml_pde, maml_driver), "leap": (leap_pde, leap_driver)}[algo]
    with pytest.raises(RuntimeError, match="cuda"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        deploy_bench.main([f"--algo={algo}", f"--train.load_model_from_expt={tmp_path}"])
    with pytest.raises(RuntimeError, match="cuda"):
        deploy_bench.run(deploy_bench.Config(), algo=algo)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([f"--train.out_dir={tmp_path}", "--train.viz_every=0"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_bench.main(["--block=1", "--blocks=1"])
    with pytest.raises(RuntimeError, match="cuda"):
        driver.build(config_mod.Config())
    with pytest.raises(RuntimeError, match="cuda"):
        driver.run(config_mod.Config(), device="cuda")
    assert not list(tmp_path.iterdir())  # refused before writing anything
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    dev, rest = device_mod.pop_device_flag(["--device=cpu", "--task.n_eval=2"])
    assert dev == torch.device("cpu") and rest == ["--task.n_eval=2"]


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=REPO, env=_env(), timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_no_binary_or_large_file_in_the_package():
    for path in PACKAGE.rglob("*"):
        if not path.is_file() or "__pycache__" in path.parts:
            continue
        data = path.read_bytes()
        assert len(data) <= 200_000, path
        assert b"\0" not in data, path
        data.decode("utf-8")


def _config_tree(cls):
    """{field: (type annotation, default or nested tree)} of a config class."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(cls):
        default = f.default_factory() if f.default is dataclasses.MISSING else f.default
        out[f.name] = (str(f.type), _config_tree(type(default))
                       if dataclasses.is_dataclass(default) else default)
    return out


def test_config_copy_equals_the_jax_package_config():
    """metapde_tpu_torch/config.py is the port's own copy: the same Config
    tree field by field (names, types, defaults), the same JSON, and
    parse_overrides maps the same flags to the same values."""
    from metapde_tpu import config as j_config

    assert _config_tree(config_mod.Config) == _config_tree(j_config.Config)
    assert config_mod.Config().to_json() == j_config.Config().to_json()
    flags = ["--task.pde=poisson", "--task.bc_weight=100", "--task.fixed_num_pdes=4",
             "--task.sample_with_replacement=true", "--model.num_layers=3",
             "--model.omega=30", "--model.compute_dtype=none", "--maml.bsize=16",
             "--maml.outer_lr=1e-5", "--train.optimizer=ranger",
             "--train.load_model_from_expt=none", "--train.out_dir=x",
             "--train.remat_inner_steps=false", "--mesh.n_point_shards=2",
             "--deploy.optimizer=adam", "--solver.newton_tol=1e-9", "--seed=3",
             "--train.best_metric=rel_err_median", "--task.domain.xmin=-2"]
    ours = config_mod.parse_overrides(config_mod.Config(), flags)
    theirs = j_config.parse_overrides(j_config.Config(), flags)
    assert ours.to_json() == theirs.to_json()
    for run_dir in (REPO / "results_poisson_maml" / "p30k_f32_s1",
                    REPO / "results_sburgers_maml" / "sbi10_2"):
        assert (config_mod.parse_overrides(config_mod.Config(), [f"--from_run={run_dir}"])
                .to_json() == j_config.parse_overrides(j_config.Config(),
                                                       [f"--from_run={run_dir}"]).to_json())
    with pytest.raises(KeyError):
        config_mod.parse_overrides(config_mod.Config(), ["--maml.no_such_flag=1"])


def test_comparison_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    """The plain-PINN and solver-sweep entry points run on the card unless
    given --device=cpu, and refuse before writing anything without one."""
    from metapde_tpu_torch.cli import gt_convergence, nn_pde, nn_pde_maml, solver_baseline
    from metapde_tpu_torch.train import baseline_driver, nn_driver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = [f"--train.out_dir={tmp_path}"]
    for call in (lambda: nn_pde.main(out), lambda: nn_pde_maml.main(out),
                 lambda: solver_baseline.main(out + ["--resolutions=2"]),
                 lambda: gt_convergence.main(["--resolutions=2", "--ref_resolution=4"]),
                 lambda: nn_driver.build(config_mod.Config()),
                 lambda: nn_driver.run(config_mod.Config(), device="cuda"),
                 lambda: baseline_driver.run(config_mod.Config(), device="cuda")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not list(tmp_path.iterdir())


def test_tool_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    """solution_viz, pde_check and roofline run on the card unless given
    --device=cpu, and refuse before writing anything without one."""
    from metapde_tpu_torch.cli import pde_check, roofline, solution_viz

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((solution_viz.main, [f"--out={tmp_path}/x.png",
                                            f"--train.load_model_from_expt={tmp_path}"]),
                       (pde_check.main, [f"--out={tmp_path}/check"]),
                       (roofline.main, ["--block=1", "--blocks=1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    assert not list(tmp_path.iterdir())
