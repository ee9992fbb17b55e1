"""The benchmark's own tests: python -m pytest benchmark/tests_bench.

Tests that need a CUDA card carry the `card` marker and skip, from inside
the test, where there is none."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(workload: str, **flags):
    """The cell `workload` at a size the CPU holds: 2-layer 16-wide fields, a
    few tasks, points and inner steps."""
    from benchmark import harness
    cell = harness.Cell.load(spec(), workload, ROOT)
    small = {"model.layer_size": "16", "model.num_layers": "2", "maml.bsize": "4",
             "task.inner_points": "64", "task.outer_points": "64", "maml.inner_steps": "2"}
    cell.config["reference_block_tasks"] = 2
    cell.config["flags"].update({**small, **flags})
    cell.traffic["traced_seconds"] = 0.2
    return cell


WORKLOADS = ["p3d_maml_train"]
