"""flops.py's analytic count against what FlopCounterMode counts over the
port's step_core, at small sizes with remat off.

They differ by exactly one thing, of the port's making and not the
algorithm's work: the port's second-derivative stream enters the first
layer as a constant zero, so autograd forms no input gradient there: one
product of d x in_dim x width a domain point fewer in each backward pass
through that layer. A MAML inner step has five such passes on its inner
set (its gradient; the meta-backward through the forward and, three,
through that gradient) and one on its outer set.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from benchmark.reference import optim
from conftest import tiny_cell


def as_the_port_computes(config):
    """flops.step_flops of `config` with the port's departure."""
    hp = optim.hyper(config)
    d, width = config["in_dim"], hp["model.layer_size"]
    kinds = config["flop_model"]["kinds"]
    first = [k["points"] for k in kinds if k["streams"] > 1][0] * d * 2 * d * width
    tasks, steps = hp["maml.bsize"], hp["maml.inner_steps"]
    first_out = first * hp["task.outer_points"] // hp["task.inner_points"]
    return flops.step_flops(config) - tasks * steps * (5 * first + first_out)


def counted(cell):
    algo = __import__(f"benchmark.algorithms.{cell.config['algorithm']}", fromlist=["Program"])
    prog = algo.Program(cell.config, torch.device("cpu"))
    init = harness.make_weights(3, optim.hyper(cell.config), cell.config["in_dim"],
                                torch.device("cpu"))
    state = prog.initial_state(init)
    batch = prog.draw(torch.Generator().manual_seed(5))
    with FlopCounterMode(display=False) as fc:
        prog.step_core(batch, state)
    return fc.get_total_flops()


@pytest.mark.parametrize("inner,outer", [(32, 48), (48, 32)])
def test_analytic_count_is_the_ports_but_for_its_departure(inner, outer):
    cell = tiny_cell("p3d_maml_train", **{"model.layer_size": "8", "model.num_layers": "3",
                                          "task.inner_points": str(inner),
                                          "task.outer_points": str(outer)})
    cell.config["settings"]["train.remat_inner_steps"] = "false"
    cell.config["flop_model"] = {
        key: [{"kind": "boundary", "points": n, "streams": 1},
              {"kind": "domain", "points": n, "streams": 7}]
        for key, n in (("kinds", inner), ("outer_kinds", outer))}
    assert counted(cell) == as_the_port_computes(cell.config)


def test_cell_counts():
    """The committed configurations' counts (PERF.md quotes them)."""
    from conftest import ROOT
    import json
    config = json.loads((ROOT / "benchmark/configs/poisson3d_maml.json").read_text())
    assert abs(flops.step_flops(config) / 1e12 - 4.294) < 5e-4
    # far above the ridge point: the compute roof bounds the step
    assert flops.step_flops(config) / flops.step_bytes_floor(config) > 295 * 100
