"""The control on the card, at each cell's own size: the reference in TF32
in the program's place fails at least one of the cell's limits, while
the program on the same seed passes them all. (The readings the limits
were set from, on a dozen seeds and more: benchmark/control.py, PERF.md.)"""

import pytest

from benchmark import control, harness
from conftest import ROOT, WORKLOADS, spec


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_where_the_program_passes(workload, card):
    cell = harness.Cell.load(spec(), workload, ROOT)
    seed = 2 ** 31 + 977

    def failed(variant):
        out = control.readings(cell, seed, variant, card)
        return [k for k, limit in cell.limits.items() if k in out and not out[k] <= limit]

    assert failed("sound") == []
    assert failed("tf32_control") != []
