"""The harness on the CPU: the spec's form, the exit without a card, what
it loads, the trace's reduction, the metric readers, and `correct` under
the faults a cell can have."""

import contextlib
import json
import re
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness
from conftest import ROOT, WORKLOADS, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keeps_to_its_form():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [x["name"] for x in metrics + spec["configs"] + spec["workloads"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert all(m["moves"] in e2e for m in spec["per_layer"])
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(json.loads((ROOT / c["file"]).read_text())["reduced"])
    for w in spec["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    for m in spec["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("what", ["run", "reference"])
def test_nothing_of_jax_is_loaded(what):
    """Whole top-level names: metapde_tpu_torch begins with metapde_tpu."""
    mods = {"run": "from benchmark import run, harness, control, faults\n"
                   "from benchmark.algorithms import maml\n"
                   "for m in ('draw_ms_per_step', 'train_mfu'): harness.load_reader(m)\n",
            "reference": "from benchmark.reference import siren, maml, optim\n"
                         "from benchmark.reference.pdes import poisson3d\n"}[what]
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{mods}"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & harness.FORBIDDEN
    if what == "reference":
        assert "metapde_tpu_torch" not in tops
    else:
        assert "metapde_tpu_torch" in tops


def test_trace_reduction():
    ms = 1_000_000
    device = [("gemm", 10 * ms, 30 * ms), ("sin", 20 * ms, 35 * ms),
              ("gemm", 150 * ms, 160 * ms), ("before", -5 * ms, -1 * ms)]
    spans = [("draw_step_inputs", 0, 10 * ms), ("step_core", 10 * ms, 90 * ms),
             ("draw_step_inputs", 100 * ms, 110 * ms), ("step_core", 110 * ms, 190 * ms)]
    t = harness.summarize_trace(device, spans, 0, 200 * ms, 2)
    assert t["window_s"] == pytest.approx(0.2) and t["busy_s"] == pytest.approx(0.035)
    assert t["device_events"] == 3
    # gaps 35-150 ms (begun inside the first step_core), 160-200 and 0-10 ms
    assert t["idle_gaps"] == [["step_core", pytest.approx(0.115)],
                              ["step_core", pytest.approx(0.04)],
                              ["draw_step_inputs", pytest.approx(0.01)]]
    assert t["device_ops"][0] == ["gemm", pytest.approx(0.03)]
    assert t["spans"]["draw_step_inputs"] == [pytest.approx(0.01)] * 2


def test_readers():
    trace = {"steps": 2, "window_s": 4.0, "busy_s": 1.0, "device_events": 10,
             "spans": {"draw_step_inputs": [0.1, 0.3]}}
    m = {"train_steps_per_s": 0.5, "setup_s": 20.0, "flops_per_step": 1e12,
         "peak_flops": 1e15, "trace": trace}
    want = {"draw_ms_per_step": 200.0, "launches_per_step": 5.0,
            "device_busy_ms_per_step": 500.0, "kernel_flop_share": 0.2, "train_mfu": 0.05,
            "device_idle_share": 75.0}
    for name, v in want.items():
        assert harness.load_reader(name)(m) == pytest.approx(v)
    # nothing to read: no device events, no peak for the card
    empty = {**m, "peak_flops": None, "trace": {**trace, "device_events": 0, "busy_s": 0.0}}
    for name in ("launches_per_step", "device_busy_ms_per_step", "kernel_flop_share",
                 "train_mfu", "device_idle_share"):
        assert harness.load_reader(name)(empty) is None


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", [None, "half_batch", "unchanged_state"])
def test_correct_under_faults(workload, fault):
    """A whole run past the look for a card (set-up, window, trace,
    reference) with the timed path sound, or broken underneath."""
    cell = tiny_cell(workload)
    algo = __import__(f"benchmark.algorithms.{cell.config['algorithm']}", fromlist=["Program"])
    ctx = faults.FAULTS[fault](algo) if fault else contextlib.nullcontext(algo)
    with ctx as adapted:
        result, checks = harness.run_cell(cell, 2 ** 33 + 5, 0.5, fault is None, 0.0,
                                          torch.device("cpu"), adapted)
    assert result["correct"] is (fault is None), checks
    assert list({**result, "checks": checks})[-1] == "checks"
