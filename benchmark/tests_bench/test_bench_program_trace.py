"""The program's spans and counters in the traced window
(program_trace.py): its readers, the idle split, a traced window on the
CPU, and on the card the clock the spans share with the device trace and
the host reads the recorder adds (none)."""

import warnings

import pytest
import torch

from benchmark import harness, program_trace
from conftest import WORKLOADS, tiny_cell
from metapde_tpu_torch.utils import spans

MS = 1_000_000


def _span(name, start, end, id, parent=None):
    return spans.Span(name, start, end, id, parent, 1, 1)


def test_readers_of_the_program_s_part():
    trace = {"steps": 2, "window_s": 6.0, "busy_s": 1.0, "device_events": 10,
             "program_spans": {"draw.sample": [1.9, 2.1], "draw.to_device": [0.01, 0.03],
                               "step": [0.6, 0.8], "maml.meta_backward": [0.3, 0.3]},
             "counters": {"h2d_bytes": 2 * 18_876_160},
             "idle_by_span": {"draw": 0.1, "draw/draw.sample": 3.5, "step": 0.4,
                              "step/maml.inner_step": 0.2, "": 0.8}}
    m = {"train_steps_per_s": 0.3, "setup_s": 20.0, "flops_per_step": 1e12,
         "peak_flops": 1e15, "trace": trace}
    want = {"draw_sample_ms_per_step": 2000.0, "draw_copy_ms_per_step": 20.0,
            "h2d_mb_per_step": 18.87616, "enqueue_ms_per_step": 700.0,
            "meta_backward_ms_per_step": 300.0, "idle_in_draw_ms_per_step": 1800.0,
            "idle_in_step_ms_per_step": 300.0}
    assert sorted(want) == sorted(program_trace.READERS)
    for name, v in want.items():
        assert harness.load_reader(name)(m) == pytest.approx(v)
    # a summary without the program's part (a program without the recorder)
    bare = {**m, "trace": {k: trace[k] for k in ("steps", "window_s", "busy_s",
                                                 "device_events")}}
    for name in want:
        assert harness.load_reader(name)(bare) is None


def test_idle_is_cut_at_span_boundaries_and_adds_up():
    # draw [0, 40) holding draw.sample [5, 30); step [40, 90) holding an
    # inner step [50, 60); nothing after 90
    got = [_span("draw", 0, 40 * MS, 1), _span("draw.sample", 5 * MS, 30 * MS, 2, 1),
           _span("step", 40 * MS, 90 * MS, 3), _span("maml.inner_step", 50 * MS, 60 * MS, 4, 3)]
    segs = program_trace.segments(got, 0, 100 * MS)
    assert [s[2] for s in segs] == ["draw", "draw/draw.sample", "draw", "step",
                                    "step/maml.inner_step", "step", ""]
    # the device runs [10, 20) and [45, 55): the gap [20, 45) crosses the
    # end of draw.sample, of draw and the start of step
    device = [("k", 10 * MS, 20 * MS), ("k", 45 * MS, 55 * MS)]
    gaps = harness.idle_gaps([(s, e) for _, s, e in device], 0, 100 * MS)
    idle = program_trace.idle_by_path(gaps, segs)
    assert idle == {"draw": 5 * MS + 10 * MS, "draw/draw.sample": 5 * MS + 10 * MS,
                    "step": 5 * MS + 30 * MS, "step/maml.inner_step": 5 * MS, "": 10 * MS}
    assert sum(idle.values()) == sum(e - s for s, e in gaps) == 80 * MS

    class Rec:
        spans, counters = got, {"h2d_bytes": 8}
    bench = [("draw_step_inputs", 0, 40 * MS), ("step_core", 40 * MS, 95 * MS)]
    part = program_trace.program_summary(device, bench, Rec, 0, 100 * MS, 1)
    assert part["idle_gaps"] == [["step_core/step/maml.inner_step", pytest.approx(0.045)],
                                 ["draw_step_inputs/draw/draw.sample", pytest.approx(0.025)],
                                 ["draw_step_inputs/draw", pytest.approx(0.01)]]
    assert part["program_spans"]["draw"] == [pytest.approx(0.04)]
    assert part["idle_by_span"][""] == pytest.approx(0.01)


def test_a_traced_window_on_the_cpu_reads_the_program():
    cell = tiny_cell(WORKLOADS[0])
    run = harness.checked_steps(cell, 2 ** 33 + 9, torch.device("cpu"))
    state, summary = program_trace.traced_window(run.prog, run.gen, run.state, 2,
                                                 torch.device("cpu"))
    k = int(cell.config["flags"]["maml.inner_steps"])
    assert {n: len(v) for n, v in summary["program_spans"].items()} == {
        "draw": 2, "draw.sample": 2, "draw.candidates": 4, "draw.choice": 4,
        "draw.to_device": 2, "step": 2, "maml.inner_step": 2 * k, "maml.meta_backward": 2,
        "outer_update": 2}
    assert summary["counters"]["h2d_bytes"] > 0
    # no device events on the CPU: the window is idle throughout
    total = sum(summary["idle_by_span"].values())
    assert total == pytest.approx(summary["window_s"])
    measured = {"trace": summary}
    for name in program_trace.READERS:
        assert harness.load_reader(name)(measured) is not None, name
    assert len(summary["idle_gaps"]) == 1 and summary["idle_gaps"][0][0] == "draw_step_inputs"


@pytest.mark.card
def test_spans_share_the_device_trace_s_clock(card):
    got = program_trace.clock_offsets(card)
    assert got["kernel_ns"] > 200_000, got  # the sleep, not another kernel
    assert got["start_inside_ns"] >= -50_000 and got["end_inside_ns"] >= -50_000, got


@pytest.mark.card
def test_the_recorder_adds_no_host_read(card):
    cell = tiny_cell(WORKLOADS[0])
    run = harness.checked_steps(cell, 2 ** 33 + 11, card)
    counts = []
    for on in (False, True):
        harness.barrier(card)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                with spans.recording() if on else spans.span("off"):
                    run.prog.step_core(run.prog.draw(run.gen), run.state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        counts.append(len(seen))
        harness.barrier(card)
    assert counts[1] <= counts[0], counts
