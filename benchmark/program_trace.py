"""The program's own spans and counters (metapde_tpu_torch/utils/spans.py)
in the traced window, beside the device's operations, and the probe that
measures them on the card.

traced_window(prog, gen, state, n_steps, device) runs harness.traced_window
as it is, with the program's recorder on over the traced steps (the
warm-up step runs with it off). Its summary is harness.summarize_trace's,
every field and gap length as they are, with the gaps of `idle_gaps` named
by paths (the benchmark's span, then the program's spans under way when
the gap began: "draw_step_inputs/draw/draw.sample/draw.choice") and
program_summary's fields added. The readers of metrics/ named in READERS
read those fields, and find nothing in a summary without them.

    python3 -m benchmark.program_trace --workload <cell> --seed <n> [--pairs 2]

from the root of a checkout, on a card: set-up as a run's, then `pairs`
traced windows with the recorder off (harness.traced_window) and on, in
turns; first the spans' clock against the device trace's and the
recorder's own cost a span. One JSON line each on standard output.
"""

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import torch

from . import harness

ROOT = Path(__file__).resolve().parent.parent

# the readers of the program's part of the summary
READERS = ["draw_sample_ms_per_step", "draw_copy_ms_per_step", "h2d_mb_per_step",
           "enqueue_ms_per_step", "meta_backward_ms_per_step", "idle_in_draw_ms_per_step",
           "idle_in_step_ms_per_step"]


def segments(spans, lo: int, hi: int):
    """[lo, hi] cut wherever the innermost of `spans` (properly nested:
    one thread's) changes: [(start, end, path)], where path joins the names
    of the spans under way, outermost first, with "/", and is "" outside
    every span. A span covers [start_ns, end_ns)."""
    edges = sorted([(s.start_ns, 1, s.id, s) for s in spans]
                   + [(s.end_ns, 0, -s.id, s) for s in spans], key=lambda e: e[:3])
    out, stack, t = [], [], lo
    for when, is_start, _, s in edges:
        if when > t and t < hi:
            out.append((t, min(when, hi), "/".join(x.name for x in stack)))
        t = max(t, when)
        if is_start:
            stack.append(s)
        else:
            stack.remove(s)
    if t < hi:
        out.append((t, hi, ""))
    return [g for g in out if g[1] > max(g[0], lo) and g[0] < hi]


def idle_by_path(gaps, segs) -> dict:
    """Each idle gap (start, end) cut at the segments' boundaries, each part
    charged to its segment's path: {path: ns}."""
    out, j = {}, 0
    for s, e in gaps:
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < e:
            a, b, path = segs[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[path] = out.get(path, 0) + part
            k += 1
    return out


def program_summary(device_events, bench_spans, rec, lo: int, hi: int, thread: int) -> dict:
    """The program's part of the traced window [lo, hi] (ns): the spans of
    `thread` (the one that ran the steps) by name (seconds each), the
    counters' change, the device's idle seconds charged to the innermost
    program span under way ("" outside them all), and the longest idle
    gaps as harness.summarize_trace keeps them, named by paths."""
    mine = [s for s in rec.spans if s.thread == thread]
    ivals = [(max(s, lo), min(e, hi)) for _, s, e in device_events if e > lo and s < hi]
    gaps = harness.idle_gaps(ivals, lo, hi)
    segs = segments(mine, lo, hi)
    by_name = {}
    for s in mine:
        by_name.setdefault(s.name, []).append((s.end_ns - s.start_ns) * 1e-9)

    def named(t):
        bench = next((n for n, s, e in bench_spans if s <= t < e), "between calls")
        path = next((p for a, b, p in segs if a <= t < b), "")
        return f"{bench}/{path}" if path else bench

    top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"program_spans": by_name, "counters": dict(rec.counters),
            "idle_by_span": {p: ns * 1e-9 for p, ns in idle_by_path(gaps, segs).items()},
            "idle_gaps": [[named(s), (e - s) * 1e-9] for s, e in top]}


class _Recorded:
    """`prog` with the program's recorder turned on at the draw of its
    second step (the first traced one) and off at close()."""

    def __init__(self, prog, spans):
        self.prog, self.spans, self.draws, self.ctx, self.rec = prog, spans, 0, None, None

    def draw(self, gen):
        self.draws += 1
        if self.draws == 2:
            self.ctx = self.spans.recording()
            self.rec = self.ctx.__enter__()
        return self.prog.draw(gen)

    def step_core(self, batch, state):
        return self.prog.step_core(batch, state)

    def close(self):
        if self.ctx is not None:
            self.ctx.__exit__(None, None, None)
        return self.rec


def traced_window(prog, gen, state, n_steps: int, device):
    """harness.traced_window with the program's recorder on over the traced
    steps; returns (state, summary with the program's part). The harness
    hands the device's events and its spans to summarize_trace alone, so
    they are caught there."""
    from metapde_tpu_torch.utils import spans

    recorded, seen = _Recorded(prog, spans), {}
    summarize = harness.summarize_trace

    def catch(*args):
        seen["args"] = args
        return summarize(*args)

    harness.summarize_trace = catch
    try:
        state, summary = harness.traced_window(recorded, gen, state, n_steps, device)
    finally:
        harness.summarize_trace = summarize
        rec = recorded.close()
    events, bench_spans, lo, hi, _ = seen["args"]
    summary.update(program_summary(events, bench_spans, rec, lo, hi, threading.get_ident()))
    return state, summary


# --- on the card ----------------------------------------------------------

def clock_offsets(device, cycles: int = 2_000_000) -> dict:
    """A program span around torch.cuda._sleep (about 1 ms) and a
    synchronize, after a barrier, under the harness's CUDA-only profiler:
    how far the sleep kernel's device interval lies inside the span (ns;
    negative: outside)."""
    from torch.profiler import ProfilerActivity, profile

    from metapde_tpu_torch.utils import spans

    def kernels(p):
        return [(e.name(), e.start_ns(), e.end_ns()) for e in p.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA]

    # the first profile of a process takes seconds to start, and a profile
    # after many others may come back without the kernel: up to 8 tries
    for tries in range(1, 9):
        harness.barrier(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof, spans.recording() as rec:
            with spans.span("sleep"):
                torch.cuda._sleep(cycles)
                harness.barrier(device)
        found = kernels(prof)
        if tries > 1 and found:
            break
    else:
        raise RuntimeError("no profile of the sleep kernel held a device event")
    name, k0, k1 = max(found, key=lambda k: k[2] - k[1])
    (s,) = rec.spans
    return {"kernel": name, "kernel_ns": k1 - k0, "span_ns": s.end_ns - s.start_ns,
            "start_inside_ns": k0 - s.start_ns, "end_inside_ns": s.end_ns - k1,
            "tries": tries}


def span_cost_ns(n: int = 200_000) -> dict:
    """Host ns a span costs with the recorder off and on, and a counter."""
    from metapde_tpu_torch.utils import spans

    def each(fn):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t0) / n

    def one():
        with spans.span("cost"):
            pass
    base = each(lambda: None)
    off = each(one) - base
    with spans.recording():
        on = each(one) - base
    return {"span_off_ns": off, "span_on_ns": on,
            "count_ns": each(lambda: spans.count("cost")) - base}


def probe(cell, seed: int, device, pairs: int, steps: int):
    """Set-up as a run's, then `pairs` traced windows of `steps` steps with
    the recorder off (harness.traced_window) and on, in turns: one row a
    window."""
    run = harness.checked_steps(cell, seed, device)
    harness.barrier(device)
    state = run.state
    for i in range(2 * pairs):
        on = i % 2 == 1
        window = traced_window if on else harness.traced_window
        state, summary = window(run.prog, run.gen, state, steps, device)
        row = {"recorder": "on" if on else "off", "ms_per_step": 1e3 * summary["window_s"] / steps}
        measured = {"trace": summary, "train_steps_per_s": 0.0, "setup_s": 0.0,
                    "flops_per_step": 0.0, "peak_flops": None}
        for name in ["draw_ms_per_step", "device_idle_share", "device_busy_ms_per_step"] + (
                READERS if on else []):
            row[name] = harness.load_reader(name)(measured)
        if on:
            idle = summary["window_s"] - summary["busy_s"]
            row["idle_ms_per_step"] = 1e3 * idle / steps
            row["idle_by_span_ms_per_step"] = {k: 1e3 * v / steps
                                               for k, v in summary["idle_by_span"].items()}
            row["span_ms_per_step"] = {k: 1e3 * sum(v) / steps
                                       for k, v in summary["program_spans"].items()}
            row["spans_per_step"] = sum(len(v) for v in summary["program_spans"].values()) / steps
            row["counters"] = summary["counters"]
            row["idle_gaps"] = summary["idle_gaps"]
        yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--steps", type=int, default=0, help="steps a window; 0: the traffic's least")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the probe needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = harness.Cell.load(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload,
                             ROOT)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "seed": args.seed,
                      "clock": clock_offsets(device), "cost": span_cost_ns()}), flush=True)
    for row in probe(cell, args.seed, device, args.pairs,
                     args.steps or cell.traffic["traced_min_steps"]):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
