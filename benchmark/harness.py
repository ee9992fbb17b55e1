"""One run of one cell: set-up, the timed window, the traced window, the
reference's check and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name (BENCHMARK.json at the checkout's root names
them): configs/<config>.json, traffic/<traffic>.json, limits/<cell>.json,
metrics/<metric>.py, algorithms/<algorithm>.py and reference/pdes/<pde>.py.
"""

import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
import types
from pathlib import Path

import torch

from . import flops
from .reference import laws, optim, siren

BENCH = Path(__file__).resolve().parent

# dense bf16 tensor-core peak of an H100 SXM (NVIDIA's datasheet, without
# sparsity, at the card's 700 W limit); the repo's MFU convention
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}

# whole top-level module names that no run may load
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "metapde_tpu"}


class Cell:
    """One cell: its configuration, traffic mix and limits, and the metrics
    it reports."""

    def __init__(self, name, chips, config, traffic, limits, end_to_end, per_layer):
        self.name, self.chips, self.config = name, chips, config
        self.traffic, self.limits = traffic, limits
        self.end_to_end, self.per_layer = end_to_end, per_layer

    @classmethod
    def load(cls, spec: dict, workload: str, root: Path):
        """The cell named `workload` in BENCHMARK.json's `spec`, with the
        files its names point at under `root`."""
        wl = {w["name"]: w for w in spec["workloads"]}[workload]
        entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]

        def here(m):
            return workload in m.get("workloads", [workload])
        e2e = [m for m in spec["end_to_end"] if here(m)]
        names = {m["name"] for m in e2e}
        per_layer = [m for m in spec["per_layer"]
                     if here(m) and ("workloads" in m or m["moves"] in names)]

        def read(path):
            return json.loads((root / path).read_text())
        return cls(workload, wl["chips"], read(entry["file"]),
                   read(f"benchmark/traffic/{wl['traffic']}.json"),
                   read(f"benchmark/limits/{workload}.json"), e2e, per_layer)


def forbidden_modules():
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def barrier(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_weights(seed: int, hp: dict, in_dim: int, device) -> dict:
    """The init both sides start from, drawn on the device from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return siren.init(gen, in_dim, hp["model.layer_size"], hp["model.num_layers"],
                      hp["model.omega"], hp["model.omega0"], hp["model.io_scale_lr_factor"],
                      device)


# --- the trace ------------------------------------------------------------

def busy_s(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def idle_gaps(intervals, lo, hi):
    """The gaps (start, end) between the union of `intervals` within [lo, hi]."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    return [g for g in gaps if g[1] > g[0]]


def summarize_trace(device_events, spans, lo: int, hi: int, n_steps: int) -> dict:
    """The traced window [lo, hi] (ns) from the device's (name, start_ns,
    end_ns) events and the benchmark's host spans (name, start_ns, end_ns):
    its length, device-busy seconds, device operations (launches), the
    device operations that took most time, and the longest
    idle gaps, each named by the span under way when it began."""
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in device_events if e > lo and s < hi]
    ivals = [(s, e) for _, s, e in dev]
    by_name = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9

    def doing(t):
        return next((n for n, s, e in spans if s <= t < e), "between calls")

    gaps = sorted(idle_gaps(ivals, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {
        "steps": n_steps,
        "window_s": (hi - lo) * 1e-9,
        "busy_s": busy_s(ivals) * 1e-9,
        "device_events": len(dev),
        "device_ops": sorted(([n, t] for n, t in by_name.items()), key=lambda r: -r[1])[:10],
        "idle_gaps": [[doing(s), (e - s) * 1e-9] for s, e in gaps],
        "spans": {k: [(e - s) * 1e-9 for n, s, e in spans if n == k]
                  for k in ("draw_step_inputs", "step_core")},
    }


def traced_window(prog, gen, state, n_steps: int, device):
    """n_steps outer steps as train_step composes them, draw_step_inputs
    then step_core, each under a host span of the benchmark's own, with
    torch.profiler recording the device's operations (its host-side
    recording would slow the host that paces these steps), after one step
    that warms the profiler up. Returns (state, summary)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    spans, found = [], {}

    def ready(p):
        found["events"] = [(e.name(), e.start_ns(), e.end_ns())
                           for e in p.profiler.kineto_results.events()
                           if on_card and e.device_type() == torch.autograd.DeviceType.CUDA]

    with profile(activities=acts, on_trace_ready=ready,
                 schedule=schedule(wait=0, warmup=1, active=n_steps)) as prof:
        for i in range(n_steps + 1):
            t0 = time.time_ns()
            batch = prog.draw(gen)
            t1 = time.time_ns()
            state, _ = prog.step_core(batch, state)
            t2 = time.time_ns()
            if i:
                spans += [("draw_step_inputs", t0, t1), ("step_core", t1, t2)]
            if i in (0, n_steps):
                barrier(device)
            if i == 1:  # the window opens once the profiler has started recording
                lo = t0
            if i == n_steps:
                hi = time.time_ns()
            prof.step()
    return state, summarize_trace(found["events"], spans, lo, hi, n_steps)


# --- the comparison with the reference ------------------------------------

def rel_gap(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / abs(b) if b else abs(a - b)


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the two sides' norms, against the
    reference's norm of that leaf or of the median leaf, the larger."""
    names = [n for n in ref if keep is None or n in keep]
    norms = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in ref}
    med = statistics.median(norms.values())
    return max(abs(float(torch.linalg.vector_norm(prog[n].double())) - norms[n])
               / max(norms[n], med) for n in names)


def moved(first_ref: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in first_ref.items()}
    med = statistics.median(norms.values())
    return {n for n, v in norms.items() if v >= 1e-3 * med}


def reference_check(cell, run, device) -> dict:
    """Follow the checked steps with the reference on the same draws and
    return each number compared: the draws' violations of the family's
    definition (support, shapes, repeats, and the laws of the draws,
    pooled over the steps), each step's mean losses, the first gradient
    and the change of the meta-parameters after the steps, by the worst
    leaf."""
    hp = optim.hyper(cell.config)
    pde = importlib.import_module(f"benchmark.reference.pdes.{hp['task.pde']}")
    ref = run.algo.REFERENCE
    block = cell.config.get("reference_block_tasks", 0)
    state = ref.init_state({k: v.clone() for k, v in run.init.items()}, hp)
    start = ref.leaves(state)
    violations, samples, loss_gap, ref_first = {}, {}, 0.0, None
    with optim.precision(tf32=False):
        for i, gs in enumerate(run.gen_states):
            gen = torch.Generator()
            gen.set_state(gs)
            batch, points, sets, t = run.prog.replay(gen)
            for k, v in pde.check_draw(batch["tp"], points, t, sets, hp).items():
                violations[k] = violations.get(k, 0) + v
            for k, v in pde.draw_laws(batch["tp"], points, hp).items():
                samples.setdefault(k, []).append(v)
            batch = {k: tuple(x.to(device) for x in v) for k, v in batch.items()}
            state, out = ref.step(state, batch, pde.task_loss, hp, block)
            loss_gap = max(loss_gap, rel_gap(run.outs[i]["ml"], out["ml"]),
                           rel_gap(run.outs[i]["losses"].mean(), out["losses"].mean()))
            if i == 0:
                ref_first = out["grad"]
            del batch, out
    violations.update(laws.violations(samples))
    change_ref = {n: v - start[n] for n, v in ref.leaves(state).items()}
    change_prog = {n: run.after[n] - start[n] for n in change_ref}
    keep = moved(ref_first)
    return {"draw_violations": sum(violations.values()),
            "loss_gap": loss_gap,
            "grad_gap": leaf_gap(run.first, ref_first),
            "change_gap": leaf_gap(change_prog, change_ref, keep=keep),
            "_violations": violations, "_left_out": sorted(set(change_ref) - keep)}


# --- one run --------------------------------------------------------------

def load_reader(name: str, bench: Path = BENCH):
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def checked_steps(cell: Cell, seed: int, device, algo=None):
    """Set-up: the program's build, the init from the seed, and the checked
    steps through the timed call, which warm every shape the window uses.
    Returns what the window and the reference's check take from it."""
    hp = optim.hyper(cell.config)
    algo = algo or importlib.import_module(f"benchmark.algorithms.{cell.config['algorithm']}")
    prog = algo.Program(cell.config, device)
    init = make_weights(seed, hp, cell.config["in_dim"], device)
    state = prog.initial_state(init)
    gen = torch.Generator().manual_seed(seed)
    gen_states, outs, first = [], [], None
    for i in range(cell.traffic["checked_steps"]):
        gen_states.append(gen.get_state())
        state, out = prog.call(gen, state)
        outs.append(out)
        if i == 0:
            first = prog.first_gradient(state)
    after = {k: v.clone() for k, v in prog.leaves(state).items()}
    return types.SimpleNamespace(algo=algo, prog=prog, init=init, state=state, gen=gen,
                                 gen_states=gen_states, outs=outs, first=first, after=after)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, algo=None):
    """Set-up, the timed window, with `trace` the traced window, then the
    reference's check. Returns (result dict without its checks, checks)."""
    device = device or torch.device("cuda", 0)
    traffic = cell.traffic
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = checked_steps(cell, seed, device, algo)
    prog, gen, state = run.prog, run.gen, run.state
    barrier(device)
    setup_s = time.perf_counter() - t_start

    t0, mls, ends = time.perf_counter(), [], []
    while True:
        state, out = prog.call(gen, state)
        mls.append(out["ml"])
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    barrier(device)
    wall = time.perf_counter() - t0
    calls = [b - a for a, b in zip([0.0] + ends, ends)]
    print(f"window: {len(calls)} calls in {wall:.3f} s; host s a call "
          f"{min(calls):.3f} / {statistics.median(calls):.3f} / {max(calls):.3f}",
          file=sys.stderr)
    n_window = len(mls)
    steps_per_s = n_window / wall
    nonfinite = int((~torch.isfinite(torch.stack(mls))).sum())

    summary = None
    if trace:
        n = max(traffic["traced_min_steps"], math.ceil(traffic["traced_seconds"] * steps_per_s))
        state, summary = traced_window(prog, gen, state, n, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, out, mls
    run.state = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = reference_check(cell, run, device)
    violations = numbers.pop("_violations")
    numbers.pop("_left_out")
    numbers["nonfinite_steps"] = nonfinite
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())  # NaN fails

    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    measured = {"train_steps_per_s": steps_per_s, "setup_s": setup_s,
                "flops_per_step": flops.step_flops(cell.config),
                "peak_flops": PEAK_FLOPS.get(dev["kind"]), "trace": summary}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(measured)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    else:
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": len(run.outs) + n_window,
              "failed": nonfinite, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if numbers["draw_violations"]:
        print("draw violations: " + json.dumps(violations), file=sys.stderr)
    return result, checks


def report(result: dict, checks: dict):
    """The checks as the last lines on standard error, then the result as
    the last line on standard output, the checks its last key."""
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
