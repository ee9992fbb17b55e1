"""Readings that the limits of `correct` are set from (see PERF.md):

    python3 benchmark/control.py --workload <name> --seeds 1,2,... \
        [--fault-seeds 1,2,3] [--variants sound,tf32_control,half_batch,bf16_program]

For each seed, the numbers that run.py compares, at the cell's own size,
without a timed window: `sound`, the program as the configuration states
it; `tf32_control`, the reference in TF32 put in the program's place (the
control); `half_batch`, the program's meta-gradient over half the tasks;
`bf16_program`, the program's own bf16 chain. The faults and the bf16
chain run on --fault-seeds only. One JSON line per reading, then one with
the largest sound reading and the smallest of each other variant per
number. Not part of a benchmark run.
"""

import argparse
import contextlib
import gc
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed, variant, device):
    """The numbers run.py compares, for one seed and one variant."""
    import torch

    from benchmark import faults, harness
    algo = importlib.import_module(f"benchmark.algorithms.{cell.config['algorithm']}")
    if variant == "bf16_program":
        cell = harness.Cell(cell.name, cell.chips, faults.bf16_program(cell.config),
                            cell.traffic, cell.limits, cell.end_to_end, cell.per_layer)
    fault = faults.FAULTS.get(variant)
    ctx = fault(algo) if fault else contextlib.nullcontext(algo)
    with ctx as adapted:
        run = harness.checked_steps(cell, seed, device, adapted)
        run.state = None
        out = harness.reference_check(cell, run, device)
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--variants", default="sound,tf32_control,half_batch,bf16_program")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if Path(q or ".").resolve() != ROOT / "benchmark"]
    import torch

    from benchmark import harness
    cell = harness.Cell.load(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload,
                             ROOT)
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    summary = {}
    for variant in args.variants.split(","):
        for seed in seeds if variant == "sound" else fault_seeds:
            out = readings(cell, seed, variant, device)
            print(json.dumps({"workload": cell.name, "variant": variant, "seed": seed, **out}),
                  flush=True)
            pick = max if variant == "sound" else min
            for k, v in out.items():
                if not k.startswith("_"):
                    key = (variant, k)
                    summary[key] = pick(summary.get(key, v), v)
    print(json.dumps({"workload": cell.name, "summary": {
        f"{v}.{k}": x for (v, k), x in summary.items()}}), flush=True)


if __name__ == "__main__":
    main()
