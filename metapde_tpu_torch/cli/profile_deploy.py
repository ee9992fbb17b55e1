"""Where the deployment time goes on the card.

    python -m metapde_tpu_torch.cli.profile_deploy \
        --train.load_model_from_expt=results_poisson_maml/p30k_f32_s1 \
        --checkpoint=best --task.n_eval=8 --inner-steps-list=0,5 \
        --model.use_pallas_inference=true

Prints JSON lines: the ground-truth solve time per task (the n_eval FEM
solves of cli/deploy_bench), then, for each k, one validation call (k-step
adaptation plus inference for every eval task) under torch.profiler: wall
time per task, device-busy time per task (the union of the CUDA kernels'
intervals), the device's idle share, kernel launches per task and the
kernels that take the most device time. Runs on CUDA unless given
--device=cpu; on the CPU the device columns are null.
"""

import json
import sys
import time
from collections import defaultdict
from functools import partial

import torch
from torch.autograd import DeviceType

from ..config import Config, parse_overrides
from ..device import pop_device_flag
from ..train import maml_driver
from ..train.validation import make_validation_fn
from ..train.loop import device_barrier
from .deploy_bench import eval_tasks, load_model


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    steps_list, which, rest = (0, 5), "latest", []
    for a in argv:
        if a.startswith("--inner-steps-list="):
            steps_list = tuple(int(x) for x in a.split("=", 1)[1].split(","))
        elif a.startswith("--checkpoint="):
            which = a.split("=", 1)[1]
        else:
            rest.append(a)
    cfg = parse_overrides(Config(), rest)
    n = cfg.task.n_eval
    c = maml_driver.build(cfg, device)
    model, _, _, _ = load_model(cfg, c, which, device)

    t0 = time.perf_counter()
    bundle = eval_tasks(cfg, c["pde"], device)
    device_barrier(device)
    print(json.dumps({"phase": "ground_truth", "device": str(device),
                      "resolution": cfg.solver.ground_truth_resolution,
                      "s_per_task": (time.perf_counter() - t0) / n}), flush=True)

    args = (model, bundle.gt_params, bundle.coords, bundle.gt_vals)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    rows = []
    for k in steps_list:
        val_fn = make_validation_fn(
            c["pde"], partial(c["make_coef_func_batched"], inner_steps=k), n)
        val_fn(*args)  # warm-up
        device_barrier(device)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            val_fn(*args)
            device_barrier(device)
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name = defaultdict(float)
        for e in kernels:
            by_name[e.name] += e.time_range.end - e.time_range.start
        busy_us = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
        on_card = device.type == "cuda" and bool(kernels)
        row = {
            "phase": "adapt_and_infer", "k": k, "device": str(device),
            "wall_ms_per_task": wall_us / n / 1e3,
            "device_busy_ms_per_task": busy_us / n / 1e3 if on_card else None,
            "device_idle_share": 1.0 - busy_us / wall_us if on_card else None,
            "kernels_per_task": len(kernels) / n if on_card else None,
            "top_kernels_ms_per_task": (
                {name[:80]: us / n / 1e3 for name, us in
                 sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}
                if on_card else None),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
