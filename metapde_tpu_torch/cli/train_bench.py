"""Meta-training throughput of the port: train_step_many on the flagship.

    python -m metapde_tpu_torch.cli.train_bench [--block=10] [--blocks=3] \
        [--device=cpu] [--a.b.c=value ...]

The configuration is bench.py's flagship (3x64 SIREN, omega 30, bsize 16,
5 inner steps, 1024 inner and 1024 outer points, sample_with_replacement,
remat off, bc_weight 1) in f32: compute_dtype=None, since the bf16 path is
not ported. Dotted overrides apply on top (the tests shrink it).

After one warm-up block, `--blocks` blocks of `--block` outer steps run
timed; a host read of each block's losses and torch.cuda.synchronize() are
the barrier. Then one more block runs under torch.profiler. Prints one JSON
line:
- outer_steps_per_s, and residual_pt_evals_per_s counted as bench.py counts
  them: bsize * (K * inner_points + (K + 1) * outer_points) per step;
- draw_s_per_step: host seconds per step to draw the tasks and points and
  queue their copy to the device (draw_step_inputs alone, timed apart);
- from the profiled block: device-busy ms per step (the union of the CUDA
  kernels' intervals), the device's idle share of the block's wall time,
  kernel launches per outer step and the kernels that take the most device
  time (null on the CPU), and the host ops with the most self time (on
  either device: PyTorch's dispatch, autograd and vmap work per op);
- max_memory_allocated_bytes (torch.cuda.max_memory_allocated; null on the
  CPU), and the card's name and power limit from nvidia-smi.
"""

import json
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

from ..config import Config, FieldConfig, MamlConfig, TaskConfig, TrainConfig, parse_overrides
from ..device import pop_device_flag
from ..train import maml_driver
from .profile_deploy import _busy_us

FLAGSHIP = Config(
    task=TaskConfig(pde="poisson", inner_points=1024, outer_points=1024,
                    validation_points=1024, n_eval=8, bc_weight=1.0,
                    sample_with_replacement=True),
    model=FieldConfig(num_layers=3, layer_size=64, omega=30.0, omega0=30.0,
                      compute_dtype=None),
    maml=MamlConfig(bsize=16, inner_steps=5, inner_lr=1e-4, outer_lr=1e-5,
                    inner_grad_clip=100.0, grad_clip=100.0, unroll=5),
    train=TrainConfig(remat_inner_steps=False),
)


def nvidia_smi():
    """nvidia-smi's name and power limit of the cards, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run(cfg: Config, device, block: int = 10, blocks: int = 3):
    c = maml_driver.build(cfg, device)
    gen = c["generator"]
    state = (c["init_params"], c["inner_lrs"], c["outer_opt"].init(c["init_params"]),
             c["lr_opt"].init(c["inner_lrs"]))
    many = c["train_step_many"]
    on_card = device.type == "cuda"

    def run_block():
        nonlocal state
        out = many(gen, *state, n_steps=block)
        state = out[:4]
        ml = out[7].cpu()  # host read: the barrier
        maml_driver.device_barrier(device)
        return ml

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    run_block()  # warm-up
    t0 = time.perf_counter()
    for _ in range(blocks):
        ml = run_block()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(ml).all()):
        raise RuntimeError(f"non-finite meta-losses in the timed blocks: {ml.tolist()}")
    steps_per_s = blocks * block / dt

    draw_gen = torch.Generator().manual_seed(cfg.seed + 1)
    t0 = time.perf_counter()
    for _ in range(block):
        c["draw_step_inputs"](draw_gen)
    draw_s = (time.perf_counter() - t0) / block
    maml_driver.device_barrier(device)

    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_block()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    busy_us = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    measured = on_card and bool(kernels)
    ops = prof.key_averages()

    K = cfg.maml.inner_steps
    pt_evals = cfg.maml.bsize * (K * cfg.task.inner_points + (K + 1) * cfg.task.outer_points)
    row = {
        "bench": "train_step_many",
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "nvidia_smi": nvidia_smi() if on_card else None,
        "torch": torch.__version__,
        "config": {"bsize": cfg.maml.bsize, "inner_steps": K,
                   "inner_points": cfg.task.inner_points,
                   "outer_points": cfg.task.outer_points,
                   "layers": cfg.model.num_layers, "width": cfg.model.layer_size,
                   "compute_dtype": cfg.model.compute_dtype,
                   "remat": cfg.train.remat_inner_steps,
                   "sample_with_replacement": cfg.task.sample_with_replacement},
        "block": block,
        "blocks": blocks,
        "outer_steps_per_s": steps_per_s,
        "residual_pt_evals_per_s": steps_per_s * pt_evals,
        "draw_s_per_step": draw_s,
        "profiled_wall_ms_per_step": wall_us / block / 1e3,
        "device_busy_ms_per_step": busy_us / block / 1e3 if measured else None,
        "device_idle_share": 1.0 - busy_us / wall_us if measured else None,
        "kernels_per_step": len(kernels) / block if measured else None,
        "top_kernels_ms_per_step": (
            {name[:80]: us / block / 1e3 for name, us in
             sorted(by_name.items(), key=lambda kv: -kv[1])[:6]} if measured else None),
        "top_host_ops_self_ms_per_step": {
            e.key[:60]: e.self_cpu_time_total / block / 1e3
            for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]},
        "host_ops_per_step": sum(e.count for e in ops) / block,
        "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                       if on_card else None),
        "final_meta_loss": float(ml[-1]),
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    block, blocks, rest = 10, 3, []
    for a in argv:
        if a.startswith("--block="):
            block = int(a.split("=", 1)[1])
        elif a.startswith("--blocks="):
            blocks = int(a.split("=", 1)[1])
        else:
            rest.append(a)
    return run(parse_overrides(FLAGSHIP, rest), device, block=block, blocks=blocks)


if __name__ == "__main__":
    main()
