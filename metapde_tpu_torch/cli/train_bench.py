"""Meta-training throughput of the port: train_step_many on the flagship.

    python -m metapde_tpu_torch.cli.train_bench [--block=10] [--blocks=3] \
        [--device=cpu] [--a.b.c=value ...]

The configuration is bench.py's flagship, as bench.py sets it: 3x64 SIREN,
omega 30, compute_dtype="bfloat16", bsize 16, 5 inner steps, 1024 inner and
1024 outer points, sample_with_replacement, remat off, bc_weight 1. Dotted
overrides apply on top: --model.compute_dtype=null times the f32 chain, and
the tests shrink it.

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
  CPU), and the card's name and power limit from nvidia-smi;
- under a compute dtype, the form of its products (bf16_gemm: "upcast",
  models/siren.py _mixed_dots) and what bf16_gemm_support finds of
  torch's bf16 GEMM with an f32 output on this device.
"""

import json
import subprocess
import sys
import time
import warnings
from collections import defaultdict

import torch
from torch.autograd import DeviceType

from ..config import Config, FieldConfig, MamlConfig, TaskConfig, TrainConfig, parse_overrides
from ..device import pop_device_flag
from ..train import loop, maml_driver
from .profile_deploy import _busy_us

FLAGSHIP = Config(
    task=TaskConfig(pde="poisson", inner_points=1024, outer_points=1024,
                    validation_points=1024, n_eval=8, bc_weight=1.0,
                    sample_with_replacement=True),
    model=FieldConfig(num_layers=3, layer_size=64, omega=30.0, omega0=30.0,
                      compute_dtype="bfloat16"),
    maml=MamlConfig(bsize=16, inner_steps=5, inner_lr=1e-4, outer_lr=1e-5,
                    inner_grad_clip=100.0, grad_clip=100.0, unroll=5),
    train=TrainConfig(remat_inner_steps=False),
)


def bf16_gemm_support(device) -> dict:
    """Probe torch.mm(a, w, out_dtype=torch.float32) on bf16 operands on
    `device`: whether it has a kernel there (`kernel`), a torch.func.vmap
    batching rule, i.e. vmap runs it without the per-example fallback
    (`vmap`), and a double backward (`double_backward`). The meta-gradient
    would need all three for the mixed chain to use bf16 GEMMs
    (models/siren.py _mixed_dots). Each value is True or the reason it is
    not."""
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(2, 8, 4, generator=gen).to(dev)
    w = torch.randn(2, 4, 3, generator=gen).to(dev)

    def mm(a, w):
        return torch.mm(a.to(torch.bfloat16), w.to(torch.bfloat16), out_dtype=torch.float32)

    def attempt(fn):
        try:
            return fn()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"

    def vmapped():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.func.vmap(mm)(a, w)
        slow = [str(m.message) for m in seen if "batching rule" in str(m.message)]
        return slow[0][:200] if slow else True

    def double_backward():
        ag, wg = a[0].clone().requires_grad_(), w[0].clone().requires_grad_()
        g = torch.autograd.grad((mm(ag, wg) ** 2).sum(), (ag, wg), create_graph=True)
        torch.autograd.grad(sum(t.sum() for t in g), (ag, wg))
        return True

    out = {"kernel": attempt(lambda: mm(a[0], w[0]) is not None)}
    if out["kernel"] is not True:
        return {**out, "vmap": "no kernel", "double_backward": "no kernel"}
    return {**out, "vmap": attempt(vmapped), "double_backward": attempt(double_backward)}


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
        loop.device_barrier(device)
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
    loop.device_barrier(device)

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
        "bf16_gemm": "upcast" if cfg.model.compute_dtype else None,
        "bf16_gemm_support": (bf16_gemm_support(device)
                              if cfg.model.compute_dtype else None),
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
