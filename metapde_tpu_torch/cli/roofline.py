"""Roofline / MFU measurement of the MAML train step on the card
(counterpart of metapde_tpu/cli/roofline.py, recast for the H100).

    python -m metapde_tpu_torch.cli.roofline [--layer_size=64] [--bsize=16]
        [--points=1024] [--inner_steps=5] [--num_layers=3] [--block=100]
        [--blocks=5] [--trace_dir=DIR] [--compute_dtype=bfloat16]
        [--no_remat] [--unroll=1] [--fast_sampler] [--device=cpu]

Times `--blocks` blocks of `--block` outer steps of the port's
train_step_many after one warm-up block, a device barrier
(torch.cuda.synchronize) before and after each block, and prints one JSON
line: steps/s, ms a step, matmul_gflops_per_step, sustained TFLOP/s, and
on a card in PEAKS the MFU against its dense bf16 peak and the roofline's
ridge point (FLOP a byte where the bf16 peak meets HBM bandwidth).

FLOPs: torch.utils.flop_counter.FlopCounterMode over one outer step
(train_step, backward included), so `matmul_gflops_per_step` counts the
matrix products (mm, bmm, addmm, and their batched forms under vmap),
their recompute under remat included, and not the elementwise work
(sines, the loss, Adam). XLA's cost_analysis, which the JAX tool reads,
has no PyTorch counterpart, nor has its "bytes accessed": the JAX tool's
mb_accessed_per_step, sustained_hbm_gbps, arithmetic_intensity and
hbm_util are left out rather than estimated.

The JAX tool's --bf16 stores the params in bfloat16 and computes in f32
through jnp's type promotion; torch does not promote mixed-dtype products,
so the flag is refused here: --compute_dtype=bfloat16 runs the bf16 chain
(models/siren.py) as bench.py's flagship does. --unroll sets
maml.unroll, which the port's inner loop (a Python loop) accepts and does
not need. --trace_dir writes a torch.profiler Chrome trace of one more
block (trace.json: host ops and, on a card, the CUDA kernels), not XLA's
format. CUDA unless given --device=cpu; on the CPU the MFU keys are
absent, as they are for a device not in PEAKS.
"""

import argparse
import json
import os
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..config import Config, FieldConfig, MamlConfig, TaskConfig, TrainConfig
from ..device import pop_device_flag
from ..train import loop, maml_driver
from .train_bench import nvidia_smi

# Dense peaks by torch.cuda.get_device_name(): NVIDIA's H100 SXM datasheet
# ("NVIDIA H100 Tensor Core GPU", H100 SXM column, without sparsity; the
# rates assume the card's 700 W limit): BF16 989.4 TFLOP/s, TF32 494.7,
# FP32 66.9, HBM3 3.35 TB/s. MFU is reported against the bf16 peak (the
# JAX tool's convention); the others are kept for reading it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.4, "tf32_tflops": 494.7,
                              "fp32_tflops": 66.9, "hbm_gbps": 3350.0},
}


def build_step(args, device):
    """The driver build of the flags' config and a fresh training state."""
    cfg = Config(
        task=TaskConfig(pde=args.pde, inner_points=args.points, outer_points=args.points,
                        validation_points=args.points, n_eval=2, bc_weight=1.0,
                        sample_with_replacement=args.fast_sampler),
        model=FieldConfig(num_layers=args.num_layers, layer_size=args.layer_size,
                          omega=30.0, omega0=30.0, compute_dtype=args.compute_dtype or None),
        maml=MamlConfig(bsize=args.bsize, inner_steps=args.inner_steps, inner_lr=1e-4,
                        outer_lr=1e-5, inner_grad_clip=100.0, grad_clip=100.0,
                        unroll=args.unroll),
        train=TrainConfig(remat_inner_steps=not args.no_remat),
    )
    c = maml_driver.build(cfg, device)
    state = (c["init_params"], c["inner_lrs"], c["outer_opt"].init(c["init_params"]),
             c["lr_opt"].init(c["inner_lrs"]))
    return c, state


def matmul_flops_per_step(c, state) -> int:
    """The matrix-product FLOPs of one outer step (FlopCounterMode)."""
    gen = torch.Generator().manual_seed(1)
    with FlopCounterMode(display=False) as counter:
        c["train_step"](gen, *state)
    return counter.get_total_flops()


def parse_args(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--pde", default="poisson")
    p.add_argument("--layer_size", type=int, default=64)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--bsize", type=int, default=16)
    p.add_argument("--points", type=int, default=1024)
    p.add_argument("--inner_steps", type=int, default=5)
    p.add_argument("--block", type=int, default=100, help="outer steps a timed block")
    p.add_argument("--blocks", type=int, default=5, help="timed blocks")
    p.add_argument("--trace_dir", default="",
                   help="also write a torch.profiler trace of one block")
    p.add_argument("--bf16", action="store_true",
                   help="refused: see the module docstring; use --compute_dtype=bfloat16")
    p.add_argument("--compute_dtype", default="",
                   help="model.compute_dtype (bfloat16: the bf16 chain)")
    p.add_argument("--no_remat", action="store_true", help="train.remat_inner_steps off")
    p.add_argument("--unroll", type=int, default=1, help="maml.unroll")
    p.add_argument("--fast_sampler", action="store_true",
                   help="task.sample_with_replacement")
    return p.parse_args(argv)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    args = parse_args(argv)
    if args.bf16:
        raise SystemExit("--bf16 (bf16 param storage with f32 compute by type promotion) "
                         "has no counterpart in torch; use --compute_dtype=bfloat16")

    c, state = build_step(args, device)
    flops_step = matmul_flops_per_step(c, state)
    gen, many = c["generator"], c["train_step_many"]

    def run_block(state):
        out = many(gen, *state, n_steps=args.block)
        return out[:4], out[7]

    state, ml = run_block(state)  # warm-up
    loop.device_barrier(device)
    seconds = 0.0
    for _ in range(args.blocks):
        loop.device_barrier(device)
        t0 = time.perf_counter()
        state, ml = run_block(state)
        loop.device_barrier(device)
        seconds += time.perf_counter() - t0
    if not bool(torch.isfinite(ml).all()):
        raise RuntimeError("non-finite meta loss during roofline run")

    if args.trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            state, ml = run_block(state)
            loop.device_barrier(device)
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "trace.json"))
        print(f"roofline: wrote profiler trace to {args.trace_dir}", file=sys.stderr)

    steps_per_sec = args.blocks * args.block / seconds
    tflops_sustained = flops_step * steps_per_sec / 1e12
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peak = PEAKS.get(kind, {})
    result = {
        "metric": "maml_train_step_roofline",
        "pde": args.pde,
        "device": kind,
        "nvidia_smi": nvidia_smi() if on_card else None,
        "config": {
            "layer_size": args.layer_size, "num_layers": args.num_layers,
            "bsize": args.bsize, "points": args.points, "inner_steps": args.inner_steps,
            "compute_dtype": args.compute_dtype or "float32", "remat": not args.no_remat,
            "unroll": args.unroll, "fast_sampler": args.fast_sampler,
            "block": args.block, "blocks": args.blocks,
        },
        "steps_per_sec": steps_per_sec,
        "ms_per_step": 1e3 / steps_per_sec,
        "matmul_gflops_per_step": flops_step / 1e9,
        "sustained_tflops": tflops_sustained,
    }
    if peak:
        result["mfu_vs_bf16_peak"] = tflops_sustained / peak["bf16_tflops"]
        result["ridge_flops_per_byte"] = peak["bf16_tflops"] * 1e12 / (peak["hbm_gbps"] * 1e9)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
