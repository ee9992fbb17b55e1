#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (metapde_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (flushed) with its name and seconds:
  0 device    torch and CUDA versions, nvidia-smi's name and power limit
  1 build     nvcc builds csrc/siren_fused.cu for sm_90a (or finds it built)
  2 kernel    siren_fused against its plain PyTorch version on the card, max
              |diff| <= 1e-5 on five configs at the main path's and larger
              shapes; CUDA-event times (median of 20 after 3 warm-ups) and the
              card's least time for the same work
  3 parity    a small deployment on the card and on the CPU, same tasks and
              points: metrics agree to 1e-2
  4 deploy    the Poisson MAML deployment path end to end through
              cli/deploy_bench: checkpoint results_poisson_maml/p30k_f32_s1,
              8 fresh tasks, FEM ground truth at resolution 16, k = 0, 1, 2, 5
              learned-LR steps, inference through the kernel; checks that the
              kernel launched, every value is finite, and the k = 5 median
              relative error beats k = 0 and is within 3x of the JAX package's
Then a JSON line with every kernel's numbers and the total seconds, and
last the ok line. A failed check raises: the exit code is then not 0. A
watchdog ends a hung run after 480 s with a traceback. Needs a CUDA device;
imports nothing of JAX or metapde_tpu.
"""

import faulthandler
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from metapde_tpu_torch.cli import deploy_bench
from metapde_tpu_torch.config import FieldConfig
from metapde_tpu_torch.models import make_field
from metapde_tpu_torch.ops import _build, siren_fused

faulthandler.dump_traceback_later(480, exit=True)

REPO = Path(__file__).resolve().parent
RUN_DIR = REPO / "results_poisson_maml" / "p30k_f32_s1"
KERNEL_TOL = 1e-5  # the bar of tests/test_pallas_siren.py
# Median val_rel_err at k=5 from the JAX package's own deploy_bench on the
# CPU, same checkpoint, resolution and k (command and output in PERF.md):
#   python -m metapde_tpu.cli.deploy_bench --algo=maml \
#     --train.load_model_from_expt=<copy of p30k_f32_s1> \
#     --model.use_pallas_inference=true --solver.ground_truth_resolution=16 \
#     --task.n_eval=8 --inner-steps-list=0,1,2,5 --checkpoint=best
JAX_CPU_K5_MEDIAN = 0.00021900353021919727
K5_FACTOR = 3.0
# card against CPU on the same deployment: the two FEM solves stop at
# different iterates inside the Newton tolerance, and sums run in other orders
PARITY_RTOL = 1e-2
# H100 SXM published peaks (dense, at the 700 W limit): f32 outside the
# tensor cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

T_START = time.perf_counter()


def emit(phase, t0, **numbers):
    print(json.dumps({"phase": phase, "s": time.perf_counter() - t0, **numbers}),
          flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def siren_bound_ms(cfg, n):
    """Least time for the fused chain on n points: matmul FLOPs over the f32
    peak against the bytes (x, params, out, each once) over HBM bandwidth."""
    h, L = cfg.layer_size, cfg.num_layers
    macs = cfg.in_dim * h + (L - 1) * h * h + h * cfg.out_dim
    n_params = macs + L * h + cfg.out_dim + cfg.in_dim + cfg.out_dim
    t_ops = 2.0 * macs * n / PEAK_F32_FLOPS
    t_bytes = 4.0 * (n * (cfg.in_dim + cfg.out_dim) + n_params) / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(smi, flush=True)
    emit("device", t0, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi)


def phase_build():
    t0 = time.perf_counter()
    res = _build.build("siren_fused")
    emit("build", t0, library=str(res.path.relative_to(REPO)), cached=res.cached,
         nvcc_s=res.seconds, nvcc_flags=" ".join(_build.NVCC_FLAGS),
         ptxas=[l.strip() for l in res.log.splitlines() if l.strip()])


def phase_kernel():
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dict(num_layers=3, layer_size=64, in_dim=2)
    cases = [  # (name, FieldConfig overrides, points)
        ("default", {}, 1500),
        ("no_log_scale", dict(log_scale=False), 1500),
        ("out_dim_2", dict(out_dim=2, squeeze_scalar=False), 1500),
        ("8_layers", dict(num_layers=8), 1500),
        ("main_path", {}, 1024),      # one eval task's validation points
        ("main_path_2pow20", {}, 1 << 20),
    ]
    results = {}
    for i, (name, kw, n) in enumerate(cases):
        cfg = FieldConfig(**{**base, **kw})
        gen = torch.Generator(device="cuda").manual_seed(1000 + i)
        params = make_field(cfg).init(gen, "cuda")
        x = torch.empty((n, cfg.in_dim), device="cuda").uniform_(-1.0, 1.0, generator=gen)
        out = siren_fused.siren_apply_fused(params, x, cfg)
        torch.cuda.synchronize()
        ref = siren_fused.siren_apply_fused_reference(params, x, cfg)
        if out.shape != ref.shape:
            raise AssertionError(f"{name}: kernel shape {tuple(out.shape)} "
                                 f"!= plain {tuple(ref.shape)}")
        err = float((out - ref).abs().max())
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain max|diff| {err} > {KERNEL_TOL}")
        row = {"n": n, "max_abs_err": err}
        if name.startswith("main_path"):
            row["ms"] = cuda_ms(lambda: siren_fused.siren_apply_fused(params, x, cfg))
            row["plain_ms"] = cuda_ms(
                lambda: siren_fused.siren_apply_fused_reference(params, x, cfg))
            row["bound_ms"], row["bound_by"] = siren_bound_ms(cfg, n)
        results[name] = row
    emit("kernel", t0, name="siren_fused", tol=KERNEL_TOL, cases=results)
    return results


def _deploy(tmp, args):
    """deploy_bench.main on a copy of the run dir under `tmp` (nothing is
    written into the repository)."""
    run_dir = Path(tmp) / RUN_DIR.name
    run_dir.mkdir(exist_ok=True)
    for f in ("checkpoint_best.pickle", "config.json"):
        shutil.copy(RUN_DIR / f, run_dir / f)
    return deploy_bench.main(["--algo=maml", f"--train.load_model_from_expt={run_dir}",
                              "--model.use_pallas_inference=true",
                              "--checkpoint=best", *args])


def phase_parity():
    """The same small deployment (2 tasks, FEM at resolution 8, k = 0 and 5)
    on the card and on the CPU: the tasks and points are drawn on the host,
    so both sides see the same inputs. The CPU side is the port's plain
    path, which tests/test_torch_deploy.py holds against the JAX package."""
    t0 = time.perf_counter()
    args = ["--solver.ground_truth_resolution=8", "--task.n_eval=2",
            "--task.validation_points=256", "--inner-steps-list=0,5", "--repeats=1"]
    with tempfile.TemporaryDirectory() as tmp:
        gpu = _deploy(tmp, args)
        cpu = _deploy(tmp, ["--device=cpu", *args])
    worst = 0.0
    for g, c in zip(gpu, cpu):
        for key in ("val_mse", "val_rel_err", "val_rel_err_median", "self_loss_mean"):
            rel = abs(g[key] - c[key]) / abs(c[key])
            worst = max(worst, rel)
            if not rel <= PARITY_RTOL:
                raise AssertionError(f"k={g['inner_steps']} {key}: card {g[key]} vs "
                                     f"cpu {c[key]} (rel {rel} > {PARITY_RTOL})")
    emit("parity", t0, rtol=PARITY_RTOL, worst_rel_diff=worst,
         card={r["inner_steps"]: r["val_rel_err_median"] for r in gpu},
         cpu={r["inner_steps"]: r["val_rel_err_median"] for r in cpu})


def phase_deploy():
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        siren_fused.siren_apply_fused.launches = 0
        rows = _deploy(tmp, ["--solver.ground_truth_resolution=16", "--task.n_eval=8",
                             "--inner-steps-list=0,1,2,5"])
        torch.cuda.synchronize()
        launches = siren_fused.siren_apply_fused.launches
    if launches <= 0:
        raise AssertionError("the deployment path never launched the siren_fused kernel")
    for r in rows:
        bad = [k for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"k={r['inner_steps']}: non-finite {bad}")
    med = {r["inner_steps"]: r["val_rel_err_median"] for r in rows}
    if sorted(med) != [0, 1, 2, 5]:
        raise AssertionError(f"deploy rows for k={sorted(med)}, expected 0, 1, 2, 5")
    if not med[5] < med[0]:
        raise AssertionError(f"k=5 median rel err {med[5]} not below k=0 {med[0]}")
    if not med[5] <= K5_FACTOR * JAX_CPU_K5_MEDIAN:
        raise AssertionError(f"k=5 median rel err {med[5]} above {K5_FACTOR} x the "
                             f"JAX CPU median {JAX_CPU_K5_MEDIAN}")
    emit("deploy", t0, launches=launches, median_rel_err=med,
         jax_cpu_k5_median=JAX_CPU_K5_MEDIAN,
         time_per_task_s={r["inner_steps"]: r["time_per_task_s"] for r in rows})
    return launches


def main():
    phase_device()
    phase_build()
    kern = phase_kernel()
    phase_parity()
    launches = phase_deploy()
    main_row, big = kern["main_path"], kern["main_path_2pow20"]
    kernels = [{
        "name": "siren_fused",
        "route": "cuda",
        "source": "metapde_tpu_torch/csrc/siren_fused.cu",
        "replaces": "metapde_tpu/ops/pallas_siren.py:91",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the chain
        "n": main_row["n"],
        "at_n_1048576": {k: big[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
    }]
    print(json.dumps({"kernels": kernels, "total_s": time.perf_counter() - T_START}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
    sys.exit(0)
