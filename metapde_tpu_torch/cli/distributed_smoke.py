"""Sharded MAML (or LEAP) step against the one-process step, rank
processes on localhost (counterpart of metapde_tpu/cli/distributed_smoke.py).

For each mesh DPxPT the orchestrator starts DP * PT rank processes on a
free localhost port, each in a session of its own (killed when the
orchestrator ends, fails or is sent SIGTERM), and consecutive meshes of
one rank count share the launch and its process group; before the first
launch's process group starts, its ranks take the unsharded step (the
reference) of each variant, variant i on rank i mod ranks, in parallel.
Each run builds the MAML driver from the same config and seed,
draws the first outer step on the host, takes its meta-gradient (grad_fn)
and the step (step_core), then --timed_steps more steps; the ranks run
the (dp, pt) mesh of parallel/. Rank 0 and each reference save
their meta-gradient and losses; the orchestrator holds the sharded ones
against the reference's: params_norm_after_step and mean_meta_loss within
--tol relative (2e-5, as in the JAX package), every meta-gradient leaf
within --grad_bar of its largest |entry| and the per-task losses within
rtol --loss_bar (MAML defaults 1e-4 in f32, 1e-2 with a bf16 compute
dtype; LEAP, whose increments carry a difference of two losses, 2e-2 and
1e-5, tests/test_torch_leap.py's parity bars). Each rank takes
cpu_count / ranks intra-op threads.

    python -m metapde_tpu_torch.cli.distributed_smoke [--algo=maml|leap]
        [--num_processes=4] [--meshes=2x1,1x2,2x2] [--device=cuda|cpu]
        [--backend=nccl|gloo] [--tol=2e-5] [--timed_steps=2]
        [--variant="FLAGS" ...]
        [config flags, e.g. --maml.bsize=16 or --from_run=DIR]

Each --variant="FLAGS" (repeatable; FLAGS are config flags, quoted as a
shell quotes them, appended to the common config flags) is a run the
launch takes in turn in the same rank processes (one start-up and one
process group a mesh), each against its own one-process step and bars,
with a line printed for each: e.g. --variant=--model.compute_dtype=null
--variant=--model.compute_dtype=bfloat16 for both dtypes, or
--variant=--from_run=A --variant=--from_run=B for two runs' configs.

--num_processes=N alone runs the (N/2 x 2) mesh. Without --backend the
ranks take parallel/mesh.py's rule (nccl when every rank has its own card,
gloo when they share one, gloo on the CPU). On a card, rank 0 also
profiles one step of each mesh while the other ranks take it unprofiled
(a reference profiles none): device launches, device-busy ms, idle
share, and the device ms of NCCL's kernels; every rank counts its
collectives (calls, bytes, host ms of the blocking calls: the counters and
spans of utils/spans.py). Each row's stage_s gives the
seconds of its stages: build, the compared step, the timed steps and the
profiled one; rank 0's also the start-up from the orchestrator's launch
(interpreter and imports), the references it took before its process group,
and the group's start. Prints one JSON line and exits 0 only on
agreement.
"""

import argparse
import atexit
import contextlib
import json
import math
import os
import shlex
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..config import Config, parse_overrides

RUN_TIMEOUT_S = 900  # one reference or one mesh's ranks
DEFAULT_FLAGS = ["--task.inner_points=128", "--task.outer_points=128",
                 "--task.validation_points=128", "--task.n_eval=2",
                 "--model.num_layers=3", "--model.layer_size=64", "--maml.inner_steps=2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leaf_err(got, want):
    """The largest |got - want| over leaves, each over its leaf's scale."""
    from ..utils.trees import tree_leaves
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _rel(a, b):
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


# --- a rank (or the reference) -----------------------------------------------

def _profile_step(fn):
    """fn() once under torch.profiler on the card: launches, device-busy ms,
    idle share, NCCL kernels' device ms."""
    from torch.autograd import DeviceType

    from .profile_deploy import _busy_us
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    busy = _busy_us((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                    for e in events)
    nccl = [e for e in events if "nccl" in e.name().lower()]
    return {"launches": len(events), "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "nccl_kernels": len(nccl), "nccl_device_ms": sum(e.duration_ns() for e in nccl) / 1e6}


def _variants(args, flags):
    """The config flags of each run a launch takes: the common flags, with
    each --variant's appended."""
    return [flags + shlex.split(v) for v in args.variant] if args.variant else [flags]


def _measure(args, flags, device, mesh, backend, tag=""):
    """Build on `mesh` ("1x1": unsharded, no process group), take the
    compared step, then the timed and the profiled steps; rank 0 saves
    <out>/<mesh><tag>.pt (meta-gradient, losses, its row). Returns the
    row."""
    from ..models.siren import mixed_precision_scope
    from ..parallel import mesh as mesh_mod
    from ..train import leap_driver, maml_driver
    from ..utils import spans
    from ..utils.trees import global_norm, tree_map

    n_dp, n_pt = (int(x) for x in mesh.split("x"))
    cfg = parse_overrides(Config(), flags + [f"--mesh.n_task_shards={n_dp}",
                                             f"--mesh.n_point_shards={n_pt}"])
    maml = args.algo == "maml"
    stage_s, t_stage = {}, time.perf_counter()

    def stage(name):
        nonlocal t_stage
        now = time.perf_counter()
        stage_s[name] = now - t_stage
        t_stage = now

    c = (maml_driver if maml else leap_driver).build(cfg, device)
    dev = c["device"]
    stage("build")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mesh_mod.barrier(c["mesh"])

    params = c["init_params"]
    if maml:
        lrs = c["inner_lrs"]
        state = (params, lrs, c["outer_opt"].init(params), c["lr_opt"].init(lrs))
        n_state, meta_of = 4, lambda o: o[5][0]
    else:
        state, n_state, meta_of = (params, c["outer_opt"].init(params)), 2, lambda o: o[2][:, -1]
    gen = c["generator"]
    batch = c["draw_step_inputs"](gen)
    with mixed_precision_scope(c["model_cfg"]):
        if maml:
            grads, losses, (meta, _) = c["grad_fn"](batch, params, lrs)
        else:
            grads, losses = c["grad_fn"](batch, params)
            meta = losses[:, -1]
    out = c["step_core"](batch, *state)
    state = out[:n_state]
    pnorm, mloss = float(global_norm(state[0])), float(meta_of(out).mean())
    stage("compared")

    steps, draws, coll = [], [], []
    for _ in range(args.timed_steps):
        sync()
        with spans.recording() as rec:
            t0 = time.perf_counter()
            batch = c["draw_step_inputs"](gen)
            t1 = time.perf_counter()
            out = c["step_core"](batch, *state)
            state = out[:n_state]
            float(meta_of(out).mean())  # the loop's host read
            sync()
            steps.append(time.perf_counter() - t0)
        draws.append(t1 - t0)
        coll.append({"calls": rec.counters.get("collective.calls", 0),
                     "bytes": rec.counters.get("collective.bytes", 0),
                     "host_ms": 1e-6 * sum(s.end_ns - s.start_ns for s in rec.spans
                                           if s.name == "collective")})
    stage("timed")
    row = {"role": "reference" if c["mesh"] is None else f"rank{args.process_id}",
           "algo": args.algo, "mesh": mesh, "backend": backend, "device": str(dev),
           "params_norm_after_step": pnorm, "mean_meta_loss": mloss,
           "compute_dtype": cfg.model.compute_dtype}
    if steps:
        row.update(steps_per_s=1.0 / statistics.mean(steps),
                   draw_s_per_step=statistics.mean(draws), collectives_per_step=coll[-1])
    if dev.type == "cuda" and steps and c["mesh"] is not None:
        batch = c["draw_step_inputs"](gen)
        sync()
        # twice, the second kept: the profiler's first start in a process takes
        # seconds, which a collective of the other ranks would spin through;
        # only rank 0's profile is printed, so the others take the step bare
        for _ in range(2):
            if args.process_id == 0:
                row["profiled_step"] = _profile_step(lambda: c["step_core"](batch, *state))
            else:
                c["step_core"](batch, *state)
            sync()
        row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        stage("profiled")
    sync()
    row["stage_s"] = stage_s
    if args.process_id == 0 or c["mesh"] is None:
        cpu = lambda t: t.detach().float().cpu()  # noqa: E731
        torch.save({"grads": tree_map(cpu, grads), "losses": cpu(losses), "meta": cpu(meta),
                    "row": row}, Path(args.out) / f"{mesh}{tag}.pt")
    return row


def worker_main(args, flags):
    """A rank; with --with_reference (the ranks of the first launch) it
    first takes the one-process step of its share of the variants (i mod
    ranks), before its process group starts, which spares the references
    processes of their own and takes them in parallel. With several
    variants (--variant) it takes each in turn, so the variants share one
    start-up and one process group."""
    from ..device import resolve_device
    from ..parallel import mesh as mesh_mod

    # seconds from the orchestrator's launch to here: interpreter, imports
    start_s = time.time() - float(os.environ.get("SMOKE_LAUNCH_TIME", time.time()))
    device = resolve_device(args.device)
    # the ranks share the host's cores (the host draw, the CPU's kernels)
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // args.num_processes))
    variants = _variants(args, flags)
    t0 = time.perf_counter()
    if args.with_reference:
        for i, f in enumerate(variants):
            if i % args.num_processes == args.process_id:
                _measure(args, f, device, "1x1", None, f"_{i}")
    if device.type == "cuda" and args.timed_steps and args.process_id == 0:
        # the profiler's first start in a process takes seconds: take it
        # before the process group, not in the profiled step
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    backend = mesh_mod.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id, backend=args.backend,
        device_type=device.type)
    t2 = time.perf_counter()
    rows = [_measure(args, f, device, mesh, backend, f"_{i}")
            for mesh in args.mesh.split(",") for i, f in enumerate(variants)]
    rows[0]["stage_s"].update(start=start_s, reference=t1 - t0, process_group=t2 - t1)
    if args.process_id == 0:
        for row in rows:
            print(json.dumps(row), flush=True)
    torch.distributed.destroy_process_group()


# --- the orchestrator ----------------------------------------------------------

class _Ranks:
    """The processes the orchestrator started, each in a session of its own,
    SIGKILLed (with their process groups) by close(), at exit and on
    SIGTERM."""

    def __init__(self):
        self.procs = []
        atexit.register(self.close)
        signal.signal(signal.SIGTERM, self._on_sigterm)

    def start(self, cmd, env):
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, start_new_session=True)
        self.procs.append(proc)
        return proc

    def close(self):
        for proc in self.procs:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(proc.pid, signal.SIGKILL)
            with contextlib.suppress(Exception):
                proc.wait(timeout=10)
        self.procs = []

    def _on_sigterm(self, signum, frame):
        self.close()
        os._exit(128 + signum)


def _run(ranks, cmds, env, n_lines=1):
    """Run the commands at once; returns the first one's last n_lines JSON
    lines."""
    procs = [ranks.start(cmd, dict(env, **extra)) for cmd, extra in cmds]
    deadline = time.monotonic() + RUN_TIMEOUT_S
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        ranks.close()
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            sys.stderr.write(err[-6000:])
            raise RuntimeError(f"process {i} of {len(procs)} exited {p.returncode}")
    return [json.loads(l) for l in outs[0][0].strip().splitlines()[-n_lines:]]


def orchestrate(args, flags):
    repo = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=repo)
    base = [sys.executable, "-m", "metapde_tpu_torch.cli.distributed_smoke",
            f"--algo={args.algo}", f"--device={args.device}",
            f"--timed_steps={args.timed_steps}"]
    if args.backend:
        base.append(f"--backend={args.backend}")
    base += [f"--variant={v}" for v in args.variant or ()]
    meshes = args.meshes.split(",") if args.meshes else [f"{args.num_processes // 2}x2"]
    variants = _variants(args, flags)
    bars = []
    for f in variants:
        bf16 = parse_overrides(Config(), f).model.compute_dtype is not None
        bars.append((args.grad_bar or (1e-2 if bf16 else 1e-4 if args.algo == "maml" else 2e-2),
                     args.loss_bar or (1e-2 if bf16 else 1e-4 if args.algo == "maml" else 1e-5)))
    ranks = _Ranks()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        common = base + [f"--out={out}"]
        rows = [[] for _ in variants]
        refs = [None for _ in variants]
        # consecutive meshes of one rank count share a launch of the ranks
        launches = []
        for mesh in meshes:
            n = math.prod(int(x) for x in mesh.split("x"))
            if launches and launches[-1][0] == n:
                launches[-1][1].append(mesh)
            else:
                launches.append((n, [mesh]))
        for n, group in launches:
            port = _free_port()
            cmds = [(common + [f"--process_id={r}", f"--num_processes={n}",
                               f"--mesh={','.join(group)}",
                               f"--coordinator=tcp://127.0.0.1:{port}"]
                     + (["--with_reference"] if refs[0] is None else []) + flags,
                     {"LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(n), "WORLD_SIZE": str(n)})
                    for r in range(n)]
            t1 = time.perf_counter()
            got_rows = _run(ranks, cmds, dict(env, SMOKE_LAUNCH_TIME=repr(time.time())),
                            len(group) * len(variants))
            seconds = time.perf_counter() - t1
            for k, row in enumerate(got_rows):
                mesh, i = group[k // len(variants)], k % len(variants)
                if refs[i] is None:
                    refs[i] = torch.load(Path(out) / f"1x1_{i}.pt")
                ref = refs[i]["row"]
                got = torch.load(Path(out) / f"{mesh}_{i}.pt")
                diffs = {k: abs(ref[k] - row[k]) / max(abs(ref[k]), 1e-12)
                         for k in ("params_norm_after_step", "mean_meta_loss")}
                errs = {"meta_grad_leaf_err": _leaf_err(got["grads"], refs[i]["grads"]),
                        "losses_rel": _rel(got["losses"], refs[i]["losses"]),
                        "meta_losses_rel": _rel(got["meta"], refs[i]["meta"])}
                grad_bar, loss_bar = bars[i]
                agree = (all(d <= args.tol for d in diffs.values())
                         and errs["meta_grad_leaf_err"] <= grad_bar
                         and max(errs["losses_rel"], errs["meta_losses_rel"]) <= loss_bar)
                rows[i].append({"mesh": mesh, "ok": agree, "rel_diffs": diffs, **errs,
                                "seconds": seconds, "rank0": row})
    ok = True
    for i, f in enumerate(variants):
        ok = ok and all(r["ok"] for r in rows[i])
        print(json.dumps({"ok": all(r["ok"] for r in rows[i]), "meshes": rows[i],
                          "reference": refs[i]["row"], "tol": args.tol, "grad_bar": bars[i][0],
                          "loss_bar": bars[i][1], "flags": f,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return ok


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--algo", choices=("maml", "leap"), default="maml")
    p.add_argument("--num_processes", type=int, default=4)
    p.add_argument("--meshes", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    p.add_argument("--tol", type=float, default=2e-5)
    p.add_argument("--grad_bar", type=float, default=None)
    p.add_argument("--loss_bar", type=float, default=None)
    p.add_argument("--timed_steps", type=int, default=2)
    p.add_argument("--variant", action="append")
    # set by the orchestrator in the processes it starts
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--mesh", default="1x1")
    p.add_argument("--out", default=None)
    p.add_argument("--with_reference", action="store_true")
    args, flags = p.parse_known_args(argv)
    if not args.variant and not any(f.startswith("--from_run=") for f in flags):
        flags = DEFAULT_FLAGS + flags
    if args.process_id is None:
        sys.exit(0 if orchestrate(args, flags) else 1)
    worker_main(args, flags)


if __name__ == "__main__":
    main()
