"""Ground-truth oracle self-convergence check (counterpart of
metapde_tpu/cli/gt_convergence.py): for each sampled task, solve at each
--resolutions entry and at --ref_resolution, evaluate both at shared
validation points, and report the relative MSE per resolution (the sweep
protocol of cli/solver_baseline).

    python -m metapde_tpu_torch.cli.gt_convergence --task.pde=poisson \
        --resolutions=4,8 --ref_resolution=16 --n_tasks=1

Prints one JSON line per resolution, {"resolution": r, "rel_mse": ...,
"time_per_solve_s": ...}, and a trailing summary line; --per_task adds a
line per task and resolution. --oracle=richardson sweeps the higher-order
pair (solve_hi / evaluate_gt_hi) against itself; --warm_chain and
--chain_down re-solve each task along a chain of resolutions warm-started
from its neighbour (pde.solve_warm: hyper_elasticity). --device=NAME:
CUDA unless given --device=cpu.

Tasks come from a host generator seeded --seed, task i's validation points
from one seeded 1000 + i (the JAX package uses PRNGKey(seed) and
PRNGKey(1000 + i)), so a card run and a CPU run check the same tasks.
"""

import json
import sys
import time

import numpy as np
import torch

from ..config import Config, parse_overrides
from ..device import DEFAULT_DEVICE, pop_device_flag, resolve_device
from ..pdes import get_pde
from ..train.baseline_driver import oracle_pde
from ..train.loop import device_barrier


def _timed_solve(solve, device):
    """(solve(), its seconds to a device barrier)."""
    device_barrier(device)
    t0 = time.perf_counter()
    gt = solve()
    device_barrier(device)
    return gt, time.perf_counter() - t0


def _vals(eval_fn, gt, pts):
    return eval_fn(gt, pts).detach().cpu().numpy().astype(np.float64)


def _task_row(pde, params, res, ref_resolution, gt, ref, num, den, task, flags=()):
    """The --per_task line of task `task` at one resolution."""
    row = {"resolution": res, "task": task, "rel_mse": num / max(den, 1e-30), **dict(flags)}
    if pde.effective_resolution is not None:
        # e.g. the hyperelasticity ligament floor can raise both solves to
        # one lattice, turning discretization error into f32-vs-f64 noise
        row["effective_resolution"] = int(pde.effective_resolution(params, res))
        row["ref_effective_resolution"] = int(pde.effective_resolution(params, ref_resolution))
    for name, g in (("gt", gt), ("ref", ref)):
        e = getattr(g, "final_energy", None)
        if e is not None:
            row[f"{name}_energy"] = float(e)
    return row


def run(cfg: Config, resolutions, ref_resolution: int, n_tasks: int = 4, n_points: int = 1024,
        seed: int = 0, per_task: bool = False, warm_chain: bool = False,
        chain_down: bool = False, task_index: int = None, oracle: str = "p1",
        device=DEFAULT_DEVICE):
    """The self-convergence rows, printed as JSON lines and returned."""
    device = resolve_device(str(device))
    # richardson: the higher-ORDER oracle against itself at ref_resolution
    pde = oracle_pde(get_pde(cfg.task), oracle, cfg.task.pde)
    solve_fn, eval_fn, solve_ref = pde.solve, pde.evaluate_gt, pde.solve_ref or pde.solve
    gen = torch.Generator().manual_seed(seed)
    tasks = [tuple(a.to(device) for a in pde.sample_params(gen)) for _ in range(n_tasks)]
    if task_index is not None:
        # one task of the same n_tasks draw, so rows stay comparable
        tasks = [tasks[task_index]]

    if warm_chain or chain_down:
        if pde.solve_warm is None:
            raise SystemExit(f"--warm_chain: {cfg.task.pde} has no solve_warm")
        return _run_warm_chain(cfg, pde, tasks, resolutions, ref_resolution, n_points,
                               per_task, chain_down, device)

    refs, pts = [], []
    for i, params in enumerate(tasks):
        gt, _ = _timed_solve(lambda: solve_ref(params, resolution=ref_resolution), device)
        refs.append(gt)
        pts.append(pde.sample_validation_points(torch.Generator().manual_seed(1000 + i),
                                                n_points, params, gt))
    ref_vals = [_vals(eval_fn, g, p) for g, p in zip(refs, pts)]

    rows = []
    for res in resolutions:
        num, den, dt = 0.0, 0.0, 0.0
        for i, (params, p, rv) in enumerate(zip(tasks, pts, ref_vals)):
            gt, secs = _timed_solve(lambda: solve_fn(params, resolution=res), device)
            dt += secs
            v = _vals(eval_fn, gt, p)
            num_i, den_i = float(np.sum((v - rv) ** 2)), float(np.sum(rv ** 2))
            num, den = num + num_i, den + den_i
            if per_task:
                print(json.dumps(_task_row(pde, params, res, ref_resolution, gt, refs[i],
                                           num_i, den_i, i)), flush=True)
        row = {"resolution": res, "rel_mse": num / max(den, 1e-30),
               "time_per_solve_s": dt / len(tasks)}
        if oracle != "p1":
            row["oracle"] = oracle
        rows.append(row)
        print(json.dumps(row), flush=True)

    summary = {"pde": cfg.task.pde, "ref_resolution": ref_resolution, "n_tasks": n_tasks,
               "n_points": n_points,
               "rel_mse_by_resolution": {str(r["resolution"]): r["rel_mse"] for r in rows}}
    if oracle != "p1":
        summary["oracle"] = oracle
    print(json.dumps(summary), flush=True)
    return rows


def _run_warm_chain(cfg, pde, tasks, resolutions, ref_resolution, n_points, per_task,
                    down, device):
    """Task-major branch-tracked sweep: each solve warm-starts from a
    neighbouring resolution's solution of the same task (pde.solve_warm),
    so the chain stays on one energy branch. Upward (down=False): coarse ->
    fine -> reference, seeded by the coarsest from-scratch solve. Downward:
    the float64 reference from scratch first, then fine -> coarse seeded on
    the reference's branch (the branch-consistent protocol; the JAX
    package's docstring gives the near-limit task it was built for)."""
    res_order = sorted(resolutions)
    acc = {r: [0.0, 0.0, 0.0] for r in res_order}  # num, den, seconds
    flags = {"warm_chain": True, **({"chain_down": True} if down else {})}

    for i, params in enumerate(tasks):
        sols = []
        if down:
            ref, _ = _timed_solve(lambda: pde.solve_warm(params, ref_resolution, None, ref=True),
                                  device)
            prev = ref
            for res in sorted(res_order, reverse=True):
                gt, secs = _timed_solve(lambda: pde.solve_warm(params, res, prev), device)
                sols.append((res, gt, secs))
                prev = gt
        else:
            prev = None
            for res in res_order:
                gt, secs = _timed_solve(lambda: pde.solve_warm(params, res, prev), device)
                sols.append((res, gt, secs))
                prev = gt
            ref, _ = _timed_solve(lambda: pde.solve_warm(params, ref_resolution, prev, ref=True),
                                  device)
        p = pde.sample_validation_points(torch.Generator().manual_seed(1000 + i), n_points,
                                         params, ref)
        rv = _vals(pde.evaluate_gt, ref, p)
        den_i = float(np.sum(rv ** 2))
        for res, gt, secs in sols:
            num_i = float(np.sum((_vals(pde.evaluate_gt, gt, p) - rv) ** 2))
            acc[res][0] += num_i
            acc[res][1] += den_i
            acc[res][2] += secs
            if per_task:
                print(json.dumps(_task_row(pde, params, res, ref_resolution, gt, ref, num_i,
                                           den_i, i, flags)), flush=True)

    rows = []
    for res in res_order:
        num, den, dt = acc[res]
        row = {"resolution": res, "rel_mse": num / max(den, 1e-30),
               "time_per_solve_s": dt / len(tasks), **flags}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"pde": cfg.task.pde, "ref_resolution": ref_resolution, "n_tasks": len(tasks),
               "n_points": n_points, **flags,
               "rel_mse_by_resolution": {str(r["resolution"]): r["rel_mse"] for r in rows}}
    print(json.dumps(summary), flush=True)
    return rows


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device, argv = pop_device_flag(argv)
    opts = dict(resolutions=[12, 24, 48], ref_resolution=96, n_tasks=4, n_points=1024, seed=0,
                per_task=False, warm_chain=False, chain_down=False, task_index=None,
                oracle="p1")
    ints = ("ref_resolution", "n_tasks", "n_points", "seed", "task_index")
    passthrough = []
    for a in argv:
        name, _, value = a[2:].partition("=")
        if a in ("--per_task", "--warm_chain", "--chain_down"):
            opts[a[2:]] = True
        elif name == "oracle":
            opts["oracle"] = value
        elif name == "resolutions":
            opts["resolutions"] = [int(x) for x in value.split(",")]
        elif name in ints:
            opts[name] = int(value)
        else:
            passthrough.append(a)
    cfg = parse_overrides(Config(), passthrough)
    return run(cfg, device=device, **opts)


if __name__ == "__main__":
    main()
