"""Classical-solver baseline sweep (counterpart of
metapde_tpu/train/baseline_driver.py): the ground-truth solvers timed and
validated across resolution grids against a high-resolution reference
solve of the same tasks, the accuracy-vs-time data the paper compares
meta-learned deployment against (pipeline/baseline.sh).

Results: errors_by_resolution.json in the run dir, one entry per
resolution (and second-axis value): rel_mse, the mean over the n_eval tasks
of the squared error at the validation coords over the mean square of the
reference there; rel_mse_std, rel_mse_median; time_per_solve, the mean
seconds of one solve and its evaluation, the warm-up solve excluded, each
timed to a device barrier (torch.cuda.synchronize() on the card, where the
JAX package has block_until_ready).

The tasks are drawn on the host from a generator seeded cfg.seed and the
validation coords after them, so a card run and a CPU run sweep the same
tasks. `sweep` is the resolution loop over given tasks, coords and
reference values, so tests hand it JAX-drawn tasks.
"""

import json
import os

import numpy as np
import torch

from ..config import Config
from ..device import DEFAULT_DEVICE, resolve_device
from ..pdes import get_pde
from ..utils import Timer
from .loop import device_barrier
from .metrics import prepare_logging


def oracle_pde(pde, oracle: str, name: str):
    """The family with its solve and evaluation for `oracle`: "p1" (the
    production solver) or "richardson" (solve_hi and evaluate_gt_hi, also
    as the reference solve); raises for a family without solve_hi."""
    if oracle == "richardson":
        if pde.solve_hi is None:
            raise SystemExit(f"oracle=richardson: {name} has no solve_hi")
        return pde._replace(solve=pde.solve_hi, evaluate_gt=pde.evaluate_gt_hi,
                            solve_ref=pde.solve_hi)
    if oracle != "p1":
        raise ValueError(f"oracle={oracle!r}: use p1 or richardson")
    return pde


def _values(pde, gt, pts):
    """The ground truth at pts [V, d] as float64 numpy [V, out]."""
    v = pde.evaluate_gt(gt, pts)
    return v.detach().cpu().numpy().astype(np.float64).reshape(pts.shape[0], -1)


def reference(pde, params_list, gen, n_points: int, ref_res: int):
    """Reference solves at ref_res (the family's float64 solve_ref when it
    has one: an f32 reference's own error would floor the sweep; every task
    in one solve_ref_batched call where the family has it) and the
    validation coords drawn from `gen` after each. Returns (coords list,
    reference values list [V, out] float64 numpy)."""
    if pde.solve_ref_batched is not None:
        gts = pde.solve_ref_batched(params_list, resolution=ref_res)
    else:
        gts = [(pde.solve_ref or pde.solve)(p, resolution=ref_res) for p in params_list]
    coords, ref_vals = [], []
    for params, gt in zip(params_list, gts):
        pts = pde.sample_validation_points(gen, n_points, params, gt)
        coords.append(pts)
        ref_vals.append(_values(pde, gt, pts))
    return coords, ref_vals


def sweep(pde, params_list, coords, ref_vals, spatial_resolutions, ref_res: int, axis2=None,
          device=torch.device("cpu"), log=print):
    """Solve every task at each resolution below ref_res (crossed with the
    axis2 values) and hold it to the reference values at the coords.
    Returns {label: entry} as errors_by_resolution.json holds it."""
    ax2_name, ax2_values = axis2 if axis2 is not None else (None, (None,))
    results = {}
    for res in spatial_resolutions:
        if res >= ref_res:
            continue
        for v2 in ax2_values:
            # the JAX solves take a boundary_points keyword and ignore it;
            # the port's have none, so that axis reaches no solve here either
            kw = {} if v2 is None or ax2_name == "boundary_points" else {ax2_name: v2}
            # warm-up (excluded from the timing, as the reference times
            # each solve apart from set-up)
            pde.solve(params_list[0], resolution=res, **kw)
            device_barrier(device)
            errs, times = [], []
            for params, pts, ref in zip(params_list, coords, ref_vals):
                with Timer() as t:
                    gt = pde.solve(params, resolution=res, **kw)
                    v = pde.evaluate_gt(gt, pts)
                    device_barrier(device)
                v = v.detach().cpu().numpy().astype(np.float64).reshape(ref.shape)
                err = v - ref
                normalizer = np.mean(ref ** 2, axis=0, keepdims=True).mean()
                errs.append(float(np.mean(err ** 2 / max(normalizer, 1e-12))))
                times.append(t.interval)
            entry = {
                "rel_mse": float(np.mean(errs)),
                "rel_mse_std": float(np.std(errs)),
                # tail-dominated on hard families: the median beside the mean
                "rel_mse_median": float(np.median(errs)),
                "time_per_solve": float(np.mean(times)),
            }
            label = str(res) if v2 is None else f"{res},{ax2_name}={v2}"
            if v2 is not None:
                entry[ax2_name] = v2
            results[label] = entry
            log(f"res {label}: rel_mse {np.mean(errs):.3e} @ {np.mean(times):.4f}s/solve")
    return results


def run(cfg: Config, spatial_resolutions=(4, 8, 16, 32), axis2=None, oracle: str = "p1",
        device=DEFAULT_DEVICE):
    """Sweep solver accuracy-vs-time over `spatial_resolutions` on n_eval
    tasks, optionally crossed with a second axis: axis2 = (keyword, values),
    each value passed to pde.solve as that keyword (("num_tsteps", (33, 65))
    for td_burgers' time resolution, ("boundary_cap", (48, 96)) for
    hyper_elasticity's boundary refinement). oracle: "p1" or "richardson"
    (oracle_pde). Writes errors_by_resolution.json; returns its dict."""
    device = resolve_device(str(device))
    out_dir = cfg.train.out_dir or f"{cfg.task.pde}_solver_baseline"
    path, log, _ = prepare_logging(out_dir, cfg.train.expt_name)
    log(cfg.to_json())
    pde = oracle_pde(get_pde(cfg.task), oracle, cfg.task.pde)
    gen = torch.Generator().manual_seed(cfg.seed)
    params_list = [tuple(a.to(device) for a in pde.sample_params(gen))
                   for _ in range(cfg.task.n_eval)]
    ref_res = cfg.solver.ground_truth_resolution
    log(f"reference solves at resolution {ref_res}"
        + (" (x64 path)" if pde.solve_ref else ""))
    with Timer() as t:
        coords, ref_vals = reference(pde, params_list, gen, cfg.task.validation_points, ref_res)
        device_barrier(device)
    log(f"reference solves: {t.interval / len(params_list)} s a task")
    results = sweep(pde, params_list, coords, ref_vals, spatial_resolutions, ref_res, axis2,
                    device, log)
    if path is not None:
        with open(os.path.join(path, "errors_by_resolution.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results
