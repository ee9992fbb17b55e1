"""Deployment benchmark: accuracy vs wall time for k-step adaptation
(counterpart of metapde_tpu/cli/deploy_bench.py).

Load a meta-learned checkpoint, then for each k in --inner-steps-list adapt
to n_eval fresh tasks with k inner steps (MAML's learned-LR steps, LEAP's
Adam rollout, or with --deploy.optimizer=NAME k steps of a fresh optimizer
at deploy.inner_lr) and report the wall time per task and the error against
the FEM ground truth:

    python -m metapde_tpu_torch.cli.deploy_bench --algo=maml \
        --train.load_model_from_expt=results_poisson_maml/p30k_f32_s1 \
        --solver.ground_truth_resolution=32 --model.use_pallas_inference=true \
        --inner-steps-list=0,1,2,5 --task.n_eval=8 --checkpoint=best

    python -m metapde_tpu_torch.cli.deploy_bench --algo=leap \
        --from_run=results_poisson_leap/lp2_4 --model.use_pallas_inference=true \
        --task.n_eval=8 --inner-steps-list=0,5,20,60

    python -m metapde_tpu_torch.cli.deploy_bench --algo=maml \
        --from_run=results_burgers_maml/bm7_5 --model.use_pallas_inference=true \
        --task.n_eval=8 --inner-steps-list=0,1,2,5 --checkpoint=best

    python -m metapde_tpu_torch.cli.deploy_bench --algo=maml \
        --from_run=results_elasticity_maml/em7_9 --checkpoint=best \
        --model.use_pallas_inference=true --task.n_eval=8 \
        --inner-steps-list=0,1,2,5 --energy_audit

    python -m metapde_tpu_torch.cli.deploy_bench --algo=maml \
        --from_run=results_sburgers_maml/sbi10_2 --checkpoint=best \
        --model.use_pallas_inference=true --task.n_eval=4 \
        --inner-steps-list=0,10,20,40,80

(resolution 32 is the one p30k_f32_s1 trained with; from 32 up the FEM
solve takes the multigrid preconditioner; a td_burgers run's ground truth
is its FV solve at its own resolution, all eval tasks in one time loop; a
hyper_elasticity run's is the sparse-direct solve on the host at its
resolution raised by the ligament floor, and its validation scores the
mirrored field too; a steady_burgers run's is the FEM solve on the device
at its resolution (sbi10_2: 48), a poisson3d run's the exact solution). Runs on CUDA unless given
--device=cpu. Prints one JSON row per k, with the JAX CLI's keys plus the
device, and writes them to
deploy_bench_torch[_<deploy.optimizer>][_<compute_dtype>]_n<n_eval>[_best].jsonl
in the checkpoint dir, so the JAX CLI's rows
(deploy_bench[_<deploy.optimizer>][_<compute_dtype>]_n<n_eval>[_best].jsonl)
are never overwritten. The ground truths are cached in gt_cache_torch/ beside the
checkpoint dir, where the JAX CLI's cache is gt_cache/. The timing barrier
is torch.cuda.synchronize(). A validation call adapts every task and
evaluates them in one inference call: LEAP and the deploy.optimizer path
(under both algos) adapt all tasks in one batched rollout, MAML's
learned-LR path task by task; with the mirror (hyper_elasticity) the
inference call takes each task's coords and mirrored coords.

--energy_audit adds, per k, each task's MC domain energy of the adapted
model and of the ground-truth field on fixed audit points (task i's drawn
from a host generator seeded 31 + i), and the count of tasks where the
model's is within 2% of the oracle's or below (energy_parity_tasks: there
the error measures a branch disagreement, not the solution's quality).
deploy.n_starts > 1 deploys each task by the multi-start
(train/multistart.py) and records n_starts and jitter in the rows.
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np
import torch

from ..config import Config, parse_overrides
from ..device import pop_device_flag, resolve_device
from ..interop import params_from_numpy
from ..train import checkpoints as ckpt
from ..train import leap_driver, maml_driver
from ..train.gt_cache import task_cache_extra
from ..train.energy import audit_points, model_energies, oracle_energies
from ..train.loop import device_barrier, validation_kwargs
from ..train.multistart import make_score_fn
from ..train.validation import get_ground_truth, make_validation_fn, task_generator
from ..utils.trees import tree_map, tree_stack


def load_model(cfg: Config, c, which: str, device, algo: str = "maml"):
    """The checkpoint's model on `device`: (params, inner LRs) for MAML,
    params for LEAP; returns (model, state, fname, resolved_best)."""
    expt = cfg.train.load_model_from_expt
    if not expt:
        raise SystemExit("--train.load_model_from_expt is required")
    fname = None
    resolved_best = False
    if which == "best":
        fname = ckpt.best_checkpoint(expt)
        resolved_best = fname is not None
        if not fname:
            print("no checkpoint_best.pickle; falling back to latest")
    fname = fname or ckpt.latest_checkpoint(expt)
    if not fname:
        raise SystemExit(f"no checkpoint under {expt}")
    state = ckpt.load_checkpoint(fname)
    params = params_from_numpy(state["params"], device)
    print(f"loaded {fname}")
    if algo == "leap":
        return params, state, fname, resolved_best
    lrs = (params_from_numpy(state["inner_lrs"], device)
           if "inner_lrs" in state else c["inner_lrs"])
    return (params, lrs), state, fname, resolved_best


def eval_tasks(cfg: Config, pde, device):
    """The n_eval unseen tasks, their validation coords and ground truth at
    cfg.solver.ground_truth_resolution. Drawn on the host, so a CPU and a GPU
    run deploy on the same tasks. The ground truths are cached next to the
    run, in <dirname(expt)>/gt_cache_torch (the JAX CLI's cache there is
    gt_cache/, which this never touches)."""
    gen = torch.Generator().manual_seed(cfg.seed + 7919)
    gt_params = [tuple(a.to(device) for a in pde.sample_params(gen))
                 for _ in range(cfg.task.n_eval)]
    expt = cfg.train.load_model_from_expt
    cache_dir = os.path.join(os.path.dirname(expt.rstrip("/")) or ".", "gt_cache_torch")
    bundle = get_ground_truth(pde, gt_params, gen, cfg.task.validation_points,
                              cfg.solver.ground_truth_resolution, cache_dir=cache_dir,
                              cache_extra=task_cache_extra(cfg.task))
    print(f"ground truth at resolution {cfg.solver.ground_truth_resolution}: "
          f"{bundle.solves} solved, {bundle.cache_hits} read from {cache_dir}", flush=True)
    return bundle


def run(cfg: Config, algo: str = "maml", inner_steps_list=(0, 1, 2, 5, 10, 20),
        repeats: int = 3, which: str = "latest", energy_audit: bool = False,
        device="cuda"):
    drivers = {"maml": maml_driver, "leap": leap_driver}
    if algo not in drivers:
        raise ValueError(f"--algo={algo}: expected one of {sorted(drivers)}")
    device = resolve_device(str(device))
    c = drivers[algo].build(cfg, device)
    pde = c["pde"]
    model, state, fname, resolved_best = load_model(cfg, c, which, device, algo)
    bundle = eval_tasks(cfg, pde, device)

    # oracle-free quality signal: the self-computable total task loss of the
    # deployed model on a fixed fresh point draw
    score_fn = make_score_fn(pde, c["loss_fn"], c["field"],
                             cfg.deploy.score_points or cfg.task.validation_points)

    def adapted(k):
        """Every task's adapted params (leaves [T, ...]) from its validation
        generator, in one call of the driver's batched deployment."""
        gens = [task_generator(i) for i in range(cfg.task.n_eval)]
        return c["deploy_final_model_batched"](gens, model, tree_stack(bundle.gt_params), int(k))

    def self_losses(finals):
        with torch.no_grad():
            return torch.stack([score_fn(task_generator(1), tree_map(lambda x: x[i], finals), tp)
                                for i, tp in enumerate(bundle.gt_params)]).cpu().numpy()

    audit_pts = oracle_e = None
    if energy_audit:
        audit_pts = audit_points(pde, bundle.gt_params, cfg.task.validation_points)
        oracle_e = oracle_energies(pde, bundle, audit_pts).cpu().tolist()

    def audit_cols(finals):
        model_e = model_energies(pde, c["field"], finals, bundle.gt_params,
                                 audit_pts).cpu().tolist()
        return {"model_energy": model_e, "oracle_energy_mc": oracle_e,
                # tasks where the model matches or beats the oracle's sampled
                # energy within 2%: the error there is a branch disagreement
                "energy_parity_tasks": int(sum(m <= o * 1.02
                                               for m, o in zip(model_e, oracle_e)))}

    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu")
    rows = []
    for k in inner_steps_list:
        val_fn = make_validation_fn(
            pde, partial(c["make_coef_func_batched"], inner_steps=int(k)), cfg.task.n_eval,
            **validation_kwargs(cfg.task))
        val = val_fn(model, bundle.gt_params, bundle.coords, bundle.gt_vals)
        device_barrier(device)  # warm-up

        t0 = time.perf_counter()
        for _ in range(repeats):
            val = val_fn(model, bundle.gt_params, bundle.coords, bundle.gt_vals)
            device_barrier(device)
        dt = (time.perf_counter() - t0) / repeats
        # the adaptation that validation ran, once more, for the columns
        # that need the adapted params (the JAX CLI adapts for each)
        finals = adapted(k)
        sl = self_losses(finals)
        row = {
            "inner_steps": int(k),
            "n_eval": int(cfg.task.n_eval),
            "checkpoint": os.path.basename(fname),
            "checkpoint_step": int(state.get("step", -1)),
            "device": device_name,
            **({"n_starts": cfg.deploy.n_starts, "jitter": cfg.deploy.jitter}
               if cfg.deploy.n_starts > 1 else {}),
            **({"deploy_optimizer": cfg.deploy.optimizer,
                "deploy_inner_lr": cfg.deploy.inner_lr} if cfg.deploy.optimizer else {}),
            **({"compute_dtype": cfg.model.compute_dtype} if cfg.model.compute_dtype else {}),
            "time_per_task_s": dt / cfg.task.n_eval,
            "val_mse": float(val.mse),
            "val_rel_err": float(val.rel_err),
            "val_rel_err_std": float(val.rel_err_std),
            "val_rel_err_median": float(val.rel_err_median),
            "val_rel_err_p90": float(val.rel_err_p90),
            "self_loss_mean": float(np.mean(sl)),
            "self_loss_median": float(np.median(sl)),
            "self_loss_max": float(np.max(sl)),
            **(audit_cols(finals) if energy_audit else {}),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    # as the JAX CLI's suffix: an optimizer-protocol or mixed-precision
    # bench gets its own file
    suffix = "_torch" + (f"_{cfg.deploy.optimizer}" if cfg.deploy.optimizer else "")
    suffix += f"_{cfg.model.compute_dtype}" if cfg.model.compute_dtype else ""
    suffix += f"_n{cfg.task.n_eval}" + ("_best" if resolved_best else "")
    out = os.path.join(cfg.train.load_model_from_expt, f"deploy_bench{suffix}.jsonl")
    with open(out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"wrote {out}")
    return rows


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    algo, steps_list, repeats, which, rest = (
        "maml", (0, 1, 2, 5, 10, 20), 3, "latest", [])
    energy_audit = False
    for a in argv:
        if a.startswith("--algo="):
            algo = a.split("=", 1)[1]
        elif a.startswith("--inner-steps-list="):
            steps_list = tuple(int(x) for x in a.split("=", 1)[1].split(","))
        elif a.startswith("--repeats="):
            repeats = int(a.split("=", 1)[1])
        elif a.startswith("--checkpoint="):
            which = a.split("=", 1)[1]
        elif a == "--energy_audit":
            energy_audit = True
        else:
            rest.append(a)
    cfg = parse_overrides(Config(), rest)
    return run(cfg, algo=algo, inner_steps_list=steps_list, repeats=repeats,
               which=which, energy_audit=energy_audit, device=device)


if __name__ == "__main__":
    main()
