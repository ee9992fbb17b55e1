"""Ground truth and validation metrics
(counterpart of metapde_tpu/train/validation.py: the plain branch, the
per-timestep branch, the mirror-symmetric and the branch-aware branches,
and the ground-truth cache).

Metric semantics kept from the JAX package:
- val_mse: mean squared error of the k-step-adapted field against the
  ground truth at the validation coords, over all eval tasks.
- rel_sq_err: err^2 / mean(gt^2 over points); rel_err is its mean,
  rel_err_std the (population) std of the per-task means, rel_err_median and
  rel_err_p90 their median and 90th percentile (linear interpolation, as
  jnp.median and jnp.percentile).
- t_rel_sq_err (td_burgers, num_tsteps given): the validation coords cycle
  through the solver's time grid, so coord j * num_tsteps + i lies at time
  i; per time i, err^2 over the per-task, per-time mean of gt^2, averaged
  over tasks and tiles. The JAX package loops over the times; here one
  reshape [T, tiles, num_tsteps, D] gives the same numbers.
- symmetry (hyper_elasticity): the compressed porous sheet's solution is
  x-mirror symmetric, so the field is also scored mirrored (x -> 1 - x,
  u_x -> -u_x) and each task keeps the branch of smaller mse. As in the
  JAX package (and the reference's take_min), val_mse is then the SUM over
  tasks of the unmirrored branch's mse, while the relative errors use the
  selected branch's error.
- branch-aware (energy_fn given): a task is flagged when the adapted
  model's domain energy on fixed audit points is at most branch_margin
  times the oracle's through the same estimator while its relative error
  exceeds branch_err_threshold; rel_err_branch is the mean over the
  unflagged tasks (the plain mean when every task is flagged).
The JAX package vmaps make_coef_func over the tasks; here the coefficient
function takes every task at once (maml_driver's make_coef_func_batched).
With symmetry it adapts each task once and evaluates the coords and the
mirrored coords of every task in one inference call ([T, 2, V, d]), one
siren_fused launch; JAX's vmap adapts twice with the same key, which
gives the same params.
"""

from typing import Callable, NamedTuple

import torch

from ..pdes.registry import solve_many


class GroundTruthBundle(NamedTuple):
    gts: list              # per-task ground-truth tuples
    gt_vals: torch.Tensor  # [n_eval, V, out_dim]
    coords: torch.Tensor   # [n_eval, V, in_dim]
    gt_params: list        # per-task params tuples
    solves: int = 0        # ground truths solved by this call
    cache_hits: int = 0    # ground truths read from the cache


def get_ground_truth(pde, gt_params_list, gen, n_points, resolution,
                     cache_dir=None, cache_extra=None) -> GroundTruthBundle:
    """Solve each eval task and tabulate its values at `n_points` validation
    coords drawn from `gen`, on the task params' device. A family with
    solve_batched solves all the tasks (or all the cache misses) in one call.

    cache_dir: a GroundTruthCache directory (train/gt_cache.py). Eval tasks
    derive from a seed, so a resumed or repeated run reads its ground truths
    there instead of solving them again. cache_extra: the gt-affecting task
    fields for the key (gt_cache.task_cache_extra)."""
    cache = None
    if cache_dir:
        from .gt_cache import GroundTruthCache

        cache = GroundTruthCache(cache_dir)
        gts = cache.get_or_solve_many(pde, gt_params_list, resolution, extra_hparams=cache_extra)
    else:
        gts = solve_many(pde, gt_params_list, resolution)
    coords, vals = [], []
    for params, gt in zip(gt_params_list, gts):
        pts = pde.sample_validation_points(gen, n_points, params, gt)
        v = pde.evaluate_gt(gt, pts)
        coords.append(pts)
        vals.append(v[:, None] if v.ndim == 1 else v)
    return GroundTruthBundle(
        gts=gts, gt_vals=torch.stack(vals), coords=torch.stack(coords),
        gt_params=list(gt_params_list),
        solves=cache.solves if cache is not None else len(gts),
        cache_hits=cache.hits if cache is not None else 0)


class ValidationResult(NamedTuple):
    mse: torch.Tensor
    norms: torch.Tensor           # per-dim mean of gt^2
    rel_err: torch.Tensor         # mean relative squared error
    per_dim_rel_err: torch.Tensor
    rel_err_std: torch.Tensor     # std of per-task rel err
    rel_err_median: torch.Tensor
    rel_err_p90: torch.Tensor
    t_rel_sq_err: torch.Tensor = None  # [num_tsteps] per-timestep error, or None
    # branch-aware metrics (None unless make_validation_fn got an energy_fn)
    rel_err_branch: torch.Tensor = None  # mean per-task rel err of unflagged tasks
    branch_flags: torch.Tensor = None    # count of flagged tasks
    branch_mask: torch.Tensor = None     # [n_eval] bool, True = flagged


def task_generator(i: int, stream: int = 0) -> torch.Generator:
    """The fixed host generator of eval task i: every validation call draws
    the same adaptation points for a task (the JAX package's
    split(PRNGKey(0))), on every device. stream 2 is the branch audit's
    adaptation (the JAX package's split(PRNGKey(2)))."""
    return torch.Generator().manual_seed(stream * 2 ** 32 + i)


def mirror_x(coords):
    """x -> 1 - x of coords [..., d] (the JAX package's .at[..., 0].set)."""
    out = coords.clone()
    out[..., 0] = 1.0 - coords[..., 0]
    return out


def make_validation_fn(pde, make_coef_func: Callable, n_eval: int, num_tsteps: int = None,
                       symmetry: bool = False, energy_fn: Callable = None, audit_points=None,
                       oracle_energy=None, branch_margin: float = 1.02,
                       branch_err_threshold: float = 0.1):
    """Build the validation-error function; with num_tsteps (td_burgers) it
    also returns the per-timestep error, with symmetry (hyper_elasticity)
    it scores the mirrored field too (module docstring).

    make_coef_func: (gens, model, task_params, coords) -> [T, V] or
    [T, V, out] values of the adapted models at coords [T, V, d] (or
    [T, S, ...] at coords [T, S, V, d], S sets a task), for T = n_eval
    tasks with generators gens[i] and params task_params[i]; called once per
    validation call.

    Branch-aware validation: energy_fn(gens, model, task_params,
    audit_points) -> [T] domain energies of the adapted models on
    audit_points[i] (fixed across calls), oracle_energy [T] the ground
    truths' energies through the same estimator on the same points
    (train/energy.py::make_branch_kwargs builds all three).
    """
    branch_aware = energy_fn is not None
    if branch_aware:
        oracle_energy = torch.as_tensor(oracle_energy)

    def validation_error(model, gt_params, coords, gt_vals) -> ValidationResult:
        gens = [task_generator(i) for i in range(n_eval)]
        if symmetry:
            both = make_coef_func(gens, model, gt_params,
                                  torch.stack([coords, mirror_x(coords)], dim=1))
            both = both.reshape(both.shape[0], 2, both.shape[2], -1)
            coefs, coefs_m = both[:, 0], both[:, 1].clone()
            coefs_m[..., 0] *= -1.0  # the mirrored field: u_x -> -u_x
        else:
            coefs = make_coef_func(gens, model, gt_params, coords)
            coefs = coefs.reshape(coefs.shape[0], coefs.shape[1], -1)
        gt = gt_vals.reshape(coefs.shape)
        err = coefs - gt
        mse = torch.mean(err ** 2)
        if symmetry:
            mse_left = torch.mean(err ** 2, dim=(1, 2))
            err_right = coefs_m - gt
            use_right = mse_left > torch.mean(err_right ** 2, dim=(1, 2))
            err = torch.where(use_right[:, None, None], err_right, err)
            # the reference's take_min: the unmirrored mse, summed over tasks
            mse = torch.sum(mse_left)

        normalizer = torch.mean(gt ** 2, dim=1, keepdim=True)  # [T,1,D]
        rel_sq_err = err ** 2 / normalizer.mean(dim=2, keepdim=True)
        per_task_rel = torch.mean(rel_sq_err, dim=(1, 2))

        t_rel = None
        if num_tsteps is not None:
            n_tasks, _, dims = err.shape
            tiles = coords.shape[1] // num_tsteps
            cut = (n_tasks, tiles, num_tsteps, dims)
            t_err = err[:, :tiles * num_tsteps].reshape(cut)
            t_norm = torch.mean(gt[:, :tiles * num_tsteps].reshape(cut) ** 2, dim=1,
                                keepdim=True)  # [T, 1, nt, D]
            t_rel = torch.mean(t_err ** 2 / t_norm.mean(dim=3, keepdim=True), dim=(0, 1, 3))

        rel_err_branch = branch_flags = branch_mask = None
        if branch_aware:
            model_e = energy_fn([task_generator(i, 2) for i in range(n_eval)], model,
                                gt_params, audit_points).to(per_task_rel.device)
            branch_mask = ((model_e <= oracle_energy.to(model_e.device) * branch_margin)
                           & (per_task_rel > branch_err_threshold))
            keep = ~branch_mask
            # every task flagged: the plain mean
            rel_err_branch = per_task_rel[keep if bool(keep.any()) else ~keep].mean()
            branch_flags = torch.sum(branch_mask)
        return ValidationResult(
            mse=mse,
            norms=torch.mean(normalizer, dim=(0, 1)),
            rel_err=torch.mean(rel_sq_err),
            per_dim_rel_err=torch.mean(rel_sq_err, dim=(0, 1)),
            rel_err_std=torch.std(per_task_rel, unbiased=False),
            rel_err_median=torch.quantile(per_task_rel, 0.5),
            rel_err_p90=torch.quantile(per_task_rel, 0.9),
            t_rel_sq_err=t_rel,
            rel_err_branch=rel_err_branch,
            branch_flags=branch_flags,
            branch_mask=branch_mask,
        )

    return validation_error
