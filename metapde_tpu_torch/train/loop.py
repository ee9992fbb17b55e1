"""What the MAML and LEAP drivers share: the problem both build on, the
move of host draws to the device, the run directory, the eval tasks'
ground truth, and the meta-training loop of run() (the JAX package writes
that loop out in each driver).

A driver gives the loop its state as a dict keyed by checkpoint names: the
model parts in the JAX layout ("params", and MAML's "inner_lrs"), and one
entry per optimizer state ("opt_state", MAML's "lr_opt_state"), which the
port saves under "torch_<name>" so the JAX package never reads them.

Under a mesh (the driver's build holds it under "mesh") every rank runs
the loop and every step, and ends each step with the same state; rank 0
alone writes log.txt, metrics.jsonl, config.json and the checkpoints,
solves or reads the ground truth and validates, and every rank waits at a
barrier after its validation or checkpoint. The NaN abort reads the
gathered meta-losses, the same on every rank, so all stop together. A
resume loads the same checkpoint on every rank.
"""

import dataclasses
import json
import os
import traceback
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..config import Config
from ..interop import params_from_numpy
from ..models import make_field
from ..parallel.mesh import POINT_AXIS, barrier, gather_values, is_writer, make_mesh
from ..parallel.sharding import split_kinds
from ..pdes import get_pde
from ..utils import Timer, spans
from ..utils.trees import tree_leaves, tree_map, tree_stack
from . import checkpoints as ckpt
from . import viz
from .energy import make_branch_kwargs
from .gt_cache import task_cache_extra
from .metrics import prepare_logging
from .optimizers import from_jax_state
from .validation import get_ground_truth, make_validation_fn


def device_barrier(device):
    """Wait for the device's queued work (the timing barrier)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(tree, device):
    """Host tensors -> `device`; through pinned memory and without a host
    wait on CUDA, so drawing the next step overlaps the device's work (on
    the CPU the same tensors). Counts their bytes as `h2d_bytes`."""
    with spans.span("draw.to_device"):
        spans.count("h2d_bytes", sum(t.numel() * t.element_size() for t in tree_leaves(tree)))
        if device.type == "cpu":
            return tree
        return tree_map(lambda t: t.pin_memory().to(device, non_blocking=True), tree)


def problem(cfg: Config):
    """The parts both meta-learners' builds share: (pde, model_cfg, field,
    loss_fn, task_loss)."""
    pde = get_pde(cfg.task)
    model_cfg = dataclasses.replace(
        cfg.model, in_dim=pde.in_dim, out_dim=pde.out_dim,
        squeeze_scalar=pde.scalar,
    )
    field = make_field(model_cfg)

    def loss_fn(field_fn, points, params):
        boundary_losses, domain_losses = pde.loss_fn(field_fn, points, params)
        loss = cfg.task.bc_weight * sum(boundary_losses.values()) + sum(
            domain_losses.values()
        )
        return loss, {**boundary_losses, **domain_losses}

    def task_loss(field_params, points, task_params):
        """The loss of one task on one point set (vmapped over tasks)."""
        return loss_fn(field.bind(field_params), points, task_params)

    return pde, model_cfg, field, loss_fn, task_loss


def mesh_of(cfg: Config):
    """The (dp, pt) mesh of cfg.mesh over the started process group, or
    None for an unsharded run (parallel/mesh.py::make_mesh raises without a
    process group or for a world size other than the mesh's)."""
    if cfg.mesh.n_task_shards <= 1 and cfg.mesh.n_point_shards <= 1:
        return None
    return make_mesh(cfg.mesh.n_task_shards, cfg.mesh.n_point_shards)


def pt_split_note(pde, mesh, point_sets: dict) -> str:
    """The mesh line's account of the pt split (parallel/sharding.py): for
    each point set of `point_sets` (batch field -> points a set), the
    counts of the kinds given whole to every pt rank and of all its kinds,
    from one set of one task drawn from a generator of its own."""
    n_pt = mesh.shape[POINT_AXIS]
    if n_pt == 1:
        return ""
    gen = torch.Generator().manual_seed(0)
    task_params = tree_stack([pde.sample_params(gen)])
    parts = []
    for name, n in point_sets.items():
        counts = [p.shape[2] for p in pde.sample_points_batched(gen, n, task_params, 1)]
        whole = [c for c, s in zip(counts, split_kinds(counts, n_pt, pde.pooled_kinds))
                 if not s]
        parts.append(f"{name} {whole} of {counts}")
    return "; point kinds given whole to every pt rank: " + ", ".join(parts)


def validation_kwargs(task_cfg):
    """make_validation_fn's family options, by the JAX drivers' and
    deploy_bench's rule: td_burgers' per-timestep metric over num_tsteps,
    hyper_elasticity's mirror symmetry."""
    return dict(num_tsteps=task_cfg.num_tsteps if task_cfg.pde == "td_burgers" else None,
                symmetry=task_cfg.pde == "hyper_elasticity")


def start_run(cfg: Config, algo: str):
    """Open the run dir's log and metrics and write its config.json;
    returns (path, log, metrics)."""
    out_dir = cfg.train.out_dir or f"{cfg.task.pde}_{algo}_results"
    path, log, metrics = prepare_logging(out_dir, cfg.train.expt_name)
    log(cfg.to_json())
    if path is not None:
        with open(f"{path}/config.json", "w") as f:
            f.write(cfg.to_json())
    return path, log, metrics


def eval_ground_truth(cfg: Config, pde, eval_seed: int, device, log):
    """The eval tasks of `eval_seed` and their ground truth at the config's
    resolution, through the cache in <out_dir>/gt_cache_torch (the JAX
    package's <out_dir>/gt_cache holds JAX entries, which the port neither
    reads nor writes)."""
    gen = torch.Generator().manual_seed(eval_seed)
    gt_params = [tuple(a.to(device) for a in pde.sample_params(gen))
                 for _ in range(cfg.task.n_eval)]
    cache_dir = (os.path.join(cfg.train.out_dir, "gt_cache_torch")
                 if cfg.train.out_dir else None)
    bundle = get_ground_truth(pde, gt_params, gen, cfg.task.validation_points,
                              cfg.solver.ground_truth_resolution, cache_dir=cache_dir,
                              cache_extra=task_cache_extra(cfg.task))
    log(f"ground truth at resolution {cfg.solver.ground_truth_resolution}: "
        f"{bundle.solves} solved, {bundle.cache_hits} read from {cache_dir}")
    return bundle


def boundaries(cfg: Config, plots: bool) -> tuple:
    """The cadences that end a block: log_every and checkpoint_every, and
    viz_every for a driver that plots (the JAX MAML driver; its LEAP driver
    leaves viz_every out)."""
    if plots:
        return cfg.train.log_every, cfg.train.viz_every, cfg.train.checkpoint_every
    return cfg.train.log_every, cfg.train.checkpoint_every


def next_block(cfg: Config, step: int, everies: tuple) -> int:
    """Outer steps to take in one call from `step`: up to the next boundary
    of `everies` (boundaries()) or the end, at most train.steps_per_call."""
    spc = max(1, cfg.train.steps_per_call)
    if spc == 1:
        return 1
    n = cfg.train.outer_steps - step
    for every in everies:
        if every and every > 0:
            n = min(n, every - step % every)
    return max(1, min(n, spc))


def hit(cfg: Config, every: int, step: int) -> bool:
    """Whether the block that ended at `step` reaches an `every` boundary."""
    if every <= 0:
        return False
    return (step - 1) % every == 0 if cfg.train.steps_per_call <= 1 else step % every == 0


class Learner(NamedTuple):
    """What a driver gives the loop.

    opts: optimizer-state name -> (optimizer, the model part it updates,
      the optimizer's name in a JAX checkpoint's state).
    step: (generator, state, n_steps) -> (state, the last step's per-task
      losses [T, ...], its meta-gradient norm, the per-step meta-loss
      means [n_steps]), with no host read.
    model: state -> the model make_coef_func_batched adapts.
    val_meta_loss: state -> the meta-loss on the fixed validation draw.
    adapt: (model, task params, k) -> one task's k-step adaptation, for
      the plots of train.viz_every; None for a driver that, like the JAX
      LEAP driver, neither plots nor traces (viz_every and profile_dir
      are then ignored)."""

    name: str
    inner_steps: int
    opts: dict
    step: Callable
    model: Callable
    val_meta_loss: Callable
    adapt: Optional[Callable] = None


def _resume(cfg: Config, learner: Learner, s: dict, gen, device, log):
    """Load the latest checkpoint of cfg.train.load_model_from_expt into the
    state `s`: the model parts, then the optimizer states of the port's own
    checkpoint (with its generator, eval seed and next step, so the same
    trajectory continues exactly) or of a JAX checkpoint (its PRNG and eval
    keys drive JAX's threefry and cannot be replayed here). Returns
    (resume step, eval seed or None)."""
    fname = ckpt.latest_checkpoint(cfg.train.load_model_from_expt)
    if not fname:
        return 0, None
    state = ckpt.load_checkpoint(fname)
    for part in [k for k in s if k not in learner.opts]:
        if state.get(part) is not None:
            s[part] = params_from_numpy(state[part], device)
    log(f"loaded checkpoint {fname}")
    for d in ckpt.config_drift(cfg.train.load_model_from_expt, cfg):
        log(f"WARNING: config drift vs loaded run: {d}")
    for name, (opt, part, _) in learner.opts.items():
        s[name] = opt.init(s[part])
    try:
        if state.get("torch_opt_state") is not None:
            for name in learner.opts:
                s[name] = params_from_numpy(state[f"torch_{name}"], device, dtype=None)
            gen.set_state(torch.as_tensor(state["torch_rng_state"]))
            resume_step = int(state["torch_next_step"])
            log(f"resuming optimizer state at step {resume_step}")
            log("pinned eval tasks from checkpoint torch_eval_seed")
            return resume_step, int(state["torch_eval_seed"])
        if state.get("opt_state") is not None:
            for name, (_, _, jax_name) in learner.opts.items():
                if state.get(name) is not None:
                    s[name] = from_jax_state(jax_name, state[name], device)
            resume_step = int(state.get("step", 0)) + 1
            log(f"resuming optimizer state at step {resume_step} (JAX checkpoint: "
                "new task draws and eval tasks)")
            return resume_step, None
    except Exception as e:
        for name, (opt, part, _) in learner.opts.items():
            s[name] = opt.init(s[part])
        log(f"could not resume optimizer state ({e}); fresh optimizers")
    return 0, None


def train(cfg: Config, c: dict, learner: Learner, s: dict) -> dict:
    """The meta-training loop (the JAX package's run()): logs, resumes from
    the latest checkpoint of the port or of the JAX package, validates
    every `val_every or log_every` steps against the FEM ground truth
    (with train.branch_aware_val also the energy-gated metrics of
    train/energy.py),
    keeps the best checkpoint and writes periodic and final ones.
    c: the driver's build; s: the fresh state. Returns the final state."""
    mesh = c["mesh"]
    writer = is_writer(mesh)
    if writer:
        path, log, metrics = start_run(cfg, learner.name)
    else:
        path, log, metrics = None, lambda *_: None, None
    device, gen = c["device"], c["generator"]
    if mesh is not None and writer:
        log(f"mesh: {mesh.shape} (dp x pt), backend {mesh.backend}, rank 0 on {device}"
            + pt_split_note(c["pde"], mesh, c["point_sets"]))

    resume_step, eval_seed = 0, None
    if cfg.train.load_model_from_expt:
        resume_step, eval_seed = _resume(cfg, learner, s, gen, device, log)

    # eval tasks are pinned across resumes by their seed, which rides in the
    # checkpoint; a fresh run draws the seed from the training generator
    if eval_seed is None:
        eval_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    if writer:
        validation_fn, bundle = _validation(cfg, c, learner, eval_seed, log)
    barrier(mesh)

    def _state(step):
        return {**{k: v for k, v in s.items() if k not in learner.opts},
                **{f"torch_{k}": s[k] for k in learner.opts},
                "torch_rng_state": gen.get_state(), "torch_eval_seed": eval_seed,
                "torch_next_step": step}

    plots = learner.adapt is not None
    everies = boundaries(cfg, plots)
    trace = Trace(cfg.train.profile_dir if plots and writer else None,
                  cfg.train.profile_steps, device, log)
    step = resume_step
    while step < cfg.train.outer_steps:
        trace.iteration()
        block = next_block(cfg, step, everies)
        with Timer() as t:
            s, losses, meta_grad_norm, ml_means = learner.step(gen, s, block)
            device_barrier(device)
        step_time = t.interval / block
        step += block
        # log/metrics report the LAST completed step of the block
        log_step = step - 1

        meta_loss_mean = float(ml_means[-1])
        if bool(torch.isnan(ml_means).any()):
            log(f"encountered nan at step {log_step}")
            break

        validate = hit(cfg, cfg.train.val_every or cfg.train.log_every, step)
        save = step > 1 and hit(cfg, cfg.train.checkpoint_every, step)
        if validate and writer:
            with Timer() as deploy_timer:
                val = validation_fn(learner.model(s), bundle.gt_params, bundle.coords,
                                    bundle.gt_vals)
                device_barrier(device)
            deployment_time = deploy_timer.interval / cfg.task.n_eval
            val_meta_loss = learner.val_meta_loss(s)

            log(
                "step: {}, meta_loss: {}, val_meta_loss: {}, val_mse: {}, "
                "val_rel_err: {}, val_rel_err_std: {}, deployment_time: {}, "
                "meta_grad_norm: {}, time: {}".format(
                    log_step, meta_loss_mean, val_meta_loss, float(val.mse),
                    float(val.rel_err), float(val.rel_err_std), deployment_time,
                    float(meta_grad_norm), step_time,
                )
            )
            if metrics is not None:
                metrics.log(
                    log_step,
                    meta_loss=meta_loss_mean,
                    val_meta_loss=val_meta_loss,
                    val_mse=val.mse,
                    val_rel_err=val.rel_err,
                    val_rel_err_std=val.rel_err_std,
                    val_rel_err_median=val.rel_err_median,
                    per_dim_rel_err=val.per_dim_rel_err,
                    per_time_step_error=val.t_rel_sq_err,
                    deployment_time=deployment_time,
                    meta_grad_norm=meta_grad_norm,
                    step_time=step_time,
                    per_step_losses=losses.mean(dim=0),
                    **({} if val.rel_err_branch is None else dict(
                        val_rel_err_branch=val.rel_err_branch,
                        val_branch_flags=val.branch_flags,
                        val_branch_mask=val.branch_mask.to(torch.int64))),
                )
            if path is not None:
                # rel_err_branch without the audit falls back to the mean
                best_val = {"rel_err_median": val.rel_err_median,
                            "rel_err_branch": (val.rel_err if val.rel_err_branch is None
                                               else val.rel_err_branch)}.get(
                    cfg.train.best_metric, val.rel_err)
                ckpt.save_best_checkpoint(path, log_step, float(best_val), _state(step))

        if path is not None and plots and hit(cfg, cfg.train.viz_every, step):
            render_viz(path, cfg, c, learner.model(s), learner.adapt, bundle, log_step)
        if path is not None and save:
            ckpt.save_checkpoint(path, log_step, _state(step))
        if validate or save:
            barrier(mesh)

    trace.stop()
    if path is not None:
        ckpt.save_checkpoint(path, step, _state(step))
    if metrics is not None:
        metrics.close()
    peaks = gather_values(torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                          else None, mesh)
    log(f"done: {step} steps, siren_fused launches in this process "
        f"{spans.counter('siren_fused.launches')}, "
        f"peak device memory by rank {json.dumps(peaks)}")
    return s


class Trace:
    """torch.profiler over loop iterations 1 .. profile_steps (iteration 0
    is the warm-up), as the JAX MAML driver traces with jax.profiler: the
    trace starts at the top of iteration 1 and stops at the top of
    iteration 1 + profile_steps, or when training ends first. It is written
    into `profile_dir` as a Chrome trace (trace.json: host ops, and on a
    card the CUDA kernels and copies with their launches, each loop
    iteration a span named loop_iteration_<i> holding the program's spans
    of utils/spans.py), not XLA's format. profile_dir None: no trace."""

    def __init__(self, profile_dir, profile_steps, device, log):
        self.dir, self.steps, self.device, self.log = profile_dir, profile_steps, device, log
        self.it, self.prof, self.recording, self.span = 0, None, None, None

    def iteration(self):
        """Call at the top of each loop iteration."""
        if self.dir and self.it == 1:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
            self.recording = spans.recording(mirror=True)
            self.recording.__enter__()
        if self.prof is not None and self.it == 1 + self.steps:
            self.stop()
            self.log(f"wrote profiler trace to {self.dir}")
        if self.prof is not None:
            self._end_span()
            self.span = spans.span(f"loop_iteration_{self.it}")
            self.span.__enter__()
        self.it += 1

    def _end_span(self):
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None

    def stop(self):
        if self.prof is None:
            return
        device_barrier(self.device)
        self._end_span()
        self.recording.__exit__(None, None, None)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        self.prof = None


def render_viz(path, cfg: Config, c: dict, model, adapt, bundle, step):
    """The ground-truth comparison plots of train.viz_every (train/viz.py):
    td_burgers' time series of the first eval task, else the field grid of
    up to 3 eval tasks at k = 0 and the trained inner steps. A failure is
    printed with its traceback, never raised: plots must not end a
    training run."""
    try:
        pde, apply = c["pde"], c["field"].apply
        adapt_one = lambda i, p, k: adapt(model, p, k)
        if cfg.task.pde == "td_burgers":
            viz.plot_burgers_time_series(path, pde, bundle.gts[0], bundle.gt_params[0],
                                         adapt_one, cfg.maml.inner_steps, apply, step=step)
        else:
            dom = cfg.task.domain
            viz.compare_plots_with_ground_truth(
                path, pde, bundle.gts, bundle.gt_params, adapt_one,
                inner_steps_list=(0, cfg.maml.inner_steps),
                bounds=(dom.xmin, dom.xmax, dom.ymin, dom.ymax), field_apply=apply, step=step)
    except Exception:  # viz must never kill training
        print(f"viz failed at step {step}:\n{traceback.format_exc()}", flush=True)


def _validation(cfg: Config, c: dict, learner: Learner, eval_seed: int, log):
    """The eval tasks' ground truth and the validation fn of run()."""
    bundle = eval_ground_truth(cfg, c["pde"], eval_seed, c["device"], log)
    # branch-aware validation: each eval task's oracle energy once on fixed
    # audit points; each validation compares the adapted model's energy on
    # the same points (train/energy.py)
    branch_kwargs = {}
    if cfg.train.branch_aware_val:
        branch_kwargs = make_branch_kwargs(c["pde"], bundle, c["deploy_final_model_batched"],
                                           c["field"], learner.inner_steps,
                                           cfg.task.validation_points)
        log("branch-aware validation on: oracle energies "
            f"{[round(float(e), 5) for e in branch_kwargs['oracle_energy']]}")
    validation_fn = make_validation_fn(
        c["pde"], partial(c["make_coef_func_batched"], inner_steps=learner.inner_steps),
        cfg.task.n_eval, **validation_kwargs(cfg.task), **branch_kwargs)
    return validation_fn, bundle
