"""MAML meta-training and deployment components, and the meta-train loop
(counterpart of metapde_tpu/train/maml_driver.py).

Reference semantics kept:
- total loss = bc_weight * sum(boundary losses) + sum(domain losses).
- inner-LR tree: congruent to the model, stacked inner_steps deep,
  initialized to ones, meta-optimized by Adam(lr_inner_lr, b2=0.99).
- meta-gradient global-norm clip: the norm measured on the MODEL part, the
  scale applied to both the model and the LR gradients.
- NaN abort.
- get_final_model: k-step single_task_rollout from the meta-learned init on
  one draw of inner points, with the learned-LR stack truncated to k steps,
  or extended by repeating its last step when k exceeds it.
- validation evaluates the adapted fields of all eval tasks at once
  (make_coef_func_batched, the JAX package's vmap of make_coef_func); the
  adaptation itself stays a per-task loop.

Tasks and points are drawn on the host from one torch.Generator seeded with
cfg.seed (after the init draws), so a CPU run and a card run train on the
same tasks; draw_step_inputs moves one outer step's draws to the device
(pinned, without a host wait). JAX's key chain is not reproduced: each
outer step draws T = bsize tasks, and per task the K + 1 inner and K + 1
outer point sets the JAX chain consumes (one per inner step and one for the
final inner loss; one outer set per step and the outer_loss_key aux set).
step_core takes those draws as an argument, so tests pass JAX's own draws.

run() solves the eval tasks' ground truth at
cfg.solver.ground_truth_resolution through the cache in
<out_dir>/gt_cache_torch (the JAX package's <out_dir>/gt_cache holds JAX
entries, which the port neither reads nor writes).

Not ported: a mesh (mesh.n_task_shards or n_point_shards > 1), viz_every,
branch_aware_val, profile_dir, non-Poisson PDEs, deploy.optimizer and
deploy.n_starts > 1; each raises NotImplementedError.
"""

import dataclasses
import os
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import DEFAULT_DEVICE, resolve_device
from ..interop import params_from_numpy
from ..meta import maml
from ..models import make_field
from ..models.siren import mixed_precision_scope
from ..pdes import get_pde
from ..utils import Timer
from ..utils.trees import global_norm, tree_map, tree_stack
from . import checkpoints as ckpt
from .gt_cache import task_cache_extra
from .metrics import prepare_logging
from .optimizers import adam, apply_updates, from_jax_state, get_optimizer
from .validation import get_ground_truth, make_validation_fn


def device_barrier(device):
    """Wait for the device's queued work (the timing barrier)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(tree, device):
    """Host tensors -> `device`; through pinned memory and without a host
    wait on CUDA, so drawing the next step overlaps the device's work."""
    if device.type == "cpu":
        return tree
    return tree_map(lambda t: t.pin_memory().to(device, non_blocking=True), tree)


def build(cfg: Config, device=DEFAULT_DEVICE):
    """Construct the pure components of a MAML experiment on `device`
    (CUDA unless the caller asks for the CPU); returns a dict."""
    if cfg.mesh.n_task_shards > 1 or cfg.mesh.n_point_shards > 1:
        raise NotImplementedError("a device mesh (mesh.n_task_shards or "
                                  "n_point_shards > 1) is not ported yet")
    if cfg.deploy.optimizer:
        raise NotImplementedError("deploy.optimizer is not ported yet")
    if cfg.deploy.n_starts > 1:
        raise NotImplementedError("multi-start deployment (deploy.n_starts > 1) "
                                  "is not ported yet")
    device = resolve_device(str(device))
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

    maml_def = maml.MamlDef(
        inner_lr=cfg.maml.inner_lr,
        inner_steps=cfg.maml.inner_steps,
        softplus_lrs=True,
        outer_loss_decay=cfg.maml.outer_loss_decay,
        inner_grad_clip=cfg.maml.inner_grad_clip,
        remat=cfg.train.remat_inner_steps,
        unroll=cfg.maml.unroll,
    )

    generator = torch.Generator().manual_seed(cfg.seed)
    init_params = field.init(generator, device)
    inner_lrs = tree_map(
        lambda x: torch.ones((cfg.maml.inner_steps,) + tuple(x.shape),
                             dtype=x.dtype, device=device), init_params)

    outer_opt = get_optimizer(cfg.train.optimizer, cfg.maml.outer_lr)
    lr_opt = adam(cfg.maml.lr_inner_lr, b1=0.9, b2=0.99)

    # --- train step ---------------------------------------------------------
    def draw_step_inputs(gen):
        """One outer step's draws for T = bsize tasks, from `gen` (on the
        host by default), on the device: a maml.TaskBatch."""
        n_sets = cfg.maml.inner_steps + 1
        tps = [pde.sample_params(gen) for _ in range(cfg.maml.bsize)]
        task_params = tree_stack(tps)
        batch = maml.TaskBatch(
            task_params=task_params,
            inner_points=pde.sample_points_batched(gen, cfg.task.inner_points,
                                                   task_params, n_sets),
            outer_points=pde.sample_points_batched(gen, cfg.task.outer_points,
                                                   task_params, n_sets))
        return _to_device(batch, device)

    def step_core(batch, params, lrs, opt_state, lr_opt_state):
        """One outer step on given draws (the JAX package's _step_core)."""
        with mixed_precision_scope(model_cfg):
            (model_grad, lr_grad), losses, meta_losses = maml.multi_task_grad_and_losses(
                maml_def, task_loss, batch, params, lrs)
        with torch.no_grad():
            # norm on the model part, the scale applied to both
            meta_grad_norm = global_norm(model_grad)
            clip = cfg.maml.grad_clip
            scale = torch.where(meta_grad_norm > clip,
                                clip / torch.clamp(meta_grad_norm, min=1e-30),
                                torch.ones_like(meta_grad_norm))
            model_grad, lr_grad = tree_map(lambda g: g * scale, (model_grad, lr_grad))
            updates, opt_state = outer_opt.update(model_grad, opt_state, params)
            params = apply_updates(params, updates)
            lr_updates, lr_opt_state = lr_opt.update(lr_grad, lr_opt_state, lrs)
            lrs = apply_updates(lrs, lr_updates)
        return params, lrs, opt_state, lr_opt_state, losses, meta_losses, meta_grad_norm

    def train_step(gen, params, lrs, opt_state, lr_opt_state):
        return step_core(draw_step_inputs(gen), params, lrs, opt_state, lr_opt_state)

    def train_step_many(gen, params, lrs, opt_state, lr_opt_state, n_steps: int):
        """n_steps outer steps with no host read: the per-step meta-loss
        means stay on the device (read once per block for the NaN check, as
        the JAX package's lax.scan returns them). Returns the final state,
        the last step's loss detail and the per-step meta-loss means."""
        ml_means = []
        for _ in range(n_steps):
            params, lrs, opt_state, lr_opt_state, losses, meta_losses, gn = train_step(
                gen, params, lrs, opt_state, lr_opt_state)
            ml_means.append(meta_losses[0].mean())
        return (params, lrs, opt_state, lr_opt_state, losses, meta_losses, gn,
                torch.stack(ml_means))

    def validation_losses(params, lrs):
        """Losses and meta-losses (no meta-gradient) on a fixed draw from a
        generator seeded 0 (the JAX package's PRNGKey(0))."""
        batch = draw_step_inputs(torch.Generator().manual_seed(0))
        _, losses, meta_losses = maml.multi_task_grad_and_losses(
            maml_def, task_loss, batch, params, lrs, need_grad=False)
        return losses, meta_losses

    def get_final_model(gen, model_and_lrs, task_params, inner_steps: int,
                        points=None):
        """k-step adaptation from the meta-learned init. The inner points are
        drawn from `gen` unless given (tests pass the points JAX drew)."""
        params, lrs = model_and_lrs
        if inner_steps == 0:
            return params
        pts = points if points is not None else pde.sample_points(
            gen, cfg.task.inner_points, task_params)

        def inner_loss_fn(fp):
            return loss_fn(field.bind(fp), pts, task_params)

        def _take_k(x):
            if inner_steps <= x.shape[0]:
                return x[:inner_steps]
            pad = x[-1].expand((inner_steps - x.shape[0],) + tuple(x.shape[1:]))
            return torch.cat([x, pad], dim=0)

        lrs_k = tree_map(_take_k, lrs)
        with mixed_precision_scope(model_cfg):
            final_params, _ = maml.single_task_rollout(
                maml_def._replace(inner_steps=inner_steps), params, inner_loss_fn, lrs_k)
        return final_params

    deploy_final_model = get_final_model

    def make_coef_func(gen, model_and_lrs, task_params, coords,
                       inner_steps: Optional[int] = None):
        k = maml_def.inner_steps if inner_steps is None else inner_steps
        final_params = deploy_final_model(gen, model_and_lrs, task_params, k)
        with torch.no_grad():
            return torch.squeeze(field.apply_inference(final_params, coords))

    def make_coef_func_batched(gens, model_and_lrs, task_params, coords,
                               inner_steps: Optional[int] = None, points=None):
        """The written-out jax.vmap(make_coef_func, (0, None, 0, 0)): adapt
        each task in turn (gens[i], task_params[i], and points[i] when given),
        stack the adapted params, or share the meta-learned init when k = 0,
        and evaluate every task in one batched inference.
        coords [T, V, d] -> [T, V] or [T, V, out]."""
        k = maml_def.inner_steps if inner_steps is None else inner_steps
        if k == 0:
            final_params, shared = model_and_lrs[0], True
        else:
            finals = [deploy_final_model(gen, model_and_lrs, tp, k,
                                         None if points is None else points[i])
                      for i, (gen, tp) in enumerate(zip(gens, task_params))]
            final_params, shared = tree_stack(finals), False
        with torch.no_grad():
            return field.apply_inference_batched(final_params, coords, shared=shared)

    return dict(
        pde=pde,
        field=field,
        model_cfg=model_cfg,
        maml_def=maml_def,
        loss_fn=loss_fn,
        task_loss=task_loss,
        init_params=init_params,
        inner_lrs=inner_lrs,
        outer_opt=outer_opt,
        lr_opt=lr_opt,
        draw_step_inputs=draw_step_inputs,
        step_core=step_core,
        train_step=train_step,
        train_step_many=train_step_many,
        validation_losses=validation_losses,
        get_final_model=get_final_model,
        deploy_final_model=deploy_final_model,
        make_coef_func=make_coef_func,
        make_coef_func_batched=make_coef_func_batched,
        generator=generator,
        device=device,
    )


def _check_run_options(cfg: Config):
    if cfg.task.pde != "poisson":
        raise NotImplementedError(f"training pde {cfg.task.pde!r}: only poisson is ported")
    if cfg.train.viz_every > 0 and cfg.train.expt_name is not None:
        raise NotImplementedError("viz_every: the ground-truth plots (train/viz.py) are "
                                  "not ported yet; pass --train.viz_every=0")
    if cfg.train.branch_aware_val:
        raise NotImplementedError("branch_aware_val is not ported yet")
    if cfg.train.profile_dir:
        raise NotImplementedError("profile_dir is not ported yet; time the training "
                                  "step with cli/train_bench")


def _eval_tasks(pde, eval_seed, n_eval, device):
    gen = torch.Generator().manual_seed(eval_seed)
    return [tuple(a.to(device) for a in pde.sample_params(gen)) for _ in range(n_eval)], gen


def run(cfg: Config, device=DEFAULT_DEVICE):
    """The meta-training loop (the JAX package's run()): logs, resumes from
    the latest checkpoint of the port or of the JAX package, validates
    every `val_every or log_every` steps against the FEM ground truth,
    keeps the best checkpoint and writes periodic and final ones."""
    device = resolve_device(str(device))
    _check_run_options(cfg)
    out_dir = cfg.train.out_dir or f"{cfg.task.pde}_maml_results"
    path, log, metrics = prepare_logging(out_dir, cfg.train.expt_name)
    log(cfg.to_json())
    if path is not None:
        with open(f"{path}/config.json", "w") as f:
            f.write(cfg.to_json())

    c = build(cfg, device)
    pde = c["pde"]
    params, inner_lrs = c["init_params"], c["inner_lrs"]
    gen = c["generator"]
    opt_state = c["outer_opt"].init(params)
    lr_opt_state = c["lr_opt"].init(inner_lrs)

    resume_step, eval_seed, state = 0, None, None
    if cfg.train.load_model_from_expt:
        fname = ckpt.latest_checkpoint(cfg.train.load_model_from_expt)
        if fname:
            state = ckpt.load_checkpoint(fname)
            params = params_from_numpy(state["params"], device)
            if state.get("inner_lrs") is not None:
                inner_lrs = params_from_numpy(state["inner_lrs"], device)
            log(f"loaded checkpoint {fname}")
            for d in ckpt.config_drift(cfg.train.load_model_from_expt, cfg):
                log(f"WARNING: config drift vs loaded run: {d}")
            opt_state = c["outer_opt"].init(params)
            lr_opt_state = c["lr_opt"].init(inner_lrs)
    if state is not None and state.get("torch_opt_state") is not None:
        # the port's own checkpoint: the same trajectory continues exactly
        try:
            opt_state = params_from_numpy(state["torch_opt_state"], device, dtype=None)
            lr_opt_state = params_from_numpy(state["torch_lr_opt_state"], device, dtype=None)
            gen.set_state(torch.as_tensor(state["torch_rng_state"]))
            eval_seed = int(state["torch_eval_seed"])
            resume_step = int(state["torch_next_step"])
            log(f"resuming optimizer state at step {resume_step}")
            log("pinned eval tasks from checkpoint torch_eval_seed")
        except Exception as e:
            log(f"could not resume optimizer state ({e}); fresh optimizers")
    elif state is not None and state.get("opt_state") is not None:
        # a JAX checkpoint: its optax states carry over; its PRNG and eval
        # keys drive JAX's threefry and cannot be replayed here
        try:
            opt_state = from_jax_state(cfg.train.optimizer, state["opt_state"], device)
            if state.get("lr_opt_state") is not None:
                lr_opt_state = from_jax_state("adam", state["lr_opt_state"], device)
            resume_step = int(state.get("step", 0)) + 1
            log(f"resuming optimizer state at step {resume_step} (JAX checkpoint: "
                "new task draws and eval tasks)")
        except Exception as e:
            log(f"could not resume optimizer state ({e}); fresh optimizers")

    # eval tasks are pinned across resumes by their seed, which rides in the
    # checkpoint; a fresh run draws the seed from the training generator
    if eval_seed is None:
        eval_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    gt_params, gt_gen = _eval_tasks(pde, eval_seed, cfg.task.n_eval, device)
    cache_dir = (os.path.join(cfg.train.out_dir, "gt_cache_torch")
                 if cfg.train.out_dir else None)
    bundle = get_ground_truth(pde, gt_params, gt_gen, cfg.task.validation_points,
                              cfg.solver.ground_truth_resolution, cache_dir=cache_dir,
                              cache_extra=task_cache_extra(cfg.task))
    log(f"ground truth at resolution {cfg.solver.ground_truth_resolution}: "
        f"{bundle.solves} solved, {bundle.cache_hits} read from {cache_dir}")
    validation_fn = make_validation_fn(
        pde, partial(c["make_coef_func_batched"], inner_steps=cfg.maml.inner_steps),
        cfg.task.n_eval)

    train_step, train_step_many = c["train_step"], c["train_step_many"]
    spc = max(1, cfg.train.steps_per_call)

    def _next_boundary(step):
        """Steps until the next log/checkpoint boundary or the end."""
        n = cfg.train.outer_steps - step
        for every in (cfg.train.log_every, cfg.train.checkpoint_every):
            if every and every > 0:
                n = min(n, every - step % every)
        return max(1, min(n, spc))

    def _state(step):
        return {"params": params, "inner_lrs": inner_lrs,
                "torch_opt_state": opt_state, "torch_lr_opt_state": lr_opt_state,
                "torch_rng_state": gen.get_state(), "torch_eval_seed": eval_seed,
                "torch_next_step": step}

    step = resume_step
    while step < cfg.train.outer_steps:
        block = _next_boundary(step) if spc > 1 else 1
        with Timer() as t:
            if block == 1:
                (params, inner_lrs, opt_state, lr_opt_state, losses,
                 meta_losses, meta_grad_norm) = train_step(
                    gen, params, inner_lrs, opt_state, lr_opt_state)
                ml_means = None
            else:
                (params, inner_lrs, opt_state, lr_opt_state, losses,
                 meta_losses, meta_grad_norm, ml_means) = train_step_many(
                    gen, params, inner_lrs, opt_state, lr_opt_state, n_steps=block)
            device_barrier(device)
        step_time = t.interval / block
        step += block
        # log/metrics report the LAST completed step of the block
        log_step = step - 1

        meta_loss_mean = float(meta_losses[0].mean())
        nan_now = (np.isnan(meta_loss_mean) if ml_means is None
                   else bool(torch.isnan(ml_means).any()))
        if nan_now:
            log(f"encountered nan at step {log_step}")
            break

        hit = lambda every: (
            every > 0 and (log_step % every == 0 if spc == 1 else step % every == 0)
        )
        if hit(cfg.train.val_every or cfg.train.log_every):
            with Timer() as deploy_timer:
                val = validation_fn((params, inner_lrs), bundle.gt_params, bundle.coords,
                                    bundle.gt_vals)
                device_barrier(device)
            deployment_time = deploy_timer.interval / cfg.task.n_eval

            val_losses, val_meta_losses = c["validation_losses"](params, inner_lrs)
            val_meta_loss = float(val_meta_losses[0].mean())

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
                    per_time_step_error=None,
                    deployment_time=deployment_time,
                    meta_grad_norm=meta_grad_norm,
                    step_time=step_time,
                    per_step_losses=losses.mean(dim=0),
                )
            if path is not None:
                best_val = {"rel_err_median": val.rel_err_median}.get(
                    cfg.train.best_metric, val.rel_err)
                ckpt.save_best_checkpoint(path, log_step, float(best_val), _state(step))

        if path is not None and step > 1 and hit(cfg.train.checkpoint_every):
            ckpt.save_checkpoint(path, log_step, _state(step))

    if path is not None:
        ckpt.save_checkpoint(path, step, _state(step))
    if metrics is not None:
        metrics.close()
    return params, inner_lrs
