"""LEAP meta-training and deployment components, and the meta-train loop
(counterpart of metapde_tpu/train/leap_driver.py).

Reference semantics kept:
- one task loss (bc_weight * boundary + domain) for the inner steps and
  the increments, an Adam inner optimizer (b1 0.9, b2 0.99), no learned LRs.
- first-order meta-gradient (meta/leap.py): memory does not grow with the
  inner steps; train.remat_inner_steps does not reach the LEAP engine,
  as in the JAX package.
- outer step: the meta-gradient's global norm, a clip at leap.grad_clip,
  then the outer optimizer (train.optimizer at leap.outer_lr).
- get_final_model: k steps of the LEAP rollout from the meta-learned init,
  a fresh point draw per step; with deploy.optimizer, k steps of a fresh
  optimizer on one draw (train/deploy.py).
- validation_losses: the rollout's losses on a fixed draw seeded 0.

Tasks and points are drawn on the host from one torch.Generator seeded with
cfg.seed (after the init draws), as in the MAML driver: each outer step
draws bsize tasks and, per task, the 2K + 1 point sets of task.inner_points
the JAX key chain consumes (meta/leap.py gives their order). step_core
takes those draws, so tests pass JAX's own draws.

Deployment is task-batched, as the JAX package vmaps make_coef_func:
make_coef_func_batched adapts every eval task in one batched rollout (the
training rollout without the accumulator and the second forward, so K point
sets per task, each drawn from the task's own generator) and evaluates them
all in one inference call (one siren_fused launch on the card).

run() is the loop of train/loop.py on LEAP's state: validation through the
cache in <out_dir>/gt_cache_torch, best, periodic and final checkpoints,
resume from the port's or the JAX package's LEAP checkpoints (the JAX one's
Adam state carries over). Its NaN abort reads the per-step meta-losses
(the last column of the loss history) also for a block of one step, where
the JAX driver reads the mean of the whole history: a NaN loss gives NaN
params and so a NaN last loss. Every family of the JAX package trains;
deploy.n_starts > 1 wraps the deployment in the multi-start
(train/multistart.py). A mesh shards the training step over a
torch.distributed process group as in the MAML driver (every rank draws
the whole step and keeps its share; the pt means in meta/leap.py, the dp
mean and the loss gather in parallel/sharding.py); validation_losses and
the deployment stay unsharded. viz_every and profile_dir are accepted and
ignored, as the JAX LEAP driver ignores them: its blocks end at log_every
and checkpoint_every only.
"""

import torch

from ..config import Config
from ..device import DEFAULT_DEVICE, resolve_device
from ..meta import leap
from ..models.siren import mixed_precision_scope
from ..parallel.mesh import rank_device
from ..parallel.sharding import check_task_split, make_sharded_leap_grad_fn, shard_batch
from ..utils.trees import global_norm, tree_map, tree_stack
from . import loop, multistart
from .deploy import coef_funcs, draw_sets, expand_tasks, make_opt_final_model, one_task
from .optimizers import adam, apply_updates, get_optimizer


def build(cfg: Config, device=DEFAULT_DEVICE):
    """Construct the pure components of a LEAP experiment on `device`
    (CUDA unless the caller asks for the CPU); returns a dict."""
    pde, model_cfg, field, loss_fn, task_loss = loop.problem(cfg)
    device = resolve_device(str(device))
    mesh = loop.mesh_of(cfg)
    if mesh is not None:
        check_task_split(cfg.leap.bsize, mesh)
        device = rank_device(device)
    leap_def = leap.LeapDef(
        inner_opt=adam(cfg.leap.inner_lr, b1=0.9, b2=0.99),
        inner_steps=cfg.leap.inner_steps,
        norm=cfg.leap.norm,
        loss_in_distance=cfg.leap.loss_in_distance,
        stabilize=cfg.leap.stabilize,
        inner_grad_clip=cfg.leap.inner_grad_clip,
    )
    generator = torch.Generator().manual_seed(cfg.seed)
    init_params = field.init(generator, device)
    outer_opt = get_optimizer(cfg.train.optimizer, cfg.leap.outer_lr)

    # --- train step ---------------------------------------------------------
    def draw_all(gen):
        """One outer step's draws for T = bsize tasks, from `gen` (on the
        host by default): a leap.TaskBatch."""
        task_params = tree_stack([pde.sample_params(gen) for _ in range(cfg.leap.bsize)])
        points = pde.sample_points_batched(gen, cfg.task.inner_points, task_params,
                                           2 * cfg.leap.inner_steps + 1)
        return leap.TaskBatch(task_params, points)

    def draw_step_inputs(gen):
        """draw_all's batch on the device; under a mesh this rank's share."""
        batch = draw_all(gen)
        if mesh is not None:
            batch = shard_batch(batch, mesh, pde.pooled_kinds)
        return loop.to_device(batch, device)

    if mesh is None:
        def grad_fn(batch, params):
            return leap.multi_task_grad_and_losses(leap_def, task_loss, batch, params)
    else:
        grad_fn = make_sharded_leap_grad_fn(leap_def, task_loss, mesh)

    def step_core(batch, params, opt_state):
        """One outer step on given draws (the JAX package's _step_core);
        under a mesh, this rank's share of them (shard_batch). Returns
        (params, opt_state, losses [T, K + 1], meta_grad_norm)."""
        with mixed_precision_scope(model_cfg):
            meta_grad, losses = grad_fn(batch, params)
        with torch.no_grad():
            meta_grad_norm = global_norm(meta_grad)
            clip = cfg.leap.grad_clip
            scale = torch.where(meta_grad_norm > clip,
                                clip / torch.clamp(meta_grad_norm, min=1e-30),
                                torch.ones_like(meta_grad_norm))
            meta_grad = tree_map(lambda g: g * scale, meta_grad)
            updates, opt_state = outer_opt.update(meta_grad, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, losses, meta_grad_norm

    def train_step(gen, params, opt_state):
        return step_core(draw_step_inputs(gen), params, opt_state)

    def train_step_many(gen, params, opt_state, n_steps: int):
        """n_steps outer steps with no host read: the per-step meta-loss
        means stay on the device. Returns the final state, the last step's
        losses and grad norm, and the per-step meta-loss means."""
        ml_means = []
        for _ in range(n_steps):
            params, opt_state, losses, gn = train_step(gen, params, opt_state)
            ml_means.append(losses[:, -1].mean())
        return params, opt_state, losses, gn, torch.stack(ml_means)

    def validation_losses(params):
        """The rollout's losses [T, K + 1] on a fixed draw from a generator
        seeded 0 (the JAX package's PRNGKey(0))."""
        batch = loop.to_device(draw_all(torch.Generator().manual_seed(0)), device)
        with mixed_precision_scope(model_cfg):
            return leap.multi_task_grad_and_losses(leap_def, task_loss, batch, params)[1]

    # --- deployment / validation --------------------------------------------
    def get_final_model_batched(gens, params, task_params, inner_steps: int, points=None):
        """k-step LEAP adaptation of T tasks (task params stacked [T, ...])
        from the meta-learned init, in one batched rollout. It keeps only
        the final params, which depend on neither the increments nor the
        losses after each step, so it skips both and draws K point sets per
        task (from gens[i], unless `points` gives them per kind as
        [T, K, n, ...]), set k - 1 feeding step k's gradient: the JAX
        get_final_model's k1 draws."""
        if inner_steps == 0:
            return expand_tasks(params, task_params[0].shape[0])
        if points is None:
            points = draw_sets(pde, gens, cfg.task.inner_points, task_params, inner_steps)
        with mixed_precision_scope(model_cfg):
            final, _, _ = leap.rollout(leap_def._replace(inner_steps=int(inner_steps)),
                                       task_loss, leap.TaskBatch(task_params, points), params,
                                       accumulate=False)
        return final

    deploy_final_model_batched = get_final_model_batched
    if cfg.deploy.optimizer:
        deploy_final_model_batched = make_opt_final_model(
            pde, loss_fn, field, cfg.task, cfg.deploy, model_is_pair=False)
    # multi-start (deploy.n_starts > 1): each task's best of K candidates
    deploy_final_model_batched = multistart.wrap_driver_deployment(
        cfg, pde, loss_fn, field, deploy_final_model_batched, model_is_pair=False)
    deploy_final_model, make_coef_func, make_coef_func_batched = coef_funcs(
        field, deploy_final_model_batched, leap_def.inner_steps, init_of=lambda m: m,
        k0_shared=multistart.init_is_the_k0_field(cfg))

    return dict(
        pde=pde,
        field=field,
        model_cfg=model_cfg,
        leap_def=leap_def,
        loss_fn=loss_fn,
        task_loss=task_loss,
        init_params=init_params,
        outer_opt=outer_opt,
        draw_all=draw_all,
        draw_step_inputs=draw_step_inputs,
        grad_fn=grad_fn,
        step_core=step_core,
        train_step=train_step,
        train_step_many=train_step_many,
        validation_losses=validation_losses,
        get_final_model=one_task(get_final_model_batched),
        get_final_model_batched=get_final_model_batched,
        deploy_final_model=deploy_final_model,
        deploy_final_model_batched=deploy_final_model_batched,
        make_coef_func=make_coef_func,
        make_coef_func_batched=make_coef_func_batched,
        generator=generator,
        device=device,
        mesh=mesh,
        point_sets={"points": cfg.task.inner_points},
    )


def run(cfg: Config, device=DEFAULT_DEVICE):
    """The meta-training loop (train/loop.py) on LEAP's state: the params
    and the outer optimizer's state. Returns the params."""
    c = build(cfg, device)

    def step(gen, s, n_steps):
        params, opt_state, losses, meta_grad_norm, ml_means = c["train_step_many"](
            gen, s["params"], s["opt_state"], n_steps)
        return {"params": params, "opt_state": opt_state}, losses, meta_grad_norm, ml_means

    learner = loop.Learner(
        name="leap", inner_steps=cfg.leap.inner_steps,
        opts={"opt_state": (c["outer_opt"], "params", cfg.train.optimizer)},
        step=step, model=lambda s: s["params"],
        val_meta_loss=lambda s: float(c["validation_losses"](s["params"])[:, -1].mean()))
    s = {"params": c["init_params"], "opt_state": c["outer_opt"].init(c["init_params"])}
    return loop.train(cfg, c, learner, s)["params"]
