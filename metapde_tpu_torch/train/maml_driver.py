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
  learned-LR adaptation itself stays a per-task loop.

Tasks and points are drawn on the host from one torch.Generator seeded with
cfg.seed (after the init draws), so a CPU run and a card run train on the
same tasks; draw_step_inputs moves one outer step's draws to the device
(pinned, without a host wait). JAX's key chain is not reproduced: each
outer step draws T = bsize tasks, and per task the K + 1 inner and K + 1
outer point sets the JAX chain consumes (one per inner step and one for the
final inner loss; one outer set per step and the outer_loss_key aux set).
step_core takes those draws as an argument, so tests pass JAX's own draws.

run() is the loop of train/loop.py on MAML's state.

Deployment takes the learned-LR rollout, or with cfg.deploy.optimizer set
k steps of a fresh optimizer (train/deploy.py), which adapts all tasks in
one batched call.

Every family of the JAX package trains (its point kinds, each
[T, sets, n_kind, in_dim], go through the same TaskBatch).
deploy.n_starts > 1 wraps the deployment in the multi-start
(train/multistart.py).

A mesh (mesh.n_task_shards or n_point_shards > 1) shards the training step
over the ranks of a torch.distributed process group (parallel/): every
rank draws the whole step on the host and keeps its tasks and points
(shard_batch), the sharded grad fn runs on rank_device(device), and every
rank ends the step with the same state. validation_losses, the deployment
and make_coef_func* stay unsharded, as in the JAX package; run() validates
and writes on rank 0 (train/loop.py). Without a process group a mesh
raises, naming torchrun. train.viz_every renders the ground-truth plots
of train/viz.py on rank 0 (the adaptation from a generator seeded 0, as the
JAX driver adapts from PRNGKey(0)); train.profile_dir writes a
torch.profiler trace of loop iterations 1 .. profile_steps (train/loop.py).
"""

import torch

from ..config import Config
from ..device import DEFAULT_DEVICE, resolve_device
from ..meta import maml
from ..models.siren import mixed_precision_scope
from ..parallel.mesh import rank_device
from ..parallel.sharding import check_task_split, make_sharded_maml_grad_fn, shard_batch
from ..utils import spans
from ..utils.trees import global_norm, tree_map, tree_stack
from . import loop, multistart
from .deploy import coef_funcs, make_opt_final_model
from .optimizers import adam, apply_updates, get_optimizer


def build(cfg: Config, device=DEFAULT_DEVICE):
    """Construct the pure components of a MAML experiment on `device`
    (CUDA unless the caller asks for the CPU); returns a dict."""
    pde, model_cfg, field, loss_fn, task_loss = loop.problem(cfg)
    device = resolve_device(str(device))
    mesh = loop.mesh_of(cfg)
    if mesh is not None:
        check_task_split(cfg.maml.bsize, mesh)
        device = rank_device(device)

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
    def draw_all(gen):
        """One outer step's draws for T = bsize tasks, from `gen` (on the
        host by default): a maml.TaskBatch."""
        n_sets = cfg.maml.inner_steps + 1
        with spans.span("draw.sample"):
            tps = [pde.sample_params(gen) for _ in range(cfg.maml.bsize)]
            task_params = tree_stack(tps)
            return maml.TaskBatch(
                task_params=task_params,
                inner_points=pde.sample_points_batched(gen, cfg.task.inner_points,
                                                       task_params, n_sets),
                outer_points=pde.sample_points_batched(gen, cfg.task.outer_points,
                                                       task_params, n_sets))

    def draw_step_inputs(gen):
        """draw_all's batch on the device; under a mesh this rank's share.
        The span `draw` begins an outer step."""
        with spans.span("draw", new_step=True):
            batch = draw_all(gen)
            if mesh is not None:
                batch = shard_batch(batch, mesh, pde.pooled_kinds)
            return loop.to_device(batch, device)

    if mesh is None:
        def grad_fn(batch, params, lrs):
            return maml.multi_task_grad_and_losses(maml_def, task_loss, batch, params, lrs)
    else:
        grad_fn = make_sharded_maml_grad_fn(maml_def, task_loss, mesh)

    def step_core(batch, params, lrs, opt_state, lr_opt_state):
        """One outer step on given draws (the JAX package's _step_core);
        under a mesh, this rank's share of them (shard_batch)."""
        with spans.span("step"):
            with mixed_precision_scope(model_cfg):
                (model_grad, lr_grad), losses, meta_losses = grad_fn(batch, params, lrs)
            with torch.no_grad(), spans.span("outer_update"):
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
        batch = loop.to_device(draw_all(torch.Generator().manual_seed(0)), device)
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

    def get_final_model_batched(gens, model_and_lrs, task_params, inner_steps: int,
                                points=None):
        """get_final_model of T tasks (task params stacked [T, ...], points
        per kind [T, 1, n, ...] or drawn from gens[i]), task by task: the
        learned-LR rollout is not task-batched yet. Returns params [T, ...]."""
        return tree_stack([
            get_final_model(gen, model_and_lrs, tuple(a[i] for a in task_params), inner_steps,
                            None if points is None else tuple(p[i, 0] for p in points))
            for i, gen in enumerate(gens)])

    # the learned-LR rollout above (the MAML protocol) or, with
    # deploy.optimizer set, k steps of a fresh optimizer (train/deploy.py)
    deploy_final_model_batched = get_final_model_batched
    if cfg.deploy.optimizer:
        deploy_final_model_batched = make_opt_final_model(
            pde, loss_fn, field, cfg.task, cfg.deploy, model_is_pair=True)
    # multi-start (deploy.n_starts > 1): each task's best of K candidates
    deploy_final_model_batched = multistart.wrap_driver_deployment(
        cfg, pde, loss_fn, field, deploy_final_model_batched, model_is_pair=True)
    deploy_final_model, make_coef_func, make_coef_func_batched = coef_funcs(
        field, deploy_final_model_batched, maml_def.inner_steps, init_of=lambda m: m[0],
        k0_shared=multistart.init_is_the_k0_field(cfg))

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
        draw_all=draw_all,
        draw_step_inputs=draw_step_inputs,
        grad_fn=grad_fn,
        step_core=step_core,
        train_step=train_step,
        train_step_many=train_step_many,
        validation_losses=validation_losses,
        get_final_model=get_final_model,
        deploy_final_model=deploy_final_model,
        deploy_final_model_batched=deploy_final_model_batched,
        make_coef_func=make_coef_func,
        make_coef_func_batched=make_coef_func_batched,
        generator=generator,
        device=device,
        mesh=mesh,
        point_sets={"inner_points": cfg.task.inner_points,
                    "outer_points": cfg.task.outer_points},
    )


def run(cfg: Config, device=DEFAULT_DEVICE):
    """The meta-training loop (train/loop.py) on MAML's state: the params,
    the learned inner LRs and their two optimizer states. Returns
    (params, inner_lrs)."""
    c = build(cfg, device)

    def step(gen, s, n_steps):
        *state, losses, _, meta_grad_norm, ml_means = c["train_step_many"](
            gen, s["params"], s["inner_lrs"], s["opt_state"], s["lr_opt_state"], n_steps)
        return (dict(zip(("params", "inner_lrs", "opt_state", "lr_opt_state"), state)),
                losses, meta_grad_norm, ml_means)

    learner = loop.Learner(
        name="maml", inner_steps=cfg.maml.inner_steps,
        opts={"opt_state": (c["outer_opt"], "params", cfg.train.optimizer),
              "lr_opt_state": (c["lr_opt"], "inner_lrs", "adam")},
        step=step, model=lambda s: (s["params"], s["inner_lrs"]),
        val_meta_loss=lambda s: float(
            c["validation_losses"](s["params"], s["inner_lrs"])[1][0].mean()),
        adapt=lambda model, task_params, k: c["get_final_model"](
            torch.Generator().manual_seed(0), model, task_params, k))
    s = {"params": c["init_params"], "inner_lrs": c["inner_lrs"],
         "opt_state": c["outer_opt"].init(c["init_params"]),
         "lr_opt_state": c["lr_opt"].init(c["inner_lrs"])}
    s = loop.train(cfg, c, learner, s)
    return s["params"], s["inner_lrs"]
