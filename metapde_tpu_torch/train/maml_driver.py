"""MAML experiment components, deployment side
(counterpart of metapde_tpu/train/maml_driver.py::build).

Reference semantics kept:
- total loss = bc_weight * sum(boundary losses) + sum(domain losses).
- inner-LR tree: congruent to the model, stacked inner_steps deep,
  initialized to ones.
- get_final_model: k-step single_task_rollout from the meta-learned init on
  one draw of inner points, with the learned-LR stack truncated to k steps,
  or extended by repeating its last step when k exceeds it.
- validation evaluates the adapted fields of all eval tasks at once
  (make_coef_func_batched, the JAX package's vmap of make_coef_func); the
  adaptation itself stays a per-task loop.

The meta-training step (outer optimizers, train_step, train_step_many) is
not ported yet, so build() returns the JAX build()'s keys without them.
"""

import dataclasses
from typing import Optional

import torch

from ..config import Config
from ..meta import maml
from ..models import make_field
from ..pdes import get_pde
from ..utils.trees import tree_map


def build(cfg: Config, device="cpu"):
    """Construct the pure components of a MAML experiment on `device`."""
    if cfg.deploy.optimizer:
        raise NotImplementedError("deploy.optimizer is not ported yet")
    if cfg.deploy.n_starts > 1:
        raise NotImplementedError("multi-start deployment (deploy.n_starts > 1) "
                                  "is not ported yet")
    device = torch.device(device)
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

    maml_def = maml.MamlDef(
        inner_lr=cfg.maml.inner_lr,
        inner_steps=cfg.maml.inner_steps,
        softplus_lrs=True,
        outer_loss_decay=cfg.maml.outer_loss_decay,
        inner_grad_clip=cfg.maml.inner_grad_clip,
    )

    generator = torch.Generator().manual_seed(cfg.seed)
    init_params = field.init(generator, device)
    inner_lrs = tree_map(
        lambda x: torch.ones((cfg.maml.inner_steps,) + tuple(x.shape),
                             dtype=x.dtype, device=device), init_params)

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
            final_params, shared = tree_map(lambda *p: torch.stack(p), *finals), False
        with torch.no_grad():
            return field.apply_inference_batched(final_params, coords, shared=shared)

    return dict(
        pde=pde,
        field=field,
        model_cfg=model_cfg,
        maml_def=maml_def,
        loss_fn=loss_fn,
        init_params=init_params,
        inner_lrs=inner_lrs,
        get_final_model=get_final_model,
        deploy_final_model=deploy_final_model,
        make_coef_func=make_coef_func,
        make_coef_func_batched=make_coef_func_batched,
        generator=generator,
    )
