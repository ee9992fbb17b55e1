"""Optimizer-based deployment (cfg.deploy.optimizer; counterpart of
metapde_tpu/train/deploy.py).

The repo measures deployment two ways: the meta-learner's own k-step
rollout (the drivers' get_final_model), and fine-tuning from the
meta-learned init with k steps of a fresh first-order optimizer at
deploy.inner_lr, which this module implements. Semantics kept from the JAX
package: one fresh collocation draw per task, k optimizer steps on the full
task loss at that draw, no gradient clip; the optimizer comes from the
training table (train/optimizers.get_optimizer, adam with b2 = 0.99). MAML's
learned inner LRs play no part on this path.

Deployment is task-batched, as the JAX package vmaps it: a function here
adapts T tasks at once (params with a leading task axis, per-task losses
through torch.func.vmap), and `one_task` gives its T = 1 case. Points are
drawn per task from that task's generator (`draw_sets`), so a task's draw
does not depend on the other tasks of the batch.
"""

import torch

from ..models.siren import mixed_precision_scope
from ..utils.trees import tree_leaves, tree_map, tree_stack, tree_unflatten
from .optimizers import apply_updates, get_optimizer


def draw_sets(pde, gens, n, task_params, sets):
    """`sets` point sets of n points for each of T tasks, task i's from
    gens[i]: per point kind [T, sets, n, ...] on the task params' device.
    task_params: each leaf stacked [T, ...]."""
    draws = [pde.sample_points_batched(gen, n, tuple(a[i:i + 1] for a in task_params), sets)
             for i, gen in enumerate(gens)]
    return tuple(torch.cat(kind) for kind in zip(*draws))


def expand_tasks(params, n_tasks):
    """One set of params as T tasks' (a view, no copy)."""
    return tree_map(lambda p: p.expand((n_tasks,) + tuple(p.shape)), params)


def one_task(final_model_batched):
    """(gens, model, task_params [T, ...], k, points=None) -> params [T, ...]
    as (gen, model, task_params, k, points=None) -> params of one task."""

    def final_model(gen, model, task_params, inner_steps: int, points=None):
        tp = tuple(a[None] for a in task_params)
        pts = None if points is None else tuple(p[None] for p in points)
        return tree_map(lambda x: x[0], final_model_batched([gen], model, tp, inner_steps, pts))

    return final_model


def coef_funcs(field, final_model_batched, default_k: int, init_of, k0_shared: bool = True):
    """A driver's (deploy_final_model, make_coef_func, make_coef_func_batched)
    over its batched deployment `final_model_batched`; init_of: model -> the
    meta-learned params, the field at k = 0 when k0_shared (false for a
    jittered multi-start, which picks among jittered inits at k = 0 too)."""
    deploy_final_model = one_task(final_model_batched)

    def make_coef_func(gen, model, task_params, coords, inner_steps=None):
        k = default_k if inner_steps is None else inner_steps
        final_params = deploy_final_model(gen, model, task_params, k)
        with torch.no_grad():
            return torch.squeeze(field.apply_inference(final_params, coords))

    def make_coef_func_batched(gens, model, task_params, coords, inner_steps=None,
                               points=None):
        """The JAX package's jax.vmap(make_coef_func, (0, None, 0, 0)): one
        batched adaptation of every task (gens[i], task_params[i], and
        points per kind [T, sets, n, ...] when given), then one batched
        inference on the stacked params, or on the shared init at k = 0.
        coords [T, V, d] -> [T, V] or [T, V, out]; coords [T, S, V, d] (S
        coordinate sets a task, e.g. a mirror) -> [T, S, ...], still one
        inference call, each task's params repeated for its S sets."""
        k = default_k if inner_steps is None else inner_steps
        if k == 0 and k0_shared:
            final_params, shared = init_of(model), True
        else:
            final_params = final_model_batched(gens, model, tree_stack(task_params), k, points)
            shared = False
        lead = coords.shape[:-2]
        if len(lead) == 2 and not shared:
            final_params = tree_map(lambda p: p.repeat_interleave(lead[1], dim=0), final_params)
        with torch.no_grad():
            out = field.apply_inference_batched(final_params, coords.reshape(-1, *coords.shape[-2:]),
                                                shared=shared)
        return out.reshape(*lead, *out.shape[1:])

    return deploy_final_model, make_coef_func, make_coef_func_batched


def make_opt_final_model(pde, loss_fn, field, task_cfg, deploy_cfg, model_is_pair: bool):
    """(gens, model, task_params, inner_steps, points=None) -> the adapted
    params of T tasks, each leaf [T, ...].

    model_is_pair: MAML passes (params, learned LRs), LEAP passes params.
    task_params: each leaf stacked [T, ...]. points: per point kind
    [T, 1, n, ...] (tests pass the points JAX drew), else one set of
    task_cfg.inner_points drawn per task from gens[i]."""
    opt = get_optimizer(deploy_cfg.optimizer, deploy_cfg.inner_lr)

    def task_loss(fp, pts, tp):
        return loss_fn(field.bind(fp), pts, tp)

    vloss = torch.func.vmap(task_loss)

    def final_model_batched(gens, model, task_params, inner_steps: int, points=None):
        params = model[0] if model_is_pair else model
        theta = expand_tasks(params, task_params[0].shape[0])
        if inner_steps == 0:
            return theta
        if points is None:
            points = draw_sets(pde, gens, task_cfg.inner_points, task_params, 1)
        pts = tuple(p[:, 0] for p in points)
        state = opt.init(theta)
        with mixed_precision_scope(field.cfg):
            for _ in range(int(inner_steps)):
                leaves = [t.detach().requires_grad_(True) for t in tree_leaves(theta)]
                with torch.enable_grad():
                    loss, _ = vloss(tree_unflatten(theta, leaves), pts, task_params)
                    grads = torch.autograd.grad(loss.sum(), leaves)
                with torch.no_grad():
                    updates, state = opt.update(tree_unflatten(theta, grads), state, theta)
                    theta = apply_updates(theta, updates)
        return theta

    return final_model_batched
