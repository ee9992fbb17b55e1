"""LEAP: first-order meta-learning over the inner loop's trajectory
(counterpart of metapde_tpu/meta/leap.py).

Semantics kept from the JAX package:
- inner step: the gradient of the task loss, global-norm clipped at
  `inner_grad_clip`, then the inner optimizer (Adam in the driver); that
  clipped gradient also enters the increment.
- increment: (theta_old - theta_new) - d_loss * grad, with
  d_loss = loss(theta_new) - loss(theta_old), stabilized to -|d_loss|;
  the d_loss term only with `loss_in_distance`.
- normalized (with `norm`) by the task-manifold distance
  sqrt(||theta_new - theta_old||^2 + d_loss^2) over every leaf of one task,
  the d_loss term only with `loss_in_distance`.
- losses [K + 1]: the loss at the init, then the loss after each step; the
  meta-gradient is the mean over tasks of the summed increments.

A batch of T tasks runs at once: every leaf carries a leading task axis,
each step's per-task losses come from torch.func.vmap of the per-task loss,
and the gradients are torch.autograd.grad of the losses' sum (each task's
own, since the tasks are independent). The clip, the optimizer, d_loss, the
norm and the increment are per task. The method is first order: each step
works on detached tensors, so memory does not grow with the inner steps
and nothing needs rematerializing (the JAX package's `remat`, which its
driver never sets, has no counterpart). The task count is the batch's.

Points are given, not drawn: `TaskBatch.points` holds, per point kind,
[T, 2K + 1, n, ...] in the order the JAX key chain consumes them. Set 0
gives the loss at the init (the first key of split(key)); for inner step k
(from 1), set 2k - 1 gives the gradient (its k1) and set 2k the loss after
the step (its k2).

Collocation points sharded over a pt process group (``pt_axis``, set by
parallel/sharding.py): each rank's losses are means over its own part of
the points; the loss and gradient of each step (one collective), the loss
after it and the loss at the init are averaged over pt before the clip,
Adam and the increment, so every pt rank walks the same trajectory and
holds the same accumulator. No autograd crosses a collective: the method
is first order.
"""

from typing import Callable, NamedTuple, Optional

import torch

from ..parallel.mesh import tree_mean
from ..train.optimizers import Optimizer, apply_updates
from ..utils.trees import (clip_by_global_norm_per_task, per_task, sum_sq_per_task,
                           tree_leaves, tree_map, tree_unflatten)


class LeapDef(NamedTuple):
    """Algorithm-level LEAP parameters."""

    inner_opt: Optimizer
    inner_steps: int
    norm: bool              # normalize increments by the task-manifold norm
    loss_in_distance: bool  # include d_loss in the manifold metric
    stabilize: bool         # d_loss <- -|d_loss|
    inner_grad_clip: float
    pt_axis: Optional[object] = None  # the pt process group, or None


class TaskBatch(NamedTuple):
    """T tasks' params (each leaf [T, ...]) and point sets (per point kind
    [T, sets, n, ...]; the module docstring gives the order)."""

    task_params: tuple
    points: tuple


def _set(points, s):
    return tree_map(lambda x: x[:, s], points)


def compute_global_norm(leap_def: LeapDef, new_params, old_params, d_loss):
    """The distance on the task manifold of each task: [T]."""
    sum_sq = sum_sq_per_task(tree_map(lambda a, b: a - b, new_params, old_params))
    if leap_def.loss_in_distance:
        sum_sq = sum_sq + d_loss ** 2
    return torch.sqrt(sum_sq)


def get_meta_grad_increment(leap_def: LeapDef, new_params, params, new_loss, loss, grad):
    """The pull-forward increment of each task (leaves [T, ...], losses [T])."""
    d_loss = new_loss - loss
    if leap_def.stabilize:
        d_loss = -torch.abs(d_loss)
    increment = tree_map(lambda x, y: x - y, params, new_params)
    if leap_def.loss_in_distance:
        increment = tree_map(lambda x, g: x - per_task(d_loss, x) * g, increment, grad)
    if leap_def.norm:
        norm = compute_global_norm(leap_def, new_params, params, d_loss)
        increment = tree_map(lambda x: x / per_task(norm, x), increment)
    return increment


def leap_inner_step(leap_def: LeapDef, loss_fn: Callable, params, opt_state, accum,
                    grad_points, loss_points=None):
    """One inner step of T tasks, and the accumulator's update.

    loss_fn: (params [T, ...], points) -> (losses [T], aux). Returns
    (new params, optimizer state, accumulator, losses after the step),
    detached. With accum None (deployment) the step stops at the update:
    no second forward, no increment, and the last two are None."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(tree_unflatten(params, leaves), grad_points)
        grads = torch.autograd.grad(loss.sum(), leaves)
    with torch.no_grad():
        grads, loss = tree_mean((tree_unflatten(params, grads), loss.detach()),
                                leap_def.pt_axis)
        grad, _ = clip_by_global_norm_per_task(grads, leap_def.inner_grad_clip)
        updates, opt_state = leap_def.inner_opt.update(grad, opt_state, params)
        new_params = apply_updates(params, updates)
        if accum is None:
            return new_params, opt_state, None, None
        new_loss = tree_mean(loss_fn(new_params, loss_points)[0], leap_def.pt_axis)
        increment = get_meta_grad_increment(leap_def, new_params, params, new_loss, loss,
                                            grad)
        accum = tree_map(lambda a, i: a + i, accum, increment)
    return new_params, opt_state, accum, new_loss


def rollout(leap_def: LeapDef, task_loss: Callable, batch: TaskBatch, initial_params,
            accumulate: bool = True):
    """Adapt T tasks from one shared init (leaves without the task axis)
    with `inner_steps` inner steps.

    task_loss: (params, points, task_params) -> (loss, aux) for ONE task;
    it is vmapped over the task axis. With `accumulate`, batch.points holds
    2K + 1 sets and the result is (final params, meta-gradient accumulator,
    losses [T, K + 1]). Without it (deployment, which keeps only the final
    params) the points hold K sets, set k - 1 feeding step k's gradient,
    and the result is (final params, None, None)."""
    k_steps = leap_def.inner_steps
    sets = tree_leaves(batch.points)[0].shape[1]
    if sets != (2 * k_steps + 1 if accumulate else k_steps):
        raise ValueError(f"{sets} point sets for {k_steps} inner steps "
                         f"({'with' if accumulate else 'without'} the accumulator)")
    n_tasks = batch.task_params[0].shape[0]
    vloss = torch.func.vmap(task_loss)

    def loss_fn(p, pts):
        return vloss(p, pts, batch.task_params)

    theta = tree_map(lambda p: p.detach().expand((n_tasks,) + tuple(p.shape)), initial_params)
    opt_state = leap_def.inner_opt.init(theta)
    if not accumulate:
        for k in range(k_steps):
            theta, opt_state, _, _ = leap_inner_step(
                leap_def, loss_fn, theta, opt_state, None, _set(batch.points, k))
        return theta, None, None
    with torch.no_grad():
        losses = [tree_mean(loss_fn(theta, _set(batch.points, 0))[0], leap_def.pt_axis)]
    accum = tree_map(torch.zeros_like, theta)
    for k in range(1, k_steps + 1):
        theta, opt_state, accum, new_loss = leap_inner_step(
            leap_def, loss_fn, theta, opt_state, accum, _set(batch.points, 2 * k - 1),
            _set(batch.points, 2 * k))
        losses.append(new_loss)
    return theta, accum, torch.stack(losses, dim=1)


def _one(task):
    return TaskBatch(*(tree_map(lambda x: x[None], part) for part in task))


def single_task_rollout(leap_def: LeapDef, task_loss: Callable, task: TaskBatch,
                        initial_params):
    """rollout of one task: `task` holds its draws without the task axis.
    Returns (final params, meta-gradient accumulator, losses [K + 1])."""
    out = rollout(leap_def, task_loss, _one(task), initial_params)
    return tree_map(lambda x: x[0], out)


def multi_task_grad_and_losses(leap_def: LeapDef, task_loss: Callable, batch: TaskBatch,
                               initial_params):
    """The mean over T tasks of the LEAP meta-gradient. Returns
    (meta_grad, losses [T, K + 1])."""
    _, accum, losses = rollout(leap_def, task_loss, batch, initial_params)
    return tree_map(lambda g: g.mean(dim=0), accum), losses


def single_task_grad_and_losses(leap_def: LeapDef, task_loss: Callable, task: TaskBatch,
                                initial_params):
    """The meta-gradient of one task (draws without the task axis). Returns
    (meta_grad, losses [K + 1])."""
    grad, losses = multi_task_grad_and_losses(leap_def, task_loss, _one(task), initial_params)
    return grad, losses[0]
