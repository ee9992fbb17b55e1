"""MAML inner loop with learned per-parameter per-step inner learning rates
(counterpart of metapde_tpu/meta/maml.py, deployment side).

Semantics kept from the JAX package:
- inner update: grad * softplus(lr) per parameter, then a global-norm clip
  at `inner_grad_clip`, then SGD at `inner_lr` (optax.sgd: p - inner_lr * g).
- rollout losses: the inner loss before each step and after the last one,
  shape [inner_steps + 1]; with an outer loss, the decayed accumulation
  L <- outer(theta_t) + decay * L along the trajectory.

Deployment (maml_inner_step, single_task_rollout) needs first-order
gradients only: each step takes torch.autograd.grad of the inner loss at
detached params, without create_graph.

Training (single_task_grad_and_losses, multi_task_grad_and_losses)
differentiates through the unroll with respect to the initial params and
the learned LRs (second order). A batch of T tasks runs at once: the params
and LRs are leaves that require grad; the params are expanded to a leading
task axis; each step's per-task losses come from torch.func.vmap of the
per-task loss (forward only); the inner gradients are
torch.autograd.grad(..., create_graph=True) of the losses' sum, which gives
each task its own gradient, since the tasks are independent; the clip norm is
per task. The meta-gradient of the mean meta-loss equals the JAX package's
mean over tasks of per-task meta-gradients, because the backward of expand
sums over the task axis. ``remat`` wraps each inner step in
torch.utils.checkpoint (non-reentrant), the counterpart of jax.checkpoint.

Collocation points sharded over a pt process group (``pt_axis``, set by
parallel/sharding.py): each rank's losses are means over its own part of
the points. Each inner gradient [T, ...] is averaged over pt through
AllReduceSum (outside vmap, before the LR scaling and the clip, as the JAX
package's pmean), so every pt rank walks the same trajectory. The
meta-gradient: each rank backpropagates its LOCAL meta-loss (the backward
of AllReduceSum sums the ranks' cotangents; seeding it with an already
reduced loss would count each one n_pt times), then the parameter and LR
gradients are averaged over pt. The logged losses, meta-losses and outer
aux are separate, non-differentiable pt means. Under pt the rollout takes
no remat: torch.utils.checkpoint would run each step's collective again in
the backward, from autograd nodes that its recompute creates on the CUDA
device thread, whose order against the backward's own collectives (the
same size) follows that thread's history; ranks with other histories (rank
0 validates, or took another config's step) then paired different tensors
in one all_reduce, a meta-gradient 1e4-1e6 times too large on the card
(the CPU runs the whole backward on the calling thread).
"""

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import tree_mean
from ..utils import spans
from ..utils.trees import (clip_by_global_norm, clip_by_global_norm_per_task, tree_leaves,
                           tree_map, tree_structure_equal, tree_unflatten)


class MamlDef(NamedTuple):
    """Algorithm-level MAML parameters (the inner optimizer is SGD).

    ``unroll`` is lax.scan's unroll factor in the JAX package, a compile-time
    knob with nothing to do in eager code: it is accepted and ignored.
    ``pt_axis``: the pt process group when the collocation points are
    sharded (parallel/sharding.py), else None."""

    inner_lr: float
    inner_steps: int
    softplus_lrs: bool
    outer_loss_decay: float
    inner_grad_clip: float
    remat: bool = True
    unroll: int = 1
    pt_axis: Optional[object] = None


class TaskBatch(NamedTuple):
    """One outer step's draws for T tasks (or one task, without the T axis,
    for single_task_grad_and_losses). Point sets are tuples of tensors with
    axes [T, K + 1, n, ...]: inner set t feeds inner step t and set K the
    final inner loss; outer set t feeds the outer loss after step t and set
    K the outer aux at the final params (the JAX key chain's k1 and k2 of
    each step, its final key and its outer_loss_key)."""

    task_params: tuple
    inner_points: tuple
    outer_points: tuple


def _scale_by_lrs(grads, inner_lr, softplus: bool):
    act = F.softplus if softplus else (lambda t: t)
    if tree_structure_equal(grads, inner_lr):
        return tree_map(lambda g, lr: g * act(lr), grads, inner_lr)
    return tree_map(lambda g: g * act(inner_lr), grads)


def maml_inner_step(maml_def: MamlDef, params, inner_loss_fn: Callable, inner_lr):
    """One inner step: lr-scaled, clipped gradient descent.

    inner_loss_fn: params -> (loss, aux). inner_lr: a tree congruent to
    params (learned LRs) or a scalar. Returns (new params, loss), detached.
    """
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        loss, _aux = inner_loss_fn(p)
        grads = torch.autograd.grad(loss, leaves)
    grads = _scale_by_lrs(tree_unflatten(params, grads), inner_lr, maml_def.softplus_lrs)
    grads, _ = clip_by_global_norm(grads, maml_def.inner_grad_clip)
    new = tree_map(lambda x, g: x.detach() - maml_def.inner_lr * g, params, grads)
    return new, loss.detach()


def single_task_rollout(
    maml_def: MamlDef,
    initial_params,
    inner_loss_fn: Callable,
    inner_lrs=None,
    outer_loss_fn: Optional[Callable] = None,
):
    """Adapt `initial_params` on one task with `inner_steps` inner steps.

    inner_lrs: a tree congruent to params stacked [inner_steps, ...] (learned
    LRs), or None for unit LRs. Returns final_params, (meta_loss, losses)
    where losses has shape [inner_steps + 1].
    """
    params = initial_params
    losses = []
    meta_loss = torch.zeros(())
    for t in range(maml_def.inner_steps):
        lr = torch.ones(()) if inner_lrs is None else tree_map(lambda x: x[t], inner_lrs)
        params, loss = maml_inner_step(maml_def, params, inner_loss_fn, lr)
        losses.append(loss)
        if outer_loss_fn is not None:
            with torch.no_grad():
                meta_loss = outer_loss_fn(params)[0] + meta_loss * maml_def.outer_loss_decay
    with torch.no_grad():
        losses.append(inner_loss_fn(params)[0])
    return params, (meta_loss, torch.stack(losses))


def _set(points, s):
    return tree_map(lambda x: x[:, s], points)


def _batched_rollout(maml_def: MamlDef, task_loss: Callable, batch: TaskBatch,
                     params_t, inner_lrs, create_graph: bool):
    """Roll T tasks out together from params_t (leaves [T, ...]).

    Returns final params, the inner losses [T, K + 1] and the decayed outer
    losses [T]. With create_graph the whole unroll stays differentiable
    (second order); without it, each step works on detached params.
    """
    vloss = torch.func.vmap(task_loss)
    decay = maml_def.outer_loss_decay

    def step(theta, lr, inner_pts, outer_pts):
        leaves = tree_leaves(theta)
        if not create_graph:
            leaves = [l.detach().requires_grad_(True) for l in leaves]
            theta = tree_unflatten(theta, leaves)
        with torch.enable_grad():
            loss, _ = vloss(theta, inner_pts, batch.task_params)
            grads = torch.autograd.grad(loss.sum(), leaves, create_graph=create_graph)
        if maml_def.pt_axis is not None:
            # the full point set's gradient, one collective for the tree
            grads = tree_mean(list(grads), maml_def.pt_axis, differentiable=create_graph)
        grads = _scale_by_lrs(tree_unflatten(theta, grads), lr, maml_def.softplus_lrs)
        grads, _ = clip_by_global_norm_per_task(grads, maml_def.inner_grad_clip)
        new = tree_map(lambda p, g: p - maml_def.inner_lr * g, theta, grads)
        if not create_graph:
            new = tree_map(torch.Tensor.detach, new)
        with torch.set_grad_enabled(create_graph):
            outer, _ = vloss(new, outer_pts, batch.task_params)
        return new, loss.detach(), outer

    if maml_def.remat and create_graph and maml_def.pt_axis is None:
        plain_step = step

        def step(*args):
            return checkpoint(plain_step, *args, use_reentrant=False)

    theta, losses, meta_loss = params_t, [], None
    for t in range(maml_def.inner_steps):
        lr = inner_lrs[t] if torch.is_tensor(inner_lrs) else tree_map(
            lambda x: x[t], inner_lrs)
        # the span outside the checkpoint: remat's recompute reruns `step`
        # inside the meta-backward
        with spans.span("maml.inner_step"):
            theta, loss, outer = step(theta, lr, _set(batch.inner_points, t),
                                      _set(batch.outer_points, t))
        losses.append(loss)
        meta_loss = outer if meta_loss is None else outer + meta_loss * decay
    with torch.no_grad():
        k = maml_def.inner_steps
        losses.append(vloss(theta, _set(batch.inner_points, k), batch.task_params)[0])
    return theta, torch.stack(losses, dim=1), meta_loss


def multi_task_grad_and_losses(maml_def: MamlDef, task_loss: Callable, batch: TaskBatch,
                               initial_params, inner_lrs=None, need_grad: bool = True):
    """The mean over T tasks of the second-order meta-gradient.

    task_loss: (params, points, task_params) -> (loss, aux dict) for ONE
    task; it is vmapped over the task axis. batch: the T tasks' draws.
    inner_lrs: a tree congruent to params stacked [K, ...] (learned LRs) or
    None for unit LRs. Returns (meta_grad, losses [T, K + 1], (meta_loss
    [T], outer_aux)), where meta_grad is (params grad, LRs grad), or the
    params grad alone for unit LRs, and outer_aux is the outer loss's aux
    dict at the final params on the aux point set. With need_grad=False the
    unroll is first order and meta_grad is None (the losses are the same).
    With maml_def.pt_axis set, every output is the mean over the pt group.
    """
    n_tasks = batch.task_params[0].shape[0]
    params = tree_map(lambda p: p.detach().requires_grad_(need_grad), initial_params)
    if inner_lrs is None:
        lrs = torch.ones(maml_def.inner_steps, device=tree_leaves(params)[0].device)
    else:
        lrs = tree_map(lambda x: x.detach().requires_grad_(need_grad), inner_lrs)
    params_t = tree_map(lambda p: p.expand((n_tasks,) + tuple(p.shape)), params)
    with torch.set_grad_enabled(need_grad):
        final, losses, meta_loss = _batched_rollout(
            maml_def, task_loss, batch, params_t, lrs, create_graph=need_grad)
    with torch.no_grad():
        _, outer_aux = torch.func.vmap(task_loss)(
            tree_map(torch.Tensor.detach, final), _set(batch.outer_points, maml_def.inner_steps),
            batch.task_params)
    meta_grad = None
    if need_grad:
        wrt = tree_leaves(params) + ([] if inner_lrs is None else tree_leaves(lrs))
        with spans.span("maml.meta_backward"):
            flat = torch.autograd.grad(meta_loss.mean(), wrt)
        n = len(tree_leaves(params))
        meta_grad = tree_unflatten(params, flat[:n])
        if inner_lrs is not None:
            meta_grad = (meta_grad, tree_unflatten(lrs, flat[n:]))
    out = (losses, meta_loss.detach(), outer_aux) + ((meta_grad,) if need_grad else ())
    out = tree_mean(out, maml_def.pt_axis)  # one collective: grads and logged losses
    losses, meta_loss, outer_aux = out[:3]
    return (out[3] if need_grad else None), losses, (meta_loss, outer_aux)


def single_task_grad_and_losses(maml_def: MamlDef, task_loss: Callable, task: TaskBatch,
                                initial_params, inner_lrs=None):
    """The meta-gradient of one task: multi_task_grad_and_losses with T = 1.
    `task` holds the draws without the task axis. Returns (meta_grad, losses
    [K + 1], (meta_loss, outer_aux))."""
    batch = TaskBatch(*(tree_map(lambda x: x[None], part) for part in task))
    grad, losses, (meta_loss, aux) = multi_task_grad_and_losses(
        maml_def, task_loss, batch, initial_params, inner_lrs)
    return grad, losses[0], (meta_loss[0], tree_map(lambda x: x[0], aux))
