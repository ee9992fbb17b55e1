"""MAML inner loop with learned per-parameter per-step inner learning rates
(counterpart of metapde_tpu/meta/maml.py, deployment side).

Semantics kept from the JAX package:
- inner update: grad * softplus(lr) per parameter, then a global-norm clip
  at `inner_grad_clip`, then SGD at `inner_lr` (optax.sgd: p - inner_lr * g).
- rollout losses: the inner loss before each step and after the last one,
  shape [inner_steps + 1]; with an outer loss, the decayed accumulation
  L <- outer(theta_t) + decay * L along the trajectory.

Deployment needs first-order gradients only: each step takes
torch.autograd.grad of the inner loss at detached params, without
create_graph. The meta-gradient through the unroll (second order) belongs
to the training slice and is not ported yet.
"""

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.trees import (clip_by_global_norm, tree_leaves, tree_map,
                           tree_structure_equal, tree_unflatten)


class MamlDef(NamedTuple):
    """Algorithm-level MAML parameters (the inner optimizer is SGD)."""

    inner_lr: float
    inner_steps: int
    softplus_lrs: bool
    outer_loss_decay: float
    inner_grad_clip: float


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
