"""Gradient-conditioned field (counterpart of
metapde_tpu/models/gradient_conditioned.py): a model whose forward pass
adapts a copy of its params by `inner_steps` of SGD on a task's inner loss,
then evaluates the adapted field at the query points. No driver uses it.

first_order=True detaches each inner gradient (the JAX package's
stop_gradient), cutting the second-order terms; otherwise the inner
gradients keep their graph (create_graph=True) and the outer gradient
flows through them. learned_lrs=True learns the per-step rates as
params["log_lrs"], lr_i = inner_lr * exp(log_lrs[i]).
"""

from typing import Callable, NamedTuple

import torch

from ..config import FieldConfig
from ..utils.trees import tree_leaves, tree_map, tree_unflatten
from .siren import field_apply, init_field_params


class GradientConditionedFieldDef(NamedTuple):
    init: Callable   # (generator, device) -> params
    apply: Callable  # (params, inner_loss_fn, x) -> adapted field values
    cfg: FieldConfig


def make_gradient_conditioned_field(cfg: FieldConfig, inner_steps: int = 5,
                                    inner_lr: float = 1e-3, learned_lrs: bool = False,
                                    first_order: bool = False) -> GradientConditionedFieldDef:
    def init(gen, device="cpu"):
        params = {"base": init_field_params(gen, cfg, device)}
        if learned_lrs:
            params["log_lrs"] = torch.zeros(inner_steps, device=device)
        return params

    def apply(params, inner_loss_fn, x):
        """inner_loss_fn(field_fn) -> scalar loss, field_fn(y) the field of
        the params being adapted."""
        base = params["base"]
        lrs = (inner_lr * torch.exp(params["log_lrs"]) if learned_lrs
               else torch.full((inner_steps,), inner_lr, device=x.device))
        p = tree_map(lambda a: a if a.requires_grad else a.detach().requires_grad_(True), base)
        with torch.enable_grad():
            for i in range(inner_steps):
                loss = inner_loss_fn(lambda y, q=p: field_apply(q, y, cfg))
                grads = torch.autograd.grad(loss, tree_leaves(p), create_graph=not first_order)
                if first_order:
                    grads = [g.detach() for g in grads]
                p = tree_map(lambda a, g, lr=lrs[i]: a - lr * g, p, tree_unflatten(p, grads))
        return field_apply(p, x, cfg)

    return GradientConditionedFieldDef(init=init, apply=apply, cfg=cfg)
