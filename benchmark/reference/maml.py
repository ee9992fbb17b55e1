"""Second-order MAML with learned per-parameter, per-step inner learning
rates: the reference of one outer step.

Each task adapts its own copy of the init by K inner steps,
    theta <- theta - inner_lr * clip(softplus(lr_t) * grad L_inner(theta)),
the clip being the task's global norm at inner_grad_clip; the meta-loss
accumulates the outer loss after every step, M <- L_outer + decay * M. Its
mean over the tasks is differentiated through the whole unroll, with
respect to the init and the learning rates (second order). The gradient is
clipped to grad_clip by the init's part of its norm, the scale applied to
both parts, then Adam steps the init (outer_lr) and the learning rates
(lr_inner_lr).

Tasks go through in blocks of `block` so that the unroll's graph fits; the
gradient is the sum of the blocks' parts.
"""

import torch
import torch.nn.functional as F

from .optim import adam, adam_init, clip_scale, sum_sq


def init_state(params: dict, hp: dict) -> dict:
    k = hp["maml.inner_steps"]
    lrs = {n: torch.ones((k,) + tuple(v.shape), device=v.device) for n, v in params.items()}
    return {"params": params, "lrs": lrs, "opt": adam_init(params), "lr_opt": adam_init(lrs)}


def _set(kinds, s, rows):
    return tuple(x[rows, s] for x in kinds)


def meta_gradient(params: dict, lrs: dict, batch: dict, task_loss, hp: dict, block: int):
    """(grad of the init, grad of the LRs, inner losses [T, K + 1], meta-loss [T])."""
    k, lr, clip = hp["maml.inner_steps"], hp["maml.inner_lr"], hp["maml.inner_grad_clip"]
    decay = hp["maml.outer_loss_decay"]
    tp = batch["tp"]
    n_tasks = tp[0].shape[0]
    block = block or n_tasks
    p0 = {n: v.detach().requires_grad_(True) for n, v in params.items()}
    l0 = {n: v.detach().requires_grad_(True) for n, v in lrs.items()}
    grads = {n: torch.zeros_like(v) for n, v in {**params, **lrs_named(lrs)}.items()}
    losses, metas = [], []
    for start in range(0, n_tasks, block):
        rows = slice(start, min(start + block, n_tasks))
        b = rows.stop - rows.start
        task = tuple(x[rows] for x in tp)
        theta = {n: v.expand((b,) + tuple(v.shape)) for n, v in p0.items()}
        meta, inner = None, []
        with torch.enable_grad():
            for t in range(k):
                loss = task_loss(theta, _set(batch["inner"], t, rows), task, hp)
                g = torch.autograd.grad(loss.sum(), list(theta.values()), create_graph=True)
                g = {n: gi * F.softplus(l0[n][t]) for n, gi in zip(theta, g)}
                scale = clip_scale(sum_sq(g, task_axis=True), clip)
                theta = {n: theta[n] - lr * g[n] * scale.reshape((-1,) + (1,) * (g[n].ndim - 1))
                         for n in theta}
                outer = task_loss(theta, _set(batch["outer"], t, rows), task, hp)
                meta = outer if meta is None else outer + decay * meta
                inner.append(loss.detach())
            part = torch.autograd.grad(meta.sum() / n_tasks, list(p0.values()) + list(l0.values()))
        with torch.no_grad():
            inner.append(task_loss(theta, _set(batch["inner"], k, rows), task, hp))
        for n, gi in zip(list(grads), part):
            grads[n] += gi
        losses.append(torch.stack(inner, 1))
        metas.append(meta.detach())
    gp = {n: grads[n] for n in params}
    gl = {n: grads["lr:" + n] for n in lrs}
    return gp, gl, torch.cat(losses), torch.cat(metas)


def lrs_named(lrs: dict) -> dict:
    return {"lr:" + n: v for n, v in lrs.items()}


def step(state: dict, batch: dict, task_loss, hp: dict, block: int):
    """One outer step. Returns (state, {"ml": mean meta-loss, "losses":
    [T, K + 1], "grad": the clipped meta-gradient by leaf name, as the
    optimizers take it})."""
    gp, gl, losses, meta = meta_gradient(state["params"], state["lrs"], batch, task_loss, hp,
                                         block)
    with torch.no_grad():
        scale = clip_scale(sum_sq(gp), hp["maml.grad_clip"])
        gp = {n: g * scale for n, g in gp.items()}
        gl = {n: g * scale for n, g in gl.items()}
        params, opt = adam(state["params"], gp, state["opt"], hp["maml.outer_lr"])
        lrs, lr_opt = adam(state["lrs"], gl, state["lr_opt"], hp["maml.lr_inner_lr"])
    return ({"params": params, "lrs": lrs, "opt": opt, "lr_opt": lr_opt},
            {"ml": meta.mean(), "losses": losses, "grad": {**gp, **lrs_named(gl)}})


def leaves(state: dict) -> dict:
    """The meta-parameters by name: the init's leaves and the LRs'."""
    return {**state["params"], **lrs_named(state["lrs"])}

