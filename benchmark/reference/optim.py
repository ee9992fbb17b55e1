"""Adam over flat dicts of tensors, and the run's hyperparameters."""

import contextlib

import torch


def hyper(config: dict) -> dict:
    """The configuration's settings and flags as typed values, by their
    dotted names: "true"/"false" as bools, numbers as ints or floats."""
    def typed(v):
        if not isinstance(v, str):
            return v
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        for kind in (int, float):
            try:
                return kind(v)
            except ValueError:
                pass
        return v
    return {k: typed(v) for k, v in {**config["settings"], **config["flags"]}.items()}


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls in full precision (TF32 off), or in TF32 for the
    control; the flags as they were afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def adam_init(params: dict) -> dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def adam(params: dict, grads: dict, state: dict, lr: float, b1=0.9, b2=0.99, eps=1e-8):
    """One Adam step, p - lr * m_hat / (sqrt(v_hat) + eps), elementwise (a
    leading task axis rides along). Returns (params, state)."""
    count = state["count"] + 1
    mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
    nu = {k: b2 * state["nu"][k] + (1 - b2) * g * g for k, g in grads.items()}
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new = {k: p - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps) for k, p in params.items()}
    return new, {"count": count, "mu": mu, "nu": nu}


def clip_scale(sum_sq: torch.Tensor, clip: float) -> torch.Tensor:
    """The factor that brings a (per-task) global norm down to `clip`."""
    norm = torch.sqrt(sum_sq)
    return torch.where(norm > clip, clip / norm.clamp(min=1e-30), torch.ones_like(norm))


def sum_sq(tree: dict, task_axis: bool = False) -> torch.Tensor:
    """The sum of squares of every leaf: a scalar, or one a task [T]."""
    if task_axis:
        return sum((g ** 2).flatten(1).sum(1) for g in tree.values())
    return sum((g ** 2).sum() for g in tree.values())
