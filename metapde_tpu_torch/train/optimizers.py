"""Outer optimizers as functional state on parameter trees
(counterpart of metapde_tpu/train/optimizers.py, which builds them from optax).

An Optimizer is a pair of functions: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; ``apply_updates``
adds the updates to the params. States are plain dicts of tensors, so a
checkpoint pickles them as numpy trees that need neither torch nor the port
to unpickle.

- adam    -> optax.adam(lr, b1=0.9, b2=0.99), eps 1e-8
- rmsprop -> Adam with b1=0, b2=0.8 (the reference's "rmsprop")
- ranger  -> RAdam(lr, b2=0.99) inside the repo's lookahead (sync period 6,
             slow step 0.5, slow weights in the state)
- sgd     -> optax.sgd(lr)

The arithmetic follows optax's order of operations (moments, bias
correction, ``m / (sqrt(v) + eps)``, scaling by ``-lr``, ``p + u``), so
f32 results agree with optax to rounding. ``from_jax_state`` rebuilds a
state from a JAX checkpoint's optax state as train/checkpoints.py unpickles
it (inert placeholders in place of the optax classes).
"""

from typing import Callable, NamedTuple

import torch

from ..interop import params_from_numpy
from ..utils.trees import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable     # params -> state
    update: Callable   # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    """params + updates, leafwise (optax.apply_updates)."""
    return tree_map(lambda p, u: p + u, params, updates)


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _count0(params):
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _moments(grads, state, b1, b2):
    """optax's moment updates: (1 - b) * g**order + b * m."""
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
    return mu, nu, state["count"] + 1


def _bias_corrected(moment, decay, count):
    bc = 1 - decay ** count.to(torch.float32)
    return tree_map(lambda t: t / bc, moment)


def _moments_init(params):
    return {"count": _count0(params), "mu": _zeros(params), "nu": _zeros(params)}


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8):
    def update(grads, state, params=None):
        mu, nu, count = _moments(grads, state, b1, b2)
        mu_hat = _bias_corrected(mu, b1, count)
        nu_hat = _bias_corrected(nu, b2, count)
        out = tree_map(lambda m, v: m / (torch.sqrt(v) + eps), mu_hat, nu_hat)
        return out, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(_moments_init, update)


def scale_by_radam(b1=0.9, b2=0.999, eps=1e-8, threshold=5.0):
    """Rectified Adam as optax.scale_by_radam: the rectified step where the
    variance estimate is tractable (rho >= threshold), else the
    bias-corrected first moment."""
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def update(grads, state, params=None):
        mu, nu, count = _moments(grads, state, b1, b2)
        cf = count.to(torch.float32)
        b2t = b2 ** cf
        ro = ro_inf - 2 * cf * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                       / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        mu_hat = _bias_corrected(mu, b1, count)
        nu_hat = _bias_corrected(nu, b2, count)
        out = tree_map(
            lambda m, v: torch.where(ro >= threshold, r * m / (torch.sqrt(v) + eps), m),
            mu_hat, nu_hat)
        return out, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(_moments_init, update)


def _scaled(inner: Optimizer, lr: float) -> Optimizer:
    """inner followed by optax.scale_by_learning_rate(lr): updates * -lr."""
    def update(grads, state, params=None):
        u, state = inner.update(grads, state, params)
        return tree_map(lambda x: x * -lr, u), state

    return Optimizer(inner.init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _scaled(scale_by_adam(b1, b2, eps), lr)


def radam(lr, b1=0.9, b2=0.999, eps=1e-8, threshold=5.0) -> Optimizer:
    return _scaled(scale_by_radam(b1, b2, eps, threshold), lr)


def sgd(lr) -> Optimizer:
    return Optimizer(lambda params: {},
                     lambda grads, state, params=None: (
                         tree_map(lambda g: g * -lr, grads), state))


def lookahead(inner: Optimizer, sync_period: int = 6, slow_step: float = 0.5) -> Optimizer:
    """Lookahead with the slow weights in the state (the JAX package's
    optimizers.lookahead): fast weights take `inner` steps; every
    sync_period steps slow += slow_step * (fast - slow) and the emitted
    update moves the params to the new slow weights."""

    def init(params):
        return {"inner": inner.init(params), "slow": tree_map(torch.clone, params),
                "count": _count0(params)}

    def update(grads, state, params=None):
        del_updates, inner_state = inner.update(grads, state["inner"], params)
        fast = apply_updates(params, del_updates)
        count = state["count"] + 1
        sync = count % sync_period == 0
        slow_new = tree_map(lambda s, f: s + slow_step * (f - s), state["slow"], fast)
        out = tree_map(lambda du, sn, p: torch.where(sync, sn - p, du),
                       del_updates, slow_new, params)
        slow = tree_map(lambda s, sn: torch.where(sync, sn, s), state["slow"], slow_new)
        return out, {"inner": inner_state, "slow": slow, "count": count}

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float) -> Optimizer:
    if name == "adam":
        return adam(lr, b1=0.9, b2=0.99)
    if name == "rmsprop":
        return adam(lr, b1=0.0, b2=0.8)
    if name == "ranger":
        return lookahead(radam(lr, b2=0.99))
    if name == "sgd":
        return sgd(lr)
    raise ValueError(f"unknown optimizer: {name!r}")


def _adam_from_jax(scale_state, device):
    count, mu, nu = scale_state
    return {"count": torch.tensor(int(count), dtype=torch.int32, device=device),
            "mu": params_from_numpy(mu, device), "nu": params_from_numpy(nu, device)}


def from_jax_state(name: str, state, device="cpu"):
    """The port's state for optimizer `name` from a JAX checkpoint's optax
    state as train/checkpoints.load_checkpoint returns it: for adam and
    rmsprop ``((count, mu, nu), ())``, for ranger the lookahead's
    ``(inner, slow, count)`` around RAdam's, for sgd ``((), ())``."""
    if name in ("adam", "rmsprop"):
        return _adam_from_jax(state[0], device)
    if name == "ranger":
        inner, slow, count = state
        return {"inner": _adam_from_jax(inner[0], device),
                "slow": params_from_numpy(slow, device),
                "count": torch.tensor(int(count), dtype=torch.int32, device=device)}
    if name == "sgd":
        return {}
    raise ValueError(f"unknown optimizer: {name!r}")

