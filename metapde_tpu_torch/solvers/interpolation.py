"""Solution-transfer interpolators (counterpart of
metapde_tpu/solvers/interpolation.py).

Built once, generically, from any evaluation function via torch.func:

- TaylorLookup: tabulate (u, grad u, hess u) at anchor points, evaluate by
  second-order Taylor expansion around the nearest anchor.
- knn_interpolant: low-temperature-softmax 5-NN interpolation over sampled
  values with a definedness mask.

Both evaluate one point x [dim]; torch.func.vmap lifts them over a batch.
"""

from typing import Callable, NamedTuple

import torch
from torch.func import hessian, jacfwd, vmap


class TaylorLookup(NamedTuple):
    """Second-order Taylor tables around anchor points."""

    x0s: torch.Tensor  # [M, dim]
    u0s: torch.Tensor  # [M, d]
    g0s: torch.Tensor  # [M, d, dim]
    h0s: torch.Tensor  # [M, d, dim, dim]


def build_taylor_lookup(fn: Callable, x0s) -> TaylorLookup:
    """Tabulate fn (x [dim] -> [d] or scalar) and its first two derivatives
    at the anchor points x0s [M, dim]."""
    x0s = torch.as_tensor(x0s)

    def as_vec(x):
        return torch.atleast_1d(fn(x))

    u0s = vmap(as_vec)(x0s)
    # in the values' dtype: torch's forward-mode tangent of a product of a
    # 0-d tensor and a Python float can come back in float64
    return TaylorLookup(x0s=x0s, u0s=u0s, g0s=vmap(jacfwd(as_vec))(x0s).to(u0s.dtype),
                        h0s=vmap(hessian(as_vec))(x0s).to(u0s.dtype))


def taylor_eval(lookup: TaylorLookup, x):
    """The expansion at x [dim] around the nearest anchor -> [d]."""
    i = torch.argmin(torch.sum((lookup.x0s - x[None, :]) ** 2, dim=1))
    dx = x - lookup.x0s[i]
    return (lookup.u0s[i] + lookup.g0s[i] @ dx
            + 0.5 * torch.einsum("a,dab,b->d", dx, lookup.h0s[i], dx))


def knn_interpolant(xys, values, mask=None, k: int = 5, temp: float = 1.0):
    """Softmax-weighted k-NN interpolant over sampled (xy, value) pairs;
    returns fn x [dim] -> [d]. Masked (undefined) samples neither take a
    neighbour slot nor receive weight."""
    xys = torch.as_tensor(xys)
    values = torch.atleast_2d(torch.as_tensor(values))
    if values.shape[0] != xys.shape[0]:
        values = values.T
    mask = (torch.ones(xys.shape[0], dtype=xys.dtype, device=xys.device) if mask is None
            else torch.as_tensor(mask, dtype=torch.float32))
    valid = mask > 0.5

    def interp(x):
        dists = torch.sum((xys - x[None, :]) ** 2, dim=1)
        # masked samples are pushed past every valid distance, and their
        # logits go to -inf (a zero logit would still win weight e^0)
        dists = torch.where(valid, dists, torch.full_like(dists, float("inf")))
        neg_top, inds = torch.topk(-dists, k)
        logits = torch.where(valid[inds], temp / (-neg_top + 1e-14),
                             torch.full_like(neg_top, -float("inf")))
        w = torch.softmax(logits, dim=0)
        return torch.einsum("k,kd->d", w, values[inds])

    return interp
