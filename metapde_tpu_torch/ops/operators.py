"""Differential operators for neural fields
(counterpart of metapde_tpu/ops/operators.py), built with torch.func.

As in the JAX package, every operator is forward-over-reverse: a JVP of
torch.func.grad along each coordinate basis vector, taken at one point. The
*point* functions take a single coordinate x of shape [d]; the vmap_*
wrappers lift them over a batch of points [N, d] with torch.func.vmap. d is
a Python int (x.shape[-1]), so the loop over basis vectors unrolls.

Params captured by the field functions stay leaves of ordinary autograd:
torch.autograd.grad of an operator's output differentiates through the
torch.func transforms (the MAML inner loop needs that).
"""

from functools import partial

import torch
from torch.func import grad, jvp, vmap


def _basis_like(x, i):
    """The i-th coordinate basis vector, with x's dtype and device."""
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)[i]


def laplacian(potential_fn, x):
    """Trace of the Hessian of a scalar field at x ([d] -> scalar), as
    sum_i d^2 u / dx_i^2 from JVPs of grad(u)."""
    grad_fn = grad(lambda y: torch.sum(potential_fn(y)))
    total = 0.0
    for i in range(x.shape[-1]):
        _, hess_col = jvp(grad_fn, (x,), (_basis_like(x, i),))
        total = total + hess_col[i]
    return total


def weighted_laplacian(potential_fn, weight_fn, x):
    """div(w(x) * grad(u))(x) for scalar u, the nonlinear-Poisson operator:
    the trace of d/dx [grad u(x) * w(x)]."""

    def flux(y):
        return grad(lambda z: torch.sum(potential_fn(z)))(y) * weight_fn(y)

    total = 0.0
    for i in range(x.shape[-1]):
        _, dflux = jvp(flux, (x,), (_basis_like(x, i),))
        total = total + dflux[i]
    return total


def hessian_diag(potential_fn, x):
    """[d] vector of d^2 u / dx_i^2 at x."""
    grad_fn = grad(lambda y: torch.sum(potential_fn(y)))
    cols = []
    for i in range(x.shape[-1]):
        _, hess_col = jvp(grad_fn, (x,), (_basis_like(x, i),))
        cols.append(hess_col[i])
    return torch.stack(cols)


def divergence(field_fn, x):
    """Divergence of a vector field u: R^d -> R^d at x."""
    total = 0.0
    for i in range(x.shape[-1]):
        _, jac_col = jvp(lambda y: torch.reshape(field_fn(y), (-1,)), (x,),
                         (_basis_like(x, i),))
        total = total + jac_col[i]
    return total


def divergence_tensor(tensor_fn, x):
    """Row-wise divergence of a tensor field T: R^d -> R^{k x d} at x:
    out[k] = sum_i dT[k, i] / dx_i."""
    cols = []
    for i in range(x.shape[-1]):
        _, jac_col = jvp(lambda y: torch.squeeze(tensor_fn(y)), (x,), (_basis_like(x, i),))
        cols.append(jac_col[..., i])
    return sum(cols)


def vmap_laplacian(points, potential_fn, weight_fn=None):
    """Laplacian (optionally coefficient-weighted) over a [N, d] point batch."""
    if weight_fn is None:
        return vmap(partial(laplacian, potential_fn))(points)
    return vmap(partial(weighted_laplacian, potential_fn, weight_fn))(points)


def vmap_weighted_laplacian(points, potential_fn, weight_fn):
    return vmap(partial(weighted_laplacian, potential_fn, weight_fn))(points)


def vmap_divergence(points, field_fn):
    return vmap(partial(divergence, field_fn))(points)


def vmap_divergence_tensor(points, tensor_fn):
    return vmap(partial(divergence_tensor, tensor_fn))(points)
