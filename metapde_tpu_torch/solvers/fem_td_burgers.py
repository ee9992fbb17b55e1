"""Implicit-Euler CG1 FEM solver for 1-D viscous Burgers, the
``task.burgers_gt_solver=fem`` ground truth (counterpart of
metapde_tpu/solvers/fem_td_burgers.py).

- closed-form P1 element integrals on a uniform mesh (mass h/6 [1 4 1],
  stiffness 1/h [-1 2 -1], the quadratic advection integrals exact),
  assembled as stencil slices;
- each implicit-Euler step is a damped Newton solve with Jacobi-
  preconditioned matrix-free BiCGStab (solvers/newton.py) at the JAX
  package's settings: 12 Newton steps, rel_tol 1e-5, Krylov tol 1e-6 and
  200 iterations;
- substeps = ceil(segment dt / h), so dt ~ h.

It returns the same BurgersGroundTruth container as the FV solver, with
node values at x_grid (the nodes include the walls) and its own evaluate.
One task per call: the Newton and Krylov loops stop per task.
"""

import math

import torch

from .fv_burgers import BurgersGroundTruth, _bilinear, linspace
from .newton import newton_krylov


def solve(params, resolution: int = 256, num_tsteps: int = 101, substeps: int = None,
          ic_fn=None, xmin: float = 0.0, xmax: float = 1.0, tmax: float = 1.0,
          newton_steps: int = 12):
    """Solve one task; params = (source_params [1], ic_params [2]) with
    source_params[0] the Reynolds number. The wall values reuse the IC
    expression at the wall coordinates."""
    source_params, _ = params
    device, dtype = source_params.device, source_params.dtype
    nu = 1.0 / source_params[0]

    n = resolution
    h = (xmax - xmin) / n
    nodes = xmin + torch.arange(n + 1, device=device, dtype=dtype) * h

    u0 = ic_fn(nodes, params)
    bc_l = ic_fn(torch.tensor(xmin, device=device, dtype=dtype), params)
    bc_r = ic_fn(torch.tensor(xmax, device=device, dtype=dtype), params)

    if substeps is None:
        # implicit Euler is unconditionally stable; substep to dt ~ h so that
        # refinement keeps tightening the (first-order in time) error
        seg_dt = tmax / (num_tsteps - 1)
        substeps = max(1, math.ceil(seg_dt / h))
    dt = tmax / ((num_tsteps - 1) * substeps)

    def residual(u, u_old):
        """Galerkin residual of (u - u_old)/dt + u u_x - nu u_xx, CG1, the
        constrained rows replaced by u - bc."""
        du = u - u_old
        mass = (h / 6.0) * (du[:-2] + 4.0 * du[1:-1] + du[2:]) / dt
        # advection element integrals (exact for P1):
        #   int_e u u_x phi_left  = (u_b - u_a)(u_a/3 + u_b/6)
        #   int_e u u_x phi_right = (u_b - u_a)(u_a/6 + u_b/3)
        d = u[1:] - u[:-1]
        ca = d * (u[:-1] / 3.0 + u[1:] / 6.0)
        cb = d * (u[:-1] / 6.0 + u[1:] / 3.0)
        adv = ca[1:] + cb[:-1]
        visc = (nu / h) * (-u[:-2] + 2.0 * u[1:-1] - u[2:])
        r_int = mass + adv + visc
        return torch.cat([(u[:1] - bc_l).reshape(1), r_int, (u[-1:] - bc_r).reshape(1)])

    # Jacobi preconditioner from the linear (mass + viscous) diagonal
    diag = ((2.0 * h / 3.0) / dt + 2.0 * nu / h).expand(n + 1).clone()
    diag[0] = 1.0
    diag[-1] = 1.0

    u = u0.clone()
    u[0] = bc_l
    u[-1] = bc_r
    frames = [u]
    for _ in range(num_tsteps - 1):
        for _ in range(substeps):
            u_old = u
            u = newton_krylov(lambda v: residual(v, u_old), u_old, max_steps=newton_steps,
                              rel_tol=1e-5, krylov_tol=1e-6, krylov_max_iters=200,
                              precond_diag=diag).u
        frames.append(u)
    t_grid = linspace(0.0, tmax, num_tsteps, device=device, dtype=dtype)
    return BurgersGroundTruth(u_grid=torch.stack(frames), x_grid=nodes, t_grid=t_grid)


def evaluate(gt: BurgersGroundTruth, xt):
    """u at (x, t) = xt[..., 0], xt[..., 1] by bilinear interpolation (the
    nodes are uniformly spaced including the walls, unlike the FV cell
    centers)."""
    x, t = xt[..., 0], xt[..., 1]
    nt = gt.t_grid.shape[0]
    nn = gt.x_grid.shape[0]

    tmax = gt.t_grid[-1]
    ft = torch.clamp(t / tmax, 0.0, 1.0) * (nt - 1)
    it = torch.clamp(torch.floor(ft).to(torch.int64), 0, nt - 2)
    wt = ft - it.to(ft.dtype)

    xmin, xmax = gt.x_grid[0], gt.x_grid[-1]
    fx = (torch.minimum(torch.maximum(x, xmin), xmax) - xmin) / (xmax - xmin) * (nn - 1)
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nn - 2)
    wx = fx - ix.to(fx.dtype)
    return _bilinear(gt.u_grid, it, ix, wt, wx)
