"""P1 FEM solver for steady 2-D viscous Burgers flow past random pores
(counterpart of metapde_tpu/solvers/fem_steady_burgers.py), the ground
truth of the steady_burgers family:

    u . grad u = (1/Re) lap u      in Omega \\ pores
    u = inlet profile              on x = xmin
    u = outlet profile             on x = xmax
    u = 0                          on walls and pore boundaries (no-slip)

on the boundary-snapped structured lattice of mesh2d (no-slip is imposed at
nodes projected onto the pore boundaries). Galerkin residual on P1
triangles (edge-midpoint quadrature, exact for the quadratic advection
integrand), assembled with index_add (the JAX package's segment_sum);
matrix-free Newton-BiCGStab (solvers/newton.py).

The solve copies the JAX package's own constants, which its steady_burgers
family uses (it passes none of cfg.solver): 20 Newton steps, f32 rel_tol
2e-5 (the f32 Newton stalls below it) and Krylov tol 1e-6, krylov_max_iters
max(300, 20 * resolution), and precond "auto" = Jacobi. solve_x64 runs the
same solve in float64 with 30 Newton steps and tolerances 1e-9 / 1e-10.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..device import full_f32_matmuls
from .mesh2d import evaluate_p1, pore_lattice
from .multigrid import make_rect_mg_preconditioner
from .newton import newton_krylov

_MIDPT = np.array(
    [[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]], dtype=np.float32
)


class SteadyBurgersGroundTruth(NamedTuple):
    u_grid: torch.Tensor       # [m, m, 2] velocity at snapped nodes
    coords_grid: torch.Tensor  # [m, m, 2] snapped node positions
    alive_grid: torch.Tensor   # [m, m]
    elem_alive: torch.Tensor   # [2 res^2]
    bounds: torch.Tensor       # [4]
    residual_norm: torch.Tensor


def solve(params, resolution: int = 32, xmin: float = -1.0, xmax: float = 1.0,
          ymin: float = -1.0, ymax: float = 1.0, max_newton_steps: int = 20,
          precond: str = "auto") -> SteadyBurgersGroundTruth:
    """Solve one task (source, bc, per-hole params, n_holes) on its device.

    precond: "jacobi", "mg" (the rect-lattice V-cycle on the snapped pore
    meshes, multigrid.make_rect_mg_preconditioner) or "auto" (= jacobi: the
    JAX package measured the V-cycle at the same residual for 1.0-1.8x the
    time at resolution 64-128)."""
    if precond == "auto":
        precond = "jacobi"
    if precond not in ("jacobi", "mg"):
        raise ValueError(f"precond={precond!r}: use jacobi, mg or auto")
    # the JAX solve pins the highest matmul precision
    with full_f32_matmuls():
        return _solve_impl(params, resolution, xmin, xmax, ymin, ymax, max_newton_steps,
                           precond)


def solve_x64(params, resolution: int = 64, xmin: float = -1.0, xmax: float = 1.0,
              ymin: float = -1.0, ymax: float = 1.0,
              max_newton_steps: int = 30) -> SteadyBurgersGroundTruth:
    """The double-precision solve on the params' device (the reference's
    Newton/MUMPS path is f64 throughout); Jacobi. Returns float64 tensors."""
    params64 = tuple(torch.as_tensor(a).to(torch.float64) if torch.is_floating_point(a)
                     else torch.as_tensor(a) for a in params)
    return _solve_impl(params64, resolution, xmin, xmax, ymin, ymax, max_newton_steps,
                       "jacobi")


def _solve_impl(params, resolution, xmin, xmax, ymin, ymax, max_newton_steps, precond):
    source_params, bc_params, per_hole_params, n_holes = params
    dev, dtype = bc_params.device, bc_params.dtype
    nu = 1.0 / source_params[0]

    lattice = pore_lattice(resolution, xmin, xmax, ymin, ymax, per_hole_params.to(dtype),
                           n_holes)
    tris, geom = lattice.tris, lattice.geom
    on_inlet, on_outlet, noslip = lattice.on_inlet, lattice.on_outlet, lattice.noslip
    flat = tris.reshape(-1)
    coords, area, gradphi = geom.coords, geom.area, geom.gradphi
    elem_alive, node_alive = geom.elem_alive, geom.node_alive
    n_nodes = coords.shape[0]
    mq = torch.as_tensor(_MIDPT, dtype=dtype, device=dev)
    constrained = (on_inlet | on_outlet | noslip)[:, None]
    # dead nodes on no constraint: their rows pin z
    free_dead = ((node_alive < 0.5)[:, None]) & ~constrained

    # inlet/outlet profiles bc_params[i] * sin(pi (y - ymin)/(ymax - ymin))
    s = torch.sin(torch.pi * (coords[:, 1] - ymin) / (ymax - ymin))[:, None]
    bc_val = torch.zeros((n_nodes, 2), dtype=dtype, device=dev)
    bc_val = torch.where(on_inlet[:, None], bc_params[0][None, :] * s, bc_val)
    bc_val = torch.where(on_outlet[:, None], bc_params[1][None, :] * s, bc_val)
    bc_val = torch.where((noslip & ~on_inlet & ~on_outlet)[:, None], 0.0, bc_val)

    zeros = torch.zeros((n_nodes, 2), dtype=dtype, device=dev)
    adv_w = (area / 3.0)[:, None, None]
    visc_w = (nu * area)[:, None, None]
    alive3 = elem_alive[:, None, None]

    def residual(z):
        zz = z.reshape(n_nodes, 2)
        u = torch.where(constrained, bc_val, zz)
        ue = u[tris]                                            # [E,3,2]
        grad_u = torch.einsum("ekd,ekg->edg", ue, gradphi)      # [E,2,2]
        uq = torch.einsum("qk,ekd->eqd", mq, ue)                # [E,3q,2]
        # advection (u . grad) u at the quadrature points, tested against
        # phi_k there
        adv_q = torch.einsum("eqg,edg->eqd", uq, grad_u)        # [E,3q,2]
        adv = adv_w * torch.einsum("eqd,qk->ekd", adv_q, mq)
        visc = visc_w * torch.einsum("edg,ekg->ekd", grad_u, gradphi)
        r = zeros.index_add(0, flat, ((adv + visc) * alive3).reshape(-1, 2))
        r = torch.where(constrained, u - bc_val, r)
        r = torch.where(free_dead, zz, r)
        return r.reshape(-1)

    # Jacobi preconditioner from the viscous diagonal
    diag_elem = nu * area[:, None] * torch.sum(gradphi ** 2, dim=2) * elem_alive[:, None]
    diag = torch.zeros(n_nodes, dtype=dtype, device=dev).index_add(0, flat, diag_elem.reshape(-1))
    diag = torch.clamp(diag, min=1e-6)
    diag2 = torch.where(constrained, 1.0, torch.stack([diag, diag], dim=1)).reshape(-1)

    precond_apply = None
    if precond == "mg":
        precond_apply = make_rect_mg_preconditioner(
            per_hole_params, n_holes, resolution, xmin, xmax, ymin, ymax, coeff=nu,
            vector_dim=2)

    # tighter tolerances in f64 (the f32 Newton stalls below ~2e-5)
    f64 = dtype == torch.float64
    result = newton_krylov(
        residual, torch.zeros(n_nodes * 2, dtype=dtype, device=dev),
        max_steps=max_newton_steps,
        rel_tol=1e-9 if f64 else 2e-5,
        krylov_tol=1e-10 if f64 else 1e-6,
        krylov_max_iters=max(300, 20 * resolution),
        precond_diag=diag2,
        precond_apply=precond_apply,
    )

    u = torch.where(constrained, bc_val, result.u.reshape(n_nodes, 2))
    m = resolution + 1
    return SteadyBurgersGroundTruth(
        u_grid=u.reshape(m, m, 2),
        coords_grid=coords.reshape(m, m, 2),
        alive_grid=node_alive.reshape(m, m),
        elem_alive=elem_alive,
        bounds=torch.tensor([xmin, xmax, ymin, ymax], dtype=dtype, device=dev),
        residual_norm=result.residual_norm,
    )


def evaluate(gt: SteadyBurgersGroundTruth, x):
    """P1 interpolation on the snapped conforming mesh: x [..., 2] ->
    [..., 2]."""
    return evaluate_p1(gt.u_grid, gt.coords_grid, gt.elem_alive, gt.bounds, x)
