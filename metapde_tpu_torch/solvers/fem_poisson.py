"""P1 FEM solver for the nonlinear Poisson star-domain problem
(counterpart of metapde_tpu/solvers/fem_poisson.py, Jacobi path).

- Mesh: structured polar triangulation of the unit disk (center fan + ring
  quads split into triangles), mapped onto the star domain
  r(theta) = 1 + c1 cos 4theta + c2 cos 8theta.
- Weak form: find u with u=g on the boundary s.t.
  int (1 + 0.1 u^2) grad u . grad v dx + int f v dx = 0 for all v.
- Assembly: per-element residuals (edge-midpoint quadrature, exact for
  quadratics) scattered with index_add (the JAX package's segment_sum).
- Newton with matrix-free BiCGStab and the Jacobi preconditioner.

Evaluation at points is bilinear interpolation in the logical (rho, theta)
chart. The geometric-multigrid preconditioner (used from resolution 32 up),
the f64 solve, Richardson extrapolation and bicubic evaluation are not
ported yet.
"""

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from .newton import newton_krylov

# Edge-midpoint quadrature barycentric weights: row q = barycentric coords of
# midpoint q; exact for degree-2 integrands on triangles.
_MIDPT = np.array(
    [[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]], dtype=np.float32
)


def mesh_topology(resolution: int):
    """Static triangulation of the polar (rho, theta) grid.

    Returns (tris [E,3] int32, nr, nt). Node 0 is the disk center; node
    1 + (i-1)*nt + j is ring i (1..nr), angle j (0..nt-1).
    """
    nr = max(8, 4 * resolution)
    nt = max(32, 16 * resolution)
    j = np.arange(nt)
    fan = np.stack([np.zeros(nt, np.int64), 1 + j, 1 + (j + 1) % nt], axis=1)
    i = np.arange(1, nr)[:, None]
    a = 1 + (i - 1) * nt + j
    b = 1 + (i - 1) * nt + (j + 1) % nt
    c, d = a + nt, b + nt
    # per ring i and angle j: triangles (a, c, d) then (a, d, b)
    quads = np.stack([np.stack([a, c, d], -1), np.stack([a, d, b], -1)], axis=2)
    tris = np.concatenate([fan, quads.reshape(-1, 3)], axis=0)
    return tris.astype(np.int32), nr, nt


def node_coords(geo_params, nr: int, nt: int):
    """Physical coordinates [1 + nr*nt, 2] of the mesh nodes for a star geometry."""
    c1, c2 = geo_params[0], geo_params[1]
    dev, dt = geo_params.device, geo_params.dtype
    thetas = torch.arange(nt, device=dev, dtype=dt) * (2.0 * math.pi / nt)
    rhos = torch.arange(1, nr + 1, device=dev, dtype=dt) / nr
    r_theta = 1.0 + c1 * torch.cos(4.0 * thetas) + c2 * torch.cos(8.0 * thetas)
    r = rhos[:, None] * r_theta[None, :]
    x = r * torch.cos(thetas)[None, :]
    y = r * torch.sin(thetas)[None, :]
    ring_pts = torch.stack([x.reshape(-1), y.reshape(-1)], dim=1)
    return torch.cat([torch.zeros((1, 2), device=dev, dtype=dt), ring_pts], dim=0)


def _element_geometry(coords, tris):
    """Per-element P1 geometry: barycentric-basis gradients and areas."""
    verts = coords[tris]  # [E,3,2]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]  # 2*signed area
    area = 0.5 * torch.abs(det)
    inv_det = 1.0 / det
    g1 = torch.stack([e2[:, 1] * inv_det, -e2[:, 0] * inv_det], dim=1)
    g2 = torch.stack([-e1[:, 1] * inv_det, e1[:, 0] * inv_det], dim=1)
    g0 = -(g1 + g2)
    gradphi = torch.stack([g0, g1, g2], dim=1)  # [E,3,2]
    mq = torch.as_tensor(_MIDPT, device=coords.device, dtype=coords.dtype)
    midpts = torch.einsum("qk,ekd->eqd", mq, verts)  # [E,3,2]
    return gradphi, area, midpts


def _auto_precond(resolution: int) -> str:
    """mg for even resolution >= 32, jacobi below (the JAX package's rule)."""
    return "mg" if resolution >= 32 and resolution % 2 == 0 else "jacobi"


class PoissonGroundTruth(NamedTuple):
    """FEM solution on the (rho, theta) chart; u_grid[0] is the center value."""

    u_grid: torch.Tensor  # [nr+1, nt]
    geo_params: torch.Tensor  # [2] (c1, c2)
    residual_norm: torch.Tensor


@contextlib.contextmanager
def _full_f32_matmuls():
    """Turn TF32 off for matmuls and cuDNN inside the solve: the JAX solve
    pins the highest matmul precision, because reduced-precision products
    stall or blow up BiCGStab on the mapped star meshes."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def solve(params, resolution: int = 16, max_newton_steps: int = 12,
          precond: str = "auto", rel_tol: float = None,
          krylov_tol: float = 1e-6) -> PoissonGroundTruth:
    """Solve one Poisson task (source, bc, geo params tensors) on their device.

    precond: "jacobi", or "auto" (= the JAX package's multigrid from even
    resolution 32 up, which is not ported yet and raises NotImplementedError).
    """
    if precond == "auto":
        precond = _auto_precond(resolution)
    if precond != "jacobi":
        raise NotImplementedError(
            f"precond={precond!r} (resolution {resolution}): the multigrid "
            "preconditioner is not ported yet; use resolution < 32")
    if rel_tol is None:
        # the Newton tolerance shrinks with the discretization error (~h^2)
        rel_tol = max(2e-5 * (16.0 / resolution) ** 2, 1e-6)
    with _full_f32_matmuls():
        return _solve_impl(params, resolution, max_newton_steps, rel_tol, krylov_tol)


def _solve_impl(params, resolution, max_newton_steps, rel_tol, krylov_tol):
    source_params, bc_params, geo_params = params
    dev, dt = geo_params.device, geo_params.dtype
    tris_np, nr, nt = mesh_topology(resolution)
    tris = torch.as_tensor(tris_np, dtype=torch.long, device=dev)
    tris_flat = tris.reshape(-1)
    n_nodes = 1 + nr * nt

    coords = node_coords(geo_params, nr, nt)
    gradphi, area, midpts = _element_geometry(coords, tris)

    # source term at the quadrature points
    mp = midpts.reshape(-1, 1, 2)
    d2 = ((mp[..., 0] - source_params[None, :, 0]) ** 2
          + (mp[..., 1] - source_params[None, :, 1]) ** 2)
    f_q = torch.sum(source_params[None, :, 2] * torch.exp(-d2), dim=-1).reshape(-1, 3)

    # Dirichlet data on the outer ring
    bdry_mask = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
    bdry_mask[1 + (nr - 1) * nt:] = True
    theta = torch.atan2(coords[:, 1], coords[:, 0])
    g = (bc_params[0]
         + bc_params[1] / 4.0 * torch.cos(theta)
         + bc_params[2] / 4.0 * torch.sin(theta)
         + bc_params[3] / 4.0 * torch.cos(2.0 * theta)
         + bc_params[4] / 4.0 * torch.sin(2.0 * theta))
    g_full = torch.where(bdry_mask, g, torch.zeros_like(g))

    mq = torch.as_tensor(_MIDPT, device=dev, dtype=dt)  # [q, k]
    load = (area[:, None] / 3.0) * (f_q @ mq)  # [E, 3]
    zeros = torch.zeros(n_nodes, device=dev, dtype=dt)

    # basis-gradient components [E,3], contiguous for the residual's products
    gx, gy = gradphi[..., 0].contiguous(), gradphi[..., 1].contiguous()

    def residual(u):
        ue = u[tris]  # [E,3]
        du_dx = torch.sum(ue * gx, dim=1, keepdim=True)  # grad u, [E,1] each
        du_dy = torch.sum(ue * gy, dim=1, keepdim=True)
        uq = ue @ mq.T  # [E,3] values at midpoints
        c_bar = torch.mean(1.0 + 0.1 * uq ** 2, dim=1, keepdim=True)  # [E,1]
        flux = (area[:, None] * c_bar) * (du_dx * gx + du_dy * gy)  # [E,3]
        r = zeros.index_add(0, tris_flat, (flux + load).reshape(-1))
        return torch.where(bdry_mask, u - g_full, r)

    # Jacobi preconditioner from the linear (c=1) stiffness diagonal
    diag_elem = area[:, None] * torch.sum(gradphi ** 2, dim=2)
    diag = zeros.index_add(0, tris_flat, diag_elem.reshape(-1))
    diag = torch.where(bdry_mask, torch.ones_like(diag), torch.clamp(diag, min=1e-12))

    result = newton_krylov(
        residual,
        g_full,
        max_steps=max_newton_steps,
        rel_tol=rel_tol,
        krylov_tol=krylov_tol,
        krylov_max_iters=max(200, 20 * resolution),
        precond_diag=diag,
    )

    u = result.u
    u_grid = torch.cat([u[0].expand(1, nt), u[1:].reshape(nr, nt)], dim=0)
    return PoissonGroundTruth(u_grid=u_grid, geo_params=geo_params,
                              residual_norm=result.residual_norm)


def evaluate(gt: PoissonGroundTruth, x):
    """Evaluate the FEM solution at points x [N, 2] -> [N].

    Bilinear interpolation in the logical (rho, theta) chart; points outside
    the star are clamped to the boundary.
    """
    nr = gt.u_grid.shape[0] - 1
    nt = gt.u_grid.shape[1]
    c1, c2 = gt.geo_params[0], gt.geo_params[1]

    theta = torch.remainder(torch.atan2(x[:, 1], x[:, 0]), 2.0 * math.pi)
    r_theta = 1.0 + c1 * torch.cos(4.0 * theta) + c2 * torch.cos(8.0 * theta)
    rho = torch.clamp(torch.linalg.norm(x, dim=-1) / r_theta, 0.0, 1.0)

    fi = rho * nr
    i0 = torch.clamp(torch.floor(fi).long(), 0, nr - 1)
    wi = fi - i0

    fj = theta / (2.0 * math.pi) * nt
    j0 = torch.clamp(torch.floor(fj).long(), 0, nt - 1)
    wj = fj - j0
    j1 = (j0 + 1) % nt

    u = gt.u_grid
    u00, u01 = u[i0, j0], u[i0, j1]
    u10, u11 = u[i0 + 1, j0], u[i0 + 1, j1]
    return (1 - wi) * ((1 - wj) * u00 + wj * u01) + wi * ((1 - wj) * u10 + wj * u11)
