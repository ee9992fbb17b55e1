"""P1 FEM solver for the nonlinear Poisson star-domain problem
(counterpart of metapde_tpu/solvers/fem_poisson.py).

- Mesh: structured polar triangulation of the unit disk (center fan + ring
  quads split into triangles), mapped onto the star domain
  r(theta) = 1 + c1 cos 4theta + c2 cos 8theta.
- Weak form: find u with u=g on the boundary s.t.
  int (1 + 0.1 u^2) grad u . grad v dx + int f v dx = 0 for all v.
- Assembly: per-element residuals (edge-midpoint quadrature, exact for
  quadratics) scattered with index_add (the JAX package's segment_sum).
- Newton with matrix-free BiCGStab, preconditioned by Jacobi or, from
  resolution 16 up (the JAX package: 32), by a geometric-multigrid V-cycle
  (multigrid.py). On the card each BiCGStab iteration is one CUDA graph
  (newton.py's cuda_graph).

Evaluation at points is bilinear interpolation in the logical (rho, theta)
chart (evaluate), or bicubic (evaluate_cubic) for the higher-order
Richardson oracle (solve_richardson). solve_x64 is the float64 solve; it
runs on the tensors' device, the card included.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import full_f32_matmuls
from .multigrid import make_polar_mg_preconditioner
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
    """mg for even resolution >= 16, jacobi below. The JAX package starts mg
    at 32; at 16 f32 Jacobi-BiCGStab already stops at its iteration cap in
    every Newton step and leaves some tasks' fields 1e-3 to 8e-3 (of their
    largest |value|) off the float64 solve, in both packages, where mg
    reaches 2e-6 to 1.4e-5 in a fifth of the iterations."""
    return "mg" if resolution >= 16 and resolution % 2 == 0 else "jacobi"


class PoissonGroundTruth(NamedTuple):
    """FEM solution on the (rho, theta) chart; u_grid[0] is the center value."""

    u_grid: torch.Tensor  # [nr+1, nt]
    geo_params: torch.Tensor  # [2] (c1, c2)
    residual_norm: torch.Tensor


def solve(params, resolution: int = 16, max_newton_steps: int = 12,
          precond: str = "auto", rel_tol: float = None,
          krylov_tol: float = 1e-6) -> PoissonGroundTruth:
    """Solve one Poisson task (source, bc, geo params tensors) on their device.

    precond: "jacobi", "mg" (geometric multigrid V-cycle, multigrid.py), or
    "auto" (= mg for even resolution >= 16, where f32 Jacobi-BiCGStab
    stagnates on the stiffness condition number; jacobi below).
    """
    if precond == "auto":
        precond = _auto_precond(resolution)
    if precond not in ("jacobi", "mg"):
        raise ValueError(f"precond={precond!r}: use jacobi, mg or auto")
    if rel_tol is None:
        # the Newton tolerance shrinks with the discretization error (~h^2)
        rel_tol = max(2e-5 * (16.0 / resolution) ** 2, 1e-6)
    # the JAX solve pins the highest matmul precision: reduced-precision
    # products stall or blow up BiCGStab on the mapped star meshes
    with full_f32_matmuls():
        return _solve_impl(params, resolution, max_newton_steps, precond, rel_tol,
                           krylov_tol)


def _solve_impl(params, resolution, max_newton_steps, precond, rel_tol, krylov_tol):
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

    if precond == "mg":
        precond_apply = make_polar_mg_preconditioner(
            geo_params, resolution, pre_sweeps=3, post_sweeps=3)
        krylov_iters = 150
    else:
        precond_apply = None
        krylov_iters = max(200, 20 * resolution)

    result = newton_krylov(
        residual,
        g_full,
        max_steps=max_newton_steps,
        rel_tol=rel_tol,
        krylov_tol=krylov_tol,
        krylov_max_iters=krylov_iters,
        precond_diag=diag,
        precond_apply=precond_apply,
        cuda_graph=True,  # the residual and the V-cycle make no host reads
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


def solve_x64(params, resolution: int = 32, max_newton_steps: int = 20,
              rel_tol: float = None, krylov_tol: float = 1e-9) -> PoissonGroundTruth:
    """Double-precision solve on the params' device: the same solver in
    float64, with the h^2-scaled Newton tolerance not floored at f32 noise
    (the oracle of accuracy sweeps and of solve_richardson). The "auto"
    preconditioner rule of `solve` applies. Returns float64 tensors."""
    if rel_tol is None:
        rel_tol = max(2e-5 * (16.0 / resolution) ** 2, 1e-10)
    params64 = tuple(torch.as_tensor(a).to(torch.float64) for a in params)
    return _solve_impl(params64, resolution, max_newton_steps,
                       _auto_precond(resolution), rel_tol, krylov_tol)


def _cubic_weights(t):
    """Lagrange cubic basis through nodes {-1, 0, 1, 2} at t ([M] -> [4, M]):
    exact for cubics (O(h^4) interpolation)."""
    wm1 = -t * (t - 1.0) * (t - 2.0) / 6.0
    w0 = (t + 1.0) * (t - 1.0) * (t - 2.0) / 2.0
    w1 = -(t + 1.0) * t * (t - 2.0) / 2.0
    w2 = (t + 1.0) * t * (t - 1.0) / 6.0
    return torch.stack([wm1, w0, w1, w2])


def _pad_rows_for_cubic(u_grid):
    """[nr+3, nt] grid padded for 4-row cubic stencils: row 0 is ring 1
    reflected through the center (u(-h, th) = u(h, th + pi)), the top row
    the cubic extrapolation past the Dirichlet boundary."""
    nt = u_grid.shape[1]
    below = torch.roll(u_grid[1], -(nt // 2))[None, :]
    top = (4.0 * u_grid[-1] - 6.0 * u_grid[-2] + 4.0 * u_grid[-3] - u_grid[-4])[None, :]
    return torch.cat([below, u_grid, top], dim=0)


def _chart_cubic(padded, nr: int, nt: int, fi, fj):
    """Bicubic Lagrange interpolation at logical grid coords fi [M] (radial,
    in [0, nr]) and fj [M] (angular, periodic), given a _pad_rows_for_cubic
    grid. Returns [M]."""
    i0 = torch.clamp(torch.floor(fi).long(), 0, nr - 1)
    j0 = torch.floor(fj).long()
    wi = _cubic_weights(fi - i0)  # [4, M]
    wj = _cubic_weights(fj - j0)
    four = torch.arange(4, device=fi.device)
    rows = i0[None, :] + four[:, None]  # grid rows i0-1..i0+2 -> padded i0..i0+3
    cols = (j0[None, :] - 1 + four[:, None]) % nt
    patch = padded[rows[:, None, :], cols[None, :, :]]  # [4, 4, M]
    return torch.sum(torch.sum(wi[:, None, :] * patch, dim=0) * wj, dim=0)


def evaluate_cubic(gt: PoissonGroundTruth, x):
    """Bicubic chart evaluation at points x [N, 2] -> [N]: O(h^4) between
    nodes, against evaluate's O(h^2), for solve_richardson's solutions; also
    valid on plain P1 solutions."""
    nr = gt.u_grid.shape[0] - 1
    nt = gt.u_grid.shape[1]
    c1, c2 = gt.geo_params[0], gt.geo_params[1]
    theta = torch.remainder(torch.atan2(x[:, 1], x[:, 0]), 2.0 * math.pi)
    r_theta = 1.0 + c1 * torch.cos(4.0 * theta) + c2 * torch.cos(8.0 * theta)
    rho = torch.clamp(torch.linalg.norm(x, dim=-1) / r_theta, 0.0, 1.0)
    return _chart_cubic(_pad_rows_for_cubic(gt.u_grid), nr, nt, rho * nr,
                        theta / (2.0 * math.pi) * nt)


def solve_richardson(params, resolution: int = 16, rel_tol: float = 1e-8,
                     krylov_tol: float = 1e-10, max_newton_steps: int = 30):
    """Higher-order Poisson oracle: Richardson extrapolation of nested
    float64 P1 solves at `resolution` and 2 * `resolution`,
    u* = u_f + (u_f - P u_c) / 3 with P the bicubic chart prolongation,
    which cancels the h^2 term of the P1 nodal error. Evaluate the result
    with evaluate_cubic."""
    if resolution < 2:
        raise ValueError("solve_richardson needs resolution >= 2 so the "
                         "mesh_topology lattices nest (nr/nt minimums)")
    gt_c = solve_x64(params, resolution=resolution, rel_tol=rel_tol,
                     krylov_tol=krylov_tol, max_newton_steps=max_newton_steps)
    gt_f = solve_x64(params, resolution=2 * resolution, rel_tol=rel_tol,
                     krylov_tol=krylov_tol, max_newton_steps=max_newton_steps)
    u_c, u_f = gt_c.u_grid, gt_f.u_grid
    nr_c, nt_c = u_c.shape[0] - 1, u_c.shape[1]
    nr_f, nt_f = u_f.shape[0] - 1, u_f.shape[1]
    if not (nr_f == 2 * nr_c and nt_f == 2 * nt_c):
        raise ValueError("the two lattices do not nest")
    dev = u_f.device
    fi = (torch.arange(nr_f + 1, device=dev, dtype=u_f.dtype) / 2.0)[:, None].expand(-1, nt_f)
    fj = (torch.arange(nt_f, device=dev, dtype=u_f.dtype) / 2.0)[None, :].expand(nr_f + 1, -1)
    prolonged = _chart_cubic(_pad_rows_for_cubic(u_c), nr_c, nt_c,
                             fi.reshape(-1), fj.reshape(-1)).reshape(nr_f + 1, nt_f)
    u_star = u_f + (u_f - prolonged) / 3.0
    # the Dirichlet row is exact on the fine lattice; never extrapolate it
    u_star = torch.cat([u_star[:-1], u_f[-1:]], dim=0)
    return PoissonGroundTruth(u_grid=u_star, geo_params=gt_f.geo_params,
                              residual_norm=gt_f.residual_norm)
