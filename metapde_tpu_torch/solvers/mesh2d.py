"""Boundary-snapped structured triangulations for pore-perforated domains
(counterpart of metapde_tpu/solvers/mesh2d.py).

A static structured triangulation of the rectangle is made to conform to
the pore boundaries by moving nodes, not by re-meshing:

- every node strictly inside a pore that shares an element with an
  exterior node is projected radially onto the pore boundary
  r0(theta) = size * (1 + c1 cos 4 theta + c2 cos 8 theta);
- elements are then dead iff a vertex is still strictly inside, or all
  three vertices lie on the boundary and the centroid is inside the pore,
  or the element degenerated to a sliver (area < 5% of the lattice's) or
  inverted.

Cut elements thus have their interior vertices on the pore boundary (an
O(h^2) interface error), with the topology fixed. Every function takes
tensors of any float dtype on any device; the solver calls them in
float64 on the host, the validation path in float32 on the card.
``evaluate_p1`` takes points with any leading axes and is differentiable in
x (torch autograd and torch.func), so the ground-truth field can go through
a loss's per-point Jacobian.
"""

from typing import NamedTuple

import numpy as np
import torch

# elements whose area shrinks below this fraction of the uniform element
# area are treated as dead (sliver guard)
_QUALITY_MIN = 0.05


def mesh_topology(resolution: int) -> np.ndarray:
    """Static uniform triangulation of the unit square: (res+1)^2 nodes,
    2 res^2 triangles. Cell (i, j) owns triangles [a,c,d] and [a,d,b] at
    element ids 2*(i*res+j) and 2*(i*res+j)+1, with a=(i,j), b=(i,j+1),
    c=(i+1,j), d=(i+1,j+1) and node (i, j) = i*(res+1)+j."""
    n = resolution
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (i * (n + 1) + j).reshape(-1)
    b, c, d = a + 1, a + n + 1, a + n + 2
    tris = np.stack([np.stack([a, c, d], 1), np.stack([a, d, b], 1)], 1)
    return tris.reshape(-1, 3).astype(np.int32)


def node_coords(resolution, xmin, xmax, ymin, ymax) -> np.ndarray:
    """[(res+1)^2, 2] lattice positions, node (i, j) at i*(res+1)+j with i
    over x and j over y."""
    n = resolution
    xx, yy = np.meshgrid(np.linspace(xmin, xmax, n + 1), np.linspace(ymin, ymax, n + 1),
                         indexing="ij")
    return np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1)


def _hole_fields(xy, per_hole_params, n_holes):
    """Per-pore radial excess phi = |x - c| - r0(theta) (negative inside;
    +inf for pores past n_holes) and the radial projection of xy onto each
    pore boundary: xy [..., 2] -> phi [..., H], proj [..., H, 2]. The angle
    is atan2(vx, vy), the reference's swapped convention."""
    c1, c2, x0, y0, size = per_hole_params.unbind(-1)
    vx = xy[..., 0:1] - x0
    vy = xy[..., 1:2] - y0
    theta = torch.atan2(vx, vy)
    length = torch.sqrt(vx ** 2 + vy ** 2)
    r0 = size * (1.0 + c1 * torch.cos(4 * theta) + c2 * torch.cos(8 * theta))
    valid = torch.arange(per_hole_params.shape[0], device=xy.device) < n_holes
    phi = torch.where(valid, length - r0, torch.full_like(length, float("inf")))
    safe_len = torch.clamp(length, min=1e-8)
    proj = torch.stack([x0 + vx * r0 / safe_len, y0 + vy * r0 / safe_len], dim=-1)
    return phi, proj


def is_in_hole(xy, per_hole_params, n_holes, tol=1e-7):
    """Pore membership of points xy [..., 2] -> bool [...]."""
    phi, _ = _hole_fields(xy, per_hole_params, n_holes)
    return torch.any(phi < -tol, dim=-1)


class Geometry(NamedTuple):
    """Snapped-mesh geometry."""

    coords: torch.Tensor      # [N, 2] snapped node positions
    area: torch.Tensor        # [E]
    gradphi: torch.Tensor     # [E, 3, 2] P1 basis gradients
    elem_alive: torch.Tensor  # [E] float 0/1
    node_alive: torch.Tensor  # [N] float 0/1 (max over adjacent elements)


def _segment_max(values, index, n):
    """Max of `values` over each of n segments (every segment non-empty)."""
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, index, values, "amax", include_self=False)


def snapped_geometry(tris, coords0, per_hole_params, n_holes, cell_h, boundary_fixed=None):
    """The conforming geometry of the static lattice for one pore layout.

    tris: [E, 3] topology (numpy or tensor); coords0: [N, 2] lattice
    positions; cell_h: lattice spacing; boundary_fixed: [N] bool, nodes that
    must not move (the outer rectangle)."""
    tris = torch.as_tensor(np.asarray(tris), dtype=torch.long, device=coords0.device)
    n_nodes = coords0.shape[0]
    flat = tris.reshape(-1)
    movable = (torch.ones(n_nodes, dtype=torch.bool, device=coords0.device)
               if boundary_fixed is None else ~boundary_fixed)

    tol = 1e-4 * cell_h
    phi_all, proj_all = _hole_fields(coords0, per_hole_params, n_holes)  # [N,H], [N,H,2]
    pore = torch.argmin(phi_all, dim=1)                                    # governing pore
    phi = torch.gather(phi_all, 1, pore[:, None])[:, 0]
    proj = torch.gather(proj_all, 1, pore[:, None, None].expand(-1, 1, 2))[:, 0]
    phi = torch.where(torch.isfinite(phi), phi, torch.ones_like(phi))    # no pores: outside

    inside = phi < -tol                                                    # strictly interior
    # interface: an inside node in an element that also has an outside node
    elem_has_outside = torch.any(~inside[tris], dim=1)
    node_touches_outside = _segment_max(
        elem_has_outside.repeat_interleave(3).to(coords0.dtype), flat, n_nodes) > 0.5
    snap = inside & node_touches_outside & movable
    coords = torch.where(snap[:, None], proj, coords0)

    verts = coords[tris]                                                   # [E,3,2]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    area = 0.5 * torch.abs(det)
    # a clamped reciprocal, so dead slivers give finite (masked) terms
    tiny = torch.where(det < 0, torch.full_like(det, -1e-12), torch.full_like(det, 1e-12))
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, tiny, det)
    g1 = torch.stack([e2[:, 1] * inv_det, -e2[:, 0] * inv_det], dim=1)
    g2 = torch.stack([-e1[:, 1] * inv_det, e1[:, 0] * inv_det], dim=1)
    gradphi = torch.stack([-(g1 + g2), g1, g2], dim=1)                    # [E,3,2]

    still_inside = inside & ~snap
    elem_inside = torch.any(still_inside[tris], dim=1)
    on_bdry = snap | (torch.abs(phi) <= tol)
    all_bdry = torch.all(on_bdry[tris], dim=1)
    cent_in = is_in_hole(verts.mean(dim=1), per_hole_params, n_holes)
    uniform_area = 0.5 * cell_h * cell_h
    degenerate = (area < _QUALITY_MIN * uniform_area) | (det <= 0)
    elem_alive = 1.0 - (elem_inside | (all_bdry & cent_in) | degenerate).to(coords0.dtype)
    node_alive = _segment_max(elem_alive.repeat_interleave(3), flat, n_nodes)
    return Geometry(coords=coords, area=area, gradphi=gradphi, elem_alive=elem_alive,
                    node_alive=node_alive)


class PoreLattice(NamedTuple):
    """The snapped lattice of the rectangle with its boundary rows, as the
    steady-Burgers solver and its multigrid levels use them."""

    tris: torch.Tensor       # [E, 3] long
    geom: Geometry
    on_inlet: torch.Tensor   # [N] bool, x = xmin
    on_outlet: torch.Tensor  # [N] bool, x = xmax
    noslip: torch.Tensor     # [N] bool: walls, pore-boundary and dead nodes


def pore_lattice(resolution, xmin, xmax, ymin, ymax, per_hole_params, n_holes) -> PoreLattice:
    """The lattice at `resolution` snapped to the pores, on the pore params'
    device and in their dtype. A pore-boundary node is an alive node that
    touches a dead element: with snapping it sits on the pore boundary."""
    dev, dt = per_hole_params.device, per_hole_params.dtype
    tris_np = mesh_topology(resolution)
    tris = torch.as_tensor(tris_np, dtype=torch.long, device=dev)
    coords0 = torch.as_tensor(node_coords(resolution, xmin, xmax, ymin, ymax), dtype=dt,
                              device=dev)

    def on(axis, v):
        return torch.isclose(coords0[:, axis], torch.tensor(v, dtype=dt, device=dev))

    on_inlet, on_outlet = on(0, xmin), on(0, xmax)
    on_walls = on(1, ymin) | on(1, ymax)
    geom = snapped_geometry(tris_np, coords0, per_hole_params, n_holes,
                            min(xmax - xmin, ymax - ymin) / resolution,
                            boundary_fixed=on_inlet | on_outlet | on_walls)
    n_nodes = coords0.shape[0]
    alive_min = torch.zeros(n_nodes, dtype=dt, device=dev).scatter_reduce(
        0, tris.reshape(-1), geom.elem_alive.repeat_interleave(3), "amin", include_self=False)
    noslip = on_walls | (alive_min < 0.5) | (geom.node_alive < 0.5)
    return PoreLattice(tris=tris, geom=geom, on_inlet=on_inlet, on_outlet=on_outlet,
                       noslip=noslip)


_OFFS = (-1, 0, 1)


def evaluate_p1(u_grid, coords_grid, elem_alive, bounds, x):
    """P1 interpolation of nodal values on the snapped mesh at points x
    [..., 2] -> [..., C] (u_grid [m, m, C]).

    The containing triangle is searched among the 18 of the 3x3 lattice
    cells around x's cell (snapped nodes move less than a spacing),
    preferring alive elements; the value is the barycentric combination
    there. A point marginally outside every alive triangle (on a pore
    chord) extrapolates from the best-scoring one; a point deep in a dead
    region (score < -0.5) takes that triangle's nodal mean."""
    m = u_grid.shape[0]
    res = m - 1
    xmin, xmax, ymin, ymax = bounds[0], bounds[1], bounds[2], bounds[3]
    px, py = x[..., 0], x[..., 1]
    fx = torch.clamp((px - xmin) / (xmax - xmin), 0.0, 1.0) * res
    fy = torch.clamp((py - ymin) / (ymax - ymin), 0.0, 1.0) * res
    i0 = torch.clamp(torch.floor(fx).long(), 0, res - 1)
    j0 = torch.clamp(torch.floor(fy).long(), 0, res - 1)
    offs = torch.tensor(_OFFS, device=x.device)
    ci = torch.clamp(i0[..., None] + offs, 0, res - 1)                 # [..., 3]
    cj = torch.clamp(j0[..., None] + offs, 0, res - 1)
    ii = ci.repeat_interleave(3, dim=-1)                                # [..., 9]
    jj = cj.repeat(*([1] * (cj.ndim - 1)), 3)
    # cell (i,j) triangles: t0 = (a,c,d), t1 = (a,d,b) -> 18 per point
    a = ii * m + jj
    b, c, d = a + 1, a + m, a + m + 1
    n0 = torch.cat([a, a], dim=-1)
    n1 = torch.cat([c, d], dim=-1)
    n2 = torch.cat([d, b], dim=-1)
    cell = ii * res + jj
    eid = torch.cat([2 * cell, 2 * cell + 1], dim=-1)
    nodes_xy = coords_grid.reshape(m * m, 2)
    nodes_u = u_grid.reshape(m * m, -1)

    def rows(table, idx):  # table[idx] by index_select (torch.func batches it)
        return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])

    v0, v1, v2 = rows(nodes_xy, n0), rows(nodes_xy, n1), rows(nodes_xy, n2)  # [..., 18, 2]
    alive = rows(elem_alive, eid)
    # Sums and products of the mesh's own values stay in its dtype; any
    # other term is in x's, each mesh value rounded into it first. That is
    # the JAX package's type promotion when it evaluates a float64
    # reference at f32 points (x64 off): an all-float64 score can choose
    # another triangle near a pore chord and move the value by ~1e-2 of the
    # field. A no-op when the dtypes agree.
    dt = x.dtype
    d1 = v1 - v0
    d2 = v2 - v0
    det = (d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]).to(dt)
    d1, d2 = d1.to(dt), d2.to(dt)
    tiny = torch.where(det < 0, torch.full_like(det, -1e-12), torch.full_like(det, 1e-12))
    safe_det = torch.where(torch.abs(det) < 1e-12, tiny, det)
    rx = px[..., None] - v0[..., 0].to(dt)
    ry = py[..., None] - v0[..., 1].to(dt)
    l1 = (rx * d2[..., 1] - ry * d2[..., 0]) / safe_det
    l2 = (ry * d1[..., 0] - rx * d1[..., 1]) / safe_det
    l0 = 1.0 - l1 - l2
    score = torch.minimum(torch.minimum(l0, l1), l2) - 10.0 * (1.0 - alive.to(dt))
    k = torch.argmax(score, dim=-1, keepdim=True)                          # [..., 1]

    def pick(t):
        return torch.take_along_dim(t, k, dim=-1)[..., 0]

    w0, w1, w2 = pick(l0), pick(l1), pick(l2)
    u0, u1, u2 = rows(nodes_u, pick(n0)), rows(nodes_u, pick(n1)), rows(nodes_u, pick(n2))
    val = w0[..., None] * u0.to(dt) + w1[..., None] * u1.to(dt) + w2[..., None] * u2.to(dt)
    far = (pick(score) < -0.5)[..., None]
    near_avg = (u0 + u1 + u2).to(dt) / 3.0
    return torch.where(far, near_avg, val)
