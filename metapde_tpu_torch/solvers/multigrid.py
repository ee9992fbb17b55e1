"""Matrix-free geometric multigrid for the structured-chart FEM solvers
(counterpart of metapde_tpu/solvers/multigrid.py).

In f32, Jacobi-preconditioned BiCGStab stagnates once the stiffness
condition number outruns the precision (the JAX package moved to multigrid
from resolution 32 up). The polar (rho, theta) chart of the star meshes
admits textbook geometric multigrid, used as a LINEAR preconditioner for
the Newton-Krylov solve:

- levels are the solver's own meshes at resolution, resolution/2, ... with
  the linear (unit-coefficient) stiffness operator rediscretised per level;
- damped-Jacobi smoothing, separable full-weighting restriction and
  bilinear prolongation on the (rho, theta) chart (theta periodic, ring 0 =
  the disk centre), Dirichlet outer-ring rows held as identity;
- the V-cycle is a fixed linear operator (fixed sweep counts, zero initial
  guess), as BiCGStab preconditioning requires.

What differs from the JAX package is how the same linear maps are
evaluated, to keep the count of kernel launches of one V-cycle low (eager
PyTorch pays host time for each): each level's operator is assembled once
per solve into a CSR matrix (one sparse product per application, where the
JAX package gathers, multiplies and scatters with segment_sum), the first
sweep from the zero guess is the single product it reduces to, and the
coarsest level's sweeps, a fixed linear map of a few hundred unknowns, are
applied as the dense matrix they make. Sums run in other orders, so the
results agree with the JAX package's to round-off.

The rectangular-lattice levels (make_rect_mg_preconditioner) are the same
V-cycle on the snapped pore lattices of mesh2d, with vertex-centred full
weighting and bilinear prolongation; a vector field's components go through
one V-cycle together as the columns of an [n, components] block, the JAX
package's per-component cycles.
"""

from functools import partial
from typing import Callable, NamedTuple, Tuple

import torch

from .mesh2d import pore_lattice


class Level(NamedTuple):
    apply: Callable          # linear operator on node vectors [n_nodes] (or [n_nodes, B])
    diag: torch.Tensor       # operator diagonal (for damped Jacobi)
    nr: int
    nt: int
    bdry_mask: torch.Tensor  # Dirichlet rows (identity in the operator)


def _vec_to_grid(u, nr, nt):
    """Node vector [1 + nr*nt] -> (center scalar, rings [nr, nt])."""
    return u[0], u[1:].reshape(nr, nt)


def _grid_to_vec(center, rings):
    return torch.cat([center.reshape(1), rings.reshape(-1)])


def _restrict_theta(x):
    """Periodic full weighting along the last axis, nt -> nt//2."""
    sm = (0.25 * torch.roll(x, 1, dims=-1) + 0.5 * x
          + 0.25 * torch.roll(x, -1, dims=-1))
    return sm[..., ::2]


def _prolong_theta(x, nt_f):
    """Periodic linear interpolation along the last axis, nt//2 -> nt:
    coarse values at the even fine angles, neighbour means between."""
    mid = 0.5 * (x + torch.roll(x, -1, dims=-1))
    return torch.stack([x, mid], dim=-1).reshape(*x.shape[:-1], nt_f)


def restrict(u, fine: Level, coarse: Level):
    """Full-weighting (center, rings) transfer fine -> coarse."""
    c, r = _vec_to_grid(u, fine.nr, fine.nt)
    r = _restrict_theta(r)                                 # [nr_f, nt_c]
    padded = torch.cat([c.expand(1, r.shape[1]), r], 0)   # ring 0..nr_f
    # coarse ring i <- fine rings 2i-1, 2i, 2i+1 (the last clamped to nr_f)
    mid = padded[2::2]
    lo = padded[1:-1:2]
    hi = torch.cat([padded[3::2], padded[-1:]], 0)
    rc = 0.25 * lo + 0.5 * mid + 0.25 * hi
    # coarse center <- fine center and its ring-1 neighborhood
    cc = 0.5 * c + 0.5 * torch.mean(padded[1])
    return _grid_to_vec(cc, rc)


def prolong(u, coarse: Level, fine: Level):
    """Bilinear (center, rings) transfer coarse -> fine."""
    c, r = _vec_to_grid(u, coarse.nr, coarse.nt)
    padded = torch.cat([c.expand(1, r.shape[1]), r], 0)   # ring 0..nr_c
    # fine odd ring 2k+1 <- mean of coarse rings k, k+1; even ring 2k <- ring k
    odd = 0.5 * (padded[:-1] + padded[1:])
    rf = torch.stack([odd, padded[1:]], dim=1).reshape(fine.nr, coarse.nt)
    return _grid_to_vec(c, _prolong_theta(rf, fine.nt))


def _col(v, like):
    """A node vector v [n] as a column [n, 1] when `like` holds columns."""
    return v if like.ndim == 1 else v[:, None]


def _smooth(level, x, rhs, sweeps, winv):
    """`sweeps` damped-Jacobi sweeps x += damping * (rhs - A x) / diag, with
    winv = damping / diag; x = None is the zero guess, whose first sweep is
    rhs * winv."""
    for _ in range(sweeps):
        if x is None:
            x = rhs * winv
        else:
            x = torch.addcmul(x, rhs - level.apply(x), winv)
    return torch.zeros_like(rhs) if x is None else x


def vcycle(levels: Tuple[Level, ...], coarse_matrix, b, pre_sweeps=2, post_sweeps=2,
           damping=0.7, restrict_fn=None, prolong_fn=None):
    """One multigrid V-cycle for A x = b with zero initial guess; b is a
    node vector [n] or a block of columns [n, B], each cycled alone.

    A fixed linear operator in b (required for Krylov preconditioning). The
    coarsest level applies `coarse_matrix` (coarse_sweep_matrix: the linear
    map of its damped-Jacobi sweeps from the zero guess). Transfers default
    to the polar (center, rings) pair; the rect-lattice levels pass theirs.
    """
    rfn = restrict if restrict_fn is None else restrict_fn
    pfn = prolong if prolong_fn is None else prolong_fn

    def cycle(li, rhs):
        if li == len(levels) - 1:
            return coarse_matrix @ rhs
        level = levels[li]
        winv = _col(damping / level.diag, rhs)
        mask = _col(level.bdry_mask, rhs)
        x = _smooth(level, None, rhs, pre_sweeps, winv)
        res = rhs - level.apply(x)
        # Dirichlet rows are exact after smoothing (identity rows); keep
        # their coarse correction at zero
        res = torch.where(mask, 0.0, res)
        coarse = levels[li + 1]
        cres = torch.where(_col(coarse.bdry_mask, rhs), 0.0, rfn(res, level, coarse))
        corr = cycle(li + 1, cres)
        x = x + torch.where(mask, 0.0, pfn(corr, coarse, level))
        return _smooth(level, x, rhs, post_sweeps, winv)

    return cycle(0, b)


def coarse_sweep_matrix(level: Level, sweeps: int, damping: float):
    """The dense matrix C with C @ rhs = `sweeps` damped-Jacobi sweeps on
    `level` from the zero guess (a linear map of rhs): the sweeps applied to
    the identity's columns."""
    eye = torch.eye(level.diag.shape[0], dtype=level.diag.dtype, device=level.diag.device)
    return _smooth(level, None, eye, sweeps, (damping / level.diag)[:, None])


def _stiffness_csr(tris, gradphi, area, n_nodes, bdry_mask):
    """The unit-coefficient P1 stiffness matrix with Dirichlet rows as
    identity rows, in CSR: entry (tris[e, k], tris[e, l]) gathers
    area_e * gradphi[e, k] . gradphi[e, l], as the segment_sum assembly."""
    vals = area[:, None, None] * (gradphi @ gradphi.transpose(1, 2))  # [E, 3, 3]
    rows = tris[:, :, None].expand_as(vals).reshape(-1)
    cols = tris[:, None, :].expand_as(vals).reshape(-1)
    keep = ~bdry_mask[rows]
    bdry = torch.nonzero(bdry_mask).reshape(-1)
    index = torch.stack([torch.cat([rows[keep], bdry]), torch.cat([cols[keep], bdry])])
    values = torch.cat([vals.reshape(-1)[keep], torch.ones_like(bdry, dtype=vals.dtype)])
    coo = torch.sparse_coo_tensor(index, values, (n_nodes, n_nodes),
                                  check_invariants=False).coalesce()
    return coo.to_sparse_csr()


def mg_resolutions(resolution: int):
    """resolution, resolution/2, ... down to 2 (or the first odd
    resolution)."""
    out, r = [], resolution
    while r >= 4 and r % 2 == 0:
        out.append(r)
        r //= 2
    out.append(r)
    return out


def polar_levels(geo_params, resolution: int):
    """The multigrid levels of the star mesh with geometry `geo_params`, on
    its device and in its dtype."""
    from .fem_poisson import _element_geometry, mesh_topology, node_coords

    levels = []
    for res in mg_resolutions(resolution):
        tris_np, nr, nt = mesh_topology(res)
        tris = torch.as_tensor(tris_np, dtype=torch.long, device=geo_params.device)
        n_nodes = 1 + nr * nt
        coords = node_coords(geo_params, nr, nt)
        gradphi, area, _ = _element_geometry(coords, tris)
        bdry_mask = torch.zeros(n_nodes, dtype=torch.bool, device=geo_params.device)
        bdry_mask[1 + (nr - 1) * nt:] = True
        A = _stiffness_csr(tris, gradphi, area, n_nodes, bdry_mask)
        diag_elem = area[:, None] * torch.sum(gradphi ** 2, dim=2)
        diag = torch.zeros(n_nodes, dtype=area.dtype, device=area.device).index_add(
            0, tris.reshape(-1), diag_elem.reshape(-1))
        diag = torch.where(bdry_mask, torch.ones_like(diag), torch.clamp(diag, min=1e-12))
        levels.append(Level(apply=partial(torch.matmul, A), diag=diag, nr=nr, nt=nt,
                            bdry_mask=bdry_mask))
    return tuple(levels)


def make_polar_mg_preconditioner(geo_params, resolution: int, pre_sweeps=2,
                                 post_sweeps=2, coarse_sweeps=40, damping=0.7):
    """Build a V-cycle preconditioner for the Poisson star-domain solver.

    Rediscretises the UNIT-coefficient stiffness operator on the polar star
    meshes at resolution, resolution/2, ..., 2 (exact 2:1 ring/angle
    coarsening holds down to resolution 2 given mesh_topology's nr = 4 res,
    nt = 16 res). Returns M: v -> approx A^{-1} v.
    """
    levels = polar_levels(geo_params, resolution)
    C = coarse_sweep_matrix(levels[-1], coarse_sweeps, damping)
    return partial(vcycle, levels, C, pre_sweeps=pre_sweeps, post_sweeps=post_sweeps,
                   damping=damping)


class RectLevel(NamedTuple):
    apply: Callable          # linear operator on node vectors [m*m] (or [m*m, B])
    diag: torch.Tensor
    m: int                   # nodes per side (resolution + 1)
    bdry_mask: torch.Tensor  # constrained rows (identity in the operator)


def _rect_restrict(u, fine: RectLevel, coarse: RectLevel):
    """Vertex-centred full weighting on the lattice, m_f -> m_c (zero
    outside), of [m*m] or [m*m, B]."""
    g = u.reshape(fine.m, fine.m, -1)
    gp = torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1))
    s = (4.0 * gp[1:-1, 1:-1]
         + 2.0 * (gp[:-2, 1:-1] + gp[2:, 1:-1] + gp[1:-1, :-2] + gp[1:-1, 2:])
         + (gp[:-2, :-2] + gp[:-2, 2:] + gp[2:, :-2] + gp[2:, 2:])) / 16.0
    return s[::2, ::2].reshape((-1,) + tuple(u.shape[1:]))


def _rect_prolong(u, coarse: RectLevel, fine: RectLevel):
    """Bilinear interpolation on the lattice, m_c -> m_f, of [m*m] or
    [m*m, B]."""
    gc = u.reshape(coarse.m, coarse.m, -1)
    out = torch.zeros((fine.m, fine.m, gc.shape[2]), dtype=gc.dtype, device=gc.device)
    out[::2, ::2] = gc
    out[1::2, ::2] = 0.5 * (gc[:-1, :] + gc[1:, :])
    out[::2, 1::2] = 0.5 * (gc[:, :-1] + gc[:, 1:])
    out[1::2, 1::2] = 0.25 * (gc[:-1, :-1] + gc[1:, :-1] + gc[:-1, 1:] + gc[1:, 1:])
    return out.reshape((-1,) + tuple(u.shape[1:]))


def rect_resolutions(resolution: int, min_resolution: int = 8):
    """resolution, resolution/2, ... while the next stays >= min_resolution
    and even."""
    out, r = [], resolution
    while r >= min_resolution * 2 and r % 2 == 0:
        out.append(r)
        r //= 2
    out.append(r)
    return out


def rect_levels(per_hole_params, n_holes, resolution: int, xmin, xmax, ymin, ymax,
                coeff=1.0, min_resolution: int = 8):
    """The multigrid levels of the snapped pore lattice at resolution,
    resolution/2, ...: each level's own snapped mesh (mesh2d), the
    coeff-scaled unit stiffness operator on its alive elements in CSR, and
    its constrained rows (outer rectangle, pore-boundary and dead nodes) as
    identity rows; on the pore params' device and in their dtype."""
    dev, dt = per_hole_params.device, per_hole_params.dtype
    levels = []
    for res in rect_resolutions(resolution, min_resolution):
        lattice = pore_lattice(res, xmin, xmax, ymin, ymax, per_hole_params, n_holes)
        tris, geom = lattice.tris, lattice.geom
        flat = tris.reshape(-1)
        n_nodes = geom.coords.shape[0]
        bdry_mask = lattice.on_inlet | lattice.on_outlet | lattice.noslip
        weight = coeff * geom.area * geom.elem_alive
        A = _stiffness_csr(tris, geom.gradphi, weight, n_nodes, bdry_mask)
        diag_elem = weight[:, None] * torch.sum(geom.gradphi ** 2, dim=2)
        diag = torch.zeros(n_nodes, dtype=dt, device=dev).index_add(0, flat, diag_elem.reshape(-1))
        diag = torch.where(bdry_mask, torch.ones_like(diag), torch.clamp(diag, min=1e-12))
        levels.append(RectLevel(apply=partial(torch.matmul, A), diag=diag, m=res + 1,
                                bdry_mask=bdry_mask))
    return tuple(levels)


def make_rect_mg_preconditioner(per_hole_params, n_holes, resolution: int, xmin, xmax,
                                ymin, ymax, coeff=1.0, min_resolution: int = 8,
                                vector_dim: int = 1, pre_sweeps=2, post_sweeps=2,
                                coarse_sweeps=40, damping=0.7):
    """V-cycle preconditioner for the snapped-lattice pore-domain solvers
    (fem_steady_burgers). For vector_dim > 1 a node-major vector [n * dim]
    is cycled as the block [n, dim]: the scalar V-cycle on each component
    (block-diagonal; the coupling between components is left to the outer
    Krylov iteration). Returns M: v -> approx A^{-1} v."""
    levels = rect_levels(per_hole_params, n_holes, resolution, xmin, xmax, ymin, ymax,
                         coeff=coeff, min_resolution=min_resolution)
    C = coarse_sweep_matrix(levels[-1], coarse_sweeps, damping)
    scalar_cycle = partial(vcycle, levels, C, pre_sweeps=pre_sweeps, post_sweeps=post_sweeps,
                           damping=damping, restrict_fn=_rect_restrict,
                           prolong_fn=_rect_prolong)
    if vector_dim == 1:
        return scalar_cycle
    return lambda v: scalar_cycle(v.reshape(-1, vector_dim)).reshape(-1)
