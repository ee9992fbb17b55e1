"""Neo-Hookean FEM ground truth for the porous-sheet compression task
(counterpart of metapde_tpu/solvers/fem_elasticity.py): the sparse-direct
solver ``solve_direct``, which the family's oracle calls, and the
matrix-free cascade ``solve`` / ``solve_x64``, which no oracle calls.

- Mesh: the static structured triangulation made conforming to the pores
  by node snapping (solvers/mesh2d.py); dead elements drop out of the
  energy, and nodes with no live element are tethered to zero.
- Energy: compressible neo-Hookean
  psi(F) = (mu/2)(Ic / max(J, 0.05) - 2) + (kappa/2)(J - 1)^2
           + 1e4 mu max(0.05 - J, 0)^2,
  Young's modulus bc_params[0], Poisson ratio 0.49; bottom row pinned, top
  row displaced by (0, top_displacement), the rest traction-free.
- Solve: damped Newton on the reduced energy, each step's direction from a
  sparse LU factorisation (``scipy.sparse.linalg.splu``) of the assembled
  Hessian, with Levenberg-Marquardt diagonal damping when the direction
  fails to descend, a 6-candidate line search on the true energy, adaptive
  load continuation from the affine compression profile (the step halves
  when Newton stalls) and a final polish at full load; or, with a warm
  start from another resolution's solution, Newton at full load from its
  P1 interpolation, falling back to the continuation when that fails.

Where it runs: the solve is float64 on the host CPU, with scipy's sparse
LU, by the reference's own design (the JAX package pins ``solve_direct``
to its CPU device with x64 on and hands the factorisation to scipy; its
ground truths are solved on the host and evaluated on the device). The
port does the same, whatever device the task params are on, and returns
the ground truth on the params' device in ``out_dtype``; ``evaluate`` (P1
interpolation) and everything after the solve run on that device.

The solve's arithmetic is numpy float64 (the snapped geometry comes from
mesh2d in torch float64): its element arrays are small, and torch's
OpenMP threads spinning beside scipy's slowed them several-fold. Element
values, gradients and Hessians are closed forms of the element energy
density (``_elem_fns``), held equal to the JAX package's jax.grad and
jax.hessian of the same density by tests/test_torch_fem_elasticity.py.
``solve_direct.newton_steps`` counts the Newton iterations that assembled
a Hessian.

The cascade (``solve``) runs on the params' device in their dtype, as the
JAX package's jitted stages run on theirs: the coarsest level (halved
while even and >= 12) takes damped Newton with load stepping from the
affine compression profile, each finer level Newton at full load from the
P1 prolongation of the coarser solution. A Newton step is matrix-free CG
(``newton.cg``: jax.scipy.sparse.linalg.cg's stopping rule, tol 1e-5 in
float32 and 1e-9 in float64, maxiter max(200, 8 res)) on Hessian-vector
products, a non-finite direction zeroed, then the best of six step
lengths on the true energy if it lowers it. One departure: the energy
that the line search compares is evaluated in float64 from the iterate
(gradient, Hessian and CG stay in the params' dtype). In float32 its
rounding, ~1e-9 at an energy of 0.0125, hides the last decreases, and
where Newton then stalls turns on the rounding of each device's sums: on
tests/test_x64_oracles.py's PRNGKey(1) task at 12 the port's float32
energy stalled at |g| 6.8e-5 where the JAX package's reached 2.1e-6, and
at 24 both stalled (|g| 0.26 and 0.24) where the float64-energy search
converges (2.3e-5, within 1.3e-4 of the float64 cascade). The
Hessian-vector product
applies the closed-form element Hessians of the step's iterate
(``_elem_terms``, the torch form of ``_elem_fns``, built once a Newton
step): a gather of v at the element dofs, a 6x6 product an element and an
index_add back, constrained rows replaced by the tether identity, as
jax.jvp of jax.grad of the energy gives it. A Newton step makes no host
read but CG's one an iteration; on a card each CG iteration replays as one
CUDA graph. ``solve.newton_steps`` counts Newton steps (CG iterations:
``newton.cg.iterations``).
"""

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..device import full_f32_matmuls
from . import newton
from .mesh2d import evaluate_p1, mesh_topology, node_coords, snapped_geometry

_JMIN = 0.05


class ElasticityGroundTruth(NamedTuple):
    """Displacement on the snapped (res+1)x(res+1) structured mesh."""

    u_grid: torch.Tensor       # [res+1, res+1, 2] (x-major indexing)
    coords_grid: torch.Tensor  # [res+1, res+1, 2] snapped node positions
    alive_grid: torch.Tensor   # [res+1, res+1] node liveness (float 0/1)
    elem_alive: torch.Tensor   # [2*res^2] element liveness (float 0/1)
    bounds: torch.Tensor       # [4] xmin, xmax, ymin, ymax
    final_energy: torch.Tensor
    # the energy gradient's norm at the returned solution (~1e-9 when
    # Newton converged; large where the continuation accepted a best effort)
    final_gnorm: torch.Tensor


def _deformation(ue, gradphi):
    """F = I + grad u per element: ue [E, 3, 2] nodal displacements,
    gradphi [E, 3, 2] -> [E, 2 (dof), 2 (x)]."""
    return np.eye(2) + (ue[:, :, :, None] * gradphi[:, :, None, :]).sum(axis=1)


def _psi(F, mu, kappa):
    """The element energy density of F [E, 2, 2]: (mu/2)(Ic / max(J, 0.05)
    - 2) + (kappa/2)(J - 1)^2 + 1e4 mu max(0.05 - J, 0)^2 (J clamped in the
    neo-Hookean term, and a smooth penalty that pulls crushed elements back
    out)."""
    J = F[:, 0, 0] * F[:, 1, 1] - F[:, 0, 1] * F[:, 1, 0]
    Ic = np.sum(F * F, axis=(1, 2))
    return ((mu / 2.0) * (Ic / np.maximum(J, _JMIN) - 2.0) + (kappa / 2.0) * (J - 1.0) ** 2
            + (1e4 * mu) * np.maximum(_JMIN - J, 0.0) ** 2)


# J's Hessian in f = vec(F) (index 2d + g): constant
_D2J = np.zeros((4, 4))
_D2J[0, 3] = _D2J[3, 0] = 1.0
_D2J[1, 2] = _D2J[2, 1] = -1.0


def _elem_fns():
    """Per-element energy value, gradient and Hessian in the 6 local dofs
    (node-major: dof 2k + d is node k's component d), batched over
    elements: (ue [E, 6], gradphi [E, 3, 2], mods (mu, kappa)) -> [E],
    [E, 6], [E, 6, 6], float64 numpy. The derivatives are closed forms of
    ``_psi`` (the JAX package takes jax.grad and jax.hessian of the same
    density): in f = vec(F), J's gradient is cof(F) and its Hessian
    constant, and df_{2d+g} / du_{2k+d} = gradphi[k, g] chains them to the
    dofs."""

    def parts(ue, gradphi, mods):
        f = _deformation(ue.reshape(-1, 3, 2), gradphi).reshape(-1, 4)
        J = f[:, 0] * f[:, 3] - f[:, 1] * f[:, 2]
        cof = np.stack([f[:, 3], -f[:, 2], -f[:, 1], f[:, 0]], axis=1)   # dJ/df
        Ic = np.sum(f * f, axis=1)
        live = J > _JMIN                       # Ic / J; below _JMIN, Ic / _JMIN
        Jc = np.maximum(J, _JMIN)
        pen = np.maximum(_JMIN - J, 0.0)       # the penalty's (0.05 - J)+
        return f, J, cof, Ic, live, Jc, pen, mods[0], mods[1]

    def chain(gradphi):
        """B [E, 4, 6] = df / du."""
        B = np.zeros((gradphi.shape[0], 4, 6))
        for d in range(2):
            for g in range(2):
                B[:, 2 * d + g, d::2] = gradphi[:, :, g]
        return B

    def val(ue, gradphi, mods):
        return _psi(_deformation(ue.reshape(-1, 3, 2), gradphi), mods[0], mods[1])

    def grad_fn(ue, gradphi, mods):
        f, J, cof, Ic, live, Jc, pen, mu, kappa = parts(ue, gradphi, mods)
        g_f = ((mu / 2.0) * (2.0 * f / Jc[:, None] - (live * Ic / Jc ** 2)[:, None] * cof)
               + (kappa * (J - 1.0))[:, None] * cof - (2e4 * mu * pen)[:, None] * cof)
        return np.einsum("efq,ef->eq", chain(gradphi), g_f)

    def hess_fn(ue, gradphi, mods):
        f, J, cof, Ic, live, Jc, pen, mu, kappa = parts(ue, gradphi, mods)
        outer = cof[:, :, None] * cof[:, None, :]
        fc = f[:, :, None] * cof[:, None, :]
        col = (slice(None), None, None)
        h_f = ((mu / 2.0) * (2.0 * np.eye(4) / Jc[col]
                             + live[col] * (-2.0 * (fc + fc.transpose(0, 2, 1)) / (Jc ** 2)[col]
                                            + 2.0 * (Ic / Jc ** 3)[col] * outer
                                            - (Ic / Jc ** 2)[col] * _D2J))
               + kappa * outer + (kappa * (J - 1.0))[col] * _D2J
               + 2e4 * mu * ((pen > 0)[col] * outer - pen[col] * _D2J))
        B = chain(gradphi)
        return np.einsum("efq,efh,ehr->eqr", B, h_f, B)

    return val, grad_fn, hess_fn


def _build_problem(params, resolution, xmin, xmax, ymin, ymax):
    """Geometry, masks and the reduced energy functional of one task
    (params float64 on the host; numpy arrays out)."""
    _, bc_params, per_hole_params, n_holes = params
    tris = mesh_topology(resolution).astype(np.int64)
    coords0 = node_coords(resolution, xmin, xmax, ymin, ymax)
    n_nodes = coords0.shape[0]
    # outer-rectangle nodes never move (BC rows stay exact); jnp.isclose's
    # default tolerances
    close = lambda a, b: np.isclose(a, b, rtol=1e-5, atol=1e-8)
    on_rect = (close(coords0[:, 0], xmin) | close(coords0[:, 0], xmax)
               | close(coords0[:, 1], ymin) | close(coords0[:, 1], ymax))
    cell_h = min((xmax - xmin), (ymax - ymin)) / resolution
    geom = snapped_geometry(tris, torch.from_numpy(coords0), per_hole_params, n_holes, cell_h,
                            boundary_fixed=torch.from_numpy(on_rect))
    young = float(bc_params[0])
    mu, kappa = young / (2.0 * (1.0 + 0.49)), young / (3.0 * (1.0 - 2.0 * 0.49))
    on_top = close(coords0[:, 1], ymax)
    constrained = close(coords0[:, 1], ymin) | on_top
    area, gradphi = geom.area.numpy(), geom.gradphi.numpy()
    elem_alive, node_alive = geom.elem_alive.numpy(), geom.node_alive.numpy()
    w_e = elem_alive * area
    # tethers: dead free nodes relax to zero, and so do the unused z entries
    # of constrained nodes (a nonsingular Hessian on those rows)
    dead_w = (1.0 - node_alive) * (1.0 - constrained)

    def u_of(z, top_disp):
        u = z.reshape(n_nodes, 2).copy()
        u[constrained] = 0.0
        u[on_top, 1] = top_disp
        return u

    def energy(z, top_disp):
        u = u_of(z, top_disp)
        elastic = np.sum(w_e * _psi(_deformation(u[tris], gradphi), mu, kappa))
        tether = (0.5 * np.sum(dead_w[:, None] * u ** 2)
                  + 0.5 * np.sum(constrained[:, None] * z.reshape(n_nodes, 2) ** 2))
        return float(elastic + tether)

    return {"geom": geom, "n_nodes": n_nodes, "energy": energy, "u_of": u_of,
            "constrained": constrained, "mods": (mu, kappa), "on_top": on_top, "tris": tris,
            "w_e": w_e, "gradphi": gradphi, "node_alive": node_alive}


def evaluate(gt: ElasticityGroundTruth, x):
    """Displacement at points x [..., 2] -> [..., 2]: P1 interpolation on
    the snapped mesh."""
    return evaluate_p1(gt.u_grid, gt.coords_grid, gt.elem_alive, gt.bounds, x)


def solve_direct(params, resolution: int = 32, xmin: float = 0.0, xmax: float = 1.0,
                 ymin: float = 0.0, ymax: float = 1.0, load_steps: int = 8,
                 newton_steps: int = 40, top_displacement: float = -0.12,
                 grad_tol: float = 1e-8, out_dtype=torch.float32, verbose: bool = False,
                 warm_start: ElasticityGroundTruth = None) -> ElasticityGroundTruth:
    """Damped-Newton solve with sparse-direct linear algebra, float64 on the
    host (module docstring). warm_start: a solution of the same task at
    another resolution; the solve then starts from its P1 interpolation at
    full load (it stays on the warm start's energy branch) and falls back
    to the load continuation if that Newton does not converge. Returns the
    ground truth on the params' device in out_dtype."""
    out_device = params[1].device
    params = tuple(torch.as_tensor(a).detach().cpu() for a in params)
    params = tuple(a.double() if a.is_floating_point() else a for a in params)
    prob = _build_problem(params, resolution, xmin, xmax, ymin, ymax)
    n_nodes, tris, energy = prob["n_nodes"], prob["tris"], prob["energy"]
    w_e, gradphi, mods = prob["w_e"], prob["gradphi"], prob["mods"]
    constrained, node_alive = prob["constrained"], prob["node_alive"]

    # dof bookkeeping (static topology -> static sparsity pattern)
    edofs = np.stack([2 * tris[:, k // 2] + k % 2 for k in range(6)], axis=1)  # [E,6]
    rows = np.repeat(edofs, 6, axis=1).reshape(-1)
    cols = np.tile(edofs, (1, 6)).reshape(-1)
    flat_edofs = edofs.reshape(-1)
    ndof = 2 * n_nodes
    free = ~np.repeat(constrained, 2)                               # [ndof]
    # the tether diagonal: dead free nodes and constrained rows, as energy()
    diag_tether = np.repeat(1.0 - node_alive, 2) * free + (~free).astype(np.float64)
    free_rc = free[rows] * free[cols]
    _, grad_f, hess_f = _elem_fns()

    def grad_np(z, scale):
        ge = grad_f(prob["u_of"](z, top_displacement * scale)[tris].reshape(-1, 6), gradphi,
                    mods)
        g = np.bincount(flat_edofs, weights=(w_e[:, None] * ge).reshape(-1), minlength=ndof)
        return g * free + diag_tether * z

    def hess_np(z, scale):
        he = hess_f(prob["u_of"](z, top_displacement * scale)[tris].reshape(-1, 6), gradphi,
                    mods)
        # constrained rows and columns are replaced by the tether identity
        data = (w_e[:, None, None] * he).reshape(-1) * free_rc
        H = sp.coo_matrix((data, (rows, cols)), shape=(ndof, ndof))
        return (H + sp.diags(diag_tether)).tocsc()

    coords = prob["geom"].coords.numpy()
    frac = (coords[:, 1] - ymin) / (ymax - ymin)
    affine = np.stack([np.zeros(n_nodes), frac], axis=1).reshape(-1) * free
    alphas = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)

    def newton(z, scale, max_iters):
        """Damped Newton at load fraction `scale`; returns (z, |g|)."""
        top_s = top_displacement * scale
        lam = 0.0
        for _ in range(max_iters):
            g = grad_np(z, scale)
            if float(np.linalg.norm(g)) < grad_tol:
                break
            H = hess_np(z, scale)
            solve_direct.newton_steps += 1
            e0 = energy(z, top_s)
            improved = False
            for _try in range(6):
                Hd = H if lam == 0.0 else (
                    H + lam * sp.diags(np.maximum(H.diagonal(), 1e-12))).tocsc()
                try:
                    dz = spla.splu(Hd).solve(-g)
                except RuntimeError:
                    lam = max(1e-8, lam * 10.0) if lam else 1e-6
                    continue
                if not np.all(np.isfinite(dz)):
                    lam = max(1e-8, lam * 10.0) if lam else 1e-6
                    continue
                for a in alphas:
                    e1 = energy(z + a * dz, top_s)
                    if np.isfinite(e1) and e1 < e0:
                        z = z + a * dz
                        improved = True
                        break
                if improved:
                    # relax the damping once a step succeeds
                    lam = 0.0 if lam < 1e-8 else lam * 0.1
                    break
                # the factorised direction failed to descend: damp harder
                # (an indefinite Hessian near a buckling bifurcation)
                lam = max(1e-6, lam * 10.0) if lam else 1e-6
            if not improved:
                break  # converged as far as this damping ladder goes
        return z, float(np.linalg.norm(grad_np(z, scale)))

    accept_tol = max(grad_tol, 1e-5)

    def finish(z, msg):
        gnorm = float(np.linalg.norm(grad_np(z, 1.0)))
        if verbose:
            print(f"  {msg}: |g| {gnorm:.3e}, E {energy(z, top_displacement):.6f}", flush=True)
        m = resolution + 1
        geom = prob["geom"]
        as_out = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(device=out_device,
                                                                         dtype=out_dtype)
        return ElasticityGroundTruth(
            u_grid=as_out(prob["u_of"](z, top_displacement).reshape(m, m, 2)),
            coords_grid=as_out(geom.coords.reshape(m, m, 2)),
            alive_grid=as_out(geom.node_alive.reshape(m, m)),
            elem_alive=as_out(geom.elem_alive),
            bounds=as_out(np.asarray([xmin, xmax, ymin, ymax])),
            final_energy=as_out(energy(z, top_displacement)),
            final_gnorm=as_out(gnorm))

    if warm_start is not None:
        ws = ElasticityGroundTruth(*(a.detach().cpu().double() for a in warm_start))
        z0 = evaluate(ws, torch.from_numpy(coords)).numpy().reshape(-1)
        z0 = np.where(np.repeat(node_alive > 0.5, 2) & free, z0, 0.0)
        z, gnorm = newton(z0, 1.0, newton_steps)
        if gnorm <= accept_tol:
            return finish(z, "warm-start")
        if verbose:
            print(f"  warm-start failed (|g| {gnorm:.3e}); falling back to load "
                  "continuation", flush=True)

    # Adaptive load continuation: advance the top displacement by ds; when
    # Newton does not converge (the post-buckling regime of near-limit pore
    # lattices), halve ds and retry from the last accepted state.
    ds0 = 1.0 / load_steps
    ds_min = ds0 / 8.0
    z, s, ds = np.zeros(ndof), 0.0, ds0
    while s < 1.0 - 1e-12:
        ds_eff = min(ds, 1.0 - s)
        s_try = s + ds_eff
        z_try = z + (ds_eff * top_displacement) * affine
        z_try, gnorm = newton(z_try, s_try, newton_steps)
        if gnorm <= accept_tol or ds_eff <= ds_min * (1 + 1e-9):
            z, s = z_try, s_try
            if gnorm <= accept_tol:
                ds = min(ds * 1.5, ds0)
            if verbose:
                print(f"  load s={s:.4f} (ds {ds_eff:.4f}): |g| {gnorm:.3e}", flush=True)
        else:
            ds = max(ds_eff / 2.0, ds_min)
            if verbose:
                print(f"  load s={s_try:.4f} rejected (|g| {gnorm:.3e}) -> ds {ds:.4f}",
                      flush=True)
    # final polish at full load
    z, _ = newton(z, 1.0, newton_steps)
    return finish(z, "polish")


solve_direct.newton_steps = 0


# ---------------------------------------------------------------------------
# The matrix-free cascade, on the params' device
# ---------------------------------------------------------------------------

_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)


def _elem_terms(ue, gradphi, mu, kappa):
    """The torch form of _elem_fns' gradient and Hessian: ue [E, 3, 2],
    gradphi [E, 3, 2] -> ([E, 6], [E, 6, 6]) in the local dofs (dof 2k + d
    is node k's component d)."""
    F = torch.eye(2, dtype=ue.dtype, device=ue.device) + torch.einsum(
        "ekd,ekg->edg", ue, gradphi)
    f = F.reshape(-1, 4)
    J = f[:, 0] * f[:, 3] - f[:, 1] * f[:, 2]
    cof = torch.stack([f[:, 3], -f[:, 2], -f[:, 1], f[:, 0]], dim=1)     # dJ/df
    Ic = (f * f).sum(dim=1)
    live = (J > _JMIN).to(f.dtype)
    Jc = torch.clamp(J, min=_JMIN)
    pen = torch.clamp(_JMIN - J, min=0.0)
    col = (slice(None), None)
    g_f = ((mu / 2.0) * (2.0 * f / Jc[col] - (live * Ic / Jc ** 2)[col] * cof)
           + (kappa * (J - 1.0))[col] * cof - (2e4 * mu * pen)[col] * cof)
    d2j = torch.as_tensor(_D2J, dtype=f.dtype, device=f.device)
    eye = torch.eye(4, dtype=f.dtype, device=f.device)
    outer = cof[:, :, None] * cof[:, None, :]
    fc = f[:, :, None] * cof[:, None, :]
    col = (slice(None), None, None)
    h_f = ((mu / 2.0) * (2.0 * eye / Jc[col]
                         + live[col] * (-2.0 * (fc + fc.transpose(1, 2)) / (Jc ** 2)[col]
                                        + 2.0 * (Ic / Jc ** 3)[col] * outer
                                        - (Ic / Jc ** 2)[col] * d2j))
           + kappa * outer + (kappa * (J - 1.0))[col] * d2j
           + 2e4 * mu * ((pen > 0).to(f.dtype)[col] * outer - pen[col] * d2j))
    # f index 2d + g; df_{2d+g} / du_{2k+d} = gradphi[k, g]
    ge = torch.einsum("edg,ekg->ekd", g_f.reshape(-1, 2, 2), gradphi).reshape(-1, 6)
    he = torch.einsum("ekg,edgch,elh->ekdlc", gradphi, h_f.reshape(-1, 2, 2, 2, 2),
                      gradphi).reshape(-1, 6, 6)
    return ge, he


def _torch_problem(params, resolution, xmin, xmax, ymin, ymax):
    """Geometry, masks and the reduced energy of one task on the params'
    device in the dtype of bc_params (JAX's _build_problem): a dict with
    the geometry, `energy(z [..., 2N], top_disp) -> [...]`, `u_of`,
    `grad_hess(z, top_disp) -> (g [2N], hvp)` and the dof masks."""
    _, bc_params, per_hole_params, n_holes = params
    dtype, device = bc_params.dtype, bc_params.device
    tris_np = mesh_topology(resolution)
    tris = torch.as_tensor(tris_np, dtype=torch.long, device=device)
    coords0 = torch.as_tensor(node_coords(resolution, xmin, xmax, ymin, ymax), dtype=dtype,
                              device=device)
    n_nodes = coords0.shape[0]
    close = lambda a, b: torch.isclose(a, torch.full_like(a, b), rtol=1e-5, atol=1e-8)
    on_rect = (close(coords0[:, 0], xmin) | close(coords0[:, 0], xmax)
               | close(coords0[:, 1], ymin) | close(coords0[:, 1], ymax))
    cell_h = min((xmax - xmin), (ymax - ymin)) / resolution
    geom = snapped_geometry(tris_np, coords0, per_hole_params, n_holes, cell_h,
                            boundary_fixed=on_rect)
    young = bc_params[0]
    mu, kappa = young / (2.0 * (1.0 + 0.49)), young / (3.0 * (1.0 - 2.0 * 0.49))
    on_top = close(coords0[:, 1], ymax)
    constrained = close(coords0[:, 1], ymin) | on_top
    cons = constrained.to(dtype)
    w_e = geom.elem_alive * geom.area
    dead_w = (1.0 - geom.node_alive) * (1.0 - cons)
    free = ~constrained.repeat_interleave(2)
    freef = free.to(dtype)
    # the tether diagonal: dead free nodes and the unused z entries of
    # constrained nodes
    diag_tether = (dead_w + cons).repeat_interleave(2)
    edofs = torch.stack([2 * tris[:, k // 2] + k % 2 for k in range(6)], dim=1)   # [E, 6]
    top_row = torch.stack([torch.zeros_like(cons), on_top.to(dtype)], dim=1)       # [N, 2]

    def u_of(z, top_disp):
        u = z.reshape(*z.shape[:-1], n_nodes, 2)
        return torch.where(constrained[:, None], top_disp * top_row, u)

    # the energy, in float64 whatever the dtype (module docstring)
    f64 = lambda t: t.to(torch.float64)
    gradphi64, w_e64, dead_w64, cons64 = map(f64, (geom.gradphi, w_e, dead_w, cons))
    mu64, kappa64 = f64(mu), f64(kappa)

    def energy(z, top_disp):
        """[...]: the energy of z [..., 2N], float64."""
        u, zz = f64(u_of(z, top_disp)), f64(z.reshape(*z.shape[:-1], n_nodes, 2))
        grad_u = torch.einsum("...ekd,ekg->...edg", u[..., tris, :], gradphi64)
        F = torch.eye(2, dtype=torch.float64, device=device) + grad_u
        J = F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
        Ic = (F * F).sum(dim=(-2, -1))
        psi = ((mu64 / 2.0) * (Ic / torch.clamp(J, min=_JMIN) - 2.0)
               + (kappa64 / 2.0) * (J - 1.0) ** 2
               + (1e4 * mu64) * torch.clamp(_JMIN - J, min=0.0) ** 2)
        tether = (0.5 * (dead_w64[:, None] * u ** 2).sum(dim=(-2, -1))
                  + 0.5 * (cons64[:, None] * zz ** 2).sum(dim=(-2, -1)))
        return (w_e64 * psi).sum(dim=-1) + tether

    def grad_hess(z, top_disp, hessian=True):
        """The energy's gradient in z, and its Hessian-vector product at z
        (None unless `hessian`)."""
        ue = u_of(z, top_disp)[tris]                                       # [E, 3, 2]
        with full_f32_matmuls():
            ge, he = _elem_terms(ue, geom.gradphi, mu, kappa)
        g = torch.zeros_like(z).index_add_(0, edofs.reshape(-1),
                                           (w_e[:, None] * ge).reshape(-1))
        g = g * freef + diag_tether * z
        if not hessian:
            return g, None
        he = w_e[:, None, None] * he

        def hvp(v):
            ve = (v * freef)[edofs]                                        # [E, 6]
            hv = (he * ve[:, None, :]).sum(dim=-1)
            out = torch.zeros_like(v).index_add_(0, edofs.reshape(-1), hv.reshape(-1))
            return out * freef + diag_tether * v

        return g, hvp

    return {"geom": geom, "n_nodes": n_nodes, "energy": energy, "u_of": u_of,
            "grad_hess": grad_hess, "free": free}


def _newton(prob, z, top_disp, newton_steps, resolution):
    """`newton_steps` damped Newton steps (JAX's newton_solve); on a card
    each CG iteration is one CUDA graph (the Hessian product makes no host
    reads)."""
    cg_tol = 1e-5 if z.dtype == torch.float32 else 1e-9
    alphas = torch.tensor(_ALPHAS, dtype=z.dtype, device=z.device)
    energy = lambda zz: prob["energy"](zz, top_disp)
    for _ in range(newton_steps):
        g, hvp = prob["grad_hess"](z, top_disp)
        dz = newton.cg(hvp, -g, tol=cg_tol, maxiter=max(200, 8 * resolution),
                       cuda_graph=True)
        dz = torch.where(torch.isfinite(dz), dz, torch.zeros_like(dz))
        e0 = energy(z)
        cand = energy(z + alphas[:, None] * dz)
        cand = torch.where(torch.isfinite(cand), cand, torch.full_like(cand, float("inf")))
        best = torch.argmin(cand)
        z = torch.where(cand[best] < e0, z + alphas[best] * dz, z)
        solve.newton_steps += 1
    return z


def _pack(prob, z, resolution, xmin, xmax, ymin, ymax, top_displacement):
    u = prob["u_of"](z, top_displacement)
    m = resolution + 1
    geom = prob["geom"]
    g, _ = prob["grad_hess"](z, top_displacement, hessian=False)
    return ElasticityGroundTruth(
        u_grid=u.reshape(m, m, 2), coords_grid=geom.coords.reshape(m, m, 2),
        alive_grid=geom.node_alive.reshape(m, m), elem_alive=geom.elem_alive,
        bounds=torch.tensor([xmin, xmax, ymin, ymax], dtype=z.dtype, device=z.device),
        final_energy=prob["energy"](z, top_displacement).to(z.dtype),
        final_gnorm=torch.linalg.norm(g))


def _solve_base(params, resolution, xmin, xmax, ymin, ymax, load_steps, newton_steps,
                top_displacement):
    """The coarsest level: the affine warm start (masked to free dofs) and
    load stepping."""
    prob = _torch_problem(params, resolution, xmin, xmax, ymin, ymax)
    coords = prob["geom"].coords
    frac = (coords[:, 1] - ymin) / (ymax - ymin)
    affine = torch.stack([torch.zeros_like(frac), frac], dim=1).reshape(-1) * prob["free"]
    ddisp = top_displacement / load_steps
    z = torch.zeros_like(affine)
    for k in range(1, load_steps + 1):
        z = z + ddisp * affine
        z = _newton(prob, z, top_displacement * k / load_steps, newton_steps, resolution)
    return _pack(prob, z, resolution, xmin, xmax, ymin, ymax, top_displacement)


def _refine_stage(params, coarse_gt, resolution, xmin, xmax, ymin, ymax, newton_steps,
                  top_displacement):
    """One cascade level: P1-prolong the coarser solution onto this level's
    snapped mesh (dead nodes and constrained rows' z at 0) and Newton at
    full load."""
    prob = _torch_problem(params, resolution, xmin, xmax, ymin, ymax)
    geom = prob["geom"]
    z0 = evaluate_p1(coarse_gt.u_grid, coarse_gt.coords_grid, coarse_gt.elem_alive,
                     coarse_gt.bounds, geom.coords).reshape(-1)
    keep = (geom.node_alive.repeat_interleave(2) > 0.5) & prob["free"]
    z0 = torch.where(keep, z0, torch.zeros_like(z0))
    z = _newton(prob, z0, top_displacement, newton_steps, resolution)
    return _pack(prob, z, resolution, xmin, xmax, ymin, ymax, top_displacement)


def solve(params, resolution: int = 32, xmin: float = 0.0, xmax: float = 1.0,
          ymin: float = 0.0, ymax: float = 1.0, load_steps: int = 4, newton_steps: int = 25,
          top_displacement: float = -0.12) -> ElasticityGroundTruth:
    """Cascadic solve at `resolution` on the params' device in their dtype
    (module docstring): the base level with load stepping, then each 2x
    refinement from the previous level."""
    chain = [resolution]
    while chain[-1] % 2 == 0 and chain[-1] // 2 >= 12:
        chain.append(chain[-1] // 2)
    chain.reverse()
    gt = _solve_base(params, chain[0], xmin, xmax, ymin, ymax, load_steps, newton_steps,
                     top_displacement)
    for res in chain[1:]:
        gt = _refine_stage(params, gt, res, xmin, xmax, ymin, ymax, newton_steps,
                           top_displacement)
    return gt


solve.newton_steps = 0


def solve_x64(params, resolution: int = 48, xmin: float = 0.0, xmax: float = 1.0,
              ymin: float = 0.0, ymax: float = 1.0, load_steps: int = 4,
              newton_steps: int = 40, top_displacement: float = -0.12) -> ElasticityGroundTruth:
    """The cascade in float64 (the float leaves of params cast; CG's
    tolerance 1e-9), for accuracy sweeps."""
    params64 = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                     for a in params)
    return solve(params64, resolution, xmin, xmax, ymin, ymax, load_steps, newton_steps,
                 top_displacement)
