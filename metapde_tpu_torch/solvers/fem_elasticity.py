"""Neo-Hookean FEM ground truth for the porous-sheet compression task
(counterpart of metapde_tpu/solvers/fem_elasticity.py: the sparse-direct
solver ``solve_direct`` and what it needs; the JAX package's matrix-free
Krylov cascade, ``solve`` and ``solve_x64``, is not on the family's path
and is not ported).

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
"""

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

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
