"""2-D compressible neo-Hookean hyperelasticity on a porous sheet
(counterpart of metapde_tpu/pdes/hyper_elasticity.py).

A rectangle with a max_holes x max_holes lattice of circular pores (the
pore shape coefficients are drawn, then zeroed, leaving circles of one
random scale) is compressed from the top by the displacement (0, -0.12);
the field is the displacement u(x), two outputs.

Losses: the domain loss is the neo-Hookean energy density psi(F),
F = I + grad u (the network minimises the potential energy); boundary
losses 1000 mean(u(bottom)^2) and 1000 mean((u(top) - (0, -0.12))^2).

Task distribution semantics kept from the JAX package:
- a factor switched off by ``vary_*`` is frozen at the JAX package's draw
  from the all-zero PRNG key (pdes/frozen.py, bit for bit): with
  vary_bc=false every task's Young's modulus is bc_scale times JAX's
  zero-key draw; the same for the source (vary_source) and the pore draws
  (vary_geometry). ``fixed_num_pdes`` draws every task from one generator
  seeded ``task.seed``.
- the rejection loop: draw again until the wall between neighbouring pores
  clears t_bar = 0.05 of the pore spacing. With the geometry frozen the
  JAX loop never ends on an infeasible draw; the port raises there.
- point samplers mask pore interiors with the reference's choice(p=mask)
  trick: candidates in the box or on an edge, then n draws among those
  outside every pore (torch.multinomial on the mask), with the JAX
  package's inverted ``replace=not sample_with_replacement``; pore-ring
  points are kept if inside the box.
- the ground truth is fem_elasticity.solve_direct at the requested
  resolution raised by the ligament floor (``ligament_resolution_floor``):
  the lattice must resolve the thinnest wall between pores.

Training draws one outer step's point sets for every task at once
(sample_points_batched): one torch.multinomial over a [rows, candidates]
weight matrix per point kind serves every task and set.
"""

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..config import TaskConfig
from ..solvers import fem_elasticity
from . import frozen
from .registry import PdeDef

TOP_DISPLACEMENT = -0.12


def ligament_resolution_floor(per_hole_params, L0, width, res, cap=192):
    """The oracle resolution that resolves the thinnest inter-pore wall:
    the cell size at most half the wall (at least 0.025 L0), capped at
    `cap`. Near the sampler's feasibility limit the walls are ~0.0125 wide,
    and a coarser lattice pinches them off during snapping."""
    php = np.asarray(torch.as_tensor(per_hole_params).detach().cpu())
    r_max = float(np.max(php[:, 4] * (1.0 + np.abs(php[:, 0]) + np.abs(php[:, 1]))))
    wall = max(L0 - 2.0 * r_max, 0.025 * L0)
    need = int(np.ceil(2.0 * width / wall))
    return int(min(max(res, need), cap))


def _psi(F, young_mod):
    """Neo-Hookean energy density of deformation gradients F [..., 2, 2]."""
    shear_mod = young_mod / (2 * (1 + 0.49))
    bulk_mod = young_mod / (3 * (1 - 2 * 0.49))
    J = F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
    Ic = torch.sum(F * F, dim=(-2, -1))
    return (shear_mod / 2) * (J ** (-2.0 / 2) * Ic - 2) + (bulk_mod / 2) * (J - 1) ** 2


def in_nearest_circle(xy, php, max_holes, x0, y0, L0):
    """Pore membership of xy [rows, C, 2] (php [rows, H, 5]) for this
    family's layout: circles (c1 = c2 = 0) of radius below L0 / 2 centred
    on the static max_holes x max_holes lattice from (x0, y0) at spacing
    L0, every pore counted. The sampler's draws always have it: the shape
    coefficients are zeroed, n_holes is max_holes^2, and the rejection loop
    (tmin >= 0.05) bounds the radius by 0.475 L0. Such circles are
    disjoint and a point can only lie in the one whose centre is nearest,
    so only that one is tested, with the reference's rule over every pore
    (r0 > |x - c| + 1e-7, r0 = size * 1.0 exactly); its actual centre is
    gathered, so centres an ulp off the lattice are exact too. One
    comparison a point instead of one a pore."""
    ix = torch.clamp(torch.round((xy[..., 0] - x0) / L0), 0, max_holes - 1)
    iy = torch.clamp(torch.round((xy[..., 1] - y0) / L0), 0, max_holes - 1)
    pore = (ix * max_holes + iy).long()                                # [rows, C]
    near = torch.gather(php, 1, pore[..., None].expand(-1, -1, 5))      # [rows, C, 5]
    vx = xy[..., 0] - near[..., 2]
    vy = xy[..., 1] - near[..., 3]
    return near[..., 4] > torch.sqrt(vx ** 2 + vy ** 2) + 1e-7


def _uniform(gen, shape, lo, hi):
    return torch.empty(shape, device=gen.device).uniform_(lo, hi, generator=gen)


def make_pde(cfg: TaskConfig) -> PdeDef:
    dom = cfg.domain
    max_holes = cfg.max_holes
    n_holes_total = max(max_holes * max_holes, 1)
    replace = not cfg.sample_with_replacement

    # static pore-lattice centres
    if max_holes > 0:
        pore_x0 = np.linspace(dom.xmin, dom.xmax, max_holes)
        pore_y0 = np.linspace(dom.ymin, dom.ymax, max_holes)
        xx, yy = np.meshgrid(pore_x0, pore_y0, indexing="ij")
        pore_x0y0 = np.stack([xx.reshape(-1), yy.reshape(-1)], 1).astype(np.float32)
        L0 = float(pore_x0[1] - pore_x0[0]) if max_holes > 1 else 1.0
    else:
        pore_x0y0 = np.zeros((1, 2), np.float32)
        L0 = 1.0
    theta_check = torch.linspace(0, 2 * math.pi, 1000)

    def _factor(gen, vary, shape, lo, hi):
        return (_uniform(gen, shape, lo, hi) if vary
                else frozen.uniform(shape, lo, hi, gen.device))

    def _sample_body(gen):
        dev = gen.device
        source_params = _factor(gen, cfg.vary_source, (2,), 0.25, 0.75)
        bc_params = cfg.bc_scale * _factor(gen, cfg.vary_bc, (2,), 0.9, 1.1)
        # pore shape coefficients drawn, then zeroed: circles
        pore_shape = 0.0 * torch.cat([_factor(gen, cfg.vary_geometry, (1,), -0.1, 0.1),
                                      _factor(gen, cfg.vary_geometry, (1,), -0.1, 0.1)])
        pore_shapes = pore_shape[None, :].expand(n_holes_total, 2)
        # base radius from the porosity phi = 0.5; XLA computes the division
        # by the square root as a product with the rounded rsqrt, so the
        # port does (the bits of the pore sizes depend on it)
        phi = 0.5
        rsqrt = (1.0 / torch.sqrt(((2 + pore_shape[0] ** 2 + pore_shape[1] ** 2)
                                   * math.pi).double())).float()
        r0 = L0 * math.sqrt(2 * phi) * rsqrt
        pore_scale = _factor(gen, cfg.vary_geometry, (1,), 0.2 * cfg.max_hole_size,
                             1.5 * cfg.max_hole_size)
        pore_sizes = torch.full((n_holes_total, 1), float(r0), device=dev) * pore_scale
        # feasibility: the wall between pores clears t_bar
        theta = theta_check.to(dev)
        r_theta = pore_scale[0] * r0 * (1 + pore_shape[0] * torch.cos(4 * theta)
                                        + pore_shape[1] * torch.cos(8 * theta))
        tmin = (L0 - 2 * torch.max(r_theta * torch.cos(theta))) / L0
        php = torch.cat([pore_shapes, torch.as_tensor(pore_x0y0, device=dev), pore_sizes], 1)
        return (bool(tmin < 0.05), source_params, bc_params, php,
                torch.tensor(max_holes * max_holes, dtype=torch.int32, device=dev))

    def sample_params(gen):
        if cfg.fixed_num_pdes is not None:
            gen = torch.Generator(device=gen.device).manual_seed(cfg.seed)
        if max_holes <= 0:
            _, src, bc, _, _ = _sample_body(gen)
            return (src, bc, torch.zeros((1, 5), device=gen.device),
                    torch.tensor(0, dtype=torch.int32, device=gen.device))
        while True:
            infeasible, src, bc, php, nh = _sample_body(gen)
            if not infeasible:
                return src, bc, php, nh
            if not cfg.vary_geometry:
                raise ValueError("the frozen pore draw (vary_geometry=false) violates the wall "
                                 "bound; the JAX package's rejection loop never ends here")

    # --- point samplers: every draw on the generator's device, for `rows`
    # point sets at once (per-row pore params [rows, H, 5])

    def in_hole(xy, php):
        """xy [rows, C, 2] inside any of its row's pores."""
        if max_holes <= 0:
            return torch.zeros(xy.shape[:-1], dtype=torch.bool, device=xy.device)
        return in_nearest_circle(xy, php, max_holes, float(pore_x0[0]), float(pore_y0[0]), L0)

    def choose(gen, n, xy, weights):
        """n of the candidates xy [rows, C, 2] per row, drawn by weight."""
        idx = torch.multinomial(weights, n, replacement=replace, generator=gen)
        return torch.gather(xy, 1, idx[..., None].expand(-1, -1, 2))

    def masked(gen, n, xy, php):
        return choose(gen, n, xy, 1.0 - in_hole(xy, php).to(xy.dtype))

    def edge(gen, n, php, fixed_axis, fixed_val, lo, hi):
        rows = php.shape[0]
        vals = _uniform(gen, (rows, 10 * n), lo, hi)
        fixed = torch.full_like(vals, fixed_val)
        xy = torch.stack([vals, fixed] if fixed_axis == 1 else [fixed, vals], dim=-1)
        return masked(gen, n, xy, php)

    def on_pores(gen, n, php):
        rows = php.shape[0]
        n_tmp = int(1.5 * n)
        thetas = _uniform(gen, (rows, 1, n_tmp), 0.0, 2 * math.pi)
        c1, c2, x0, y0, size = (php[:, :, i:i + 1] for i in range(5))
        r0 = size * (1 + c1 * torch.cos(4 * thetas) + c2 * torch.cos(8 * thetas))
        xy = torch.stack([x0 + r0 * torch.cos(thetas), y0 + r0 * torch.sin(thetas)],
                         dim=-1).reshape(rows, -1, 2)        # hole-major, as JAX's
        in_bound = ((xy[..., 0] > dom.xmin) & (xy[..., 0] < dom.xmax)
                    & (xy[..., 1] > dom.ymin) & (xy[..., 1] < dom.ymax))
        return choose(gen, n, xy, in_bound.to(xy.dtype))

    def in_domain(gen, n, php):
        rows = php.shape[0]
        xs = _uniform(gen, (rows, 3 * n), dom.xmin, dom.xmax)
        ys = _uniform(gen, (rows, 3 * n), dom.ymin, dom.ymax)
        return masked(gen, n, torch.stack([xs, ys], dim=-1), php)

    def _draw(gen, n, php):
        """The six kinds (top, bottom, left, right, pore rings, domain), each
        [rows, n, 2]."""
        top = edge(gen, n, php, 1, dom.ymax, dom.xmin, dom.xmax)
        bottom = edge(gen, n, php, 1, dom.ymin, dom.xmin, dom.xmax)
        left = edge(gen, n, php, 0, dom.xmin, dom.ymin, dom.ymax)
        right = edge(gen, n, php, 0, dom.xmax, dom.ymin, dom.ymax)
        holes = on_pores(gen, n, php) if max_holes > 0 else top
        return top, bottom, left, right, holes, in_domain(gen, n, php)

    def _rows(params, gen, sets=1):
        php = params[2].to(gen.device)
        if php.ndim == 2:
            php = php[None]
        return php.repeat_interleave(sets, 0)

    def sample_points(gen, n, params):
        return tuple(p[0].to(params[2].device) for p in _draw(gen, n, _rows(params, gen)))

    def sample_points_in_domain(gen, n, params):
        return in_domain(gen, n, _rows(params, gen))[0].to(params[2].device)

    def sample_points_batched(gen, n, params_stacked, sets):
        """`sets` independent point sets for each of T tasks (task params
        stacked [T, ...]): the six kinds, each [T, sets, n, 2], each set
        drawn as sample_points draws one."""
        t = params_stacked[2].shape[0]
        return tuple(p.reshape(t, sets, n, 2).to(params_stacked[2].device)
                     for p in _draw(gen, n, _rows(params_stacked, gen, sets)))

    def loss_domain_fn(field_fn, points_in_domain, params):
        """The neo-Hookean energy density at each point."""
        young_mod = params[1][0]
        if hasattr(field_fn, "vjac"):
            # one first-order pass: F = I + grad u for the whole batch
            _, g = field_fn.vjac(points_in_domain)
            return _psi(torch.eye(2, dtype=g.dtype, device=g.device) + g, young_mod)

        def integrand(x):
            jac = jacfwd(lambda y: field_fn(y).reshape(-1))(x)
            return _psi(torch.eye(2, dtype=jac.dtype, device=jac.device) + jac, young_mod)

        return vmap(integrand)(points_in_domain)

    def loss_fn(field_fn, points, params):
        """(boundary losses, domain losses) dicts."""
        points_on_top, points_on_bottom, _, _, _, points_in_domain = points
        target = torch.tensor([0.0, TOP_DISPLACEMENT], device=points_on_top.device)
        return (
            {"loss_bottom": 1000.0 * torch.mean(field_fn(points_on_bottom) ** 2),
             "loss_top": 1000.0 * torch.mean((field_fn(points_on_top) - target) ** 2)},
            {"loss_domain": torch.mean(loss_domain_fn(field_fn, points_in_domain, params))},
        )

    def _ligament_floor(params, res, cap=192):
        if max_holes <= 0:
            return res
        return ligament_resolution_floor(params[2], L0, dom.xmax - dom.xmin, res, cap=cap)

    box = dict(xmin=dom.xmin, xmax=dom.xmax, ymin=dom.ymin, ymax=dom.ymax,
               top_displacement=TOP_DISPLACEMENT)

    def solve(params, resolution=None, boundary_cap=None):
        """The ground truth at `resolution` (32), raised by the ligament
        floor; boundary_cap caps the floor (192)."""
        res = _ligament_floor(params, resolution or 32, boundary_cap or 192)
        return fem_elasticity.solve_direct(params, resolution=res, **box)

    def solve_ref(params, resolution=None, boundary_cap=None):
        res = _ligament_floor(params, resolution or 48, boundary_cap or 192)
        return fem_elasticity.solve_direct(params, resolution=res, out_dtype=torch.float64,
                                           **box)

    def solve_warm(params, resolution, warm_start, ref=False):
        """A branch-tracking re-solve from another resolution's solution of
        the same task, with 120 Newton steps (a short budget can make the
        warm attempt fall back to a different post-buckling branch)."""
        res = _ligament_floor(params, resolution or 32)
        return fem_elasticity.solve_direct(
            params, resolution=res, out_dtype=torch.float64 if ref else torch.float32,
            warm_start=warm_start, newton_steps=120, **box)

    def sample_validation_points(gen, n, params, gt=None):
        return sample_points_in_domain(gen, n, params)

    return PdeDef(
        name="hyper_elasticity",
        in_dim=2,
        out_dim=2,
        scalar=False,
        sample_params=sample_params,
        sample_points=sample_points,
        sample_points_in_domain=sample_points_in_domain,
        loss_fn=loss_fn,
        solve=solve,
        evaluate_gt=fem_elasticity.evaluate,
        sample_validation_points=sample_validation_points,
        sample_points_batched=sample_points_batched,
        # v3: the sparse-direct Newton oracle with the ligament floor
        gt_version=3,
        solve_ref=solve_ref,
        effective_resolution=_ligament_floor,
        solve_warm=solve_warm,
    )
