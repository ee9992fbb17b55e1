"""Steady 2-D viscous Burgers flow past random star-shaped pores
(counterpart of metapde_tpu/pdes/steady_burgers.py).

    (u . grad) u = (1/Re) lap u          in Omega \\ pores
    u = bc[0] * sin(pi (y-ymin)/(ymax-ymin))  on the inlet (x = xmin)
    u = bc[1] * sin(pi (y-ymin)/(ymax-ymin))  on the outlet (x = xmax)
    u = 0                                 on the walls and pore boundaries

The field is the velocity, two outputs. Task distribution kept from the JAX
package: Re = max(max_reynolds * U(0, 1), 1), inlet/outlet amplitudes
bc_scale * U(-1, 1)^(2x2), the hole count U{1..max_holes}, star-shape
coefficients U(-0.2, 0.2), sizes U(0.1, max_hole_size / n_holes) in
jax.random.uniform's arithmetic (max(lo, u (hi - lo) + lo): with hi below
0.1 every size is 0.1), centres uniform in the box inset by 1.5
max_hole_size, then the greedy overlap pass (``overlap_pass``): hole j is
valid iff it clears every earlier valid hole by max_hole_size; valid holes
are sorted first and n_holes is clamped to their count. A factor switched
off by ``vary_*`` is frozen at the JAX package's zero-key draw (frozen.py,
bit for bit); ``fixed_num_pdes`` draws one of that many tasks, each from
a generator seeded by task.seed and its index.

Samplers, each for `rows` point sets at once: stratified inlet, outlet and
wall points (a uniform jitter a set), pore-ring points with the hole drawn
by size^2 among the valid holes, and domain points by the reference's
choice(p=mask) over 3n box candidates with the JAX package's inverted
``replace=not sample_with_replacement``. The point budget: n/12 each to
inlet and outlet, n/6 to the walls, the rest of n/2 to the pores, n in the
domain. Training draws one outer step's sets for every task at once
(sample_points_batched).

The ground truth is fem_steady_burgers.solve at the requested resolution
(32 by default) with the solver's own constants (gt_version 2).
"""

import math

import torch
from torch.func import jacfwd, jvp, vmap

from ..config import TaskConfig
from ..solvers import fem_steady_burgers
from . import frozen
from .registry import PdeDef


def overlap_pass(pore_shapes, pore_sizes, pore_x0y0, n_holes, max_hole_size):
    """The greedy overlap-validity pass on one task's raw draws (shapes
    [H, 2], sizes [H, 1], centres [H, 2], the drawn hole count): hole 0 is
    valid, hole j iff its distance to every earlier valid hole is at least
    the two sizes plus max_hole_size. Returns (per-hole params [H, 5] with
    the valid holes first in their order, n_holes clamped to the valid
    count), as the JAX package's lax.scan and stable argsort."""
    h = pore_x0y0.shape[0]
    validity = torch.zeros(h, dtype=pore_x0y0.dtype, device=pore_x0y0.device)
    validity[0] = 1.0
    for j in range(1, h):
        d = pore_x0y0[j][None, :] - pore_x0y0
        dists = torch.sqrt(torch.sum(d * d, dim=1))
        space = (pore_sizes[j, 0] + pore_sizes[:, 0] + max_hole_size) * validity
        validity[j] = torch.all(dists - space >= 0.0).to(validity.dtype)
    order = torch.argsort(-validity, stable=True)
    php = torch.cat([pore_shapes, pore_x0y0, pore_sizes], dim=1)[order]
    return php, torch.minimum(n_holes, torch.sum(validity).to(torch.int32))


def _unit(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _scaled(u, lo, hi):
    """jax.random.uniform's scaling of unit draws u: max(lo, u (hi - lo) + lo)."""
    lo = torch.as_tensor(lo, dtype=u.dtype).to(u.device)
    hi = torch.as_tensor(hi, dtype=u.dtype).to(u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def in_any_hole(xy, php, n_holes, tol=1e-7):
    """xy [rows, C, 2] inside any valid pore of its row (php [rows, H, 5],
    n_holes [rows]): the JAX rule r0(theta) > |x - c| + tol with the
    reference's angle atan2(vx, vy)."""
    c1, c2, x0, y0, size = (php[:, None, :, i] for i in range(5))   # [rows, 1, H]
    vx = xy[..., 0:1] - x0
    vy = xy[..., 1:2] - y0
    theta = torch.atan2(vx, vy)
    length = torch.sqrt(vx ** 2 + vy ** 2)
    r0 = size * (1.0 + c1 * torch.cos(4 * theta) + c2 * torch.cos(8 * theta))
    mask = torch.arange(php.shape[1], device=xy.device)[None, None, :] < n_holes[:, None, None]
    return torch.any((r0 > length + tol) & mask, dim=-1)


def make_pde(cfg: TaskConfig) -> PdeDef:
    dom = cfg.domain
    max_holes = max(cfg.max_holes, 1)
    replace = not cfg.sample_with_replacement
    inset = 1.5 * cfg.max_hole_size
    centre_lo = [dom.xmin + inset, dom.ymin + inset]
    centre_hi = [dom.xmax - inset, dom.ymax - inset]

    def sample_params(gen):
        dev = gen.device
        if cfg.fixed_num_pdes is not None:
            idx = int(torch.randint(0, cfg.fixed_num_pdes, (), generator=gen, device=dev))
            gen = torch.Generator(device=dev).manual_seed(cfg.seed * 1_000_003 + idx)
        src_u = _unit(gen, (1,)) if cfg.vary_source else frozen.unit_uniform((1,), dev)
        source_params = torch.maximum(cfg.max_reynolds * src_u,
                                      torch.ones((), device=dev))
        bc_params = cfg.bc_scale * (_scaled(_unit(gen, (2, 2)), -1.0, 1.0) if cfg.vary_bc
                                    else frozen.uniform((2, 2), -1.0, 1.0, dev))
        geo = cfg.vary_geometry
        n_holes = (torch.randint(1, max_holes + 1, (), generator=gen, device=dev,
                                 dtype=torch.int32) if geo
                   else frozen.hole_count(max_holes, dev))
        size_hi = torch.tensor(cfg.max_hole_size, dtype=torch.float32, device=dev) / n_holes
        if geo:
            pore_shapes = _scaled(_unit(gen, (max_holes, 2)), -0.2, 0.2)
            pore_sizes = _scaled(_unit(gen, (max_holes, 1)), 0.1, size_hi)
            pore_x0y0 = _scaled(_unit(gen, (max_holes, 2)), centre_lo, centre_hi)
        else:
            # the JAX package zeroes k4, k5 and k6 alike: one zero-key draw
            pore_shapes = frozen.uniform((max_holes, 2), -0.2, 0.2, dev)
            pore_sizes = frozen.uniform((max_holes, 1), 0.1, size_hi, dev)
            pore_x0y0 = frozen.uniform((max_holes, 2), centre_lo, centre_hi, dev)
        php, n_holes = overlap_pass(pore_shapes, pore_sizes, pore_x0y0, n_holes,
                                    cfg.max_hole_size)
        return source_params, bc_params, php, n_holes

    # --- point samplers: every draw on the generator's device, for `rows`
    # point sets at once (per-row params php [rows, H, 5], n_holes [rows])

    def stratified(gen, rows, n, lo, hi):
        """linspace(lo, hi, n, endpoint=False) + one U(0, (hi - lo)/n) jitter a row."""
        base = lo + (hi - lo) / n * torch.arange(n, device=gen.device, dtype=torch.float32)
        return base[None, :] + _unit(gen, (rows, 1)) * ((hi - lo) / n)

    def inlet(gen, rows, n, x):
        ys = stratified(gen, rows, n, dom.ymin, dom.ymax)
        return torch.stack([torch.full_like(ys, x), ys], dim=-1)

    def walls(gen, rows, n):
        n_top = n // 2
        top = stratified(gen, rows, n_top, dom.xmin, dom.xmax)
        bot = stratified(gen, rows, n - n_top, dom.xmin, dom.xmax)
        return torch.cat([torch.stack([top, torch.full_like(top, dom.ymax)], dim=-1),
                          torch.stack([bot, torch.full_like(bot, dom.ymin)], dim=-1)], dim=1)

    def on_pores(gen, n, php, n_holes):
        """Ring points, each hole drawn by size^2 among the valid ones."""
        rows, h = php.shape[:2]
        valid = torch.arange(h, device=php.device)[None, :] < n_holes[:, None]
        w = php[..., 4] ** 2 * valid
        idx = torch.multinomial(w, n, replacement=True, generator=gen)          # [rows, n]
        hole = torch.gather(php, 1, idx[..., None].expand(-1, -1, 5))            # [rows, n, 5]
        thetas = _unit(gen, (rows, n)) * (2 * math.pi)
        r0 = hole[..., 4] * (1 + hole[..., 0] * torch.cos(4 * thetas)
                             + hole[..., 1] * torch.cos(8 * thetas))
        return torch.stack([hole[..., 2] + r0 * torch.cos(thetas),
                            hole[..., 3] + r0 * torch.sin(thetas)], dim=-1)

    def in_domain(gen, n, php, n_holes):
        rows = php.shape[0]
        xs = _scaled(_unit(gen, (rows, 3 * n)), dom.xmin, dom.xmax)
        ys = _scaled(_unit(gen, (rows, 3 * n)), dom.ymin, dom.ymax)
        xy = torch.stack([xs, ys], dim=-1)
        outside = (~in_any_hole(xy, php, n_holes)).to(xy.dtype)
        idx = torch.multinomial(outside, n, replacement=replace, generator=gen)
        return torch.gather(xy, 1, idx[..., None].expand(-1, -1, 2))

    def budget(n):
        n_inlet = max(n // 12, 1)
        n_walls = max(n // 6, 2)
        return n_inlet, n_walls, max(n // 2 - n_walls - 2 * n_inlet, 1)

    def _draw(gen, n, php, n_holes):
        """The five kinds (inlet, outlet, walls, pore rings, domain), each
        [rows, n_kind, 2]."""
        rows = php.shape[0]
        n_inlet, n_walls, n_pores = budget(n)
        return (inlet(gen, rows, n_inlet, dom.xmin), inlet(gen, rows, n_inlet, dom.xmax),
                walls(gen, rows, n_walls), on_pores(gen, n_pores, php, n_holes),
                in_domain(gen, n, php, n_holes))

    def _rows(params, gen, sets=1):
        php = params[2].to(gen.device)
        n_holes = params[3].to(gen.device)
        if php.ndim == 2:
            php, n_holes = php[None], n_holes.reshape(1)
        return php.repeat_interleave(sets, 0), n_holes.repeat_interleave(sets, 0)

    def sample_points(gen, n, params):
        return tuple(p[0].to(params[2].device) for p in _draw(gen, n, *_rows(params, gen)))

    def sample_points_in_domain(gen, n, params):
        return in_domain(gen, n, *_rows(params, gen))[0].to(params[2].device)

    def sample_points_batched(gen, n, params_stacked, sets):
        """`sets` independent point sets for each of T tasks (task params
        stacked [T, ...]): the five kinds, each [T, sets, n_kind, 2], each
        set drawn as sample_points draws one."""
        t = params_stacked[2].shape[0]
        return tuple(p.reshape((t, sets) + tuple(p.shape[1:])).to(params_stacked[2].device)
                     for p in _draw(gen, n, *_rows(params_stacked, gen, sets)))

    def loss_domain_fn(field_fn, points_in_domain, params):
        """((u . grad) u - (1/Re) lap u)^2 at each point, [N, 2]."""
        nu = 1.0 / params[0][0]
        if hasattr(field_fn, "vhd"):
            # one Taylor-mode pass: g [N, 2, 2] the Jacobian, hd [N, 2, 2]
            # the per-axis second derivatives
            u, g, hd = field_fn.vhd(points_in_domain)
            adv = torch.einsum("nij,nj->ni", g, u)
            return (adv - nu * hd.sum(-1)) ** 2

        def f(y):
            return field_fn(y).reshape(2)

        def residual(x):
            adv = jacfwd(f)(x) @ f(x)
            lap = 0.0
            for i in range(2):
                e = torch.eye(2, dtype=x.dtype, device=x.device)[i]
                lap = lap + jvp(lambda xi: jvp(f, (xi,), (e,))[1], (x,), (e,))[1]
            return adv - nu * lap

        return vmap(residual)(points_in_domain) ** 2

    def profile(points, amplitude):
        s = torch.sin(math.pi * (points[:, 1] - dom.ymin) / (dom.ymax - dom.ymin))
        return amplitude[None, :] * s[:, None]

    def loss_fn(field_fn, points, params):
        """(boundary losses, domain losses) dicts."""
        pts_inlet, pts_outlet, pts_walls, pts_holes, pts_domain = points
        bc_params = params[1]
        pts_noslip = torch.cat([pts_walls, pts_holes])
        return (
            {"loss_noslip": torch.mean(field_fn(pts_noslip) ** 2),
             "loss_inlet": torch.mean((field_fn(pts_inlet) - profile(pts_inlet, bc_params[0]))
                                      ** 2),
             "loss_outlet": torch.mean(
                 (field_fn(pts_outlet) - profile(pts_outlet, bc_params[1])) ** 2)},
            {"loss_domain": torch.mean(loss_domain_fn(field_fn, pts_domain, params))},
        )

    box = dict(xmin=dom.xmin, xmax=dom.xmax, ymin=dom.ymin, ymax=dom.ymax)

    def solve(params, resolution=None):
        return fem_steady_burgers.solve(params, resolution=resolution or 32, **box)

    def solve_ref(params, resolution=None):
        return fem_steady_burgers.solve_x64(params, resolution=resolution or 64, **box)

    def sample_validation_points(gen, n, params, gt=None):
        return sample_points_in_domain(gen, n, params)

    return PdeDef(
        name="steady_burgers",
        in_dim=2,
        out_dim=2,
        scalar=False,
        sample_params=sample_params,
        sample_points=sample_points,
        sample_points_in_domain=sample_points_in_domain,
        loss_fn=loss_fn,
        solve=solve,
        evaluate_gt=fem_steady_burgers.evaluate,
        sample_validation_points=sample_validation_points,
        sample_points_batched=sample_points_batched,
        gt_version=2,  # v2: the boundary-snapped conforming mesh (mesh2d)
        solve_ref=solve_ref,
        # loss_noslip: one mean over the walls and the pore rings
        pooled_kinds=((2, 3),),
    )
