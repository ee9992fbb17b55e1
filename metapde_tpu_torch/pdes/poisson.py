"""Nonlinear Poisson on random star-shaped domains
(counterpart of metapde_tpu/pdes/poisson.py).

    div((1 + 0.1 u^2) grad u) = f       in Omega
    u = g                               on dOmega

with Omega the star domain r(theta) = 1 + c1 cos(4 theta) + c2 cos(8 theta),
f a sum of two Gaussian bumps, and g a low-order Fourier series in theta.

Task distribution semantics kept from the JAX package:
- a factor switched off by ``vary_*`` is frozen at the JAX package's draw
  from the all-zero PRNG key (pdes/frozen.py, bit for bit), so every task
  shares it, as in the JAX package; ``fixed_num_pdes`` draws every task from
  one generator seeded ``task.seed``.
- domain points: 3n uniform box candidates, then n draws among those inside
  the star. As in the JAX package (``replace=not sample_with_replacement``),
  the default ``sample_with_replacement=False`` draws WITH replacement and
  ``True`` draws without.
- boundary points by the theta parametrisation with uniform jitter.
- ``is_in_hole`` calls atan2(x, y), a quirk kept from the reference; every
  other angle is atan2(y, x).

Training draws one outer step's point sets for every task at once
(sample_points_batched), with the same distribution per set.

torch's generators give other numbers than JAX's keys, so the samplers are
held to the JAX package by distribution, and the losses on shared points.
Draws happen on the generator's device, so a host generator gives the same
tasks and points to a CPU and a GPU run.
"""

import math

import torch

from ..config import TaskConfig
from ..ops.operators import vmap_weighted_laplacian
from ..solvers import fem_poisson
from . import frozen
from .registry import PdeDef, constant, multinomial


def radius(theta, c1, c2):
    return 1.0 + c1 * torch.cos(4.0 * theta) + c2 * torch.cos(8.0 * theta)


def boundary_conditions(bc_params, x):
    """Dirichlet value at boundary points x [N, 2]."""
    theta = torch.atan2(x[:, 1], x[:, 0])
    return (
        bc_params[0]
        + bc_params[1] / 4.0 * torch.cos(theta)
        + bc_params[2] / 4.0 * torch.sin(theta)
        + bc_params[3] / 4.0 * torch.cos(2.0 * theta)
        + bc_params[4] / 4.0 * torch.sin(2.0 * theta)
    )


def source(source_params, x):
    """Sum-of-Gaussian-bumps source term at points x [N, 2]."""
    d2 = ((x[:, None, 0] - source_params[None, :, 0]) ** 2
          + (x[:, None, 1] - source_params[None, :, 1]) ** 2)
    return torch.sum(source_params[None, :, 2] * torch.exp(-d2), dim=-1)


def is_in_hole(xy, geo_params, tol=1e-7):
    """True where xy [N, 2] lies OUTSIDE the star domain ('hole' is the
    reference's name for the complement of the star)."""
    theta = torch.atan2(xy[:, 0], xy[:, 1])  # reference quirk: atan2(x, y)
    length = torch.linalg.norm(xy, dim=-1)
    return radius(theta, geo_params[0], geo_params[1]) < length + tol


def _uniform(gen, n, lo, hi):
    return torch.empty(n, device=gen.device).uniform_(lo, hi, generator=gen)


def _fresh(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def make_pde(cfg: TaskConfig) -> PdeDef:
    dom = cfg.domain

    def sample_params(gen):
        dev = gen.device
        if cfg.fixed_num_pdes is not None:
            gen = _fresh(dev, cfg.seed)

        source_params = (torch.randn((2, 3), generator=gen, device=dev) if cfg.vary_source
                         else frozen.normal((2, 3), dev))
        bc_params = cfg.bc_scale * (_uniform(gen, 5, -1.0, 1.0) if cfg.vary_bc
                                    else frozen.uniform((5,), -1.0, 1.0, dev))
        geo_params = (_uniform(gen, 2, -0.2, 0.2) if cfg.vary_geometry
                      else frozen.uniform((2,), -0.2, 0.2, dev))
        return source_params, bc_params, geo_params

    # point samplers draw on the generator's device and return the points on
    # the task params' device
    def sample_points_on_boundary(gen, n, params):
        geo = params[2].to(gen.device)
        theta = torch.linspace(0.0, 2.0 * math.pi, n, device=gen.device)
        theta = theta + _uniform(gen, n, 0.0, 2.0 * math.pi / n)
        r0 = radius(theta, geo[0], geo[1])
        pts = torch.stack([r0 * torch.cos(theta), r0 * torch.sin(theta)], dim=1)
        return pts.to(params[2].device)

    def sample_points_in_domain(gen, n, params):
        n_cand = 3 * n
        xs = _uniform(gen, n_cand, dom.xmin, dom.xmax)
        ys = _uniform(gen, n_cand, dom.ymin, dom.ymax)
        xy = torch.stack([xs, ys], dim=1)
        inside = (~is_in_hole(xy, params[2].to(gen.device))).to(xy.dtype)
        idxs = multinomial(inside, n, not cfg.sample_with_replacement, gen)
        return xy[idxs].to(params[2].device)

    def sample_points(gen, n, params):
        return (sample_points_on_boundary(gen, n, params),
                sample_points_in_domain(gen, n, params))

    def sample_points_batched(gen, n, params_stacked, sets):
        """`sets` independent point sets for each of T tasks in a few ops:
        params_stacked holds each task param with a leading axis T. Returns
        (boundary [T, sets, n, 2], domain [T, sets, n, 2]), each set drawn as
        sample_points draws one (the same candidate count and the same
        inverted replacement flag)."""
        geo = params_stacked[2].to(gen.device)
        t, rows = geo.shape[0], geo.shape[0] * sets
        c1 = geo[:, 0].repeat_interleave(sets)[:, None]
        c2 = geo[:, 1].repeat_interleave(sets)[:, None]
        theta = torch.linspace(0.0, 2.0 * math.pi, n, device=gen.device)
        theta = theta + _uniform(gen, rows * n, 0.0, 2.0 * math.pi / n).reshape(rows, n)
        r0 = radius(theta, c1, c2)
        bnd = torch.stack([r0 * torch.cos(theta), r0 * torch.sin(theta)], dim=-1)
        u = _uniform(gen, rows * 3 * n * 2, 0.0, 1.0).reshape(rows, 3 * n, 2)
        lo = constant([dom.xmin, dom.ymin], gen.device)
        hi = constant([dom.xmax, dom.ymax], gen.device)
        xy = lo + (hi - lo) * u
        # is_in_hole per row, with the reference's atan2(x, y)
        length = torch.linalg.norm(xy, dim=-1)
        inside = ~(radius(torch.atan2(xy[..., 0], xy[..., 1]), c1, c2) < length + 1e-7)
        idxs = multinomial(inside.to(xy.dtype), n, not cfg.sample_with_replacement, gen)
        dmn = torch.gather(xy, 1, idxs[..., None].expand(rows, n, 2))
        out_dev = params_stacked[2].device
        return (bnd.reshape(t, sets, n, 2).to(out_dev),
                dmn.reshape(t, sets, n, 2).to(out_dev))

    def loss_fn(field_fn, points, params):
        """(boundary_losses, domain_losses) dicts."""
        points_on_boundary, points_in_domain = points
        source_params, bc_params, _ = params

        bc_vals = boundary_conditions(bc_params, points_on_boundary)
        err_on_boundary = bc_vals - field_fn(points_on_boundary)
        loss_on_boundary = torch.mean(err_on_boundary ** 2)

        if hasattr(field_fn, "vhd"):
            # one Taylor-mode pass (models/siren.py field_apply_vhd):
            # div((1+0.1u^2) grad u) = (1+0.1u^2) lap(u) + 0.2 u |grad u|^2
            u, g, hd = field_fn.vhd(points_in_domain)
            lap = (1.0 + 0.1 * u ** 2) * hd.sum(-1) + 0.2 * u * (g ** 2).sum(-1)
        else:
            lap = vmap_weighted_laplacian(
                points_in_domain, field_fn, lambda x: 1.0 + 0.1 * field_fn(x) ** 2)
        src = source(source_params, points_in_domain)
        loss_in_domain = torch.mean((lap - src) ** 2)
        return {"boundary_loss": loss_on_boundary}, {"domain_loss": loss_in_domain}

    def solve(params, resolution=None):
        # precond "auto": multigrid from resolution 32 up, Jacobi below
        return fem_poisson.solve(params, resolution=resolution or 16)

    def solve_ref(params, resolution=None):
        return fem_poisson.solve_x64(params, resolution=resolution or 64)

    def solve_hi(params, resolution=None):
        return fem_poisson.solve_richardson(params, resolution=resolution or 16)

    def sample_validation_points(gen, n, params, gt=None):
        return sample_points_in_domain(gen, n, params)

    return PdeDef(
        name="poisson",
        in_dim=2,
        out_dim=1,
        scalar=True,
        sample_params=sample_params,
        sample_points=sample_points,
        sample_points_in_domain=sample_points_in_domain,
        loss_fn=loss_fn,
        solve=solve,
        evaluate_gt=fem_poisson.evaluate,
        sample_validation_points=sample_validation_points,
        sample_points_batched=sample_points_batched,
        solve_ref=solve_ref,
        solve_hi=solve_hi,
        evaluate_gt_hi=fem_poisson.evaluate_cubic,
    )
