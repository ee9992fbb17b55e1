"""Nonlinear Poisson in 3-D on random star-shaped balls
(counterpart of metapde_tpu/pdes/poisson3d.py).

    div((1 + 0.1 u^2) grad u) = f       in Omega (a star ball in R^3)
    u = g                               on dOmega

with the star ball r(dir) = 1 + c1 Re[(nx + i ny)^4] + c2 cos(2 phi).
Ground truth by the method of manufactured solutions: each task's exact
solution u*(x) = b0 + 0.25 b . x + sum_i a_i exp(-|x - mu_i|^2), with
f := div((1 + 0.1 u*^2) grad u*) and g := u* on the boundary. The oracle is
exact and needs no solve; validation evaluates u* at the validation points.
The JAX package derives f by autodiff of u*; the port writes the same
derivatives out, (1 + 0.1 u^2) lap u + 0.2 u |grad u|^2 with the Gaussians'
gradients and Laplacians in closed form, because the MAML inner step runs
under torch.utils.checkpoint (train.remat_inner_steps), where torch.func
transforms cannot run. tests/test_torch_poisson3d.py holds it against JAX's
autodiff source and the port's ops/operators.weighted_laplacian of u*.

Task distribution kept from the JAX package: two bumps, centres
0.5 N(0, 1)^3 and amplitudes N(0, 1) (vary_source), the affine background
bc_scale U(-1, 1)^4 (vary_bc), the shape (c1, c2) U(-0.2, 0.2)^2
(vary_geometry); a factor switched off is frozen at the JAX package's
zero-key draw (frozen.py), and ``fixed_num_pdes`` draws every task from one
generator seeded task.seed. Domain points: 24n candidates uniform in the
bounding ball of radius 1.45 (direction x 1.45 U^(1/3)), n draws among
those inside the star by choice(p=mask) with the JAX package's inverted
``replace=not sample_with_replacement`` (an outside candidate is drawn
only where the inside ones run out, as JAX's choice pads), then
the tail guard: a pick outside the star moves radially to half its
direction's star radius. Boundary points: normal directions scaled to the
star radius.
"""

from typing import NamedTuple

import torch

from ..config import TaskConfig
from ..ops.operators import vmap_weighted_laplacian
from ..utils import spans
from . import frozen
from .registry import PdeDef

# box bound for candidate sampling: r <= 1 + |c1| + |c2| <= 1.4
_BOX = 1.45


class Poisson3dGroundTruth(NamedTuple):
    """The manufactured solution's params: the ground truth itself."""

    source_params: torch.Tensor  # [2, 4] bump centres and amplitudes
    bc_params: torch.Tensor      # [4] affine background


def radius(direction, c1, c2):
    """The star-ball radius along unit directions [..., 3]."""
    nx, ny, nz = direction[..., 0], direction[..., 1], direction[..., 2]
    # cos(4 theta) sin^4 phi = Re[(nx + i ny)^4]
    cos4t_s4 = nx ** 4 - 6.0 * nx ** 2 * ny ** 2 + ny ** 4
    cos2phi = 2.0 * nz ** 2 - 1.0
    return 1.0 + c1 * cos4t_s4 + c2 * cos2phi


def exact_solution(sol_params, x):
    """The manufactured solution u*(x) at points x [..., 3] -> [...]."""
    source_params, bc_params = sol_params[0], sol_params[1]
    d2 = torch.sum((x[..., None, :] - source_params[:, :3]) ** 2, dim=-1)   # [..., 2]
    bumps = torch.sum(source_params[:, 3] * torch.exp(-d2), dim=-1)
    affine = bc_params[0] + 0.25 * torch.sum(bc_params[1:4] * x, dim=-1)
    return affine + bumps


def source(sol_params, x):
    """f := div((1 + 0.1 u*^2) grad u*) at points x [..., 3] -> [...]:
    (1 + 0.1 u^2) lap u + 0.2 u |grad u|^2, with grad and lap of each bump
    a exp(-r^2) written out (-2 a e (x - mu) and a e (4 r^2 - 6))."""
    source_params, bc_params = sol_params[0], sol_params[1]
    diff = x[..., None, :] - source_params[:, :3]                          # [..., 2, 3]
    r2 = torch.sum(diff ** 2, dim=-1)
    bump = source_params[:, 3] * torch.exp(-r2)                            # [..., 2]
    u = bc_params[0] + 0.25 * torch.sum(bc_params[1:4] * x, dim=-1) + torch.sum(bump, dim=-1)
    grad_u = 0.25 * bc_params[1:4] - 2.0 * torch.sum(bump[..., None] * diff, dim=-2)
    lap_u = torch.sum(bump * (4.0 * r2 - 6.0), dim=-1)
    return (1.0 + 0.1 * u ** 2) * lap_u + 0.2 * u * torch.sum(grad_u ** 2, dim=-1)


def is_outside(x, geo_params, tol=1e-7):
    """Points x [..., 3] outside the star ball (geo_params [..., 2]
    broadcasting against x's leading axes)."""
    length = torch.linalg.vector_norm(x, dim=-1)
    direction = x / torch.clamp(length, min=1e-12)[..., None]
    return radius(direction, geo_params[..., 0], geo_params[..., 1]) < length + tol


def make_pde(cfg: TaskConfig) -> PdeDef:
    replace = not cfg.sample_with_replacement

    def sample_params(gen):
        dev = gen.device
        if cfg.fixed_num_pdes is not None:
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        raw = (torch.randn((2, 4), generator=gen, device=dev) if cfg.vary_source
               else frozen.normal((2, 4), dev))
        source_params = raw * torch.tensor([0.5, 0.5, 0.5, 1.0], device=dev)
        bc = (torch.empty(4, device=dev).uniform_(-1.0, 1.0, generator=gen) if cfg.vary_bc
              else frozen.uniform((4,), -1.0, 1.0, dev))
        geo_params = (torch.empty(2, device=dev).uniform_(-0.2, 0.2, generator=gen)
                      if cfg.vary_geometry else frozen.uniform((2,), -0.2, 0.2, dev))
        return source_params, cfg.bc_scale * bc, geo_params

    # --- samplers: draws on the generator's device for `rows` point sets at
    # once (per-row shapes geo [rows, 2])

    def unit_dirs(gen, rows, n):
        d = torch.randn((rows, n, 3), generator=gen, device=gen.device)
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

    def on_boundary(gen, n, geo):
        dirs = unit_dirs(gen, geo.shape[0], n)
        return radius(dirs, geo[:, None, 0], geo[:, None, 1])[..., None] * dirs

    def in_domain(gen, n, geo):
        rows = geo.shape[0]
        n_cand = 24 * n
        with spans.span("draw.candidates"):
            dirs = unit_dirs(gen, rows, n_cand)
            rad = _BOX * torch.rand((rows, n_cand, 1), generator=gen,
                                    device=gen.device) ** (1.0 / 3.0)
            x = rad * dirs
            inside = (~is_outside(x, geo[:, None, :])).to(x.dtype)
        with spans.span("draw.choice"):
            # where the inside candidates run out (or, drawing with
            # replacement, a row has none) JAX's choice falls on
            # zero-probability ones; a weight of 1e-30 does that, and is
            # never drawn otherwise
            idx = torch.multinomial(inside + 1e-30, n, replacement=replace, generator=gen)
            pts = torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))
            # the tail guard: a pick outside moves to half its star radius
            length = torch.clamp(torch.linalg.vector_norm(pts, dim=-1, keepdim=True), min=1e-12)
            d = pts / length
            r_star = radius(d, geo[:, None, 0], geo[:, None, 1])[..., None]
            bad = is_outside(pts, geo[:, None, :])[..., None]
            return torch.where(bad, 0.5 * r_star * d, pts)

    def _geo(params, gen, sets=1):
        geo = params[2].to(gen.device)
        return (geo[None] if geo.ndim == 1 else geo).repeat_interleave(sets, 0)

    def sample_points(gen, n, params):
        geo = _geo(params, gen)
        return (on_boundary(gen, n, geo)[0].to(params[2].device),
                in_domain(gen, n, geo)[0].to(params[2].device))

    def sample_points_in_domain(gen, n, params):
        return in_domain(gen, n, _geo(params, gen))[0].to(params[2].device)

    def sample_points_batched(gen, n, params_stacked, sets):
        """`sets` independent point sets for each of T tasks (task params
        stacked [T, ...]): (boundary, domain), each [T, sets, n, 3]."""
        t = params_stacked[2].shape[0]
        geo = _geo(params_stacked, gen, sets)
        out_dev = params_stacked[2].device
        return (on_boundary(gen, n, geo).reshape(t, sets, n, 3).to(out_dev),
                in_domain(gen, n, geo).reshape(t, sets, n, 3).to(out_dev))

    def loss_fn(field_fn, points, params):
        """(boundary losses, domain losses) dicts."""
        points_on_boundary, points_in_domain = points
        sol_params = (params[0], params[1])
        err_on_boundary = exact_solution(sol_params, points_on_boundary) - field_fn(
            points_on_boundary)
        loss_on_boundary = torch.mean(err_on_boundary ** 2)
        if hasattr(field_fn, "vhd"):
            u, g, hd = field_fn.vhd(points_in_domain)
            lap = (1.0 + 0.1 * u ** 2) * hd.sum(-1) + 0.2 * u * (g ** 2).sum(-1)
        else:
            lap = vmap_weighted_laplacian(points_in_domain, field_fn,
                                          lambda x: 1.0 + 0.1 * field_fn(x) ** 2)
        src = source(sol_params, points_in_domain)
        loss_in_domain = torch.mean((lap - src) ** 2)
        return {"boundary_loss": loss_on_boundary}, {"domain_loss": loss_in_domain}

    def solve(params, resolution=None):
        """The manufactured solution is the ground truth; resolution-free."""
        return Poisson3dGroundTruth(source_params=params[0], bc_params=params[1])

    def evaluate_gt(gt, x):
        return exact_solution(gt, x)

    def sample_validation_points(gen, n, params, gt=None):
        return sample_points_in_domain(gen, n, params)

    return PdeDef(
        name="poisson3d",
        in_dim=3,
        out_dim=1,
        scalar=True,
        sample_params=sample_params,
        sample_points=sample_points,
        sample_points_in_domain=sample_points_in_domain,
        loss_fn=loss_fn,
        solve=solve,
        evaluate_gt=evaluate_gt,
        sample_validation_points=sample_validation_points,
        sample_points_batched=sample_points_batched,
        solve_ref=solve,
    )
