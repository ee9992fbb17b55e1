"""Reference of the poisson3d task family: its loss and the check of its
draws.

    div((1 + 0.1 u^2) grad u) = f   in a star ball of R^3,   u = g on its surface,

with the manufactured solution u*(x) = b0 + 0.25 b . x + sum_i a_i
exp(-|x - mu_i|^2): f is div((1 + 0.1 u*^2) grad u*), here by autograd of
u*, and g is u*. The star ball's radius along a unit direction n is
1 + c1 Re[(n_x + i n_y)^4] + c2 cos(2 phi).

Task params, each with the task axis first: bumps [T, 2, 4] (centres,
amplitude), bc [T, 4] (b0, b), geo [T, 2] (c1, c2). Point kinds:
boundary and domain, each [T, n, 3].

The laws of the draws: bump centres N(0, 0.5^2) and amplitudes N(0, 1),
bc uniform on [-bc_scale, bc_scale], geo uniform on [-0.2, 0.2];
boundary points r(n) n with n uniform on the sphere, so each coordinate
of n is uniform on [-1, 1]; domain points uniform in the star ball, so
(|x| / r(x / |x|))^3 is uniform on [0, 1].
"""

import torch

from .. import laws as law
from .. import siren


def exact(tp, x):
    """u* [T, N] at x [T, N, 3]."""
    bumps, bc = tp[0], tp[1]
    r2 = ((x[:, :, None, :] - bumps[:, None, :, :3]) ** 2).sum(-1)       # [T, N, 2]
    gauss = (bumps[:, None, :, 3] * torch.exp(-r2)).sum(-1)
    return bc[:, None, 0] + 0.25 * (x * bc[:, None, 1:]).sum(-1) + gauss


def source(tp, x):
    """f [T, N] at x [T, N, 3], by autograd of u*."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        u = exact(tp, x)
        g = torch.autograd.grad(u.sum(), x, create_graph=True)[0]
        flux = (1.0 + 0.1 * u[..., None] ** 2) * g
        div = sum(torch.autograd.grad(flux[..., i].sum(), x, retain_graph=True)[0][..., i]
                  for i in range(3))
    return div.detach()


def radius(direction, geo):
    """The star radius [T, N] along unit directions [T, N, 3]."""
    nx, ny, nz = direction.unbind(-1)
    return (1.0 + geo[:, None, 0] * (nx ** 4 - 6.0 * nx ** 2 * ny ** 2 + ny ** 4)
            + geo[:, None, 1] * (2.0 * nz ** 2 - 1.0))


def task_loss(p: dict, pts, tp, hp: dict):
    """bc_weight * mean boundary misfit^2 + mean residual^2, per task [T]."""
    xb, xd = pts
    omega = hp["model.omega"]
    boundary = ((exact(tp, xb) - siren.forward(p, xb, omega)) ** 2).mean(1)
    u, g, hd = siren.vhd(p, xd, omega)
    lhs = (1.0 + 0.1 * u ** 2) * hd.sum(-1) + 0.2 * u * (g ** 2).sum(-1)
    domain = ((lhs - source(tp, xd)) ** 2).mean(1)
    return hp["task.bc_weight"] * boundary + domain


def check_draw(tp, points: dict, t: int, sets: dict, hp: dict) -> dict:
    """What in one outer step's draws breaks the family's definition:
    shapes (t tasks; for each point set, sets x n points), task
    params outside their support or repeated between tasks, boundary
    points off the surface and domain points outside the ball. Returns
    {violation: count}."""
    bumps, bc, geo = tp
    bad = {"task_shape": int(bumps.shape != (t, 2, 4) or bc.shape != (t, 4)
                             or geo.shape != (t, 2)),
           "task_support": int((bc.abs() > hp["task.bc_scale"]).sum()
                               + (geo.abs() > 0.2).sum()
                               + (~torch.isfinite(bumps)).sum()),
           "task_repeats": t - len({tuple(r) for r in bumps.reshape(t, -1).tolist()})}
    bad["point_shape"] = off_surface = outside = 0
    for name, (n, n_sets) in sets.items():
        xb, xd = points[name]
        for x in (xb, xd):
            bad["point_shape"] += int(x.shape != (t, n_sets, n, 3))
        for s in range(xb.shape[1]):
            lb = torch.linalg.vector_norm(xb[:, s], dim=-1)
            rb = radius(xb[:, s] / lb[..., None], geo)
            off_surface += int(((lb - rb).abs() > 1e-5 * rb).sum())
            ld = torch.linalg.vector_norm(xd[:, s], dim=-1)
            rd = radius(xd[:, s] / ld.clamp(min=1e-12)[..., None], geo)
            outside += int((ld > rd * (1 + 1e-6)).sum())
    bad["off_surface"], bad["outside"] = off_surface, outside
    return bad


def draw_laws(tp, points: dict, hp: dict) -> dict:
    """One outer step's draws as samples of the laws above:
    {name: (values, cdf)}."""
    bumps, bc, geo = (x.double() for x in tp)
    s = hp["task.bc_scale"]
    out = {"bump_centres": (bumps[..., :3], law.normal(0.5)),
           "bump_amplitudes": (bumps[..., 3], law.normal(1.0)),
           "bc": (bc, law.uniform(-s, s)), "geo": (geo, law.uniform(-0.2, 0.2))}
    for name, (xb, xd) in points.items():
        xb, xd = xb.double(), xd.double()
        n = xb / torch.linalg.vector_norm(xb, dim=-1, keepdim=True)
        for i, axis in enumerate("xyz"):
            out[f"{name}.boundary_n{axis}"] = (n[..., i], law.uniform(-1.0, 1.0))
        t = xd.shape[0]
        ld = torch.linalg.vector_norm(xd, dim=-1).reshape(t, -1)
        rd = radius((xd.reshape(t, -1, 3) / ld.clamp(min=1e-12)[..., None]), geo)
        out[f"{name}.domain_radius_cubed"] = ((ld / rd) ** 3, law.uniform(0.0, 1.0))
    return out
