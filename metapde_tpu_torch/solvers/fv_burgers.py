"""Finite-volume solver for 1-D viscous Burgers, the TD-Burgers ground truth
(counterpart of metapde_tpu/solvers/fv_burgers.py).

- Godunov flux for the convex flux f(u) = u^2/2, written in its closed form
  max(f(max(ul, 0)), f(min(ur, 0))): it selects the same f(ul) or f(ur) (or
  0) as the JAX package's case split, so the values are equal bit for bit,
  in fewer ops.
- Central second-order diffusion (1/Re) u_xx.
- SSP-RK3 with a static step count chosen from worst-case stability over
  the whole task distribution (max_reynolds and the IC amplitude bound).
- Dirichlet walls through ghost cells pinned to the formulation's IC value
  at the wall coordinate.

``solve_stacked`` takes the task axis: task params stacked [T, ...] and u
[T, nx], one time loop for every task (the JAX package vmaps a jitted
scan). Every op is elementwise along x, and the IC's sines are taken on
the x grid alone, so a task's result does not depend on the batch it was
solved in. The loop has a static step count and no host read. On a CUDA
device one output segment (its RK steps, ~2,400 kernels at resolution 512)
is captured once as a CUDA graph and replayed for every segment: the same
kernels on the same buffers, so the same bits as the eager loop, with one
launch a segment instead of ~2,400 (the eager loop is host-bound, ~66
launches an RK step).

The card and the CPU give the same bits: the IC's sines are taken in
float64 and rounded to the solve's dtype (f32 sines differ by an ulp
between devices, and 22,200 RK stages amplify an ulp ~100x), a division
by a constant divides by a 0-d tensor on the solve's device (PyTorch's
CUDA division by a Python scalar multiplies by the reciprocal, where its
CPU division divides), and every other op is a single IEEE operation.
Against the JAX package the gap left is XLA's fused multiply-adds and its
f32 sine (tests/test_torch_fv_burgers.py measures it).
"""

import math
from typing import NamedTuple

import torch


class BurgersGroundTruth(NamedTuple):
    """u on a [num_tsteps, nx+2] grid.

    Layout (FV producer, `solve`): u_grid[:, 1:-1] are cell averages at the
    centers xmin + (j - 0.5) dx and u_grid[:, 0] / [:, -1] are GHOST values
    (2 bc - adjacent center), located at xmin - dx/2 and xmax + dx/2, not
    the wall values. x_grid stores [xmin, centers..., xmax] (the domain
    span), not the positions of columns 0 and -1. Only `evaluate` (half-cell
    index mapping: u(xmin) = (ghost + first center)/2 = bc) reads u_grid
    correctly: do not interpolate u_grid against x_grid. The FEM producer
    (fem_td_burgers.solve) fills the same container with node values at
    x_grid and pairs with its own evaluate."""

    u_grid: torch.Tensor   # [num_tsteps, nx+2]
    x_grid: torch.Tensor   # [nx+2] [xmin, centers, xmax] (FV) / nodes (FEM)
    t_grid: torch.Tensor   # [num_tsteps]


def linspace(start, stop, num, endpoint=True, device="cpu", dtype=torch.float32):
    """num points from start to stop, computed as XLA computes jnp.linspace
    (start (1 - s) + stop s, with s = i / div taken as i times the
    reciprocal of div), so the grids from 0 to 1 equal the JAX package's
    bit for bit; torch.linspace rounds other ulps."""
    div = num - 1 if endpoint else num
    step = torch.arange(div, device=device, dtype=dtype) * (1.0 / div)
    out = start * (1 - step) + stop * step
    if endpoint:
        out = torch.cat([out, torch.tensor([stop], device=device, dtype=dtype)])
    return out


def godunov_flux(ul, ur):
    """Godunov numerical flux for f(u) = u^2/2."""
    fl = torch.clamp(ul, min=0.0)
    fr = torch.clamp(ur, max=0.0)
    return torch.maximum(0.5 * fl * fl, 0.5 * fr * fr)


def _sin_f64(a):
    """sin taken in float64, rounded to a's dtype: the same bits on every
    device."""
    return torch.sin(a.to(torch.float64)).to(a.dtype)


def n_substeps(nx, length, tmax, max_reynolds, cfl, u_bound, num_tsteps):
    """Static worst-case stable step count (diffusion and advection limits):
    (total steps, steps per output segment)."""
    dx = length / nx
    nu_max = 1.0 / (0.8 * max_reynolds)
    dt_adv = cfl * dx / u_bound
    dt_diff = 0.45 * dx * dx / nu_max
    dt = min(dt_adv, dt_diff)
    steps = max(1, math.ceil(tmax / dt))
    seg = num_tsteps - 1
    per_seg = max(1, math.ceil(steps / seg))
    return per_seg * seg, per_seg


def _segment_runner(step, u0, per_seg, cuda_graph):
    """u -> u after per_seg steps; on a CUDA device with cuda_graph, one
    capture replayed on static buffers (the result is the static output:
    copy it before the next call)."""
    def segment(u):
        for _ in range(per_seg):
            u = step(u)
        return u

    if not (cuda_graph and u0.is_cuda):
        return segment
    static_in = u0.clone()
    side = torch.cuda.Stream(u0.device)
    side.wait_stream(torch.cuda.current_stream(u0.device))
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs ask
        segment(static_in)
    torch.cuda.current_stream(u0.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = segment(static_in)

    def replay(u):
        static_in.copy_(u)
        graph.replay()
        return static_out

    return replay


def solve_stacked(params, resolution: int = 512, num_tsteps: int = 101,
                  max_reynolds: float = 100.0, cfl: float = 0.4, ic_fn=None,
                  xmin: float = 0.0, xmax: float = 1.0, tmax: float = 1.0,
                  dtype=torch.float32, cuda_graph: bool = True):
    """Solve T tasks at once; params = (source_params [T, 1], ic_params
    [T, 2]) with source_params[:, 0] the Reynolds number. Returns
    (u_grid [T, num_tsteps, nx+2], x_grid [nx+2], t_grid [num_tsteps]).
    cuda_graph=False keeps the eager loop on a CUDA device."""
    source_params, ic_params = (p.to(dtype) for p in params)
    device = source_params.device
    nu = 1.0 / source_params[:, :1]                   # [T, 1]
    task_ic = (source_params[:, None], ic_params[:, None])  # broadcasts against [nx]

    nx = resolution
    length = xmax - xmin
    dx = length / nx
    centers = xmin + (torch.arange(nx, device=device, dtype=dtype) + 0.5) * dx

    u0 = ic_fn(centers, task_ic, sin=_sin_f64)         # [T, nx]
    # maximum principle: |u| bounded by the IC/BC sup; |a|, |b| <= 2 -> 5
    u_bound = 5.0
    n_total, per_seg = n_substeps(nx, length, tmax, max_reynolds, cfl, u_bound, num_tsteps)
    dt = tmax / n_total
    # divisors as device tensors: a true division on the card too
    dx_t, dx2_t, three = (torch.tensor(c, device=device, dtype=dtype)
                          for c in (dx, dx * dx, 3.0))

    def wall(x):
        return 2.0 * ic_fn(torch.tensor(x, device=device, dtype=dtype), task_ic, sin=_sin_f64)

    two_bc_l, two_bc_r = wall(xmin), wall(xmax)        # [T, 1]

    def rhs(u):
        # ghost cells: linear extrapolation so that the face value at each
        # wall equals its Dirichlet value
        ue = torch.cat([two_bc_l - u[:, :1], u, two_bc_r - u[:, -1:]], dim=1)
        flux = godunov_flux(ue[:, :-1], ue[:, 1:])     # [T, nx+1] face fluxes
        adv = (flux[:, :-1] - flux[:, 1:]) / dx_t      # -(f[j+1] - f[j]) / dx
        diff = nu * (ue[:, 2:] - 2.0 * ue[:, 1:-1] + ue[:, :-2]) / dx2_t
        return adv + diff

    def ssp_rk3(u):
        u1 = u + dt * rhs(u)
        u2 = 0.75 * u + 0.25 * (u1 + dt * rhs(u1))
        return u / three + (2.0 / 3.0) * (u2 + dt * rhs(u2))

    frames = torch.empty((u0.shape[0], num_tsteps, nx), device=device, dtype=dtype)
    frames[:, 0] = u0
    segment = _segment_runner(ssp_rk3, u0, per_seg, cuda_graph)
    u = u0
    for seg in range(1, num_tsteps):
        u = segment(u)
        frames[:, seg] = u

    # ghost values at both ends: with nodes at (j - 0.5) dx the linear
    # interpolant ghost <-> first center passes through the wall BC
    u_grid = torch.cat([two_bc_l[:, :, None] - frames[:, :, :1], frames,
                        two_bc_r[:, :, None] - frames[:, :, -1:]], dim=2)
    x_grid = torch.cat([torch.tensor([xmin], device=device, dtype=dtype), centers,
                        torch.tensor([xmax], device=device, dtype=dtype)])
    t_grid = linspace(0.0, tmax, num_tsteps, device=device, dtype=dtype)
    return u_grid, x_grid, t_grid


def solve_batched(params_list, dtype=torch.float32, **kw):
    """Solve a list of tasks (each (source_params [1], ic_params [2])) in one
    time loop; returns one BurgersGroundTruth per task."""
    stacked = tuple(torch.stack([p[i] for p in params_list]) for i in range(2))
    u_grid, x_grid, t_grid = solve_stacked(stacked, dtype=dtype, **kw)
    return [BurgersGroundTruth(u_grid=u, x_grid=x_grid, t_grid=t_grid) for u in u_grid]


def solve(params, **kw):
    """Solve one task; params = (source_params [1], ic_params [2]) with
    source_params[0] the Reynolds number."""
    return solve_batched([params], **kw)[0]


def solve_x64(params, **kw):
    """The float64 solve, for accuracy sweeps: over ~1e5 SSP-RK3 substeps
    the f32 path accumulates round-off."""
    return solve_batched([params], dtype=torch.float64, **kw)[0]


def evaluate(gt: BurgersGroundTruth, xt):
    """u at (x, t) = xt[..., 0], xt[..., 1] by bilinear interpolation; xt
    [N, 2], or [T, N, 2] with u_grid stacked [T, num_tsteps, nx+2]."""
    x, t = xt[..., 0], xt[..., 1]
    nxg = gt.x_grid.shape[0]
    nt = gt.t_grid.shape[0]

    # time index (uniform grid)
    tmax = gt.t_grid[-1]
    ft = torch.clamp(t / tmax, 0.0, 1.0) * (nt - 1)
    it = torch.clamp(torch.floor(ft).to(torch.int64), 0, nt - 2)
    wt = ft - it.to(ft.dtype)

    # space index: nodes at (j - 0.5) dx (j = 0 the ghost just outside the
    # left wall, j = nx + 1 the right ghost); fx in [0.5, nx + 0.5]
    xmin, xmax = gt.x_grid[0], gt.x_grid[-1]
    dx = (xmax - xmin) / (nxg - 2)
    fx = (torch.minimum(torch.maximum(x, xmin), xmax) - xmin) / dx + 0.5
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nxg - 2)
    wx = torch.clamp(fx - ix.to(fx.dtype), 0.0, 1.0)
    return _bilinear(gt.u_grid, it, ix, wt, wx)


def _bilinear(u_grid, it, ix, wt, wx):
    if u_grid.ndim == 3:  # [T, nt, nx] with indices [T, N]
        rows = torch.arange(u_grid.shape[0], device=u_grid.device)[:, None]
        u = lambda i, j: u_grid[rows, i, j]  # noqa: E731
    else:
        u = lambda i, j: u_grid[i, j]  # noqa: E731
    return (1 - wt) * ((1 - wx) * u(it, ix) + wx * u(it, ix + 1)) + wt * (
        (1 - wx) * u(it + 1, ix) + wx * u(it + 1, ix + 1))
