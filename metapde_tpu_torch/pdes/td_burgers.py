"""Time-dependent 1-D viscous Burgers on (x, t) in [0, 1] x [0, tmax]
(counterpart of metapde_tpu/pdes/td_burgers.py).

    u_t = (1/Re) u_xx - u u_x        (x, t) in (0, 1) x (0, tmax]
    u(x, 0) = IC(x; a, b)            formulation plugin
    u(0, t), u(1, t) = IC(0), IC(1)  Dirichlet walls

The field takes (x, t) as a 2-vector. Task distribution: Re = max_reynolds
* U(0.8, 1) (vary_source), ic_params ~ U(-2, 2)^2 (vary_ic). A factor
switched off by its flag is frozen at the JAX package's draw from the
all-zero PRNG key (pdes/frozen.py), bit for bit; ``fixed_num_pdes`` draws
every task from one generator seeded ``task.seed``.

Sampling semantics kept from the JAX package:
- wall points: one x per time slice, (sample_tsteps - 1) slices; the left
  and right walls share their time draws (JAX passes one key to both);
- domain points: n rounded down to a multiple of (sample_tsteps - 1);
- initial points: the domain's xs and both walls, at t = 0;
- time: uniform in (tmin, tmax) (sample_time_random) or the stratified grid
  linspace(tmin, tmax, slices, endpoint=False)[1:], each value repeated.
  The stratified grid has one value fewer than the domain's xs, so the JAX
  package's domain sampler cannot concatenate them and raises; the port
  raises too.

Training draws one outer step's point sets for every task at once
(sample_points_batched), with the same distribution per set.

Ground truth comes from the FV solver (solvers/fv_burgers.py) or, with
``burgers_gt_solver=fem``, the implicit-Euler FEM (solvers/fem_td_burgers.py);
the FV solve takes every eval task in one time loop (solve_batched).
Validation coords cycle through the solver's output time grid.
"""

import torch
from torch.func import grad, jvp, vmap

from ..config import TaskConfig
from ..solvers import fem_td_burgers, fv_burgers
from . import frozen
from .burgers_formulations import get_formulation
from .registry import PdeDef


def _uniform(gen, shape, lo, hi):
    return torch.empty(shape, device=gen.device).uniform_(lo, hi, generator=gen)


def stratified_times(dom, n_slices, n, device="cpu"):
    """The stratified time samples: linspace(tmin, tmax, n_slices,
    endpoint=False)[1:], each repeated n times, as a column."""
    t = fv_burgers.linspace(dom.tmin, dom.tmax, n_slices, endpoint=False, device=device)
    return torch.repeat_interleave(t[1:], n).reshape(-1, 1)


def make_pde(cfg: TaskConfig) -> PdeDef:
    dom = cfg.domain
    form = get_formulation(cfg.burgers_formulation)
    n_slices = cfg.sample_tsteps - 1

    def sample_params(gen):
        dev = gen.device
        if cfg.fixed_num_pdes is not None:
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        unit = (_uniform(gen, (1,), 0.8, 1.0) if cfg.vary_source
                else frozen.uniform((1,), 0.8, 1.0, dev))
        source_params = cfg.max_reynolds * unit
        ic_params = (_uniform(gen, (2,), -2.0, 2.0) if cfg.vary_ic
                     else frozen.uniform((2,), -2.0, 2.0, dev))
        return source_params, ic_params

    def sample_time(gen, rows, n):
        """[rows, slices * n] times (random) or [rows, (slices - 1) * n]
        (stratified), on the generator's device."""
        if cfg.sample_time_random:
            return _uniform(gen, (rows, n_slices * n), dom.tmin, dom.tmax)
        return stratified_times(dom, n_slices, n, gen.device).reshape(1, -1).expand(rows, -1)

    def domain_xs(gen, rows, n):
        return _uniform(gen, (rows, n // n_slices * n_slices), dom.xmin, dom.xmax)

    def walls(t):
        """The left and right wall points at the times t [rows, m]."""
        return tuple(torch.stack([torch.full_like(t, x), t], dim=-1)
                     for x in (dom.xmin, dom.xmax))

    def domain(xs, t):
        if xs.shape[-1] != t.shape[-1]:
            raise ValueError(
                f"{xs.shape[-1]} domain xs against {t.shape[-1]} stratified times: the JAX "
                "package's domain sampler cannot concatenate them either "
                "(sample_time_random=False)")
        return torch.stack([xs, t], dim=-1)

    def initial(xs):
        rows = xs.shape[0]
        wall_x = torch.tensor([dom.xmin, dom.xmax], device=xs.device).expand(rows, 2)
        x = torch.cat([xs, wall_x], dim=1)
        return torch.stack([x, torch.zeros_like(x)], dim=-1)

    def _draw(gen, n, rows):
        """The four kinds (left, right, initial, domain) for `rows` point
        sets, each [rows, n_kind, 2], on the generator's device."""
        left, right = walls(sample_time(gen, rows, 1))
        init = initial(domain_xs(gen, rows, n))
        dom_pts = domain(domain_xs(gen, rows, n), sample_time(gen, rows, n // n_slices))
        return left, right, init, dom_pts

    def sample_points(gen, n, params):
        out_dev = params[0].device
        return tuple(p[0].to(out_dev) for p in _draw(gen, n, 1))

    def sample_points_in_domain(gen, n, params):
        xs = domain_xs(gen, 1, n)
        return domain(xs, sample_time(gen, 1, n // n_slices))[0].to(params[0].device)

    def sample_points_batched(gen, n, params_stacked, sets):
        """`sets` independent point sets for each of T tasks: params_stacked
        holds each task param with a leading axis T. Returns the four kinds
        (left, right, initial, domain), each [T, sets, n_kind, 2], each set
        drawn as sample_points draws one."""
        t = params_stacked[0].shape[0]
        out_dev = params_stacked[0].device
        return tuple(p.reshape((t, sets) + tuple(p.shape[1:])).to(out_dev)
                     for p in _draw(gen, n, t * sets))

    def loss_domain_fn(field_fn, points_in_domain, params):
        """Squared residual u_t - ((1/Re) u_xx - u u_x)."""
        source_params, _ = params
        inv_re = 1.0 / source_params[0]

        if hasattr(field_fn, "vhd"):
            # one pass: g = (u_x, u_t), hd = (u_xx, u_tt)
            u, g, hd = field_fn.vhd(points_in_domain)
            res = g[:, 1] - (inv_re * hd[:, 0] - g[:, 0] * u)
            return res ** 2

        grad_fn = grad(lambda y: torch.sum(field_fn(y)))

        def residual(x):
            u = field_fn(x)
            grad_u = grad_fn(x)
            e_x = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)[0]
            _, hcol = jvp(grad_fn, (x,), (e_x,))
            return grad_u[1] - (inv_re * hcol[0] - grad_u[0] * u)

        return vmap(residual)(points_in_domain) ** 2

    def loss_fn(field_fn, points, params):
        """(initial and wall losses, domain losses) dicts."""
        points_on_left, points_on_right, points_initial, points_in_domain = points
        return (
            {
                "loss_initial": torch.mean(
                    form.loss_initial_fn(field_fn, points_initial, params)),
                "loss_left": torch.mean(form.loss_left_fn(field_fn, points_on_left, params)),
                "loss_right": torch.mean(
                    form.loss_right_fn(field_fn, points_on_right, params)),
            },
            {"loss_domain": torch.mean(loss_domain_fn(field_fn, points_in_domain, params))},
        )

    use_fem_gt = cfg.burgers_gt_solver == "fem"
    domain_kw = dict(ic_fn=form.ic_fn, xmin=dom.xmin, xmax=dom.xmax, tmax=dom.tmax)
    fv_kw = dict(max_reynolds=cfg.max_reynolds, **domain_kw)

    def solve_batched(params_list, resolution=None, num_tsteps=None):
        """The ground truths of several tasks: one FV time loop for all of
        them, or one FEM solve each."""
        nt = num_tsteps if num_tsteps is not None else cfg.num_tsteps
        if use_fem_gt:
            return [fem_td_burgers.solve(p, resolution=resolution or 256, num_tsteps=nt,
                                         **domain_kw) for p in params_list]
        return fv_burgers.solve_batched(params_list, resolution=resolution or 512,
                                        num_tsteps=nt, **fv_kw)

    def solve(params, resolution=None, num_tsteps=None):
        return solve_batched([params], resolution, num_tsteps)[0]

    def solve_ref_batched(params_list, resolution=None, num_tsteps=None):
        """The float64 FV solves of several tasks in one time loop (each
        task's rows as its own solve's)."""
        return fv_burgers.solve_batched(
            params_list, dtype=torch.float64, resolution=resolution or 1024,
            num_tsteps=num_tsteps if num_tsteps is not None else cfg.num_tsteps, **fv_kw)

    def solve_ref(params, resolution=None, num_tsteps=None):
        return solve_ref_batched([params], resolution, num_tsteps)[0]

    def sample_validation_points(gen, n, params, gt=None):
        """Space random, time cycling through the solver's output grid."""
        xs = domain_xs(gen, 1, n)[0].to(params[0].device)
        n_actual = xs.shape[0]
        t_grid = (gt.t_grid if gt is not None
                  else fv_burgers.linspace(dom.tmin, dom.tmax, cfg.num_tsteps,
                                           device=xs.device))
        tile_idx = n_actual // cfg.num_tsteps + 1
        time_axis = t_grid.repeat(tile_idx)[:n_actual]
        return torch.stack([xs, time_axis], dim=1)

    return PdeDef(
        name="td_burgers",
        in_dim=2,
        out_dim=1,
        scalar=True,
        sample_params=sample_params,
        sample_points=sample_points,
        sample_points_in_domain=sample_points_in_domain,
        loss_fn=loss_fn,
        solve=solve,
        evaluate_gt=fem_td_burgers.evaluate if use_fem_gt else fv_burgers.evaluate,
        sample_validation_points=sample_validation_points,
        sample_points_batched=sample_points_batched,
        solve_batched=solve_batched,
        # the fem ground truth has no float64 path
        solve_ref=None if use_fem_gt else solve_ref,
        solve_ref_batched=None if use_fem_gt else solve_ref_batched,
    )
