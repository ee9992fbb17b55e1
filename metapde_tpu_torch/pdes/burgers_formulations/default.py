"""Default Burgers formulation (counterpart of
metapde_tpu/pdes/burgers_formulations/default.py).

IC: u(x, 0) = sin(pi x) + a sin(2 pi x) + b sin(4 pi x), with (a, b) the
task's ic_params. The left and right wall losses reuse the IC expression at
the wall coordinate; for this sine basis the walls x in {0, 1} give u = 0.
"""

import math

import torch


def ic_fn(x, params, sin=torch.sin):
    """Initial condition u(x, t=0) at spatial coords x.

    ic_params is [2] for one task, or [..., 2] to broadcast against x (the
    solvers pass [T, 1, 2] with x [nx] for T tasks at once): the sines of x
    are then taken once, whatever the number of tasks. `sin` lets a solver
    take the sines more exactly than its dtype's sin (fv_burgers.py)."""
    _, ic_params = params
    return (sin(math.pi * x)
            + ic_params[..., 0] * sin(2.0 * math.pi * x)
            + ic_params[..., 1] * sin(4.0 * math.pi * x))


def loss_initial_fn(field_fn, points_initial, params):
    """(u_theta - IC)^2 at the t = 0 points."""
    target = ic_fn(points_initial[:, 0], params)
    return (field_fn(points_initial) - target) ** 2


def loss_left_fn(field_fn, points_on_left, params):
    return loss_initial_fn(field_fn, points_on_left, params)


def loss_right_fn(field_fn, points_on_right, params):
    return loss_initial_fn(field_fn, points_on_right, params)
