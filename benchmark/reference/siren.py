"""The plain SIREN of the benchmark's reference, over a leading task axis.

A field of `layers` hidden layers of `width` maps x [T, N, d] to u [T, N]:
h = x * exp(log_in_scale); h <- sin(omega (h W_l + b_l)) for each hidden
layer; u = (h W_out + b_out) * exp(log_out_scale), summed over its one
output. Params are a flat dict of named leaves, each with the task axis
first: "layers.<i>.w" [T, fan_in, fan_out], "layers.<i>.b" [T, fan_out],
"log_in_scale" [T, d], "log_out_scale" [T, 1].

`vhd` propagates (h, dh/dx_i, d2h/dx_i^2) through the layers in one pass
(forward-mode Taylor arithmetic); `vhd_autograd` computes the same three
by autograd and is what the tests hold `vhd` to. Neither imports anything
of the program under test.
"""

import math

import torch


def init(gen: torch.Generator, in_dim: int, width: int, layers: int, omega: float,
         omega0: float, io_scale_lr_factor: float, device) -> dict:
    """SIREN's published init, drawn in one call on `gen`'s device: the
    first kernel U(-1/fan_in, 1/fan_in) * omega0 / omega, every later one
    U(-sqrt(6/fan_in)/omega, +), biases 0, both log scales
    log(1/io_scale_lr_factor). Leaves without a task axis."""
    shapes = [(in_dim, width)] + [(width, width)] * (layers - 1) + [(width, 1)]
    bounds = [omega0 / omega / in_dim] + [math.sqrt(6.0 / width) / omega] * layers
    sizes = [a * b for a, b in shapes]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    params, start = {}, 0
    for i, ((a, b), size, bound) in enumerate(zip(shapes, sizes, bounds)):
        params[f"layers.{i}.w"] = ((2.0 * u[start:start + size] - 1.0) * bound).reshape(a, b)
        params[f"layers.{i}.b"] = torch.zeros(b, device=device)
        start += size
    log_scale = math.log(1.0 / io_scale_lr_factor)
    params["log_in_scale"] = torch.full((in_dim,), log_scale, device=device)
    params["log_out_scale"] = torch.full((1,), log_scale, device=device)
    return params


def _layers(p):
    n = sum(1 for k in p if k.endswith(".w"))
    return [(p[f"layers.{i}.w"], p[f"layers.{i}.b"]) for i in range(n)]


def forward(p: dict, x: torch.Tensor, omega: float) -> torch.Tensor:
    """u [T, N] at x [T, N, d]."""
    layers = _layers(p)
    h = x * torch.exp(p["log_in_scale"])[:, None, :]
    for w, b in layers[:-1]:
        h = torch.sin(omega * (torch.bmm(h, w) + b[:, None, :]))
    w, b = layers[-1]
    out = (torch.bmm(h, w) + b[:, None, :]) * torch.exp(p["log_out_scale"])[:, None, :]
    return out.sum(-1)


def vhd(p: dict, x: torch.Tensor, omega: float):
    """(u [T, N], du/dx [T, N, d], d2u/dx_i^2 [T, N, d]) at x [T, N, d].

    The tangents ride beside h with the coordinate axis before the feature
    axis, J and D of shape [T, N, d, F]. Through h' = h W + b they become
    J W and D W; through h = sin(omega a), J <- omega cos(omega a) J' and
    D <- omega cos(omega a) D' - omega^2 sin(omega a) J'^2."""
    t, n, d = x.shape
    layers = _layers(p)

    def lin(v, w):  # [T, N, d, F] @ [T, F, G]
        return torch.bmm(v.reshape(t, n * d, -1), w).reshape(t, n, d, -1)

    s = torch.exp(p["log_in_scale"])                       # [T, d]
    h = x * s[:, None, :]
    jac = torch.diag_embed(s)[:, None].expand(t, n, d, d)  # d h_f / d x_i = s_i [i = f]
    dd = None                                              # the first layer is linear in x
    for w, b in layers[:-1]:
        a = omega * (torch.bmm(h, w) + b[:, None, :])
        ja = lin(jac, w)
        sa, ca = torch.sin(a)[:, :, None, :], torch.cos(a)[:, :, None, :]
        curv = -(omega ** 2) * sa * ja ** 2
        dd = curv if dd is None else curv + omega * ca * lin(dd, w)
        h, jac = sa[:, :, 0, :], omega * ca * ja
    w, b = layers[-1]
    so = torch.exp(p["log_out_scale"])                     # [T, 1]
    u = ((torch.bmm(h, w) + b[:, None, :]) * so[:, None, :]).sum(-1)
    g = (lin(jac, w) * so[:, None, None, :]).sum(-1)
    hd = (lin(dd, w) * so[:, None, None, :]).sum(-1)
    return u, g, hd


def vhd_autograd(p: dict, x: torch.Tensor, omega: float):
    """vhd's three outputs by autograd through `forward`: the gradient by
    one backward pass, each Hessian diagonal entry by one more."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        u = forward(p, x, omega)
        g = torch.autograd.grad(u.sum(), x, create_graph=True)[0]
        hd = torch.stack([torch.autograd.grad(g[..., i].sum(), x, create_graph=True)[0][..., i]
                          for i in range(x.shape[-1])], dim=-1)
    return u, g, hd
