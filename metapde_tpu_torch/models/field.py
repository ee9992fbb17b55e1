"""Derived fields on the SIREN base field (counterpart of
metapde_tpu/models/field.py): a 2-D divergence-free velocity field from a
scalar stream function, v = (d phi / dy, -d phi / dx), divergence-free by
construction. No driver uses it.
"""

import dataclasses

import torch

from ..config import FieldConfig
from .siren import FieldDef, field_apply, init_field_params


def make_div_free_field(cfg: FieldConfig) -> FieldDef:
    """The stream-function field of `cfg` (in_dim 2, one scalar output)
    and its perpendicular gradient. apply(params, x [..., 2]) -> [..., 2];
    the gradient is taken by torch.autograd.grad with create_graph=True,
    so the velocity trains: its loss backpropagates into the params (and
    into x, where x requires grad)."""
    base_cfg = dataclasses.replace(cfg, out_dim=1, squeeze_scalar=True, in_dim=2)

    def init(gen, device="cpu"):
        return init_field_params(gen, base_cfg, device)

    def apply(params, x):
        pts = x.reshape(-1, 2)
        if not pts.requires_grad:
            pts = pts.detach().requires_grad_(True)
        with torch.enable_grad():
            phi = field_apply(params, pts, base_cfg).sum()
            gradphi = torch.autograd.grad(phi, pts, create_graph=True)[0]
        vel = torch.stack([gradphi[:, 1], -gradphi[:, 0]], dim=1)
        return vel.reshape(*x.shape[:-1], 2)

    return FieldDef(init=init, apply=apply, cfg=base_cfg)
