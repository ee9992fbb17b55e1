"""SIREN neural fields as plain functions on dicts of tensors
(counterpart of metapde_tpu/models/siren.py).

MAML adapts parameters functionally, so a field is not an nn.Module: params
are the JAX package's pytree with tensor leaves,
``{"layers": [{"w": [in, out], "b": [out]}, ...], "log_in_scale": [in],
"log_out_scale": [out]}``, and a layer computes ``x @ w + b``.

Semantics kept from the JAX package:
- SIREN init: hidden kernels ~ U(-sqrt(6/fan_in)/omega, +), first-layer
  kernel ~ (omega0/omega) * U(-1/fan_in, +1/fan_in).
- Every layer computes sin(omega * (x W + b)).
- Optional learnable log input/output scales, init log(1/io_scale_lr_factor).
- Scalar fields (out_dim=1, squeeze_scalar) sum the last axis, giving [N].
- Optional octave Fourier features before the first layer.

A set ``compute_dtype`` (the flagship's "bfloat16") is the JAX package's
``_mixed_dots`` chain: matmul operands rounded to bf16, products accumulated
and returned in f32, the h / J / D tensors carried between layers stored in
bf16, activation math and the Fourier block in f32. Forward-only inference
through the fused kernel stays f32 whatever ``compute_dtype`` is, as the
JAX package's Pallas kernel does.
"""

import contextlib
import math
from typing import Callable, NamedTuple

import torch

from ..config import FieldConfig
from ..device import full_f32_matmuls
from ..ops import siren_fused
from ..ops.fourier import fourier_feature_dim, fourier_features
from ..utils.trees import tree_map


class BoundField:
    """A field with params bound: a plain callable for the PdeDef loss
    contract, also exposing the one-pass (value, grad, Hessian-diag) path as
    `.vhd`; PDE losses check for the attribute and take that route."""

    __slots__ = ("params", "_apply", "vhd", "vjac")

    def __init__(self, field_def, params):
        self.params = params
        self._apply = field_def.apply
        if field_def.apply_vhd is not None:
            self.vhd = lambda x: field_def.apply_vhd(params, x)
        if field_def.apply_vjac is not None:
            self.vjac = lambda x: field_def.apply_vjac(params, x)

    def __call__(self, x):
        return self._apply(self.params, x)


class FieldDef(NamedTuple):
    """A neural-field family: init produces a params dict, apply evaluates it."""

    init: Callable  # (generator, device) -> params
    apply: Callable  # (params, x) -> field values
    cfg: FieldConfig
    apply_vhd: Callable = None  # (params, x[N,d]) -> (u, grad, hess_diag)
    apply_vjac: Callable = None  # (params, x[N,d]) -> (u, jacobian)
    apply_inference: Callable = None  # forward-only fused serving path
    # (params, x[T,N,d], shared) -> [T,N] / [T,N,o]: all tasks at once
    apply_inference_batched: Callable = None

    def bind(self, params) -> BoundField:
        return BoundField(self, params)


def mixed_precision_scope(cfg: FieldConfig):
    """Inside a mixed-precision chain, TF32 off: the products are f32 GEMMs
    of bf16-rounded operands, whose sums must stay f32 as the JAX package's
    preferred_element_type keeps them. The field's passes enter it; so do the
    callers that differentiate them (the meta-gradient, deployment's
    adaptation), so that the backward products keep f32 sums too. An f32
    field leaves the flags as the caller set them."""
    return full_f32_matmuls() if cfg.compute_dtype else contextlib.nullcontext()


def _mixed_dots(cfg: FieldConfig, x):
    """(dot, store) implementing cfg.compute_dtype, as the JAX package's
    _mixed_dots: dot(a, w) multiplies the operands rounded to the compute
    dtype and returns the f32 (x.dtype) sums; store(t) casts a tensor carried
    to the next layer down to the compute dtype. Without a compute dtype,
    plain f32 products and no casts.

    The products are the "upcast" form: the rounded operands cast back to
    f32 and multiplied as an f32 GEMM. bf16 x bf16 products are exact in
    f32, so this equals a bf16 GEMM that accumulates and returns f32. That
    GEMM itself, torch.mm(..., out_dtype=torch.float32), has no vmap
    batching rule and no derivative in the torch releases the port runs on
    (cli/train_bench reports it), and the meta-gradient needs both."""
    if not cfg.compute_dtype:
        return (lambda a, w: a @ w), (lambda t: t)
    cd, acc = getattr(torch, cfg.compute_dtype), x.dtype

    def dot(a, w):
        return a.to(cd).to(acc) @ w.to(cd).to(acc)

    return dot, (lambda t: t.to(cd))


def _uniform(gen, shape, lo, hi):
    return torch.empty(shape, device=gen.device).uniform_(lo, hi, generator=gen)


def init_field_params(gen: torch.Generator, cfg: FieldConfig, device="cpu"):
    """Build the params dict for a field with config `cfg`, drawing from
    `gen` (on the generator's device) and placing the result on `device`."""
    dtype = getattr(torch, cfg.dtype)
    sizes = [cfg.layer_size] * cfg.num_layers
    d_in = fourier_feature_dim(cfg.in_dim, cfg.n_fourier)

    def siren_uniform(shape):
        bound = math.sqrt(6.0 / shape[0]) / cfg.omega
        return _uniform(gen, shape, -bound, bound)

    def variance_scaling(shape):
        # fan-in truncated normal (flax variance_scaling(1, fan_in, truncated_normal))
        std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
        t = torch.empty(shape, device=gen.device)
        return std * torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                                 generator=gen)

    layers = []
    prev = d_in
    for i, size in enumerate(sizes):
        shape = (prev, size)
        if not cfg.siren:
            w = variance_scaling(shape)
        elif i == 0:
            w = (cfg.omega0 / cfg.omega) * _uniform(
                gen, shape, -1.0 / prev, 1.0 / prev)
        else:
            w = siren_uniform(shape)
        layers.append({"w": w, "b": torch.zeros(size)})
        prev = size
    shape = (prev, cfg.out_dim)
    w_out = siren_uniform(shape) if cfg.siren else variance_scaling(shape)
    layers.append({"w": w_out, "b": torch.zeros(cfg.out_dim)})

    params = {"layers": layers}
    if cfg.log_scale:
        init_log = math.log(1.0 / cfg.io_scale_lr_factor)
        params["log_in_scale"] = torch.full((cfg.in_dim,), init_log)
        params["log_out_scale"] = torch.full((cfg.out_dim,), init_log)
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)


def field_apply(params, x, cfg: FieldConfig):
    """Evaluate the field at coordinates x of shape [..., in_dim].

    Returns [...] for scalar fields (out_dim=1, squeeze_scalar) else
    [..., out_dim].
    """
    with mixed_precision_scope(cfg):
        return _field_apply(params, x, cfg)


def _field_apply(params, x, cfg: FieldConfig):
    batch_shape = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1])
    dot, store = _mixed_dots(cfg, x)

    if cfg.log_scale:
        h = h * torch.exp(params["log_in_scale"]).reshape(1, -1)
    if cfg.n_fourier is not None:
        h = fourier_features(h, cfg.n_fourier)

    layers = params["layers"]
    for layer in layers[:-1]:
        a = dot(h, layer["w"]) + layer["b"]
        h = store(torch.sin(cfg.omega * a) if cfg.siren else torch.nn.functional.silu(a))
    out_layer = layers[-1]
    out = dot(h, out_layer["w"]) + out_layer["b"]

    if cfg.log_scale:
        out = out * torch.exp(params["log_out_scale"]).reshape(1, -1)

    out = out.reshape(*batch_shape, cfg.out_dim)
    if cfg.out_dim == 1 and cfg.squeeze_scalar:
        out = out.sum(dim=-1)
    return out


def field_apply_vhd(params, x, cfg: FieldConfig):
    """One forward pass computing (value, gradient, Hessian diagonal).

    A Taylor-mode chain propagates (h, dh/dx_i, d2h/dx_i^2) through every
    layer:

        affine  W,b:  h' = hW+b        J' = JW          D' = DW
        sin(omega a): h = sin(omega a) J = omega cos(omega a) J'
                      D = -omega^2 sin(omega a) J'^2 + omega cos(omega a) D'

    It is plain torch, so autograd differentiates through it.

    Args: x [N, in_dim]. Returns (u, g, hd):
      scalar fields (out_dim=1, squeeze_scalar): u [N], g [N,d], hd [N,d]
      vector fields: u [N,o], g [N,o,d], hd [N,o,d]  with hd_i = d2u/dx_i^2.
    """
    with mixed_precision_scope(cfg):
        return _field_apply_vhd(params, x, cfg)


def _field_apply_vhd(params, x, cfg: FieldConfig):
    n, d = x.shape
    h = x
    dot, store = _mixed_dots(cfg, x)
    # J [N, d, F]: J[n, i, f] = d h_f / d x_i ;  D likewise second derivative
    J = torch.eye(d, dtype=x.dtype, device=x.device)[None].expand(n, d, d)
    D = torch.zeros_like(J)

    if cfg.log_scale:
        s = torch.exp(params["log_in_scale"]).reshape(1, -1)
        h = h * s
        J = J * s[:, None, :]

    if cfg.n_fourier is not None:
        # octave features are elementwise in each coordinate j:
        # phi(h_j) in {h_j, sin(c h_j)/c, cos(c h_j)/c}
        nf = cfg.n_fourier
        scale = (2.0 ** torch.arange(nf, dtype=x.dtype, device=x.device)).reshape(1, 1, -1)
        he = h[:, :, None]
        val = torch.cat(
            [he, torch.sin(scale * he) / scale, torch.cos(scale * he) / scale], dim=-1)
        dphi = torch.cat(
            [torch.ones_like(he), torch.cos(scale * he), -torch.sin(scale * he)], dim=-1)
        d2phi = torch.cat(
            [torch.zeros_like(he), -scale * torch.sin(scale * he),
             -scale * torch.cos(scale * he)], dim=-1)
        Jp, Dp = J[:, :, :, None], D[:, :, :, None]
        J = (dphi[:, None] * Jp).reshape(n, d, -1)
        D = (d2phi[:, None] * Jp ** 2 + dphi[:, None] * Dp).reshape(n, d, -1)
        h = val.reshape(n, -1)

    om = cfg.omega
    layers = params["layers"]
    for layer in layers[:-1]:
        w, b = layer["w"], layer["b"]
        a = dot(h, w) + b
        Ja = dot(J, w)
        Da = dot(D, w)
        if cfg.siren:
            sa = torch.sin(om * a)
            ca = torch.cos(om * a)
            h = sa
            J = om * ca[:, None, :] * Ja
            D = -(om ** 2) * sa[:, None, :] * Ja ** 2 + om * ca[:, None, :] * Da
        else:
            sig = torch.sigmoid(a)
            d1 = sig * (1.0 + a * (1.0 - sig))
            d2 = sig * (1.0 - sig) * (2.0 + a * (1.0 - 2.0 * sig))
            h = a * sig
            J = d1[:, None, :] * Ja
            D = d2[:, None, :] * Ja ** 2 + d1[:, None, :] * Da
        h, J, D = store(h), store(J), store(D)

    w, b = layers[-1]["w"], layers[-1]["b"]
    u = dot(h, w) + b  # [N, o]
    J = dot(J, w)      # [N, d, o]
    D = dot(D, w)

    if cfg.log_scale:
        so = torch.exp(params["log_out_scale"]).reshape(1, 1, -1)
        u = u * so[0]
        J = J * so
        D = D * so

    if cfg.out_dim == 1 and cfg.squeeze_scalar:
        return u.sum(-1), J.sum(-1), D.sum(-1)  # [N], [N,d], [N,d]
    return u, J.transpose(1, 2), D.transpose(1, 2)


def field_apply_vjac(params, x, cfg: FieldConfig):
    """One forward pass computing (value, Jacobian): the first-order slice of
    field_apply_vhd, for losses that need only grad u.

    Args: x [N, in_dim]. Returns (u, g):
      scalar fields: u [N], g [N,d]; vector fields: u [N,o], g [N,o,d].
    """
    with mixed_precision_scope(cfg):
        return _field_apply_vjac(params, x, cfg)


def _field_apply_vjac(params, x, cfg: FieldConfig):
    n, d = x.shape
    h = x
    dot, store = _mixed_dots(cfg, x)
    J = torch.eye(d, dtype=x.dtype, device=x.device)[None].expand(n, d, d)

    if cfg.log_scale:
        s = torch.exp(params["log_in_scale"]).reshape(1, -1)
        h = h * s
        J = J * s[:, None, :]

    if cfg.n_fourier is not None:
        nf = cfg.n_fourier
        scale = (2.0 ** torch.arange(nf, dtype=x.dtype, device=x.device)).reshape(1, 1, -1)
        he = h[:, :, None]
        val = torch.cat(
            [he, torch.sin(scale * he) / scale, torch.cos(scale * he) / scale], dim=-1)
        dphi = torch.cat(
            [torch.ones_like(he), torch.cos(scale * he), -torch.sin(scale * he)], dim=-1)
        J = (dphi[:, None] * J[:, :, :, None]).reshape(n, d, -1)
        h = val.reshape(n, -1)

    om = cfg.omega
    layers = params["layers"]
    for layer in layers[:-1]:
        w, b = layer["w"], layer["b"]
        a = dot(h, w) + b
        Ja = dot(J, w)
        if cfg.siren:
            h = torch.sin(om * a)
            J = om * torch.cos(om * a)[:, None, :] * Ja
        else:
            sig = torch.sigmoid(a)
            h = a * sig
            J = (sig * (1.0 + a * (1.0 - sig)))[:, None, :] * Ja
        h, J = store(h), store(J)

    w, b = layers[-1]["w"], layers[-1]["b"]
    u = dot(h, w) + b
    J = dot(J, w)

    if cfg.log_scale:
        so = torch.exp(params["log_out_scale"]).reshape(1, 1, -1)
        u = u * so[0]
        J = J * so

    if cfg.out_dim == 1 and cfg.squeeze_scalar:
        return u.sum(-1), J.sum(-1)
    return u, J.transpose(1, 2)


def _kernel_fits(cfg: FieldConfig) -> bool:
    """The gate of the JAX package's dispatcher: the config opts in and the
    fused SIREN kernel (ops/siren_fused.py) takes it. compute_dtype plays no
    part: the kernel computes in the dtype of its f32 inputs, as the JAX
    package's Pallas kernel does under a bf16 config."""
    return bool(
        cfg.use_pallas_inference
        and cfg.siren
        and cfg.n_fourier is None
        and cfg.layer_size <= siren_fused.MAX_WIDTH
        and cfg.out_dim <= siren_fused.MAX_WIDTH
        and cfg.in_dim <= siren_fused.MAX_WIDTH
    )


def _make_apply_inference_batched(cfg: FieldConfig):
    """Forward-only evaluation over a task axis, as the JAX package's vmap of
    apply_inference: x [T, N, d]; params with a leading task axis T on every
    leaf, or one set for every task when `shared`. One kernel launch for all
    tasks when the config fits the gate; otherwise field_apply task by task.
    Not differentiable: training paths use apply/apply_vhd."""
    fits = _kernel_fits(cfg)

    def apply_inference_batched(params, x, shared=False):
        if fits and x.ndim == 3:
            return siren_fused.siren_apply_fused_batched(params, x, cfg, shared=shared)
        return torch.stack([
            field_apply(params if shared else tree_map(lambda p: p[t], params), x[t], cfg)
            for t in range(x.shape[0])])

    return apply_inference_batched


def make_field(cfg: FieldConfig) -> FieldDef:
    # apply_inference at [N, d] is the T = 1 case of the batched dispatcher
    batched = _make_apply_inference_batched(cfg)
    return FieldDef(
        init=lambda gen, device="cpu": init_field_params(gen, cfg, device),
        apply=lambda params, x: field_apply(params, x, cfg),
        cfg=cfg,
        apply_vhd=lambda params, x: field_apply_vhd(params, x, cfg),
        apply_vjac=lambda params, x: field_apply_vjac(params, x, cfg),
        apply_inference=lambda params, x: batched(params, x[None], shared=True)[0],
        apply_inference_batched=batched,
    )
