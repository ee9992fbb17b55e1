"""Fused SIREN inference: CUDA kernel wrapper and its plain PyTorch version.

Replaces metapde_tpu/ops/pallas_siren.py::siren_apply_fused. The kernel
(csrc/siren_fused.cu) runs the whole layer chain per tile of points:

    h = x * exp(log_in_scale)
    h = sin(omega * (h W_l + b_l))            for each hidden layer
    out = (h W_out + b_out) * exp(log_out_scale)   summed to [N] for scalar fields

On the H100 it is bound by f32 FMA throughput (the reads of x and writes of
out are tiny next to ~16.8 kFLOP per point for a 3x64 SIREN). Its design
keeps the tile's activations and each layer's weights in shared memory, so
only the final output goes to device memory.

``siren_apply_fused`` launches the kernel for a CUDA tensor (or raises) and
takes the plain version only for a tensor on the CPU. Its ``launches``
attribute counts kernel launches, so a run can show it went through the
kernel.
"""

import ctypes
import functools

import torch

from . import _build

MAX_WIDTH = 128  # largest in_dim, layer width and out_dim the kernel takes


def _layer_dims(params, x, cfg):
    """Validate what the kernel takes; returns (in_dim, hidden, n_hidden, out_dim)."""
    if not cfg.siren or cfg.n_fourier is not None:
        raise ValueError("siren_apply_fused needs a SIREN without Fourier features")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, in_dim] float32, got {tuple(x.shape)} {x.dtype}")
    layers = params["layers"]
    n_hidden = len(layers) - 1
    if n_hidden < 1:
        raise ValueError("siren_apply_fused needs at least one hidden layer")
    in_dim = x.shape[1]
    hidden = layers[0]["w"].shape[1]
    out_dim = layers[-1]["w"].shape[1]
    if max(in_dim, hidden, out_dim) > MAX_WIDTH:
        raise ValueError(f"widths {in_dim}/{hidden}/{out_dim} exceed {MAX_WIDTH}")
    prev = in_dim
    for layer in layers:
        width = hidden if layer is not layers[-1] else out_dim
        w, b = layer["w"], layer["b"]
        if tuple(w.shape) != (prev, width) or tuple(b.shape) != (width,):
            raise ValueError(f"layer shapes {tuple(w.shape)}, {tuple(b.shape)} "
                             f"do not chain from width {prev}")
        for t in (w, b):
            if t.dtype != torch.float32 or t.device != x.device:
                raise ValueError("params must be float32 on x's device")
        prev = width
    return in_dim, hidden, n_hidden, out_dim


def _scales(params, cfg, in_dim, out_dim, device):
    if cfg.log_scale:
        return torch.exp(params["log_in_scale"]), torch.exp(params["log_out_scale"])
    return (torch.ones(in_dim, device=device), torch.ones(out_dim, device=device))


def _finish(out, cfg):
    if out.shape[1] == 1 and cfg.squeeze_scalar:
        return out.sum(dim=-1)
    return out


def siren_apply_fused_reference(params, x, cfg):
    """The plain PyTorch version of the kernel: same arithmetic, op by op."""
    in_dim, _, _, out_dim = _layer_dims(params, x, cfg)
    in_scale, out_scale = _scales(params, cfg, in_dim, out_dim, x.device)
    h = x * in_scale
    for layer in params["layers"][:-1]:
        h = torch.sin(cfg.omega * (h @ layer["w"] + layer["b"]))
    last = params["layers"][-1]
    return _finish((h @ last["w"] + last["b"]) * out_scale, cfg)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("siren_fused")
    fn = lib.siren_fused_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def siren_apply_fused(params, x, cfg):
    """Fused inference for a SIREN params dict (init_field_params layout).

    x: [N, in_dim] float32 -> [N] (scalar fields) or [N, out_dim]. A CUDA
    tensor goes through the kernel, which raises if it fails to launch; a
    CPU tensor goes through siren_apply_fused_reference.
    """
    in_dim, hidden, n_hidden, out_dim = _layer_dims(params, x, cfg)
    if x.device.type == "cpu":
        return siren_apply_fused_reference(params, x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"siren_apply_fused takes cpu or cuda tensors, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[0] == 0:
        return _finish(x.new_empty((0, out_dim)), cfg)
    fn = _library()
    layers = params["layers"]
    # packed copies: contiguous, and alive until the stream-ordered kernel
    # has read them (the caching allocator reuses memory in stream order)
    ws = torch.cat([l["w"].reshape(-1) for l in layers[:-1]])
    bs = torch.cat([l["b"] for l in layers[:-1]])
    wout = layers[-1]["w"].contiguous()
    bout = layers[-1]["b"].contiguous()
    in_scale, out_scale = _scales(params, cfg, in_dim, out_dim, x.device)
    in_scale, out_scale = in_scale.contiguous(), out_scale.contiguous()
    out = torch.empty((x.shape[0], out_dim), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), ws.data_ptr(), bs.data_ptr(), wout.data_ptr(),
                bout.data_ptr(), in_scale.data_ptr(), out_scale.data_ptr(),
                out.data_ptr(), x.shape[0], in_dim, hidden, n_hidden, out_dim,
                float(cfg.omega), stream)
    if rc != 0:
        raise RuntimeError(f"siren_fused_forward failed to launch: cudaError {rc}")
    siren_apply_fused.launches += 1
    return _finish(out, cfg)


siren_apply_fused.launches = 0
