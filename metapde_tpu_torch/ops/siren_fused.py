"""Fused SIREN inference: CUDA kernel wrapper and its plain PyTorch version.

Replaces metapde_tpu/ops/pallas_siren.py::siren_apply_fused, which the JAX
package vmaps over the eval tasks. The kernel (csrc/siren_fused.cu) runs the
whole layer chain for every task in one launch:

    h = x[t] * exp(log_in_scale[t])
    h = sin(omega * (h W_l[t] + b_l[t]))            for each hidden layer
    out[t] = (h W_out[t] + b_out[t]) * exp(log_out_scale[t])   summed to [T, N] for scalar fields

On the H100 it is bound by operations (~16.8 kFLOP and 192 sines per
point for a 3x64 SIREN, against 16 bytes of input and output). It keeps a
tile's activations and the network's weights in shared memory, runs the
hidden x hidden layers as 3xTF32 tensor-core products and the sines on the
SFU after an exact range reduction, so it agrees with the plain version to
~1e-7, inside the 1e-5 bar.

``siren_apply_fused_batched`` takes x [T, N, in_dim] and params whose leaves
carry a leading task axis of T, or one set of params for every task when
``shared`` (the k = 0 deployment). ``siren_apply_fused`` is its T = 1 case.
Both launch the kernel for a CUDA tensor (or raise) and take the plain
version only for a tensor on the CPU. The counter ``siren_fused.launches``
(utils/spans.py) counts kernel launches, so a run can show it went through
the kernel.
"""

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import spans
from . import _build

MAX_WIDTH = 128  # largest in_dim, layer width and out_dim the kernel takes


def layer_dims(params, x, cfg, shared):
    """Validate what the kernel takes; returns (in_dim, hidden, n_hidden, out_dim).

    x must be [T, N, in_dim] float32; each params leaf has the leading task
    axis T unless `shared`."""
    if not cfg.siren or cfg.n_fourier is not None:
        raise ValueError("siren_apply_fused needs a SIREN without Fourier features")
    if x.ndim != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be [T, N, in_dim] float32, got {tuple(x.shape)} {x.dtype}")
    lead = () if shared else (x.shape[0],)
    layers = params["layers"]
    n_hidden = len(layers) - 1
    if n_hidden < 1:
        raise ValueError("siren_apply_fused needs at least one hidden layer")
    in_dim = x.shape[2]
    hidden = layers[0]["w"].shape[-1]
    out_dim = layers[-1]["w"].shape[-1]
    if max(in_dim, hidden, out_dim) > MAX_WIDTH:
        raise ValueError(f"widths {in_dim}/{hidden}/{out_dim} exceed {MAX_WIDTH}")
    expected = []
    prev = in_dim
    for layer in layers:
        width = hidden if layer is not layers[-1] else out_dim
        expected += [(layer["w"], lead + (prev, width)), (layer["b"], lead + (width,))]
        prev = width
    if cfg.log_scale:
        expected += [(params["log_in_scale"], lead + (in_dim,)),
                     (params["log_out_scale"], lead + (out_dim,))]
    for t, shape in expected:
        if tuple(t.shape) != shape:
            raise ValueError(f"param of shape {tuple(t.shape)} where {shape} was expected "
                             f"({'shared' if shared else f'{x.shape[0]} tasks'})")
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("params must be float32 on x's device")
    return in_dim, hidden, n_hidden, out_dim


def _check_2d(x):
    if x.ndim != 2:
        raise ValueError(f"x must be [N, in_dim], got {tuple(x.shape)}")


def _scales(params, cfg, lead, in_dim, out_dim, device):
    if cfg.log_scale:
        return torch.exp(params["log_in_scale"]), torch.exp(params["log_out_scale"])
    return (torch.ones(lead + (in_dim,), device=device),
            torch.ones(lead + (out_dim,), device=device))


def _finish(out, cfg):
    if out.shape[-1] == 1 and cfg.squeeze_scalar:
        return out.sum(dim=-1)
    return out


def siren_apply_fused_batched_reference(params, x, cfg, shared=False):
    """The plain PyTorch version of the kernel, with the task axis written
    out: the same arithmetic, op by op. Compare it with the kernel with TF32
    matmuls off (torch.backends.cuda.matmul.allow_tf32 = False)."""
    in_dim, _, _, out_dim = layer_dims(params, x, cfg, shared)
    lead = () if shared else (x.shape[0],)
    in_scale, out_scale = _scales(params, cfg, lead, in_dim, out_dim, x.device)
    h = x * in_scale.unsqueeze(-2)
    for layer in params["layers"][:-1]:
        h = torch.sin(cfg.omega * (torch.matmul(h, layer["w"]) + layer["b"].unsqueeze(-2)))
    w, b = params["layers"][-1]["w"], params["layers"][-1]["b"]
    if out_dim == 1:
        # a row-wise dot product: BLAS takes a matrix-vector route for one
        # task and a batched one for several, which round differently
        out = (h * w[..., 0].unsqueeze(-2)).sum(dim=-1, keepdim=True)
    else:
        out = torch.matmul(h, w)
    return _finish((out + b.unsqueeze(-2)) * out_scale.unsqueeze(-2), cfg)


def siren_apply_fused_reference(params, x, cfg):
    """The plain version for x [N, in_dim]: the T = 1 case."""
    _check_2d(x)
    return siren_apply_fused_batched_reference(params, x[None], cfg, shared=True)[0]


class Packed(NamedTuple):
    """Every task's parameters in the kernel's layout."""

    params: torch.Tensor  # [T, task_floats], or [1, task_floats] when shared
    task_stride: int      # task_floats, or 0 when every task shares one set
    in_dim: int
    hidden: int
    n_hidden: int
    out_dim: int


def pack(params, cfg, n_tasks, shared, dims) -> Packed:
    """Pack all tasks' parameters with one torch.cat: per task W_0 b_0 ...
    W_out b_out in_scale out_scale, row-major (csrc/siren_fused.cu)."""
    in_dim, hidden, n_hidden, out_dim = dims
    lead = () if shared else (n_tasks,)
    rows = 1 if shared else n_tasks
    device = params["layers"][0]["w"].device
    in_scale, out_scale = _scales(params, cfg, lead, in_dim, out_dim, device)
    leaves = [t for layer in params["layers"] for t in (layer["w"], layer["b"])]
    flat = torch.cat([t.reshape(rows, -1) for t in (*leaves, in_scale, out_scale)], dim=1)
    return Packed(flat, 0 if shared else flat.shape[1], in_dim, hidden, n_hidden, out_dim)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("siren_fused")
    fn = lib.siren_fused_forward
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    plan = lib.siren_fused_plan
    plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_longlong),
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    return lib


class LaunchPlan(NamedTuple):
    """How the kernel runs a network shape on a device."""

    resident: bool      # every layer's weights stay in shared memory
    smem_bytes: int     # dynamic shared memory of a block
    blocks_per_sm: int  # cudaOccupancyMaxActiveBlocksPerMultiprocessor
    n_sm: int


def launch_plan(dims, device) -> LaunchPlan:
    """The kernel's plan for dims (in_dim, hidden, n_hidden, out_dim, as
    layer_dims returns them) on a CUDA device, without launching."""
    resident, n_sm, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_longlong()
    with torch.cuda.device(device):
        rc = _library().siren_fused_plan(*dims, ctypes.byref(resident), ctypes.byref(smem),
                                         ctypes.byref(per_sm), ctypes.byref(n_sm))
    if rc != 0:
        raise RuntimeError(f"siren_fused_plan failed: cudaError {rc}")
    return LaunchPlan(bool(resident.value), smem.value, per_sm.value, n_sm.value)


def launch(packed: Packed, x, omega):
    """Launch the kernel on packed parameters; x [T, N, in_dim] contiguous
    float32 on a CUDA device -> [T, N, out_dim]. Counts the launch."""
    n_tasks, n, _ = x.shape
    out = torch.empty((n_tasks, n, packed.out_dim), dtype=torch.float32, device=x.device)
    # the kernel runs on the current device; switch only when x lies elsewhere
    on_x = (contextlib.nullcontext() if x.device.index == torch.cuda.current_device()
            else torch.cuda.device(x.device))
    with on_x:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _library().siren_fused_forward(
            x.data_ptr(), packed.params.data_ptr(), packed.task_stride, out.data_ptr(),
            n_tasks, n, packed.in_dim, packed.hidden, packed.n_hidden, packed.out_dim,
            float(omega), stream)
    if rc != 0:
        raise RuntimeError(f"siren_fused_forward failed to launch: cudaError {rc}")
    spans.count("siren_fused.launches")
    return out


def siren_apply_fused_batched(params, x, cfg, shared=False):
    """Fused inference for T tasks in one launch.

    x: [T, N, in_dim] float32 -> [T, N] (scalar fields) or [T, N, out_dim].
    params: the init_field_params layout with a leading task axis T on every
    leaf, or, when `shared`, one set of params for every task. A CUDA tensor
    goes through the kernel, which raises if it fails to launch; a CPU
    tensor goes through siren_apply_fused_batched_reference.
    """
    dims = layer_dims(params, x, cfg, shared)
    if x.device.type == "cpu":
        return siren_apply_fused_batched_reference(params, x, cfg, shared)
    if x.device.type != "cuda":
        raise ValueError(f"siren_apply_fused takes cpu or cuda tensors, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() == 0:
        return _finish(x.new_empty(x.shape[:2] + (dims[3],)), cfg)
    # the packed copy stays alive until the stream-ordered kernel has read it
    # (the caching allocator reuses memory in stream order)
    return _finish(launch(pack(params, cfg, x.shape[0], shared, dims), x, cfg.omega), cfg)


def siren_apply_fused(params, x, cfg):
    """Fused inference for one set of params: x [N, in_dim] -> [N] (scalar
    fields) or [N, out_dim]; the T = 1 case of siren_apply_fused_batched."""
    _check_2d(x)
    return siren_apply_fused_batched(params, x[None], cfg, shared=True)[0]
