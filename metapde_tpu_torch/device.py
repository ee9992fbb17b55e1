"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A CUDA
request on a machine without a usable CUDA device raises: nothing falls
back to the CPU quietly.
"""

import contextlib

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(name: str = DEFAULT_DEVICE) -> torch.device:
    """Return the torch.device for `name` ("cuda", "cuda:1", "cpu")."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device=cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    return dev


def pop_device_flag(argv):
    """Split ``--device=NAME`` out of a CLI argv; returns (device, rest)."""
    name, rest = DEFAULT_DEVICE, []
    for a in argv:
        if a.startswith("--device="):
            name = a.split("=", 1)[1]
        else:
            rest.append(a)
    return resolve_device(name), rest


@contextlib.contextmanager
def full_f32_matmuls():
    """TF32 off for matmuls and cuDNN inside the block, then the flags as
    they were: f32 products keep f32 sums, as the JAX package's highest
    matmul precision and preferred_element_type=f32 keep them."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
