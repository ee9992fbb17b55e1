"""Carry parameter trees between the JAX package's numpy form and the port.

A JAX checkpoint holds params and learned inner LRs as nested dicts and
lists of numpy arrays (``{"layers": [{"w": [in, out], "b": [out]}, ...],
"log_in_scale": ..., "log_out_scale": ...}``). The port keeps exactly that
layout with torch tensors at the leaves, so conversion is leafwise.
"""

import numpy as np
import torch

from .utils.trees import tree_map


def params_from_numpy(tree, device="cpu", dtype=torch.float32):
    """numpy (or array-like) leaves -> tensors of `dtype` on `device`;
    dtype=None keeps each leaf's own (an optimizer state's int32 count)."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device), tree)


def params_to_numpy(tree):
    """tensor leaves -> numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
