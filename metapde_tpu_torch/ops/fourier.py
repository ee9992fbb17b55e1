"""Fourier positional features (counterpart of metapde_tpu/ops/fourier.py).

Octave-scaled sin/cos features: for each input coordinate x_j and octave p,
emit sin(2^p x_j)/2^p and cos(2^p x_j)/2^p alongside the raw coordinate.
"""

import torch


def fourier_features(x, n_features: int):
    if x.ndim == 1:
        x = x.reshape(1, -1)
    n, d = x.shape
    xe = x[:, :, None]
    pows = torch.arange(n_features, dtype=x.dtype, device=x.device).reshape(1, 1, -1)
    scale = 2.0 ** pows
    sins = torch.sin(scale * xe) / scale
    coss = torch.cos(scale * xe) / scale
    return torch.cat([xe, sins, coss], dim=-1).reshape(n, -1)


def fourier_feature_dim(in_dim: int, n_features) -> int:
    if n_features is None:
        return in_dim
    return in_dim * (1 + 2 * n_features)
