"""Fourier positional features and standardisation (counterpart of
metapde_tpu/ops/fourier.py).

Octave-scaled sin/cos features: for each input coordinate x_j and octave p,
emit sin(2^p x_j)/2^p and cos(2^p x_j)/2^p alongside the raw coordinate.
whiten / dewhiten standardise rows of coordinates or values by a mean and
a std per column (no caller in either package).
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


def whiten(x, mean=None, std=None):
    """(x - mean) / std per column; either may be None (skipped)."""
    if mean is not None:
        x = x - torch.as_tensor(mean, dtype=x.dtype, device=x.device).reshape(1, -1)
    if std is not None:
        x = x / torch.as_tensor(std, dtype=x.dtype, device=x.device).reshape(1, -1)
    return x


def dewhiten(y, mean=None, std=None):
    """The inverse of whiten: y * std + mean per column."""
    if std is not None:
        y = y * torch.as_tensor(std, dtype=y.dtype, device=y.device).reshape(1, -1)
    if mean is not None:
        y = y + torch.as_tensor(mean, dtype=y.dtype, device=y.device).reshape(1, -1)
    return y
