from .fourier import dewhiten, fourier_feature_dim, fourier_features, whiten  # noqa: F401
