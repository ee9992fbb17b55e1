from .fourier import fourier_feature_dim, fourier_features  # noqa: F401
