from .registry import get_pde, PdeDef  # noqa: F401
