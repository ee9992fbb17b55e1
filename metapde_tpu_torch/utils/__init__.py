from .timer import Timer  # noqa: F401
from .trees import clip_by_global_norm, global_norm, tree_leaves, tree_map  # noqa: F401
