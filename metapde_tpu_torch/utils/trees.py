"""Parameter-tree utilities over nested dicts, lists and tuples of tensors
(counterpart of metapde_tpu/utils/trees.py)."""

import torch


def tree_leaves(tree):
    """Leaves in JAX's order: dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply fn leafwise over congruent trees, keeping the container types
    (dicts come back with sorted keys, as from a JAX tree_map)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """Rebuild a tree shaped like `like` from leaves in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_structure_equal(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(tree_structure_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(tree_structure_equal(x, y) for x, y in zip(a, b)))
    return not isinstance(b, (dict, list, tuple))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in leaves))


def clip_by_global_norm(tree, max_norm):
    """Scale the whole tree so its global norm is at most max_norm.

    The tree is rescaled by max_norm/norm only when norm > max_norm,
    otherwise unchanged (the where(norm > max) form of the JAX package).
    Returns (clipped tree, norm).
    """
    norm = global_norm(tree)
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-30),
                        torch.ones_like(norm))
    return tree_map(lambda x: x * scale, tree), norm


def per_task(v, like):
    """Broadcast a per-task vector [T] against a leaf `like` [T, ...]."""
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def sum_sq_per_task(tree) -> torch.Tensor:
    """The sum of squares of each task of a tree whose leaves are [T, ...]:
    the sums run over every axis but the task axis. Returns [T]."""
    return sum(torch.sum(torch.square(g), dim=tuple(range(1, g.ndim)))
               for g in tree_leaves(tree))


def global_norm_per_task(tree) -> torch.Tensor:
    """global_norm of each task of a [T, ...] tree. Returns [T]."""
    return torch.sqrt(sum_sq_per_task(tree))


def clip_by_global_norm_per_task(tree, max_norm):
    """clip_by_global_norm for each task of a [T, ...] tree. Returns
    (clipped tree, norms [T])."""
    norm = global_norm_per_task(tree)
    scale = torch.where(norm > max_norm, max_norm / torch.clamp(norm, min=1e-30),
                        torch.ones_like(norm))
    return tree_map(lambda g: g * per_task(scale, g), tree), norm


def tree_stack(trees):
    """List of congruent trees -> one tree with a stacked leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)
