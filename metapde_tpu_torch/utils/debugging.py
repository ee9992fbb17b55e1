"""Debugging helpers (counterpart of metapde_tpu/utils/debugging.py), in
PyTorch's idiom.

- djit: eager mode has no trace, so the wrapper prints the argument and
  output shapes at the first call of each argument-shape signature (the
  JAX djit prints them at each trace, i.e. each recompile).
- dgrad: torch.func.grad of a function, wrapped by djit.
- KeyLineage: flags a reused random state. A torch.Generator is mutable
  state, not a value, so what can be reused is a state: drawing twice from
  generators in the same state (get_state()), e.g. after seeding two with
  one seed, repeats the draws, as reusing a JAX PRNG key does.
"""

import functools
import hashlib

import torch


def _shapes(tree):
    """The tree with each tensor replaced by its shape (None for others)."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_shapes(v) for v in tree)
    return tuple(tree.shape) if torch.is_tensor(tree) else None


def djit(fn=None, *, name=None):
    """fn, printing its argument and output shapes at the first call of
    each argument-shape signature."""
    if fn is None:
        return functools.partial(djit, name=name)
    label = name or getattr(fn, "__name__", "fn")
    seen = set()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        shapes = _shapes((args, kwargs))
        sig = repr(shapes)
        first = sig not in seen
        if first:
            seen.add(sig)
            print(f"[djit] first call of {label} with {shapes}")
        out = fn(*args, **kwargs)
        if first:
            print(f"[djit] {label} -> {_shapes(out)}")
        return out

    return wrapped


def dgrad(fn, **grad_kwargs):
    """torch.func.grad(fn, **grad_kwargs) with djit's shape printing."""
    return djit(torch.func.grad(fn, **grad_kwargs),
                name=f"grad({getattr(fn, '__name__', 'fn')})")


class KeyLineage:
    """Flags the reuse of a generator state: use(gen) records the state it
    is about to draw from and raises if that state was used before. Host
    state, for eager debugging sessions."""

    def __init__(self):
        self._consumed = set()

    def use(self, gen: torch.Generator, where: str = "?"):
        h = hashlib.sha256(gen.get_state().numpy().tobytes()).hexdigest()
        if h in self._consumed:
            raise RuntimeError(f"generator state reused at {where}: draws would repeat. "
                               "Seed a fresh generator from this one instead.")
        self._consumed.add(h)
        return gen

    def split(self, gen: torch.Generator, n: int = 2, where: str = "?"):
        """n fresh generators seeded from gen's draws (the counterpart of
        jax.random.split), after recording gen's state as used."""
        self.use(gen, where)
        seeds = torch.randint(0, 2 ** 62, (n,), generator=gen)
        return [torch.Generator(device=gen.device).manual_seed(int(s)) for s in seeds]
