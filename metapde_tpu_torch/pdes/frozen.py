"""The JAX package's draws from the all-zero PRNG key, for frozen factors.

The JAX package freezes a task factor that a ``vary_*`` flag switches off
by zeroing the PRNG key it is drawn from (``k * jnp.uint32(vary)``), so
every task shares JAX's draw from key [0, 0]. JAX's threefry is
partitionable, so a zero-key draw of n values is the first n of one stream
whatever its shape; the port keeps the first 32 values of the unit-uniform
stream and 8 of the normal stream as f32 bit patterns, and JAX's zero-key
``randint`` of the hole count for each max_holes up to 16. It scales a
uniform draw as ``jax.random.uniform`` does, bounds broadcast against the
shape: ``max(min, u * (max - min) + min)`` in f32, with the multiply-add
fused as XLA fuses it on the CPU (the product of two f32 values is exact in
f64, so one f64 add rounded to f32 gives the fused result).
tests/test_torch_td_burgers.py and tests/test_torch_steady_burgers.py compute
every entry with JAX at every shape and scale the families use and require
equal bits.
"""

import numpy as np
import torch

# jax.random.uniform(jnp.zeros(2, jnp.uint32), (32,)), in [0, 1)
_UNIT_UNIFORM_BITS = (
    0x3F729A4E, 0x3F7A8436, 0x3EAA221C, 0x3EEFF550, 0x3F11E43A, 0x3E2979A0, 0x3E9ED1D4,
    0x3F3081CC, 0x3F3F2C18, 0x3E2F1E70, 0x3F7C4026, 0x3CCF1D80, 0x3F23D9C8, 0x3F100C82,
    0x3F6632E0, 0x3F6F3DDA, 0x3F558A36, 0x3F39C1FC, 0x3F0285BC, 0x3CE286C0, 0x3D00FA60,
    0x3F7540B8, 0x3F04D156, 0x3F4ACE8C, 0x3F0D5FBA, 0x3F1C81A0, 0x3F64A726, 0x3F414716,
    0x3E58B8A0, 0x3E6ADAA8, 0x3D7DA300, 0x3F1E72B2,
)
# jax.random.normal(jnp.zeros(2, jnp.uint32), (8,))
_NORMAL_BITS = (0x3FCFB2BD, 0x40019DF0, 0xBEDE0017, 0xBDA10222, 0x3E34512C, 0xBF78DAD7,
                0xBEFD97CC, 0x3EFD1F31)
# jax.random.randint(jnp.zeros(2, jnp.uint32), (), 1, max_holes + 1) by max_holes
_HOLE_COUNT = {1: 1, 2: 2, 3: 2, 4: 2, 5: 5, 6: 2, 7: 2, 8: 6, 9: 5, 10: 10, 11: 9, 12: 2,
               13: 7, 14: 2, 15: 5, 16: 6}


def _from_bits(stream, shape, device):
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    if n > len(stream):
        raise KeyError(f"no zero-key draw of shape {shape}: the stream holds {len(stream)}")
    bits = np.asarray(stream[:n], np.uint32).view(np.float32).reshape(shape)
    return torch.tensor(bits, device=device)


def unit_uniform(shape, device="cpu") -> torch.Tensor:
    """JAX's zero-key unit-uniform draw of `shape`, f32."""
    return _from_bits(_UNIT_UNIFORM_BITS, shape, device)


def uniform(shape, minval, maxval, device="cpu") -> torch.Tensor:
    """jax.random.uniform(zero key, shape, minval, maxval), bit for bit; the
    bounds are f32 scalars or arrays that broadcast against `shape`."""
    lo = torch.as_tensor(minval, dtype=torch.float32).to(device)
    hi = torch.as_tensor(maxval, dtype=torch.float32).to(device)
    fused = unit_uniform(shape, device).double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fused.float())


def normal(shape, device="cpu") -> torch.Tensor:
    """jax.random.normal(zero key, shape), f32."""
    return _from_bits(_NORMAL_BITS, shape, device)


def hole_count(max_holes: int, device="cpu") -> torch.Tensor:
    """jax.random.randint(zero key, (), 1, max_holes + 1), int32."""
    if max_holes not in _HOLE_COUNT:
        raise KeyError(f"no zero-key hole count for max_holes={max_holes}; have 1..16")
    return torch.tensor(_HOLE_COUNT[max_holes], dtype=torch.int32, device=device)
