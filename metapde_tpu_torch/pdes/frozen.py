"""The JAX package's draws from the all-zero PRNG key, for frozen factors.

The JAX package freezes a task factor that a ``vary_*`` flag switches off
by zeroing the PRNG key it is drawn from (``k * jnp.uint32(vary)``), so
every task shares JAX's draw from key [0, 0]. The port keeps those draws as
f32 bit patterns, one entry per shape its families use, and scales them as
``jax.random.uniform`` does: ``max(min, u * (max - min) + min)`` in f32,
with the multiply-add fused as XLA fuses it on the CPU (the product of two
f32 values is exact in f64, so one f64 add rounded to f32 gives the fused
result; the test checks every entry at every scale the families use).
tests/test_torch_td_burgers.py computes every entry with JAX and requires equal
bits.
"""

import numpy as np
import torch

# jax.random.uniform(jnp.zeros(2, jnp.uint32), shape), in [0, 1)
_UNIT_UNIFORM_BITS = {
    (1,): (0x3F729A4E,),
    (2,): (0x3F729A4E, 0x3F7A8436),
    (5,): (0x3F729A4E, 0x3F7A8436, 0x3EAA221C, 0x3EEFF550, 0x3F11E43A),
}
# jax.random.normal(jnp.zeros(2, jnp.uint32), shape)
_NORMAL_BITS = {
    (2, 3): (0x3FCFB2BD, 0x40019DF0, 0xBEDE0017, 0xBDA10222, 0x3E34512C, 0xBF78DAD7),
}


def _from_bits(table, shape, device):
    shape = tuple(shape)
    if shape not in table:
        raise KeyError(f"no zero-key draw of shape {shape}; have {sorted(table)}")
    bits = np.asarray(table[shape], np.uint32).view(np.float32).reshape(shape)
    return torch.tensor(bits, device=device)


def unit_uniform(shape, device="cpu") -> torch.Tensor:
    """JAX's zero-key unit-uniform draw of `shape`, f32."""
    return _from_bits(_UNIT_UNIFORM_BITS, shape, device)


def uniform(shape, minval, maxval, device="cpu") -> torch.Tensor:
    """jax.random.uniform(zero key, shape, minval, maxval), bit for bit."""
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    fused = unit_uniform(shape, device).double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fused.float())


def normal(shape, device="cpu") -> torch.Tensor:
    """jax.random.normal(zero key, shape), f32."""
    return _from_bits(_NORMAL_BITS, shape, device)
