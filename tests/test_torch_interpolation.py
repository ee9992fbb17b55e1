"""Solution-transfer interpolators: metapde_tpu.solvers.interpolation
against the PyTorch port on shared numpy inputs from a seed.

- TaylorLookup: exact on a quadratic in float64 (1e-12), and its tables and
  expansions against JAX's on a smooth two-output field in float32 (rtol
  1e-5 of each table's scale).
- knn_interpolant: against JAX's at 200 points, with and without a mask
  (1e-6 of the values' scale); masked samples never contribute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from metapde_tpu.solvers import interpolation as j_interp
from metapde_tpu_torch.solvers import interpolation as interp

torch.set_num_threads(2)


def test_taylor_lookup_is_exact_on_a_quadratic():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((2, 2)))
    b = torch.tensor(rng.standard_normal(2))

    def q(x):
        return x @ a @ x + b @ x + 0.5

    anchors = torch.tensor(rng.uniform(-1, 1, (16, 2)))
    lookup = interp.build_taylor_lookup(q, anchors)
    x = torch.tensor(rng.uniform(-1, 1, (100, 2)))
    got = vmap(lambda p: interp.taylor_eval(lookup, p))(x)[:, 0]
    np.testing.assert_allclose(got.numpy(), vmap(q)(x).numpy(), rtol=0, atol=1e-12)


def _field(np_mod):
    def f(x):
        return np_mod.stack([np_mod.sin(2.0 * x[0]) * x[1], np_mod.exp(-x[0] * x[1])])
    return f


def test_taylor_lookup_matches_jax():
    rng = np.random.default_rng(1)
    anchors = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    jl = j_interp.build_taylor_lookup(_field(jnp), anchors)
    tl = interp.build_taylor_lookup(_field(torch), torch.tensor(anchors))
    for name in jl._fields:
        want = np.asarray(getattr(jl, name))
        np.testing.assert_allclose(getattr(tl, name).numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    want = np.asarray(jax.vmap(lambda p: j_interp.taylor_eval(jl, p))(x))
    got = vmap(lambda p: interp.taylor_eval(tl, p))(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("masked", [False, True])
def test_knn_interpolant_matches_jax(masked):
    rng = np.random.default_rng(2)
    xys = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    values = rng.standard_normal((300, 2)).astype(np.float32)
    mask = (rng.uniform(size=300) > 0.3).astype(np.float32) if masked else None
    x = rng.uniform(-1, 1, (200, 2)).astype(np.float32)
    j_fn = j_interp.knn_interpolant(xys, values, mask=mask, temp=0.01)
    t_fn = interp.knn_interpolant(torch.tensor(xys), torch.tensor(values),
                                  mask=None if mask is None else torch.tensor(mask), temp=0.01)
    want = np.asarray(jax.vmap(j_fn)(x))
    got = vmap(t_fn)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(values).max())
    if masked:
        # an interpolant of the valid samples alone gives the same values
        keep = mask > 0.5
        alone = interp.knn_interpolant(torch.tensor(xys[keep]), torch.tensor(values[keep]),
                                       temp=0.01)
        np.testing.assert_allclose(vmap(alone)(torch.tensor(x)).numpy(), got, rtol=0, atol=1e-6)
