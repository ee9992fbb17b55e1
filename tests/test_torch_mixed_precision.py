"""The bf16 mixed-precision chain (model.compute_dtype="bfloat16", the
flagship's setting): metapde_tpu.models.siren against the port, on shared
params (the JAX init, carried over) and points from a numpy seed.

Bars, each with what it was measured at on the CPU:
- bf16 field_apply / field_apply_vhd / field_apply_vjac against the JAX
  package's bf16 ones: norm-relative 1e-3 per output (measured 1.6e-8 to
  1.7e-4: the port rounds the same operands to bf16 and sums the products in
  f32, as preferred_element_type does, but in another order, and a 1e-7
  difference before store() can flip one bf16 ulp of sin(30 a)).
- bf16 against the port's own f32 chain: below 3e-2 (5e-2 for the Hessian
  diagonal of the Fourier vector field), the JAX package's own bars
  (tests/test_mixed_precision.py); measured 7e-3 to 1e-2 on the default
  config.
- The second-order meta-gradient in bf16 against the JAX package's bf16
  meta-gradient: norm-relative 5e-3 over all leaves (measured 1.1e-3 at
  2x32 and 1.4e-3 at 3x64) and 2e-2 of each leaf's scale (measured 6.1e-3).
  The cotangent of a bf16 operand is the f32 product rounded to bf16 in both
  packages (the same bits on a single product); what is left are the ulp
  flips above, which the second-order terms carry into every leaf. That
  noise is of the bf16 chain's own size (the JAX bf16 meta-gradient is
  1.6e-3 from its f32 one), so the forward bars above, not these, are the
  ones that tell bf16 from f32. Meta-losses rtol 1e-5.
- One outer step (step_core against the JAX train_step on JAX's own draws):
  params within 1e-5 of a leaf's scale (measured 3.2e-8), inner LRs within
  1e-2 (measured 4.2e-3: Adam divides each element by its own gradient
  size, so an element whose meta-gradient is near zero carries the bf16
  difference into a step of full size), meta-grad norm rtol 1e-4.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.meta import maml as j_maml
from metapde_tpu.models import make_field as j_make_field
from metapde_tpu_torch.cli import train_bench
from metapde_tpu_torch.config import Config, FieldConfig, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.meta import maml
from metapde_tpu_torch.models import make_field, siren
from metapde_tpu_torch.train import maml_driver
from metapde_tpu_torch.utils.trees import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_train as tt  # noqa: E402  (the JAX key-chain replay helpers)

torch.set_num_threads(2)

BF16 = {"compute_dtype": "bfloat16"}
CASES = [
    dict(),
    dict(log_scale=False),
    dict(out_dim=2, squeeze_scalar=False),
    dict(out_dim=2, squeeze_scalar=False, n_fourier=2),
    dict(siren=False),
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _fields(kw, seed=0):
    kw = {"num_layers": 3, "layer_size": 64, "in_dim": 2, **kw}
    j_field = j_make_field(JFieldConfig(**kw, **BF16))
    t_field = make_field(FieldConfig(**kw, **BF16))
    t_f32 = make_field(FieldConfig(**kw))
    j_params = j_field.init(jax.random.PRNGKey(seed))
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params))
    return j_field, t_field, t_f32, j_params, t_params


def _points(n=256, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 2)).astype(np.float32)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", ["apply", "apply_vhd", "apply_vjac"])
@pytest.mark.parametrize("kw", CASES)
def test_bf16_chain_matches_jax(kw, name):
    j_field, t_field, _, j_params, t_params = _fields(kw)
    x = _points()
    ours = _tuple(getattr(t_field, name)(t_params, torch.tensor(x)))
    ref = _tuple(getattr(j_field, name)(j_params, x))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel(a.numpy(), b) <= 1e-3, (name, _rel(a.numpy(), b))


def test_bf16_chain_stays_within_the_jax_bar_of_f32():
    _, t_field, t_f32, _, t_params = _fields({})
    x = torch.tensor(_points())
    for name in ("apply", "apply_vhd", "apply_vjac"):
        for a, b in zip(_tuple(getattr(t_field, name)(t_params, x)),
                        _tuple(getattr(t_f32, name)(t_params, x))):
            assert 0 < _rel(a.numpy(), b.numpy()) < 3e-2, name
    # every branch of the chain: vector output and the f32 Fourier block
    _, t_field, t_f32, _, t_params = _fields(dict(out_dim=2, squeeze_scalar=False,
                                                  n_fourier=2), seed=3)
    bars = (3e-2, 3e-2, 5e-2)
    for a, b, bar in zip(t_field.apply_vhd(t_params, x), t_f32.apply_vhd(t_params, x), bars):
        assert _rel(a.numpy(), b.numpy()) < bar


def test_bound_field_exposes_vjac():
    _, t_field, _, _, t_params = _fields({})
    x = torch.tensor(_points(16))
    bound = t_field.bind(t_params)
    for a, b in zip(bound.vjac(x), t_field.apply_vjac(t_params, x)):
        assert torch.equal(a, b)
    u, g, _ = bound.vhd(x)
    assert torch.equal(bound.vjac(x)[0], u) and torch.equal(bound.vjac(x)[1], g)


def test_bf16_gradients_are_f32_and_second_order_runs():
    _, t_field, _, _, t_params = _fields({})
    x = torch.tensor(_points(64))
    params = [p.requires_grad_() for p in tree_leaves(t_params)]

    def loss():
        u, _, hd = t_field.apply_vhd(t_params, x)
        return (hd.sum(-1) ** 2).mean() + (u ** 2).mean()

    g = torch.autograd.grad(loss(), params, create_graph=True)
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in g)
    gg = torch.autograd.grad(sum((t ** 2).sum() for t in g), params)
    assert all(bool(torch.isfinite(t).all()) for t in gg)


def _grad_setup(extra):
    saved = tt.SMALL
    tt.SMALL = saved + extra
    try:
        return tt._fixed_point_setup()
    finally:
        tt.SMALL = saved


@pytest.mark.parametrize("width", [[], ["--model.num_layers=3", "--model.layer_size=64"]])
def test_bf16_meta_gradient_matches_jax(width):
    (j_def, jp, j_lrs), (t_def, t_loss, tp, t_lrs), task_draws = _grad_setup(
        ["--model.compute_dtype=bfloat16"] + width)
    key = jax.random.PRNGKey(6)
    j_grad, _, (j_meta, _) = j_maml.multi_task_grad_and_losses(j_def, key, jp, j_lrs)
    batch = tt._batch([task_draws(k) for k in jax.random.split(key, j_def.n_batch_tasks)])
    t_grad, _, (t_meta, _) = maml.multi_task_grad_and_losses(
        t_def._replace(remat=False), t_loss, batch, tp, t_lrs)
    a = np.concatenate([t.detach().numpy().ravel() for t in tree_leaves(t_grad)])
    b = np.concatenate([np.asarray(t).ravel() for t in jax.tree_util.tree_leaves(j_grad)])
    assert _rel(a, b) <= 5e-3
    tt._close_trees(t_grad, j_grad, 2e-2)
    np.testing.assert_allclose(t_meta.numpy(), np.asarray(j_meta), rtol=1e-5)


def test_bf16_outer_step_matches_jax_train_step():
    argv = tt.SMALL + ["--model.compute_dtype=bfloat16"]
    jc, tc = tt._builds(argv)
    cfg = j_parse_overrides(JConfig(), argv)
    j_state, t_state = tt._start(tc, jc)
    key = jax.random.PRNGKey(11)
    out = jc["train_step"](key, *j_state)
    t_out = tc["step_core"](tt._jax_draws(jc["pde"], cfg, key), *t_state)
    tt._close_trees(t_out[0], out[0], 1e-5)
    tt._close_trees(t_out[1], out[1], 1e-2)
    np.testing.assert_allclose(float(t_out[6]), float(out[6]), rtol=1e-4)
    np.testing.assert_allclose(t_out[5][0].numpy(), np.asarray(out[5][0]), rtol=1e-5)
    np.testing.assert_allclose(t_out[4].numpy(), np.asarray(out[4]), rtol=1e-5)


def test_bf16_gemm_probe_on_the_cpu():
    """torch has no CPU kernel for the bf16 GEMM with an f32 output; the
    probe says so, and leaves the two checks that need it untried."""
    support = train_bench.bf16_gemm_support("cpu")
    assert support["kernel"] is not True
    assert support["vmap"] == support["double_backward"] == "no kernel"


def test_upcast_products_equal_an_f32_sum_of_bf16_products():
    """dot(a, w) is the product of the bf16-rounded operands, summed in
    f32: against a float64 sum of the same rounded operands, f32 round-off
    only; against the unrounded operands, bf16 rounding."""
    cfg = FieldConfig(**BF16)
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.normal(size=(64, 32)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(32, 16)).astype(np.float32))
    dot, store = siren._mixed_dots(cfg, a)
    exact = (a.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()).float()
    out = dot(a, w)
    assert out.dtype == torch.float32 and store(out).dtype == torch.bfloat16
    assert _rel(out.numpy(), exact.numpy()) < 1e-6 < _rel(out.numpy(), (a @ w).numpy())


def test_mixed_chain_restores_the_matmul_flags():
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    seen = []
    orig = siren._mixed_dots

    def spy(cfg, x):
        seen.append(mm.allow_tf32)
        return orig(cfg, x)

    try:
        mm.allow_tf32 = True
        siren._mixed_dots = spy
        _, t_field, t_f32, _, t_params = _fields({})
        x = torch.tensor(_points(8))
        t_field.apply(t_params, x)
        t_field.apply_vhd(t_params, x)
        t_f32.apply(t_params, x)
        assert seen == [False, False, True]
        assert mm.allow_tf32
    finally:
        siren._mixed_dots = orig
        mm.allow_tf32 = saved


def test_driver_differentiates_the_bf16_chain_with_tf32_off(monkeypatch):
    """The backward products of the bf16 chain keep f32 sums too: the
    meta-gradient and deployment's adaptation run inside the mixed scope,
    and the flag is the caller's again afterwards."""
    mm = torch.backends.cuda.matmul
    seen = []
    for name in ("multi_task_grad_and_losses", "single_task_rollout"):
        def spy(*args, _orig=getattr(maml, name), _name=name, **kw):
            seen.append((_name, mm.allow_tf32))
            return _orig(*args, **kw)
        monkeypatch.setattr(maml, name, spy)
    monkeypatch.setattr(mm, "allow_tf32", True)
    cfg = parse_overrides(Config(), tt.SMALL + ["--model.compute_dtype=bfloat16"])
    d = maml_driver.build(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    params, lrs = d["init_params"], d["inner_lrs"]
    d["train_step"](gen, params, lrs, d["outer_opt"].init(params), d["lr_opt"].init(lrs))
    tp = d["pde"].sample_params(gen)
    d["get_final_model"](gen, (params, lrs), tp, 1)
    assert {n for n, _ in seen} == {"multi_task_grad_and_losses", "single_task_rollout"}
    assert not any(flag for _, flag in seen), seen
    assert mm.allow_tf32


def test_bf16_field_dtypes_follow_the_config():
    """Params stay f32 under a bf16 config (cfg.dtype), as in the JAX package."""
    cfg = dataclasses.replace(FieldConfig(num_layers=2, layer_size=16), **BF16)
    p = make_field(cfg).init(torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))
    j_p = j_make_field(JFieldConfig(num_layers=2, layer_size=16, **BF16)).init(
        jax.random.PRNGKey(0))
    assert all(t.dtype == jnp.float32 for t in jax.tree_util.tree_leaves(j_p))
