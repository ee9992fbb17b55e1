"""SIREN field and fused-inference parity: metapde_tpu against metapde_tpu_torch.

Shared inputs: params made by the JAX package's init and carried over with
interop.params_from_numpy; points from a numpy seed. Tolerance 1e-5 in f32
(the bar of tests/test_pallas_siren.py), taken relative to each output's
largest magnitude for the Hessian diagonal, which carries omega^2 = 900.
The Pallas kernel runs in interpret mode on the CPU, as its own tests run it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.models import make_field as j_make_field
from metapde_tpu.ops import pallas_siren
from metapde_tpu_torch.config import FieldConfig
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.models import make_field, siren
from metapde_tpu_torch.models.siren import field_apply_vhd
from metapde_tpu_torch.ops import siren_fused
from metapde_tpu_torch.utils import spans
from metapde_tpu_torch.utils.trees import tree_map

torch.set_num_threads(1)

TOL = 1e-5

FIELD_CASES = [
    dict(),
    dict(log_scale=False),
    dict(out_dim=2, squeeze_scalar=False),
    dict(num_layers=8),
    dict(siren=False),
    dict(n_fourier=3),
]


def _pair(kw, seed=0):
    """(jax field, torch field, jax params, torch params) for one config."""
    kw = {"num_layers": 3, "layer_size": 64, "in_dim": 2, **kw}
    j_field, t_field = j_make_field(JFieldConfig(**kw)), make_field(FieldConfig(**kw))
    j_params = j_field.init(jax.random.PRNGKey(seed))
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params))
    return j_field, t_field, j_params, t_params


def _points(n, d=2, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(np.float32)


def _close(actual, expected, rel=False):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape
    scale = max(np.abs(expected).max(), 1.0) if rel else 1.0
    assert np.abs(actual - expected).max() <= TOL * scale


@pytest.mark.parametrize("kw", FIELD_CASES)
def test_field_apply_matches_jax(kw):
    j_field, t_field, j_params, t_params = _pair(kw)
    x = _points(300)
    _close(t_field.apply(t_params, torch.tensor(x)), j_field.apply(j_params, x))


@pytest.mark.parametrize("kw", FIELD_CASES)
def test_field_apply_vhd_matches_jax(kw):
    j_field, t_field, j_params, t_params = _pair(kw)
    x = _points(200)
    for a, b in zip(t_field.apply_vhd(t_params, torch.tensor(x)),
                    j_field.apply_vhd(j_params, x)):
        _close(a, b, rel=True)


@pytest.mark.parametrize("kw", [dict(), dict(siren=False), dict(n_fourier=2)])
def test_field_apply_vhd_matches_autograd(kw):
    _, t_field, _, t_params = _pair(kw)
    cfg = t_field.cfg
    x = torch.tensor(_points(16), dtype=torch.float64)
    p64 = tree_map(lambda t: t.double(), t_params)
    u, g, hd = field_apply_vhd(p64, x, cfg)
    f = lambda xi: t_field.apply(p64, xi[None])[0]
    for i in range(x.shape[0]):
        np.testing.assert_allclose(g[i].numpy(), torch.func.grad(f)(x[i]).numpy(),
                                   rtol=1e-9, atol=1e-9)
        hess = torch.func.hessian(f)(x[i])
        np.testing.assert_allclose(hd[i].numpy(), torch.diagonal(hess).numpy(),
                                   rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(u.numpy(), t_field.apply(p64, x).numpy(), rtol=1e-12)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(log_scale=False), dict(out_dim=2, squeeze_scalar=False),
     dict(num_layers=8)],
)
def test_fused_reference_matches_pallas_kernel(kw):
    j_field, _, j_params, t_params = _pair(kw)
    cfg = dataclasses.replace(FieldConfig(), **{"num_layers": 3, "layer_size": 64, **kw})
    j_cfg = j_field.cfg
    x = _points(1500)
    u_kernel = pallas_siren.siren_apply_fused(j_params, x, j_cfg)
    u_ref = siren_fused.siren_apply_fused_reference(t_params, torch.tensor(x), cfg)
    _close(u_ref, u_kernel)


def test_dispatcher_falls_back_for_fourier():
    _, t_field, _, t_params = _pair(dict(n_fourier=3, use_pallas_inference=True))
    x = torch.tensor(_points(64))
    before = spans.counter("siren_fused.launches")
    u = t_field.apply_inference(t_params, x)
    np.testing.assert_allclose(u.numpy(), t_field.apply(t_params, x).numpy(), atol=1e-6)
    assert spans.counter("siren_fused.launches") == before


def test_dispatcher_opt_in():
    """Off by default; when on, it agrees with apply (on the CPU the wrapper
    takes the plain version, so no launch is counted)."""
    x = torch.tensor(_points(300))
    _, t_off, _, p = _pair(dict())
    _, t_on, _, _ = _pair(dict(use_pallas_inference=True))
    calls = []
    orig = siren_fused.siren_apply_fused_batched
    try:
        siren_fused.siren_apply_fused_batched = lambda *a, **k: calls.append(1) or orig(*a, **k)
        u_off = t_off.apply_inference(p, x)
        assert calls == []
        u_on = t_on.apply_inference(p, x)
        assert calls == [1]
    finally:
        siren_fused.siren_apply_fused_batched = orig
    _close(u_on, t_on.apply(p, x))
    _close(u_off, t_off.apply(p, x))
    assert spans.counter("siren_fused.launches") == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, t_field, _, p = _pair(dict())
    cfg = t_field.cfg
    x = torch.tensor(_points(8))
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent fallback
        siren_fused.siren_apply_fused(
            tree_map(lambda t: t.to("meta"), p), x.to("meta"), cfg)
    with pytest.raises(ValueError):
        siren_fused.siren_apply_fused(p, x.double(), cfg)
    with pytest.raises(ValueError):
        siren_fused.siren_apply_fused(p, torch.zeros(8, 3), cfg)
    _, wide, _, pw = _pair(dict(layer_size=130))
    with pytest.raises(ValueError):
        siren_fused.siren_apply_fused(pw, x, wide.cfg)


# configs of the batched tests: the four of test_pallas_siren.py and width
# 128; N = 1000 is ragged against the kernel's 64-point tiles
BATCHED_CASES = [
    (dict(), 300),
    (dict(log_scale=False), 300),
    (dict(out_dim=2, squeeze_scalar=False), 300),
    (dict(num_layers=8), 300),
    (dict(layer_size=128), 1000),
]


def _stacked_pair(kw, n_tasks):
    """(jax field, torch config, numpy params, torch params) for n_tasks
    tasks: a JAX init per task, biases and log scales moved by numpy noise so
    that no two tasks share a leaf, stacked on a leading task axis."""
    kw = {"num_layers": 3, "layer_size": 64, "in_dim": 2, **kw}
    j_field = j_make_field(JFieldConfig(**kw))
    rng = np.random.default_rng(4)

    def one(seed):
        p = jax.tree_util.tree_map(np.asarray, j_field.init(jax.random.PRNGKey(seed)))
        for layer in p["layers"]:
            layer["b"] = layer["b"] + rng.normal(0, 0.1, layer["b"].shape).astype(np.float32)
        for key in ("log_in_scale", "log_out_scale"):
            if key in p:
                p[key] = p[key] + rng.normal(0, 0.1, p[key].shape).astype(np.float32)
        return p

    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *[one(s) for s in range(n_tasks)])
    return j_field, FieldConfig(**kw), stacked, params_from_numpy(stacked)


def _task_points(n_tasks, n, seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n_tasks, n, 2)).astype(np.float32)


@pytest.mark.parametrize("shared", [False, True], ids=["per_task", "shared"])
@pytest.mark.parametrize("kw,n", BATCHED_CASES)
def test_batched_reference_matches_vmapped_pallas_kernel(kw, n, shared):
    """The batched plain version against the JAX package's Pallas kernel
    under jax.vmap (in_axes (0, 0) per task, (None, 0) shared)."""
    j_field, cfg, stacked, t_stacked = _stacked_pair(kw, 3)
    xs = _task_points(3, n)
    kernel = lambda p, x: pallas_siren.siren_apply_fused(p, x, j_field.cfg)
    if shared:
        u_kernel = jax.vmap(kernel, in_axes=(None, 0))(
            jax.tree_util.tree_map(lambda a: a[0], stacked), xs)
        t_params = tree_map(lambda t: t[0], t_stacked)
    else:
        u_kernel = jax.vmap(kernel, in_axes=(0, 0))(stacked, xs)
        t_params = t_stacked
    u_ref = siren_fused.siren_apply_fused_batched_reference(
        t_params, torch.tensor(xs), cfg, shared=shared)
    _close(u_ref, u_kernel)


@pytest.mark.parametrize("kw", [dict(), dict(out_dim=2, squeeze_scalar=False)])
def test_batched_reference_equals_per_task_bit_for_bit(kw):
    _, cfg, _, p = _stacked_pair(kw, 3)
    x = torch.tensor(_task_points(3, 300))
    per_task = torch.stack([
        siren_fused.siren_apply_fused_reference(tree_map(lambda t: t[i], p), x[i], cfg)
        for i in range(3)])
    assert torch.equal(siren_fused.siren_apply_fused_batched_reference(p, x, cfg), per_task)
    one = tree_map(lambda t: t[0], p)
    shared = torch.stack([siren_fused.siren_apply_fused_reference(one, x[i], cfg)
                          for i in range(3)])
    assert torch.equal(
        siren_fused.siren_apply_fused_batched_reference(one, x, cfg, shared=True), shared)


@pytest.mark.parametrize("shared", [False, True], ids=["per_task", "shared"])
@pytest.mark.parametrize("kw,kernel", [
    (dict(use_pallas_inference=True), True),
    (dict(), False),
    (dict(n_fourier=3, use_pallas_inference=True), False),
])
def test_batched_dispatcher(kw, kernel, shared, monkeypatch):
    """apply_inference_batched takes the batched kernel wrapper under the
    JAX dispatcher's gate, else field_apply task by task; both agree with
    apply on each task."""
    _, cfg, _, p = _stacked_pair(kw, 3)
    field = make_field(cfg)
    if shared:
        p = tree_map(lambda t: t[0], p)
    x = torch.tensor(_task_points(3, 64))
    calls = []
    orig = siren_fused.siren_apply_fused_batched
    monkeypatch.setattr(siren_fused, "siren_apply_fused_batched",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    u = field.apply_inference_batched(p, x, shared=shared)
    assert calls == ([{"shared": shared}] if kernel else [])
    for i in range(3):
        _close(u[i], field.apply(p if shared else tree_map(lambda t: t[i], p), x[i]))
    assert spans.counter("siren_fused.launches") == 0


def test_batched_wrapper_rejects_wrong_batch_shapes_and_dtypes():
    _, cfg, _, p = _stacked_pair(dict(), 3)
    x = torch.tensor(_task_points(3, 8))
    f = siren_fused.siren_apply_fused_batched
    assert f(p, x, cfg).shape == (3, 8)
    for bad_x in (x[0], x.double(), x[:2], torch.zeros(3, 8, 3)):
        with pytest.raises(ValueError):
            f(p, bad_x, cfg)
    with pytest.raises(ValueError):  # stacked params called as shared
        f(p, x, cfg, shared=True)
    with pytest.raises(ValueError):  # one set of params called as stacked
        f(tree_map(lambda t: t[0], p), x, cfg)
    with pytest.raises(ValueError):
        f(tree_map(lambda t: t.double(), p), x, cfg)
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent fallback
        f(tree_map(lambda t: t.to("meta"), p), x.to("meta"), cfg)
    assert spans.counter("siren_fused.launches") == 0


def test_init_distribution_bounds():
    cfg = FieldConfig(num_layers=3, layer_size=64)
    p = make_field(cfg).init(torch.Generator().manual_seed(0))
    w0, w1, wo = p["layers"][0]["w"], p["layers"][1]["w"], p["layers"][-1]["w"]
    assert w0.shape == (2, 64) and w1.shape == (64, 64) and wo.shape == (64, 1)
    assert float(w0.abs().max()) <= 0.5  # (omega0/omega) / fan_in
    b = np.sqrt(6.0 / 64) / 30.0
    assert float(w1.abs().max()) <= b and float(w1.abs().max()) > 0.9 * b
    assert all(float(l["b"].abs().max()) == 0.0 for l in p["layers"])
    np.testing.assert_allclose(p["log_in_scale"].numpy(), np.log(0.1), rtol=1e-6)


def test_bf16_config_runs_near_f32():
    """A bf16 config runs the mixed chain (tests/test_torch_mixed_precision.py
    holds it against the JAX package) and returns f32 values near the f32
    chain's."""
    _, t_field, _, p = _pair(dict(compute_dtype="bfloat16"))
    _, t_f32, _, _ = _pair(dict())
    x = torch.tensor(_points(64))
    u, u32 = t_field.apply(p, x), t_f32.apply(p, x)
    assert u.dtype == torch.float32 and u.shape == u32.shape
    assert 0 < float(torch.linalg.norm(u - u32) / torch.linalg.norm(u32)) < 3e-2


@pytest.mark.parametrize("batched", [False, True])
def test_kernel_gate_ignores_compute_dtype(batched, monkeypatch):
    """The JAX dispatcher's gate has no compute_dtype condition: under bf16
    the fused kernel (f32, as the Pallas kernel) takes inference, once per
    call. On the same params it equals the port's f32 path and the JAX
    package's apply_inference (the Pallas kernel in interpret mode), 1e-5."""
    kw = dict(use_pallas_inference=True, compute_dtype="bfloat16")
    j_field, t_field, j_params, t_params = _pair(kw)
    _, t_f32, _, _ = _pair(dict(use_pallas_inference=True))
    assert siren._kernel_fits(t_field.cfg)
    calls = []
    orig = siren_fused.siren_apply_fused_batched
    monkeypatch.setattr(siren_fused, "siren_apply_fused_batched",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x = _points(300)
    if batched:
        u = t_field.apply_inference_batched(t_params, torch.tensor(x)[None], shared=True)[0]
        u32 = t_f32.apply_inference_batched(t_params, torch.tensor(x)[None], shared=True)[0]
    else:
        u = t_field.apply_inference(t_params, torch.tensor(x))
        u32 = t_f32.apply_inference(t_params, torch.tensor(x))
    assert calls == [1, 1]
    assert u.dtype == torch.float32
    _close(u, u32)
    _close(u, j_field.apply_inference(j_params, x))


def test_sine_sass_counts_the_fast_path():
    """cli/sine_sass follows the first conditional branch from the load to
    the store and leaves out convergence markers, on a listing in
    cuobjdump's format."""
    from metapde_tpu_torch.cli import sine_sass

    code = ["LDG.E R11, desc[UR6][R8.64]", "BSSY B0, 0x0070",
            "FSETP.GT.AND P0, PT, |R11|, 8192, PT", "@!P0 MUFU.SIN R0, R11",
            "@!P0 BRA 0x0080", "CALL.REL.NOINC 0x00a0", "FMUL R0, R11, 2",
            "BSYNC B0", "STG.E desc[UR6][R8.64], R0", "EXIT", "FFMA R0, R0, R0, RZ",
            "NOP"]
    listing = "\t\tFunction : probe\n" + "".join(
        f"        /*{16 * i:04x}*/  {ins} ;  /* 0x0 */\n" for i, ins in enumerate(code))
    found = sine_sass.instructions(listing, "probe")
    assert [ins for _, ins in found] == code
    assert sine_sass.fast_path(found) == code[2:5]
