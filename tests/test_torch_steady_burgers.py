"""Steady Burgers: metapde_tpu.pdes.steady_burgers against the PyTorch port
on shared inputs (JAX's task params, raw draws, points and field params),
and the family end to end on the CPU.

- Frozen factors: JAX's zero-key draws at every shape and scale the family
  freezes (Re (1,), the amplitudes (2, 2), the hole count, pore shapes
  (H, 2), sizes (H, 1) with the f32 bound max_hole_size / n_holes, centres
  (H, 2) with per-column bounds) equal the port's bit for bit, and with
  every vary_* off sample_params equals JAX's, the overlap pass included.
- overlap_pass on JAX's raw draws (the test replays sample_params' key
  splits): the same validity order, per-hole params bit for bit and the
  clamped n_holes, over 40 keys at max_holes 4 and 12.
- The task distribution over 2000 tasks against JAX's 2000: the mean
  Reynolds number within 0.25 (std of the mean ~0.06), the clamped hole
  counts' frequencies within 0.04.
- Samplers (sample_points and the batched draw): the five kinds at the
  point budget of the JAX package; inlet, outlet and walls on their edges
  in the box; every ring point on a valid pore's boundary (1e-5); no
  domain point inside a pore; the domain points' occupancy of 4 x 4 cells
  against JAX's on the same task, 40 x 1024 points an arm, within 0.01.
- loss_fn on JAX's params, points and field params (two outputs), the fused
  vhd path and the per-point jacfwd/jvp path: rtol 1e-5.
- The ground-truth cache round-trips a SteadyBurgersGroundTruth.
- A tiny maml_driver.run and leap_driver.run (through the CLIs) and
  deploy_bench of both algorithms and both protocols on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.config import TaskConfig as JTaskConfig
from metapde_tpu.models import make_field as j_make_field
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu_torch.cli import deploy_bench, leap_pde, maml_pde
from metapde_tpu_torch.config import FieldConfig, TaskConfig
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.models import make_field
from metapde_tpu_torch.pdes import frozen, get_pde
from metapde_tpu_torch.pdes.steady_burgers import in_any_hole, overlap_pass
from metapde_tpu_torch.solvers import fem_steady_burgers
from metapde_tpu_torch.train.gt_cache import GroundTruthCache
from metapde_tpu_torch.utils.trees import tree_stack

torch.set_num_threads(2)

ZERO = jnp.zeros(2, jnp.uint32)
# sbi10_2's task settings
SB = dict(pde="steady_burgers", max_holes=4, max_hole_size=0.3, max_reynolds=10.0)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _pdes(**kw):
    kw = {**SB, **kw}
    return j_get_pde(JTaskConfig(**kw)), get_pde(TaskConfig(**kw))


# --- frozen factors ------------------------------------------------------------

@pytest.mark.parametrize("max_holes", [1, 4, 12, 16])
def test_zero_key_draws_of_the_family_s_shapes_are_jax_s(max_holes):
    n = jax.random.randint(ZERO, (), 1, max_holes + 1)
    assert int(frozen.hole_count(max_holes)) == int(n)
    size_hi = 0.3 / n.astype(jnp.float32)
    lo = jnp.asarray([-1.0 + 0.45, -1.0 + 0.45])
    hi = jnp.asarray([1.0 - 0.45, 1.0 - 0.45])
    cases = [
        (frozen.uniform((1,), 0.0, 1.0), jax.random.uniform(ZERO, (1,))),
        (frozen.uniform((2, 2), -1.0, 1.0), jax.random.uniform(ZERO, (2, 2), minval=-1.0,
                                                               maxval=1.0)),
        (frozen.uniform((max_holes, 2), -0.2, 0.2),
         jax.random.uniform(ZERO, (max_holes, 2), minval=-0.2, maxval=0.2)),
        (frozen.uniform((max_holes, 1), 0.1, torch.tensor(0.3) / frozen.hole_count(max_holes)),
         jax.random.uniform(ZERO, (max_holes, 1), minval=0.1, maxval=size_hi)),
        (frozen.uniform((max_holes, 2), [-0.55, -0.55], [0.55, 0.55]),
         jax.random.uniform(ZERO, (max_holes, 2), minval=lo, maxval=hi)),
    ]
    for t, j in cases:
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("max_holes", [4, 12])
def test_frozen_task_is_jax_s(max_holes):
    kw = dict(vary_source=False, vary_bc=False, vary_geometry=False, bc_scale=2.0,
              max_holes=max_holes)
    j_pde, pde = _pdes(**kw)
    j = j_pde.sample_params(jax.random.PRNGKey(3))
    t = pde.sample_params(_gen(3))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_bits(a) if a.is_floating_point() else a.numpy(),
                                      _bits(b) if a.is_floating_point() else np.asarray(b))


def _jax_raw_draws(cfg, key):
    """sample_params' raw draws before the overlap pass (its key splits)."""
    max_holes = max(cfg.max_holes, 1)
    _, _, k3, k4, k5, k6 = jax.random.split(key, 6)
    n_holes = jax.random.randint(k3, (), 1, max_holes + 1)
    shapes = jax.random.uniform(k4, (max_holes, 2), minval=-0.2, maxval=0.2)
    sizes = jax.random.uniform(k5, (max_holes, 1), minval=0.1,
                               maxval=cfg.max_hole_size / n_holes.astype(jnp.float32))
    inset = 1.5 * cfg.max_hole_size
    d = cfg.domain
    x0y0 = jax.random.uniform(k6, (max_holes, 2),
                              minval=jnp.asarray([d.xmin + inset, d.ymin + inset]),
                              maxval=jnp.asarray([d.xmax - inset, d.ymax - inset]))
    return shapes, sizes, x0y0, n_holes


@pytest.mark.parametrize("max_holes, max_hole_size", [(4, 0.3), (12, 0.1)])
def test_overlap_pass_on_jax_s_raw_draws(max_holes, max_hole_size):
    cfg = JTaskConfig(**{**SB, "max_holes": max_holes, "max_hole_size": max_hole_size})
    j_pde = j_get_pde(cfg)
    clamped = 0
    for s in range(40):
        key = jax.random.PRNGKey(s)
        shapes, sizes, x0y0, n = _jax_raw_draws(cfg, key)
        php, nh = overlap_pass(_t(shapes), _t(sizes), _t(x0y0), _t(n), max_hole_size)
        _, _, j_php, j_nh = j_pde.sample_params(key)
        np.testing.assert_array_equal(_bits(php), _bits(j_php))
        assert int(nh) == int(j_nh)
        clamped += int(nh) < int(n)
    assert clamped > 0  # the pass rejected holes for some keys


def test_task_distribution_matches_jax():
    j_pde, pde = _pdes()
    j = jax.vmap(j_pde.sample_params)(jax.random.split(jax.random.PRNGKey(0), 2000))
    gen = _gen(0)
    t = [pde.sample_params(gen) for _ in range(2000)]
    j_re, t_re = np.asarray(j[0][:, 0]), np.array([float(p[0][0]) for p in t])
    assert abs(j_re.mean() - t_re.mean()) < 0.25
    assert t_re.min() >= 1.0 and t_re.max() <= 10.0
    j_n, t_n = np.asarray(j[3]), np.array([int(p[3]) for p in t])
    for k in range(1, 5):
        assert abs((j_n == k).mean() - (t_n == k).mean()) < 0.04
    bc = torch.stack([p[1] for p in t])
    assert bc.shape == (2000, 2, 2) and float(bc.abs().max()) <= 1.0


# --- samplers --------------------------------------------------------------------

def _jax_in_hole(xy, php, nh):
    """JAX's membership test (metapde_tpu/pdes/steady_burgers.py:110-125)."""
    c1, c2, x0, y0, size = (php[None, :, i] for i in range(5))
    vx, vy = xy[:, :1] - x0, xy[:, 1:] - y0
    theta = np.arctan2(vx, vy)
    r0 = size * (1.0 + c1 * np.cos(4 * theta) + c2 * np.cos(8 * theta))
    return np.any((r0 > np.sqrt(vx ** 2 + vy ** 2) + 1e-7) & (np.arange(php.shape[0]) < nh),
                  axis=1)


def _check_kinds(kinds, php, nh, n):
    inlet, outlet, walls, rings, dom = (k.numpy() for k in kinds)
    assert [k.shape[0] for k in (inlet, outlet, walls, rings, dom)] == [
        max(n // 12, 1), max(n // 12, 1), max(n // 6, 2),
        max(n // 2 - max(n // 6, 2) - 2 * max(n // 12, 1), 1), n]
    assert np.all(inlet[:, 0] == -1.0) and np.all(outlet[:, 0] == 1.0)
    for e in (inlet, outlet):
        assert np.all(np.abs(e[:, 1]) <= 1.0)
    assert np.all(np.abs(walls[:, 1]) == 1.0) and np.all(np.abs(walls[:, 0]) <= 1.0)
    assert (walls[:, 1] == 1.0).sum() == walls.shape[0] // 2
    # every ring point on the boundary of a valid pore
    v = rings[:, None, :] - php[None, :nh, 2:4]
    r = np.linalg.norm(v, axis=-1)
    theta = np.arctan2(v[..., 0], v[..., 1])
    r0 = php[None, :nh, 4] * (1 + php[None, :nh, 0] * np.cos(4 * theta)
                              + php[None, :nh, 1] * np.cos(8 * theta))
    assert np.all(np.min(np.abs(r - r0), axis=1) < 1e-5)
    assert not np.any(_jax_in_hole(dom, php, nh))
    assert np.all(np.abs(dom) <= 1.0)


def test_samplers_respect_the_pores_and_the_edges():
    _, pde = _pdes()
    gen = _gen(4)
    params = [pde.sample_params(gen) for _ in range(3)]
    for p in params:
        _check_kinds(pde.sample_points(gen, 96, p), p[2].numpy(), int(p[3]), 96)
    batched = pde.sample_points_batched(gen, 96, tree_stack(params), 2)
    for kind in batched:
        assert kind.shape[:2] == (3, 2) and kind.shape[-1] == 2
    for i, p in enumerate(params):
        for s in range(2):
            _check_kinds(tuple(k[i, s] for k in batched), p[2].numpy(), int(p[3]), 96)


def test_in_any_hole_equals_jax_s_test():
    _, pde = _pdes(max_holes=12, max_hole_size=0.2)
    p = pde.sample_params(_gen(2))
    xy = torch.rand((1, 20000, 2), generator=_gen(3)) * 2 - 1
    got = in_any_hole(xy, p[2][None], p[3].reshape(1))[0].numpy()
    want = _jax_in_hole(xy[0].numpy(), p[2].numpy(), int(p[3]))
    assert np.array_equal(got, want) and 0.005 < want.mean() < 0.9


def _cells(xy):
    idx = np.clip(((xy + 1) * 2).astype(int), 0, 3)
    return np.bincount(idx[:, 0] * 4 + idx[:, 1], minlength=16) / len(xy)


def test_domain_draws_match_jax_s_distribution():
    j_pde, pde = _pdes()
    jp = j_pde.sample_params(jax.random.PRNGKey(6))
    tp = tree_stack([tuple(_t(a) for a in jp)])
    t = pde.sample_points_batched(_gen(6), 1024, tp, 40)[4].reshape(-1, 2).numpy()
    j = np.asarray(jax.vmap(lambda k: j_pde.sample_points(k, 1024, jp)[4])(
        jax.random.split(jax.random.PRNGKey(7), 40))).reshape(-1, 2)
    assert np.abs(_cells(t) - _cells(j)).max() < 0.01


# --- losses ----------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["vhd", "operators"])
def test_loss_fn_matches_jax(branch):
    j_pde, pde = _pdes()
    jp = j_pde.sample_params(jax.random.PRNGKey(0))
    pts = j_pde.sample_points(jax.random.PRNGKey(1), 256, jp)
    kw = dict(num_layers=3, layer_size=32, in_dim=2, out_dim=2, squeeze_scalar=False)
    j_field, field = j_make_field(JFieldConfig(**kw)), make_field(FieldConfig(**kw))
    j_fp = j_field.init(jax.random.PRNGKey(2))
    fp = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_fp))
    if branch == "vhd":
        j_fn, fn = j_field.bind(j_fp), field.bind(fp)
        assert hasattr(fn, "vhd")
    else:
        j_fn, fn = (lambda x: j_field.apply(j_fp, x)), (lambda x: field.apply(fp, x))
    j_out = j_pde.loss_fn(j_fn, pts, jp)
    out = pde.loss_fn(fn, tuple(_t(p) for p in pts), tuple(_t(a) for a in jp))
    for a, b in zip(out, j_out):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5)


# --- the ground-truth cache ---------------------------------------------------------

def test_cache_round_trips_a_steady_burgers_ground_truth(tmp_path):
    _, pde = _pdes()
    params = pde.sample_params(_gen(0))
    cache = GroundTruthCache(str(tmp_path))
    gt = cache.get_or_solve(pde, params, 8)
    assert isinstance(gt, fem_steady_burgers.SteadyBurgersGroundTruth)
    again = GroundTruthCache(str(tmp_path))
    back = again.get_or_solve(pde, params, 8)
    assert (again.hits, again.solves) == (1, 0)
    for name in gt._fields:
        assert torch.equal(getattr(back, name), getattr(gt, name)), name
    assert pde.gt_version == 2


# --- end to end on the CPU ------------------------------------------------------------

TINY = ["--device=cpu", "--task.pde=steady_burgers", "--task.max_holes=4",
        "--task.max_hole_size=0.3", "--task.max_reynolds=10", "--train.viz_every=0",
        "--task.inner_points=64", "--task.outer_points=64", "--task.validation_points=64",
        "--task.n_eval=2", "--solver.ground_truth_resolution=8", "--model.num_layers=2",
        "--model.layer_size=16", "--train.outer_steps=2", "--train.log_every=1"]


@pytest.mark.parametrize("algo", ["maml", "leap"])
def test_train_and_deploy_end_to_end_on_the_cpu(tmp_path, algo):
    cli = {"maml": maml_pde, "leap": leap_pde}[algo]
    cli.main(TINY + [f"--train.out_dir={tmp_path}", "--train.expt_name=r",
                     f"--{algo}.bsize=2", f"--{algo}.inner_steps=2"])
    run = tmp_path / "r"
    recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["val_rel_err"]) for r in recs)
    assert len(recs[-1]["per_dim_rel_err"]) == 2  # two outputs, no mirror
    for extra in ([], ["--deploy.optimizer=adam"]):
        rows = deploy_bench.main(["--device=cpu", f"--algo={algo}", f"--from_run={run}",
                                  "--inner-steps-list=0,2", "--repeats=1"] + extra)
        assert [r["inner_steps"] for r in rows] == [0, 2]
        assert all(np.isfinite(r["val_rel_err_median"]) for r in rows)
    # two eval tasks of training and two of deployment, each solved once
    assert len(list((tmp_path / "gt_cache_torch").glob("steady_burgers_*.npz"))) == 4
