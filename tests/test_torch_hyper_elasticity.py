"""Hyperelasticity: metapde_tpu.pdes.hyper_elasticity and the training
slice around it against the PyTorch port, on shared inputs (JAX's task
params, points and field params, or numpy from a seed).

- Frozen factors: JAX's zero-key draws at the family's scales equal the
  port's bit for bit; with vary_bc=false (em7_9, lde2_3) every task's
  Young's modulus is JAX's (f32 bits 1066104277, 1.0895334), and a frozen
  source or pore draw equals JAX's; a frozen pore draw that fails the wall
  bound raises (the JAX loop never ends there).
- ligament_resolution_floor and effective_resolution: equal to JAX's on
  numpy-seeded pore lattices and on JAX's tasks.
- sample_params: every task clears the wall bound; the pore scale's mean
  and spread against JAX's over 1000 tasks each (within 0.02 of the
  range).
- The samplers' nearest-pore membership test equals the JAX sampler's test
  over every pore, on uniform points and points within 1e-6 of a boundary.
- Samplers (sample_points and the batched training draw): six kinds of n
  points; no domain or edge point inside a pore; edge points on their
  edge; ring points inside the box and on a pore boundary (within 1e-5);
  the domain points' occupancy of 4 x 4 cells against JAX's on the same
  task, 40 x 1024 points an arm, within 0.01 (a cell's binomial std
  ~1.2e-3).
- loss_fn on JAX's params, points and field params, the fused .vjac branch
  and the per-point Jacobian branch: rtol 1e-5.
- The committed runs: em7_9's and lde2_3's checkpoints loaded through the
  port equal the pickles' leaves.
- One MAML outer step (step_core) from em7_9's checkpoint_step_500001
  (8x64, both Adam states) on JAX's own draws, cut to bsize 2 and 64
  points: params and inner LRs within 1e-4 of each leaf's scale, the
  meta-gradients (from the new Adam moments) within 1e-4 of each leaf's
  largest entry, meta-losses rtol 1e-4. (From a fresh Adam the first step is
  lr * g / (|g| + 1e-8), which turns f32 noise in a gradient entry near
  1e-8 into a visible difference of the inner LRs, whose Adam runs at lr
  0.5; tests/test_torch_energy.py takes LEAP's step from lde2_3.)
- The ground-truth cache round-trips an ElasticityGroundTruth with every
  field, final_energy and final_gnorm included.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.config import TaskConfig as JTaskConfig
from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.models import make_field as j_make_field
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.pdes.hyper_elasticity import ligament_resolution_floor as j_floor
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import maml_driver as j_maml_driver
from metapde_tpu_torch.cli import deploy_bench
from metapde_tpu_torch.config import FieldConfig, TaskConfig, load_run_config
from metapde_tpu_torch.config import parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.meta import leap, maml
from metapde_tpu_torch.models import make_field
from metapde_tpu_torch.pdes import frozen, get_pde
from metapde_tpu_torch.pdes import hyper_elasticity as he
from metapde_tpu_torch.pdes.hyper_elasticity import ligament_resolution_floor
from metapde_tpu_torch.solvers import fem_elasticity
from metapde_tpu_torch.train import checkpoints, leap_driver, maml_driver, optimizers
from metapde_tpu_torch.train.gt_cache import GroundTruthCache
from metapde_tpu_torch.utils.trees import tree_leaves, tree_stack

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EM7_9 = REPO / "results_elasticity_maml" / "em7_9"
LDE2_3 = REPO / "results_elasticity_leap" / "lde2_3"
ZERO = jnp.zeros(2, jnp.uint32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _pdes(run=EM7_9, **kw):
    j_task = j_load_run_config(str(run)).task
    t_task = load_run_config(str(run)).task
    if kw:
        import dataclasses

        j_task, t_task = dataclasses.replace(j_task, **kw), dataclasses.replace(t_task, **kw)
    return j_get_pde(j_task), get_pde(t_task)


# --- frozen factors ------------------------------------------------------------

@pytest.mark.parametrize("shape, lo, hi", [((2,), 0.25, 0.75), ((2,), 0.9, 1.1),
                                           ((1,), -0.1, 0.1), ((1,), 0.2, 1.5),
                                           ((1,), 0.1, 0.75)])
def test_zero_key_draws_at_the_family_s_scales_are_jax_s(shape, lo, hi):
    np.testing.assert_array_equal(
        _bits(frozen.uniform(shape, lo, hi)),
        _bits(jax.random.uniform(ZERO, shape, minval=lo, maxval=hi)))


@pytest.mark.parametrize("flag, idx", [("vary_source", 0), ("vary_bc", 1),
                                       ("vary_geometry", 2)])
def test_frozen_factor_is_jax_s(flag, idx):
    # max_hole_size 0.5: the frozen pore draw clears the wall bound
    kw = dict(pde="hyper_elasticity", max_holes=5, max_hole_size=0.5, bc_scale=2.0,
              **{flag: False})
    j = j_get_pde(JTaskConfig(**kw)).sample_params(jax.random.PRNGKey(3))
    t = get_pde(TaskConfig(**kw)).sample_params(_gen(3))
    np.testing.assert_array_equal(_bits(t[idx]), _bits(j[idx]))


@pytest.mark.parametrize("run", [EM7_9, LDE2_3])
def test_committed_runs_share_jax_s_young_modulus(run):
    j_pde, pde = _pdes(run)
    gen = _gen(0)
    mods = [pde.sample_params(gen)[1] for _ in range(4)]
    j_mods = [j_pde.sample_params(k)[1] for k in jax.random.split(jax.random.PRNGKey(0), 4)]
    for m, jm in zip(mods, j_mods):
        assert _bits(m).tolist() == _bits(jm).tolist()
    assert _bits(mods[0][:1]).tolist() == [1066104277]
    assert float(mods[0][0]) == pytest.approx(1.0895334, abs=1e-7)


def test_a_frozen_infeasible_pore_draw_raises():
    pde = get_pde(TaskConfig(pde="hyper_elasticity", max_holes=5, max_hole_size=1.0,
                             vary_geometry=False))
    with pytest.raises(ValueError, match="wall bound"):
        pde.sample_params(_gen(0))


# --- the ligament floor and the task distribution --------------------------------

def test_ligament_floor_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        php = np.zeros((25, 5), np.float32)
        php[:, :2] = rng.uniform(-0.1, 0.1, (25, 2)) * rng.integers(0, 2)
        php[:, 4] = rng.uniform(0.0, 0.125)
        for res, cap in ((8, 192), (32, 192), (32, 96)):
            assert (ligament_resolution_floor(torch.tensor(php), 0.25, 1.0, res, cap)
                    == j_floor(php, 0.25, 1.0, res, cap))


def test_effective_resolution_matches_jax_on_jax_s_tasks():
    j_pde, pde = _pdes()
    floors = []
    for k in jax.random.split(jax.random.PRNGKey(5), 12):
        jp = j_pde.sample_params(k)
        tp = tuple(_t(a) for a in jp)
        floors.append(pde.effective_resolution(tp, 32))
        assert floors[-1] == j_pde.effective_resolution(jp, 32)
    assert max(floors) > 32  # some tasks need the floor


def test_task_distribution_matches_jax():
    j_pde, pde = _pdes()
    gen = _gen(1)
    t = np.array([float(pde.sample_params(gen)[2][0, 4]) for _ in range(1000)])
    j = np.asarray(jax.vmap(j_pde.sample_params)(
        jax.random.split(jax.random.PRNGKey(1), 1000))[2][:, 0, 4])
    r0 = 0.25 / np.sqrt(2 * np.pi)
    for sizes in (t, j):  # pore scale in [0.2, 1.5], cut by the wall bound
        assert sizes.min() >= 0.2 * r0 - 1e-7 and (0.25 - 2 * sizes).min() >= 0.05 * 0.25 - 1e-6
    span = (1.5 - 0.2) * r0
    assert abs(t.mean() - j.mean()) < 0.02 * span
    assert abs(t.std() - j.std()) < 0.02 * span


# --- samplers --------------------------------------------------------------------

def _in_pore(xy, php):
    d = np.linalg.norm(xy[:, None, :] - php[None, :, 2:4], axis=-1)
    return (d < php[None, :, 4] - 1e-6).any(axis=1)


def _check_kinds(kinds, php, n):
    top, bottom, left, right, ring, dom = (np.asarray(k) for k in kinds)
    for pts, axis, val in ((top, 1, 1.0), (bottom, 1, 0.0), (left, 0, 0.0), (right, 0, 1.0)):
        assert pts.shape == (n, 2)
        assert np.all(pts[:, axis] == val) and not _in_pore(pts, php).any()
    assert dom.shape == (n, 2) and not _in_pore(dom, php).any()
    assert ((dom >= 0) & (dom <= 1)).all()
    assert ((ring > 0) & (ring < 1)).all()
    d = np.linalg.norm(ring[:, None, :] - php[None, :, 2:4], axis=-1) - php[None, :, 4]
    assert np.abs(d).min(axis=1).max() < 1e-5


def test_samplers_respect_the_pores_and_the_edges():
    j_pde, pde = _pdes()
    jp = j_pde.sample_params(jax.random.PRNGKey(2))
    tp = tuple(_t(a) for a in jp)
    php = np.asarray(jp[2])
    _check_kinds(pde.sample_points(_gen(3), 256, tp), php, 256)
    batched = pde.sample_points_batched(_gen(4), 128, tree_stack([tp, tp]), 3)
    assert [tuple(k.shape) for k in batched] == [(2, 3, 128, 2)] * 6
    for t in range(2):
        for s in range(3):
            _check_kinds([k[t, s] for k in batched], php, 128)
    # JAX's own draws pass the same checks
    _check_kinds(j_pde.sample_points(jax.random.PRNGKey(3), 256, jp), php, 256)


def _jax_in_pores(xy, php, nh):
    """The JAX sampler's membership rule (_mask_pore_points: is_in_hole
    vmapped over points and pores, then the n_holes mask), on rows of
    points xy [rows, C, 2] with pores php [rows, H, 5]."""
    def is_in_hole(p, pore, tol=1e-7):
        c1, c2, x0, y0, size = (pore[i] for i in range(5))
        vx, vy = p[0] - x0, p[1] - y0
        theta = jnp.arctan2(vx, vy)
        length = jnp.sqrt(vx ** 2 + vy ** 2)
        r0 = size * (1.0 + c1 * jnp.cos(4 * theta) + c2 * jnp.cos(8 * theta))
        return r0 > length + tol

    def row(xy_r, php_r, nh_r):
        inside = jax.vmap(jax.vmap(is_in_hole, in_axes=(0, None)), in_axes=(None, 0),
                          out_axes=1)(xy_r, php_r)
        return jnp.any(inside & (jnp.arange(php_r.shape[0])[None, :] < nh_r), axis=1)

    return torch.from_numpy(np.asarray(jax.vmap(row)(
        jnp.asarray(xy.numpy()), jnp.asarray(php.numpy()), jnp.asarray(nh.numpy()))))


@pytest.mark.parametrize("run", [EM7_9, LDE2_3])
def test_nearest_pore_test_equals_the_test_over_every_pore(run):
    """The samplers' membership test for the family's layout against the
    JAX sampler's test over all pores, on uniform points and on points
    within 1e-6 of every pore's boundary."""
    _, pde = _pdes(run)
    cfg = load_run_config(str(run)).task
    gen = _gen(9)
    php = torch.stack([pde.sample_params(gen)[2] for _ in range(8)])
    nh = torch.full((8,), 25, dtype=torch.int32)
    theta = torch.rand(8, 25, 400, generator=gen) * 2 * np.pi
    r = php[:, :, 4:5] * (1 + 2e-6 * (torch.rand(8, 25, 400, generator=gen) - 0.5))
    ring = torch.stack([php[:, :, 2:3] + r * torch.cos(theta),
                        php[:, :, 3:4] + r * torch.sin(theta)], -1).reshape(8, -1, 2)
    xy = torch.cat([torch.rand(8, 20000, 2, generator=gen), ring], 1)
    fast = he.in_nearest_circle(xy, php, cfg.max_holes, 0.0, 0.0, 0.25)
    assert torch.equal(fast, _jax_in_pores(xy, php, nh))
    assert 0.02 < float(fast.float().mean()) < 0.9


def _cells(xy):
    idx = np.clip((xy * 4).astype(int), 0, 3)
    return np.bincount(idx[:, 0] * 4 + idx[:, 1], minlength=16) / len(xy)


def test_domain_draws_match_jax_s_distribution():
    j_pde, pde = _pdes()
    jp = j_pde.sample_params(jax.random.PRNGKey(6))
    tp = tree_stack([tuple(_t(a) for a in jp)])
    t = pde.sample_points_batched(_gen(6), 1024, tp, 40)[5].reshape(-1, 2).numpy()
    j = np.asarray(jax.vmap(lambda k: j_pde.sample_points(k, 1024, jp)[5])(
        jax.random.split(jax.random.PRNGKey(7), 40))).reshape(-1, 2)
    assert np.abs(_cells(t) - _cells(j)).max() < 0.01


# --- losses ----------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["vjac", "jacobian"])
def test_loss_fn_matches_jax(branch):
    j_pde, pde = _pdes()
    jp = j_pde.sample_params(jax.random.PRNGKey(0))
    pts = j_pde.sample_points(jax.random.PRNGKey(1), 256, jp)
    kw = dict(num_layers=3, layer_size=32, in_dim=2, out_dim=2, squeeze_scalar=False)
    j_field, field = j_make_field(JFieldConfig(**kw)), make_field(FieldConfig(**kw))
    j_fp = j_field.init(jax.random.PRNGKey(2))
    fp = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_fp))
    if branch == "vjac":
        j_fn, fn = j_field.bind(j_fp), field.bind(fp)
        assert hasattr(fn, "vjac")
    else:
        j_fn, fn = (lambda x: j_field.apply(j_fp, x)), (lambda x: field.apply(fp, x))
    j_out = j_pde.loss_fn(j_fn, pts, jp)
    out = pde.loss_fn(fn, tuple(_t(p) for p in pts), tuple(_t(a) for a in jp))
    for a, b in zip(out, j_out):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5)


# --- the committed runs ----------------------------------------------------------

@pytest.mark.parametrize("run, algo", [(EM7_9, "maml"), (LDE2_3, "leap")])
def test_committed_checkpoints_load_as_their_pickles(run, algo):
    cfg = parse_overrides(load_run_config(str(run)), [f"--train.load_model_from_expt={run}"])
    c = {"maml": maml_driver, "leap": leap_driver}[algo].build(cfg, "cpu")
    model, state, fname, best = deploy_bench.load_model(cfg, c, "best", torch.device("cpu"),
                                                        algo)
    assert best and fname.endswith("checkpoint_best.pickle")
    raw = checkpoints.load_checkpoint(fname)
    ours = tree_leaves(model)
    ref = jax.tree_util.tree_leaves((raw["params"], raw["inner_lrs"]) if algo == "maml"
                                    else raw["params"])
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    width = {"maml": (8, 64), "leap": (10, 128)}[algo]
    assert (cfg.model.num_layers, cfg.model.layer_size) == width
    assert tuple(model[0]["layers"][-1]["w"].shape if algo == "maml"
                 else model["layers"][-1]["w"].shape) == (width[1], 2)


# --- one outer step against the JAX drivers ----------------------------------------

def _stack(sets):
    """Per task a list of point-set tuples -> per kind [T, sets, n, 2]."""
    kinds = len(sets[0][0])
    return tuple(torch.stack([torch.stack([_t(s[j]) for s in task]) for task in sets])
                 for j in range(kinds))


def _task_params(tps):
    return tuple(torch.stack([_t(tp[j]) for tp in tps]) for j in range(len(tps[0])))


def _maml_draws(j_pde, cfg, key):
    """The draws of JAX's MAML key chain for one outer step."""
    tasks = []
    for tk in jax.random.split(key, cfg.maml.bsize):
        task_key, rollout_key, outer_loss_key = jax.random.split(tk, 3)
        tp = j_pde.sample_params(task_key)
        inner, outer, k = [], [], rollout_key
        for _ in range(cfg.maml.inner_steps):
            k1, k2, k = jax.random.split(k, 3)
            inner.append(j_pde.sample_points(k1, cfg.task.inner_points, tp))
            outer.append(j_pde.sample_points(k2, cfg.task.outer_points, tp))
        inner.append(j_pde.sample_points(k, cfg.task.inner_points, tp))
        outer.append(j_pde.sample_points(outer_loss_key, cfg.task.outer_points, tp))
        tasks.append((tp, inner, outer))
    return maml.TaskBatch(task_params=_task_params([t[0] for t in tasks]),
                          inner_points=_stack([t[1] for t in tasks]),
                          outer_points=_stack([t[2] for t in tasks]))


def _leap_draws(j_pde, cfg, key):
    """The draws of JAX's LEAP key chain for one outer step: per task its
    params, then 2K + 1 point sets in the order the rollout takes them."""
    tps, sets = [], []
    for tk in jax.random.split(key, cfg.leap.bsize):
        task_key, k = jax.random.split(tk, 2)
        tp = j_pde.sample_params(task_key)
        loss0_key, inner_key = jax.random.split(k, 2)
        keys = [loss0_key]
        for ik in jax.random.split(inner_key, cfg.leap.inner_steps):
            keys += list(jax.random.split(ik, 2))
        tps.append(tp)
        sets.append([j_pde.sample_points(kk, cfg.task.inner_points, tp) for kk in keys])
    return leap.TaskBatch(_task_params(tps), _stack(sets))


def _close_trees(t_tree, j_tree, rel):
    a, b = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=0,
                                   atol=rel * max(np.abs(y).max(), 1e-3))


def _close_meta_grads(t_state, j_state, old_mu, rel, tree_rel=None):
    """The meta-gradient each side's outer Adam took, recovered from its new
    first moment, mu = b1 mu_old + (1 - b1) g (optax.adam's b1 = 0.9 in
    both packages), held within `rel` of each JAX leaf's largest |g| and,
    if given, `tree_rel` of the tree's norm: a step of the wrong size or
    direction fails here even where the step is below the params' own bar."""
    b1 = 0.9
    a, b = tree_leaves(t_state["mu"]), jax.tree_util.tree_leaves(j_state[0].mu)
    old = jax.tree_util.tree_leaves(old_mu)
    assert len(a) == len(b) == len(old)
    diff_sq = norm_sq = 0.0
    for x, y, m in zip(a, b, old):
        m = np.asarray(m, np.float64)
        g_t = (x.detach().numpy().astype(np.float64) - b1 * m) / (1 - b1)
        g_j = (np.asarray(y, np.float64) - b1 * m) / (1 - b1)
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=rel * np.abs(g_j).max())
        diff_sq += float(((g_t - g_j) ** 2).sum())
        norm_sq += float((g_j ** 2).sum())
    if tree_rel is not None:
        assert diff_sq ** 0.5 <= tree_rel * norm_sq ** 0.5


def _np(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def test_maml_step_from_em7_9_matches_jax():
    """Both packages resume em7_9's checkpoint_step_500001.pickle (8x64,
    learned LRs 5 steps deep, both Adam states) and take one outer step on
    the same draws, cut to bsize 2 and 64 points. The meta-gradients, from
    the new Adam moments, within 1e-4 of each leaf's largest entry
    (measured 2.6e-5 on the params', 7.9e-5 on the inner LRs')."""
    cuts = ["--maml.bsize=2", "--task.inner_points=64", "--task.outer_points=64",
            "--train.viz_every=0"]
    j_cfg = j_parse_overrides(j_load_run_config(str(EM7_9)), cuts)
    t_cfg = parse_overrides(load_run_config(str(EM7_9)), cuts)
    jc, tc = j_maml_driver.build(j_cfg), maml_driver.build(t_cfg, "cpu")
    ck = str(EM7_9 / "checkpoint_step_500001.pickle")
    js, ts = j_ckpt.load_checkpoint(ck), checkpoints.load_checkpoint(ck)
    j_state = tuple(jax.tree_util.tree_map(jnp.asarray, js[k])
                    for k in ("params", "inner_lrs", "opt_state", "lr_opt_state"))
    t_state = (params_from_numpy(ts["params"]), params_from_numpy(ts["inner_lrs"]),
               optimizers.from_jax_state("adam", ts["opt_state"]),
               optimizers.from_jax_state("adam", ts["lr_opt_state"]))
    key = jax.random.PRNGKey(11)
    out = jc["train_step"](key, *j_state)
    batch = _maml_draws(jc["pde"], j_cfg, key)
    assert [tuple(p.shape) for p in batch.inner_points] == [(2, 6, 64, 2)] * 6
    t_out = tc["step_core"](batch, *t_state)
    _close_trees(t_out[0], out[0], 1e-4)
    _close_trees(t_out[1], out[1], 1e-4)
    _close_meta_grads(t_out[2], out[2], js["opt_state"][0][1], 1e-4)
    _close_meta_grads(t_out[3], out[3], js["lr_opt_state"][0][1], 1e-4)
    np.testing.assert_allclose(t_out[5][0].numpy(), np.asarray(out[5][0]), rtol=1e-4)
    np.testing.assert_allclose(t_out[4].numpy(), np.asarray(out[4]), rtol=1e-4)
    assert int(t_out[2]["count"]) == int(t_state[2]["count"]) + 1


# --- the ground-truth cache ---------------------------------------------------------

def test_cache_round_trips_an_elasticity_ground_truth(tmp_path):
    _, pde = _pdes()
    params = pde.sample_params(_gen(0))
    cache = GroundTruthCache(str(tmp_path))
    gt = cache.get_or_solve(pde, params, 8)
    assert isinstance(gt, fem_elasticity.ElasticityGroundTruth)
    again = GroundTruthCache(str(tmp_path))
    back = again.get_or_solve(pde, params, 8)
    assert (again.hits, again.solves) == (1, 0)
    for name in gt._fields:
        assert torch.equal(getattr(back, name), getattr(gt, name)), name
    assert float(back.final_gnorm) < 1e-5 and float(back.final_energy) > 0
    # the key holds gt_version 3 and the requested resolution, not the floor
    assert cache.path(pde, params, 8) != cache.path(pde, params, 9)
    assert pde.gt_version == 3
