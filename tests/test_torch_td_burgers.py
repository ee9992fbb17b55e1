"""TD-Burgers: metapde_tpu.pdes.td_burgers and the slice around it against
the PyTorch port, on shared inputs (JAX's draws or numpy from a seed).

- Frozen factors: the port's table of JAX's zero-key draws (pdes/frozen.py)
  equals JAX's bits for every shape, each shape on its own; a factor that
  a vary_* flag freezes equals the JAX package's bit for bit for Poisson
  and TD-Burgers; bm7_5's config (vary_source false) gives every task
  Re = 98.95334 (f32 bits 1120266268), as the JAX package does.
- Samplers: sizes (63, 63, 1010, 1008 at n = 1024 and 64 time samples),
  ranges, the walls' shared time draws, the stratified time grid equal to
  JAX's expression bit for bit (and the domain sampler refusing it, as
  JAX's does), and the distribution of random draws against JAX's: 64 x
  1008 domain points per arm in 6 x 6 (x, t) cells, the largest cell gap
  under 0.005 (a cell's Monte-Carlo std ~7e-4); task params' means within
  0.03 of the range (2000 tasks an arm).
- loss_fn on JAX's params, points and field params, the Taylor-mode
  (.vhd) branch and the autograd branch: rtol 1e-5.
- Validation: sample_validation_points' time axis is the ground truth's
  time grid tiled, as JAX's (bit for bit); the per-timestep branch against
  JAX's make_validation_fn(num_tsteps=...) on the same coefficients: rtol
  1e-5; the cache round-trips a BurgersGroundTruth.
- One MAML outer step (step_core) on JAX's own draws of its key chain
  against JAX's train_step, 2 layers of 16, 2 inner steps, 128 points:
  params and inner LRs within 1e-5 of each leaf's scale, meta-losses rtol
  1e-5.
- The CLIs on the CPU: maml_pde and leap_pde write 201-long
  per_time_step_error rows at bm7_5's num_tsteps, and deploy_bench on a
  copy of bm7_5 (its 201 output times, cut to 2 tasks, k = 0, 1 and
  ground truth at resolution 64) writes its _torch rows and leaves the JAX
  rows alone.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import DomainConfig as JDomainConfig
from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.config import TaskConfig as JTaskConfig
from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.models import make_field as j_make_field
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.train import maml_driver as j_driver
from metapde_tpu.train.validation import make_validation_fn as j_make_validation_fn
from metapde_tpu_torch.cli import deploy_bench, leap_pde, maml_pde
from metapde_tpu_torch.config import Config, DomainConfig, FieldConfig, TaskConfig
from metapde_tpu_torch.config import load_run_config
from metapde_tpu_torch.config import parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.meta import maml
from metapde_tpu_torch.models import make_field
from metapde_tpu_torch.pdes import frozen, get_pde, td_burgers
from metapde_tpu_torch.solvers import fv_burgers
from metapde_tpu_torch.train import maml_driver
from metapde_tpu_torch.train.gt_cache import GroundTruthCache
from metapde_tpu_torch.train.validation import make_validation_fn
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
BM7_5 = REPO / "results_burgers_maml" / "bm7_5"
ZERO = jnp.zeros(2, jnp.uint32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# --- frozen factors ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (2,), (5,)])
def test_zero_key_unit_uniform_is_jax_s(shape):
    np.testing.assert_array_equal(_bits(frozen.unit_uniform(shape)),
                                  _bits(jax.random.uniform(ZERO, shape)))


@pytest.mark.parametrize("shape", [(2, 3)])
def test_zero_key_normal_is_jax_s(shape):
    np.testing.assert_array_equal(_bits(frozen.normal(shape)),
                                  _bits(jax.random.normal(ZERO, shape)))


@pytest.mark.parametrize("shape, lo, hi", [((1,), 0.8, 1.0), ((2,), -2.0, 2.0),
                                           ((5,), -1.0, 1.0), ((2,), -0.2, 0.2)])
def test_zero_key_scaled_uniform_is_jax_s(shape, lo, hi):
    np.testing.assert_array_equal(
        _bits(frozen.uniform(shape, lo, hi)),
        _bits(jax.random.uniform(ZERO, shape, minval=lo, maxval=hi)))


@pytest.mark.parametrize("flag, idx", [("vary_source", 0), ("vary_bc", 1),
                                       ("vary_geometry", 2)])
def test_poisson_frozen_factor_is_jax_s(flag, idx):
    kw = {flag: False, "bc_scale": 2.0}
    j = j_get_pde(JTaskConfig(**kw)).sample_params(jax.random.PRNGKey(3))
    t = get_pde(TaskConfig(**kw)).sample_params(_gen(3))
    np.testing.assert_array_equal(_bits(t[idx]), _bits(j[idx]))


@pytest.mark.parametrize("flag, idx", [("vary_source", 0), ("vary_ic", 1)])
def test_td_burgers_frozen_factor_is_jax_s(flag, idx):
    kw = {"pde": "td_burgers", flag: False}
    j = j_get_pde(JTaskConfig(**kw)).sample_params(jax.random.PRNGKey(4))
    t = get_pde(TaskConfig(**kw)).sample_params(_gen(4))
    np.testing.assert_array_equal(_bits(t[idx]), _bits(j[idx]))


def test_bm7_5_tasks_share_jax_s_reynolds_number():
    cfg = load_run_config(str(BM7_5)).task
    j_cfg = j_load_run_config(str(BM7_5)).task
    assert not cfg.vary_source
    pde, j_pde = get_pde(cfg), j_get_pde(j_cfg)
    gen = _gen(0)
    res = [pde.sample_params(gen)[0] for _ in range(4)]
    j_res = [j_pde.sample_params(k)[0] for k in jax.random.split(jax.random.PRNGKey(0), 4)]
    for r, jr in zip(res, j_res):
        assert _bits(r).tolist() == _bits(jr).tolist() == [1120266268]
    assert float(res[0][0]) == pytest.approx(98.95334, abs=1e-5)


# --- samplers ------------------------------------------------------------------

def _pde(**kw):
    """The family on the committed runs' domain, (x, t) in [0, 1]^2."""
    return get_pde(TaskConfig(pde="td_burgers", num_tsteps=201,
                              domain=DomainConfig(xmin=0.0, xmax=1.0), **kw))


def _j_pde(**kw):
    return j_get_pde(JTaskConfig(pde="td_burgers", num_tsteps=201,
                                 domain=JDomainConfig(xmin=0.0, xmax=1.0), **kw))


def test_sampler_sizes_and_ranges():
    pde = _pde()
    params = pde.sample_params(_gen(0))
    assert 80.0 <= float(params[0][0]) <= 100.0 and float(params[1].abs().max()) <= 2.0
    left, right, init, dom = pde.sample_points(_gen(1), 1024, params)
    assert [p.shape for p in (left, right, init, dom)] == [(63, 2), (63, 2), (1010, 2),
                                                          (1008, 2)]
    assert bool((left[:, 0] == 0).all() and (right[:, 0] == 1).all())
    assert bool((init[:, 1] == 0).all()) and init[-2:, 0].tolist() == [0.0, 1.0]
    for pts in (left, dom):
        assert 0.0 <= float(pts[:, 1].min()) and float(pts[:, 1].max()) <= 1.0
    assert 0.0 <= float(dom[:, 0].min()) and float(dom[:, 0].max()) <= 1.0
    batched = pde.sample_points_batched(_gen(2), 1024, tuple(p[None].expand(3, *p.shape)
                                                             for p in params), 4)
    assert [tuple(p.shape) for p in batched] == [(3, 4, 63, 2), (3, 4, 63, 2),
                                                (3, 4, 1010, 2), (3, 4, 1008, 2)]


def test_walls_share_their_time_draws():
    pde = _pde()
    params = pde.sample_params(_gen(0))
    left, right, _, _ = pde.sample_points(_gen(1), 256, params)
    assert torch.equal(left[:, 1], right[:, 1])
    bl, br, _, _ = pde.sample_points_batched(_gen(2), 256, tuple(p[None] for p in params), 3)
    assert torch.equal(bl[..., 1], br[..., 1])
    assert not torch.equal(bl[0, 0, :, 1], bl[0, 1, :, 1])  # each set its own draw
    # JAX's walls: the same key for both, so the same times
    j_pde = _j_pde()
    jp = j_pde.sample_params(jax.random.PRNGKey(0))
    jl, jr, _, _ = j_pde.sample_points(jax.random.PRNGKey(1), 256, jp)
    np.testing.assert_array_equal(np.asarray(jl[:, 1]), np.asarray(jr[:, 1]))


@pytest.mark.parametrize("n", [1, 16])
def test_stratified_time_grid_is_jax_s(n):
    """The JAX expression (td_burgers.py sample_time) against the port's."""
    dom = TaskConfig().domain
    j = jnp.repeat(jnp.linspace(dom.tmin, dom.tmax, 63, endpoint=False)[1:], n).reshape(-1, 1)
    t = td_burgers.stratified_times(dom, 63, n)
    assert t.shape == (62 * n, 1)
    np.testing.assert_array_equal(_bits(t), _bits(j))


def test_stratified_walls_and_the_refused_domain():
    pde = _pde(sample_time_random=False)
    params = pde.sample_params(_gen(0))
    with pytest.raises(ValueError):
        pde.sample_points(_gen(1), 1024, params)
    j_pde = _j_pde(sample_time_random=False)
    with pytest.raises(TypeError):
        j_pde.sample_points(jax.random.PRNGKey(1), 1024, j_pde.sample_params(
            jax.random.PRNGKey(0)))


def _cells(xt):
    h, _, _ = np.histogram2d(xt[:, 0], xt[:, 1], bins=6, range=[[0, 1], [0, 1]])
    return h / h.sum()


def test_random_draws_match_jax_s_distribution():
    pde, j_pde = _pde(), _j_pde()
    params = pde.sample_params(_gen(0))
    dom = pde.sample_points_batched(_gen(5), 1024, tuple(p[None] for p in params), 64)[3]
    jp = j_pde.sample_params(jax.random.PRNGKey(0))
    j_dom = jax.vmap(lambda k: j_pde.sample_points(k, 1024, jp)[3])(
        jax.random.split(jax.random.PRNGKey(5), 64))
    gap = np.abs(_cells(dom.reshape(-1, 2).numpy()) - _cells(np.asarray(j_dom).reshape(-1, 2)))
    assert gap.max() < 0.005
    gen = _gen(6)
    tps = [pde.sample_params(gen) for _ in range(2000)]
    j_tps = jax.vmap(j_pde.sample_params)(jax.random.split(jax.random.PRNGKey(6), 2000))
    re, ic = torch.stack([p[0] for p in tps]).numpy(), torch.stack([p[1] for p in tps]).numpy()
    assert re.min() >= 80.0 and re.max() <= 100.0 and np.abs(ic).max() <= 2.0
    assert abs(re.mean() - float(j_tps[0].mean())) < 0.03 * 20.0
    np.testing.assert_allclose(ic.mean(0), np.asarray(j_tps[1].mean(0)), atol=0.03 * 4.0)


# --- losses --------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["vhd", "autograd"])
def test_loss_fn_matches_jax(branch):
    j_pde = j_get_pde(JTaskConfig(pde="td_burgers"))
    pde = get_pde(TaskConfig(pde="td_burgers"))
    jp = j_pde.sample_params(jax.random.PRNGKey(0))
    pts = j_pde.sample_points(jax.random.PRNGKey(1), 256, jp)
    j_field = j_make_field(JFieldConfig(num_layers=3, layer_size=32, in_dim=2))
    field = make_field(FieldConfig(num_layers=3, layer_size=32, in_dim=2))
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


# --- validation ----------------------------------------------------------------

def test_validation_points_cycle_through_the_time_grid():
    pde = _pde()
    params = pde.sample_params(_gen(0))
    gt = pde.solve(params, resolution=32)
    pts = pde.sample_validation_points(_gen(1), 1024, params, gt)
    assert pts.shape == (1008, 2)
    assert torch.equal(pts[:, 1], gt.t_grid.repeat(6)[:1008])
    assert 0.0 <= float(pts[:, 0].min()) and float(pts[:, 0].max()) <= 1.0
    j_pde = _j_pde()
    j_gt = type("Gt", (), {"t_grid": jnp.asarray(gt.t_grid.numpy())})
    j_pts = j_pde.sample_validation_points(jax.random.PRNGKey(1), 1024,
                                           j_pde.sample_params(jax.random.PRNGKey(0)), j_gt)
    np.testing.assert_array_equal(pts[:, 1].numpy(), np.asarray(j_pts[:, 1]))
    # without a ground truth: the config's time grid, as JAX's linspace
    no_gt = pde.sample_validation_points(_gen(1), 1024, params)
    j_no_gt = j_pde.sample_validation_points(jax.random.PRNGKey(1), 1024,
                                             j_pde.sample_params(jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(no_gt[:, 1].numpy(), np.asarray(j_no_gt[:, 1]))


@pytest.mark.parametrize("n_points, num_tsteps", [(1008, 201), (300, 11)])
def test_per_timestep_validation_matches_jax(n_points, num_tsteps):
    rng = np.random.default_rng(9)
    n_eval = 3
    src = rng.uniform(80, 100, (n_eval, 1)).astype(np.float32)
    ic = rng.uniform(-2, 2, (n_eval, 2)).astype(np.float32)
    coords = rng.uniform(0, 1, (n_eval, n_points, 2)).astype(np.float32)
    gt_vals = rng.normal(0, 1, (n_eval, n_points, 1)).astype(np.float32)

    def j_coef(key, model, tp, c):
        return jnp.sin(3.0 * c[:, 0]) * jnp.cos(2.0 * c[:, 1]) + 0.01 * tp[1][0]

    def t_coef(gens, model, tps, c):
        a = torch.stack([tp[1][0] for tp in tps])[:, None]
        return torch.sin(3.0 * c[..., 0]) * torch.cos(2.0 * c[..., 1]) + 0.01 * a

    j_pde = j_get_pde(JTaskConfig(pde="td_burgers", num_tsteps=num_tsteps))
    pde = get_pde(TaskConfig(pde="td_burgers", num_tsteps=num_tsteps))
    j_val = j_make_validation_fn(j_pde, j_coef, n_eval, num_tsteps=num_tsteps)(
        None, (jnp.asarray(src), jnp.asarray(ic)), jnp.asarray(coords), jnp.asarray(gt_vals))
    val = make_validation_fn(pde, t_coef, n_eval, num_tsteps=num_tsteps)(
        None, [(_t(s), _t(i)) for s, i in zip(src, ic)], _t(coords), _t(gt_vals))
    assert val.t_rel_sq_err.shape == (num_tsteps,)
    np.testing.assert_allclose(val.t_rel_sq_err.numpy(), np.asarray(j_val.t_rel_sq_err),
                               rtol=1e-5)
    for k in ("mse", "rel_err", "rel_err_std", "rel_err_median", "rel_err_p90"):
        np.testing.assert_allclose(float(getattr(val, k)), float(getattr(j_val, k)), rtol=1e-5)
    assert make_validation_fn(pde, t_coef, n_eval)(
        None, [(_t(s), _t(i)) for s, i in zip(src, ic)], _t(coords),
        _t(gt_vals)).t_rel_sq_err is None


def test_cache_round_trips_a_burgers_ground_truth(tmp_path):
    pde = get_pde(TaskConfig(pde="td_burgers", num_tsteps=11))
    gen = _gen(0)
    tasks = [pde.sample_params(gen) for _ in range(3)]
    cache = GroundTruthCache(str(tmp_path))
    first = cache.get_or_solve_many(pde, tasks, 32)
    assert (cache.solves, cache.hits) == (3, 0) and len(list(tmp_path.glob("*.npz"))) == 3
    again = GroundTruthCache(str(tmp_path))
    second = again.get_or_solve_many(pde, tasks, 32)
    assert (again.solves, again.hits) == (0, 3)
    for a, b in zip(first, second):
        assert type(b) is fv_burgers.BurgersGroundTruth
        for x, y in zip(a, b):
            assert torch.equal(x, y) and x.dtype == y.dtype


# --- one MAML outer step on JAX's draws ----------------------------------------

SMALL = ["--task.pde=td_burgers", "--model.num_layers=2", "--model.layer_size=16",
         "--maml.bsize=2", "--maml.inner_steps=2", "--task.inner_points=128",
         "--task.outer_points=128"]


def _stack_sets(sets):
    """Per task a list of point-set tuples -> per kind [T, sets, n, 2]."""
    return tuple(torch.stack([torch.stack([_t(s[j]) for s in task]) for task in sets])
                 for j in range(4))


def _jax_draws(j_pde, cfg, key):
    """The draws of JAX's MAML key chain for one outer step (as
    tests/test_torch_train.py replays it), four point kinds a set."""
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
    return maml.TaskBatch(
        task_params=tuple(torch.stack([_t(tp[j]) for tp, _, _ in tasks]) for j in range(2)),
        inner_points=_stack_sets([inner for _, inner, _ in tasks]),
        outer_points=_stack_sets([outer for _, _, outer in tasks]))


def _close_trees(t_tree, j_tree, rel):
    a, b = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        np.testing.assert_allclose(x.detach().numpy(), y, rtol=0,
                                   atol=rel * max(np.abs(y).max(), 1e-3))


def test_maml_step_core_matches_jax_on_burgers():
    j_cfg = j_parse_overrides(JConfig(), SMALL)
    jc, tc = j_driver.build(j_cfg), maml_driver.build(parse_overrides(Config(), SMALL), "cpu")
    j_state = (jc["init_params"], jc["inner_lrs"], jc["outer_opt"].init(jc["init_params"]),
               jc["lr_opt"].init(jc["inner_lrs"]))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jc["init_params"]))
    tl = params_from_numpy(jax.tree_util.tree_map(np.asarray, jc["inner_lrs"]))
    key = jax.random.PRNGKey(11)
    out = jc["train_step"](key, *j_state)
    batch = _jax_draws(jc["pde"], j_cfg, key)
    assert [tuple(p.shape) for p in batch.inner_points] == [(2, 3, 63, 2), (2, 3, 63, 2),
                                                           (2, 3, 128 // 63 * 63 + 2, 2),
                                                           (2, 3, 126, 2)]
    t_out = tc["step_core"](batch, tp, tl, tc["outer_opt"].init(tp), tc["lr_opt"].init(tl))
    _close_trees(t_out[0], out[0], 1e-5)
    _close_trees(t_out[1], out[1], 1e-5)
    np.testing.assert_allclose(float(t_out[6]), float(out[6]), rtol=1e-4)
    np.testing.assert_allclose(t_out[5][0].numpy(), np.asarray(out[5][0]), rtol=1e-5)
    np.testing.assert_allclose(t_out[4].numpy(), np.asarray(out[4]), rtol=1e-5)


# --- the CLIs on the CPU ---------------------------------------------------------

TINY = ["--task.pde=td_burgers", "--device=cpu", "--task.num_tsteps=201",
        "--task.inner_points=128", "--task.outer_points=128", "--task.validation_points=1024",
        "--task.n_eval=2", "--solver.ground_truth_resolution=32", "--model.num_layers=2",
        "--model.layer_size=16", "--train.viz_every=0", "--train.log_every=1",
        "--train.outer_steps=2"]


@pytest.mark.parametrize("algo", ["maml", "leap"])
def test_cli_writes_per_time_step_rows(algo, tmp_path):
    main, knobs = {"maml": (maml_pde.main, ["--maml.bsize=2", "--maml.inner_steps=2"]),
                   "leap": (leap_pde.main, ["--leap.bsize=2", "--leap.inner_steps=2"])}[algo]
    main(TINY + knobs + [f"--train.out_dir={tmp_path}", "--train.expt_name=run"])
    recs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text()
            .splitlines()]
    assert len(recs) == 2
    for r in recs:
        assert len(r["per_time_step_error"]) == 201
        assert all(np.isfinite(r["per_time_step_error"])) and np.isfinite(r["val_rel_err"])
    assert "2 solved, 0 read" in (tmp_path / "run" / "log.txt").read_text()


def test_deploy_bench_on_a_copy_of_bm7_5(tmp_path):
    run = tmp_path / "bm7_5"
    run.mkdir()
    for f in ("checkpoint_best.pickle", "config.json", "deploy_bench.jsonl",
              "deploy_bench_best.jsonl"):
        shutil.copy(BM7_5 / f, run / f)
    jax_rows = {f: (run / f).read_bytes() for f in ("deploy_bench.jsonl",
                                                    "deploy_bench_best.jsonl")}
    rows = deploy_bench.main(["--device=cpu", "--algo=maml", f"--from_run={run}",
                              "--model.use_pallas_inference=true", "--task.n_eval=2",
                              "--inner-steps-list=0,1", "--repeats=1", "--checkpoint=best",
                              "--solver.ground_truth_resolution=64"])
    assert [r["inner_steps"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["val_rel_err"]) for r in rows)
    assert rows[1]["val_rel_err_median"] < rows[0]["val_rel_err_median"]
    assert rows[0]["checkpoint_step"] == 497999
    written = [json.loads(line) for line in
               (run / "deploy_bench_torch_n2_best.jsonl").read_text().splitlines()]
    assert written == rows
    assert {f: (run / f).read_bytes() for f in jax_rows} == jax_rows
    assert len(list((tmp_path / "gt_cache_torch").glob("td_burgers_*.npz"))) == 2
