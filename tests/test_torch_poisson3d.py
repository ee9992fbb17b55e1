"""3-D Poisson (manufactured solutions): metapde_tpu.pdes.poisson3d against
the PyTorch port on shared inputs (JAX's task params and points, numpy
points from a seed, JAX's field params), and the family end to end on the
CPU.

- radius, exact_solution and source on JAX's tasks at 512 numpy points:
  rtol 1e-5 (source: 1e-5 of its scale; the port writes JAX's autodiff
  derivatives out in closed form, and holds them against its own
  ops/operators.weighted_laplacian of u* too).
- MMS: the exact solution as the field gives a zero loss on the operator
  path (below 1e-10 of the source's mean square).
- loss_fn at in_dim 3 on JAX's params, points and field params, the fused
  vhd path and the operator path: rtol 1e-5.
- Frozen factors: with every vary_* off sample_params equals JAX's bit for
  bit (the zero-key normal (2, 4) and uniforms (4,) and (2,)).
- Samplers: boundary points on the star surface (1e-5), every domain point
  inside; the tail guard moves an outside pick to half its star radius
  (sets of one point, where a set's 24 candidates can all lie outside);
  the domain points' octant and radial-shell occupancy against JAX's on
  the same task, 40 x 1024 points an arm, within 0.01; the batched draw's
  shapes.
- The exact ground truth through the port's cache, and a tiny
  maml_driver.run, leap_driver.run (through the CLIs) and deploy_bench on
  the CPU.
"""

import json

import jax
import numpy as np
import pytest
import torch

from metapde_tpu.config import FieldConfig as JFieldConfig
from metapde_tpu.config import TaskConfig as JTaskConfig
from metapde_tpu.models import make_field as j_make_field
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.pdes import poisson3d as j_p3
from metapde_tpu_torch.cli import deploy_bench, leap_pde, maml_pde
from metapde_tpu_torch.config import FieldConfig, TaskConfig
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.models import make_field
from metapde_tpu_torch.ops.operators import weighted_laplacian
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.pdes import poisson3d as p3
from metapde_tpu_torch.train.gt_cache import GroundTruthCache
from metapde_tpu_torch.utils.trees import tree_stack

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _pdes(**kw):
    kw = {"pde": "poisson3d", **kw}
    return j_get_pde(JTaskConfig(**kw)), get_pde(TaskConfig(**kw))


def _points(seed, n=512):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_radius_exact_solution_and_source_match_jax(seed):
    j_pde, _ = _pdes()
    jp = j_pde.sample_params(jax.random.PRNGKey(seed))
    sol_j, sol_t = (jp[0], jp[1]), (_t(jp[0]), _t(jp[1]))
    x = _points(seed)
    d = x / np.linalg.norm(x, axis=1, keepdims=True)
    np.testing.assert_allclose(
        p3.radius(torch.tensor(d), _t(jp[2][0]), _t(jp[2][1])).numpy(),
        np.asarray(jax.vmap(lambda v: j_p3.radius(v, jp[2][0], jp[2][1]))(d)), rtol=1e-5)
    np.testing.assert_allclose(p3.exact_solution(sol_t, torch.tensor(x)).numpy(),
                               np.asarray(jax.vmap(lambda v: j_p3.exact_solution(sol_j, v))(x)),
                               rtol=1e-5, atol=1e-6)
    want = np.asarray(jax.vmap(lambda v: j_p3.source(sol_j, v))(x))
    got = p3.source(sol_t, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    def u_fn(y):
        return p3.exact_solution(sol_t, y)

    auto = torch.func.vmap(lambda v: weighted_laplacian(
        u_fn, lambda y: 1.0 + 0.1 * u_fn(y) ** 2, v))(torch.tensor(x))
    np.testing.assert_allclose(got, auto.numpy(), rtol=0, atol=1e-5 * np.abs(want).max())


def test_the_exact_solution_has_zero_loss():
    _, pde = _pdes()
    params = pde.sample_params(_gen(0))
    pts = pde.sample_points(_gen(1), 256, params)
    b, d = pde.loss_fn(lambda x: p3.exact_solution(params[:2], x), pts, params)
    src = p3.source(params[:2], pts[1])
    assert float(b["boundary_loss"]) == 0.0
    assert float(d["domain_loss"]) <= 1e-10 * float(torch.mean(src ** 2))


@pytest.mark.parametrize("branch", ["vhd", "operators"])
def test_loss_fn_matches_jax(branch):
    j_pde, pde = _pdes()
    jp = j_pde.sample_params(jax.random.PRNGKey(0))
    pts = j_pde.sample_points(jax.random.PRNGKey(1), 256, jp)
    kw = dict(num_layers=3, layer_size=32, in_dim=3, out_dim=1)
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


def test_frozen_task_is_jax_s():
    kw = dict(vary_source=False, vary_bc=False, vary_geometry=False, bc_scale=2.0)
    j_pde, pde = _pdes(**kw)
    for a, b in zip(pde.sample_params(_gen(3)), j_pde.sample_params(jax.random.PRNGKey(3))):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _outside(x, geo):
    return p3.is_outside(torch.as_tensor(x), torch.as_tensor(geo)).numpy()


def test_samplers_respect_the_star_ball():
    _, pde = _pdes()
    gen = _gen(4)
    params = [pde.sample_params(gen) for _ in range(3)]
    for p in params:
        bnd, dom = pde.sample_points(gen, 300, p)
        assert bnd.shape == dom.shape == (300, 3)
        r = torch.linalg.vector_norm(bnd, dim=1)
        np.testing.assert_allclose(r.numpy(), p3.radius(bnd / r[:, None], p[2][0], p[2][1]),
                                   atol=1e-5)
        assert not _outside(dom, p[2]).any()
    batched = pde.sample_points_batched(gen, 64, tree_stack(params), 2)
    assert [tuple(k.shape) for k in batched] == [(3, 2, 64, 3)] * 2
    assert not _outside(batched[1], tree_stack(params)[2][:, None, None, :]).any()


def test_the_tail_guard_moves_outside_picks_inside():
    # one point from 24 candidates a set: about one set in 2000 has no
    # candidate inside the star (c = (0.2, 0.2)), and its pick is guarded
    _, pde = _pdes()
    geo = torch.tensor([0.2, 0.2])
    tp = (torch.zeros(1, 2, 4), torch.zeros(1, 4), geo[None])
    pts = pde.sample_points_batched(_gen(0), 1, tp, 20000)[1].reshape(-1, 3)
    r = torch.linalg.vector_norm(pts, dim=1)
    guarded = torch.abs(r / p3.radius(pts / r[:, None], geo[0], geo[1]) - 0.5) < 1e-6
    assert int(guarded.sum()) >= 3
    assert not _outside(pts, geo).any()


def _occupancy(x):
    octant = (x[:, 0] > 0) * 4 + (x[:, 1] > 0) * 2 + (x[:, 2] > 0)
    shell = np.clip((np.linalg.norm(x, axis=1) / 1.45 * 4).astype(int), 0, 3)
    return (np.bincount(octant, minlength=8) / len(x),
            np.bincount(shell, minlength=4) / len(x))


def test_domain_draws_match_jax_s_distribution():
    j_pde, pde = _pdes()
    jp = j_pde.sample_params(jax.random.PRNGKey(6))
    tp = tree_stack([tuple(_t(a) for a in jp)])
    t = pde.sample_points_batched(_gen(6), 1024, tp, 40)[1].reshape(-1, 3).numpy()
    j = np.asarray(jax.vmap(lambda k: j_pde.sample_points(k, 1024, jp)[1])(
        jax.random.split(jax.random.PRNGKey(7), 40))).reshape(-1, 3)
    for a, b in zip(_occupancy(t), _occupancy(j)):
        assert np.abs(a - b).max() < 0.01


def test_the_exact_ground_truth_through_the_cache(tmp_path):
    _, pde = _pdes()
    params = pde.sample_params(_gen(0))
    cache = GroundTruthCache(str(tmp_path))
    gt = cache.get_or_solve(pde, params, 16)
    assert isinstance(gt, p3.Poisson3dGroundTruth)
    back = GroundTruthCache(str(tmp_path)).get_or_solve(pde, params, 16)
    x = pde.sample_validation_points(_gen(1), 64, params, back)
    assert torch.equal(pde.evaluate_gt(back, x), p3.exact_solution(params[:2], x))


TINY = ["--device=cpu", "--task.pde=poisson3d", "--train.viz_every=0",
        "--task.inner_points=64", "--task.outer_points=64", "--task.validation_points=64",
        "--task.n_eval=2", "--model.num_layers=2", "--model.layer_size=16",
        "--train.outer_steps=2", "--train.log_every=1"]


@pytest.mark.parametrize("algo", ["maml", "leap"])
def test_train_and_deploy_end_to_end_on_the_cpu(tmp_path, algo):
    cli = {"maml": maml_pde, "leap": leap_pde}[algo]
    cli.main(TINY + [f"--train.out_dir={tmp_path}", "--train.expt_name=r",
                     f"--{algo}.bsize=2", f"--{algo}.inner_steps=2"])
    recs = [json.loads(l) for l in (tmp_path / "r" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["val_rel_err"]) and r["val_rel_err"] < 1e3 for r in recs)
    for extra in ([], ["--deploy.optimizer=adam"]):
        rows = deploy_bench.main(["--device=cpu", f"--algo={algo}",
                                  f"--from_run={tmp_path / 'r'}", "--inner-steps-list=0,2",
                                  "--repeats=1", "--model.use_pallas_inference=true"] + extra)
        assert [r["inner_steps"] for r in rows] == [0, 2]
        assert all(np.isfinite(r["val_rel_err_median"]) for r in rows)
