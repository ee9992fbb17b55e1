"""The sharded meta-gradients (metapde_tpu_torch/parallel) on gloo ranks on
the CPU, against the JAX package's sharded ones and the port's unsharded
ones on the same draws.

One spawn of 4 ranks (tests/torch_dist_worker.py) runs every check in
turn; the JAX side and the port's unsharded references run in this
process. Configs: MAML at 2 layers of 32, bsize 4, 2 inner steps, 64
points; LEAP at 2 layers of 32, bsize 4, 3 Adam steps, 128 points.

- dp = 4 against JAX's make_sharded_maml_grad_fn on 4 of conftest's 8
  virtual CPU devices, on JAX's own draws: every meta-gradient and loss
  entry within rtol 1e-4, atol 1e-6 (tests/test_sharding.py's bars).
  LEAP against make_sharded_leap_grad_fn: the unsharded LEAP parity bars
  of tests/test_torch_leap.py (the paper's setting: 2e-2 of a leaf's
  scale, 1e-3 of the tree's norm; losses rtol 1e-5).
- tests/test_sharding.py's exact second-order set through the MAML engine
  on 4 pt ranks, remat on and off, against JAX's unsharded value: rtol
  1e-5.
- pt = 4, a 2 x 2 mesh and dp = 4 against the port's unsharded
  meta-gradient on the same full draws, remat on and off: every MAML leaf
  within 1e-4 of its largest |entry| (measured <= 1.9e-6), losses rtol
  1e-5. LEAP's increments carry d_loss, the difference of two losses of
  ~28 summed over other point splits (test_torch_leap.py): every leaf
  within 2e-3 of its scale (measured <= 2.1e-4) and 1e-3 of the tree's
  norm, tighter than its parity bars against JAX.
- three outer steps of train_step_many on 2 x 2 against three unsharded
  steps of the same seed (the same host draws): params and inner LRs
  within 1e-4 of each leaf's scale, every rank's params bit for bit equal.
- refusals: a world size other than the mesh's, bsize not divisible by dp,
  and a mesh with no process group. A point kind whose count pt does not
  divide is given whole to every pt shard (parallel/sharding.py), no
  longer refused.
- the backend rule (nccl only when every rank on the node has a card of
  its own), and no process group for a one-process run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.parallel.mesh import make_mesh as j_make_mesh
from metapde_tpu.parallel.sharding import make_sharded_leap_grad_fn as j_leap_grad_fn
from metapde_tpu.parallel.sharding import make_sharded_maml_grad_fn as j_maml_grad_fn
from metapde_tpu.train import leap_driver as j_leap_driver
from metapde_tpu.train import maml_driver as j_maml_driver
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.meta import maml
from metapde_tpu_torch.parallel.mesh import Mesh, initialize_distributed, pick_backend
from metapde_tpu_torch.parallel.sharding import shard_batch
from metapde_tpu_torch.train import leap_driver, maml_driver
from metapde_tpu_torch.utils.trees import tree_leaves
from test_torch_leap import jax_batch
from test_torch_train import _jax_draws
from torch_dist_worker import run_ranks

torch.set_num_threads(2)

MAML_ARGV = ["--model.num_layers=2", "--model.layer_size=32", "--maml.bsize=4",
             "--maml.inner_steps=2", "--task.inner_points=64", "--task.outer_points=64"]
LEAP_ARGV = ["--model.num_layers=2", "--model.layer_size=32", "--leap.bsize=4",
             "--leap.inner_steps=3", "--task.inner_points=128"]
MESHES = {"dp": (4, 1), "pt": (1, 4), "2x2": (2, 2)}
THETA0 = 0.7
LEAF_BAR = 1e-4
LEAP_LEAF_BAR, LEAP_TREE_BAR = 2e-2, 1e-3  # test_torch_leap.py's GRAD_BARS["paper"]
LEAP_SHARD_BAR = 2e-3  # sharded against the port's unsharded LEAP


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf_close(got, want, bar, tree_bar=None):
    """Every leaf within `bar` of its reference's largest |entry| (>= 1e-3);
    with tree_bar, the whole difference within tree_bar of the tree's norm."""
    a = [np.asarray(x) for x in tree_leaves(got)]
    b = [np.asarray(y) for y in tree_leaves(want)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=bar * max(np.abs(y).max(), 1e-3))
    if tree_bar is not None:
        diff = np.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)))
        norm = np.sqrt(sum((y ** 2).sum() for y in b))
        assert diff <= tree_bar * norm, (diff, norm)


def _allclose(got, want, **kw):
    a, b = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **kw)


def _pt_exact_reference():
    """tests/test_sharding.py's unsharded value, in JAX."""
    pts = jnp.linspace(0.0, 1.0, 32)

    def loss_full(t):
        return jnp.mean((jnp.sin(3 * pts) - t * pts) ** 2)

    def rollout_full(t0):
        t = t0
        for _ in range(3):
            t = t - 0.3 * jax.grad(loss_full)(t)
        return loss_full(t)

    return float(jax.grad(rollout_full)(jnp.float32(THETA0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded and the port's unsharded results in this process, the
    sharded ones from one spawn of 4 gloo ranks."""
    assert len(jax.devices()) >= 4, "conftest's 8 virtual CPU devices"
    out = {}
    # MAML: JAX's dp grad fn on JAX's draws; the port's unsharded on them
    j_cfg = j_parse_overrides(JConfig(), MAML_ARGV)
    jc = j_maml_driver.build(j_cfg)
    rng = np.random.default_rng(3)
    lrs = jax.tree_util.tree_map(
        lambda x: rng.normal(0.5, 1.0, x.shape).astype(np.float32), _np(jc["inner_lrs"]))
    key = jax.random.PRNGKey(21)
    out["jax_maml"] = j_maml_grad_fn(jc["maml_def"], j_make_mesh(4, 1))(
        key, jc["init_params"], jax.tree_util.tree_map(jnp.asarray, lrs))
    maml_args = dict(argv=MAML_ARGV, batch=_jax_draws(jc["pde"], j_cfg, key),
                     params=params_from_numpy(_np(jc["init_params"])),
                     lrs=params_from_numpy(lrs))
    tc = maml_driver.build(parse_overrides(Config(), MAML_ARGV), "cpu")
    out["maml_unsharded"] = {remat: maml.multi_task_grad_and_losses(
        tc["maml_def"]._replace(remat=remat), tc["task_loss"], maml_args["batch"],
        maml_args["params"], maml_args["lrs"]) for remat in (False, True)}
    # LEAP: the same with the JAX driver's leap_def
    jl = j_leap_driver.build(j_parse_overrides(JConfig(), LEAP_ARGV))
    lkey = jax.random.PRNGKey(22)
    out["jax_leap"] = j_leap_grad_fn(jl["leap_def"], j_make_mesh(4, 1))(lkey, jl["init_params"])
    leap_args = dict(argv=LEAP_ARGV, batch=jax_batch(jl["pde"], 128, lkey, 4, 3),
                     params=params_from_numpy(_np(jl["init_params"])))
    tl = leap_driver.build(parse_overrides(Config(), LEAP_ARGV), "cpu")
    out["leap_unsharded"] = tl["grad_fn"](leap_args["batch"], leap_args["params"])
    out["pt_exact"] = _pt_exact_reference()
    # three unsharded outer steps of the same seed
    p, l = tc["init_params"], tc["inner_lrs"]
    out["steps"] = tc["train_step_many"](tc["generator"], p, l, tc["outer_opt"].init(p),
                                         tc["lr_opt"].init(l), 3)

    checks = [(f"maml_grad:{m}", dict(maml_args, mesh=MESHES[m], remats=(False, True)))
              for m in MESHES]
    checks += [(f"leap_grad:{m}", dict(leap_args, mesh=MESHES[m])) for m in MESHES]
    checks += [("pt_exact", {"theta0": THETA0}),
               ("train_steps", dict(argv=MAML_ARGV, mesh=(2, 2), n_steps=3)),
               ("refusal:world", dict(argv=MAML_ARGV, mesh=(3, 1))),
               ("refusal:bsize", dict(argv=MAML_ARGV + ["--maml.bsize=6"], mesh=(4, 1))),
               ("refusal:leap_bsize", dict(argv=LEAP_ARGV + ["--leap.bsize=2"], mesh=(4, 1),
                                           algo="leap"))]
    out["ranks"] = run_ranks(tmp_path_factory.mktemp("ranks"), 4, checks, timeout=150)
    return out


def test_maml_dp_matches_jax_sharded(runs):
    got = runs["ranks"][0]["maml_grad:dp"][False]
    j_grads, j_losses, (j_meta, j_aux) = runs["jax_maml"]
    grads, losses, (meta, aux) = got
    _allclose(grads, j_grads, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(losses, np.asarray(j_losses), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(meta, np.asarray(j_meta), rtol=1e-4, atol=1e-6)
    _allclose(aux, j_aux, rtol=1e-4, atol=1e-6)
    assert losses.shape == (4, 3)


def test_leap_dp_matches_jax_sharded(runs):
    grads, losses = runs["ranks"][0]["leap_grad:dp"]
    j_grads, j_losses = runs["jax_leap"]
    np.testing.assert_allclose(losses, np.asarray(j_losses), rtol=1e-5)
    _leaf_close(grads, _np(j_grads), LEAP_LEAF_BAR, LEAP_TREE_BAR)


@pytest.mark.parametrize("remat", [False, True])
def test_pt_sharded_second_order_grads_exact(runs, remat):
    grad, _ = runs["ranks"][0]["pt_exact"][remat]
    np.testing.assert_allclose(grad, runs["pt_exact"], rtol=1e-5)


@pytest.mark.parametrize("mesh", ["pt", "2x2", "dp"])
@pytest.mark.parametrize("remat", [False, True])
def test_maml_sharded_equals_unsharded(runs, mesh, remat):
    grads, losses, (meta, aux) = runs["ranks"][0][f"maml_grad:{mesh}"][remat]
    r_grads, r_losses, (r_meta, r_aux) = runs["maml_unsharded"][remat]
    _leaf_close(grads, r_grads, LEAF_BAR)
    np.testing.assert_allclose(losses, r_losses.numpy(), rtol=1e-5)
    np.testing.assert_allclose(meta, r_meta.numpy(), rtol=1e-5)
    _leaf_close(aux, r_aux, 1e-5)


@pytest.mark.parametrize("mesh", ["pt", "2x2", "dp"])
def test_leap_sharded_equals_unsharded(runs, mesh):
    grads, losses = runs["ranks"][0][f"leap_grad:{mesh}"]
    r_grads, r_losses = runs["leap_unsharded"]
    _leaf_close(grads, r_grads, LEAP_SHARD_BAR, LEAP_TREE_BAR)
    np.testing.assert_allclose(losses, r_losses.numpy(), rtol=1e-5)


def test_every_rank_ends_with_the_same_result(runs):
    ranks = runs["ranks"]
    for name in ("maml_grad:2x2", "leap_grad:2x2", "train_steps"):
        for r in ranks[1:]:
            for a, b in zip(tree_leaves(r[name]), tree_leaves(ranks[0][name])):
                assert np.array_equal(a, b), name


def test_three_outer_steps_on_2x2_equal_unsharded(runs):
    got = runs["ranks"][0]["train_steps"]
    ref = runs["steps"]
    _leaf_close(got["params"], ref[0], LEAF_BAR)
    _leaf_close(got["inner_lrs"], ref[1], LEAF_BAR)
    np.testing.assert_allclose(got["ml_means"], ref[7].numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["losses"], ref[4].numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["meta_grad_norm"], float(ref[6]), rtol=1e-4)


@pytest.mark.parametrize("case,words", [
    ("refusal:world", ("3 task x 1 point", "3 ranks", "has 4")),
    ("refusal:bsize", ("bsize 6", "n_task_shards=4")),
    ("refusal:leap_bsize", ("bsize 2", "n_task_shards=4")),
])
def test_refusals_on_ranks(runs, case, words):
    for r in runs["ranks"]:
        assert r[case] is not None and all(w in r[case] for w in words), r[case]


def test_a_mesh_without_a_process_group_raises_naming_torchrun():
    for drv in (maml_driver, leap_driver):
        with pytest.raises(RuntimeError, match="torch.distributed.run --nproc_per_node=4"):
            drv.build(parse_overrides(Config(), ["--mesh.n_task_shards=2",
                                                 "--mesh.n_point_shards=2"]), "cpu")


def test_shard_batch_splits_tasks_and_every_point_once():
    """No process group needed: the split itself, on a fake mesh."""
    c = maml_driver.build(parse_overrides(Config(), MAML_ARGV), "cpu")
    batch = c["draw_all"](torch.Generator().manual_seed(4))
    parts = {(i, j): shard_batch(batch, Mesh({"dp": 2, "pt": 2}, i, j, None, None, "gloo"))
             for i in range(2) for j in range(2)}
    for name in ("inner_points", "outer_points"):
        for k, full in enumerate(getattr(batch, name)):
            rows = [torch.cat([getattr(parts[i, j], name)[k] for j in range(2)], dim=2)
                    for i in range(2)]
            assert torch.equal(torch.cat(rows, dim=0), full)
    for k, full in enumerate(batch.task_params):
        assert torch.equal(torch.cat([parts[i, 0].task_params[k] for i in range(2)]), full)
    # pt = 3 divides no kind of 64 points: each is whole on every pt shard
    for j in range(3):
        part = shard_batch(batch, Mesh({"dp": 1, "pt": 3}, 0, j, None, None, "gloo"))
        for name in ("inner_points", "outer_points"):
            for got, full in zip(getattr(part, name), getattr(batch, name)):
                assert full.shape[2] == 64 and torch.equal(got, full)


@pytest.mark.parametrize("device_type,cards,local,want", [
    ("cpu", 4, 2, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 4, 2, "nccl"),
    ("cuda", 1, 2, "gloo"), ("cuda", 2, 4, "gloo")])
def test_backend_rule(monkeypatch, device_type, cards, local, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    assert pick_backend(device_type) == want


def test_a_one_process_run_starts_no_process_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed(device_type="cpu") is None
    assert not torch.distributed.is_initialized()
