"""Sharded meta-training of TD-Burgers, hyperelasticity and steady Burgers
(metapde_tpu_torch/parallel) on gloo ranks on the CPU, against the JAX
package and the port's unsharded step on the same draws.

One spawn of 4 ranks (tests/torch_dist_worker.py) runs every check while
this process computes the JAX side and the port's unsharded references.
Configs: 2 layers of 32; MAML bsize 4, 2 inner steps; LEAP bsize 4, 3 Adam
steps; TD-Burgers at 128 points (kinds 63 / 63 / 128 / 126: the walls
divide by neither 2 nor 4, the domain's 126 not by 4), hyperelasticity at
64 (six kinds of 64), steady Burgers at 64 (5 / 5 / 10 / 12 / 64: the
inlets divide by neither; at pt = 4 the walls' 10 do not, so the pool of
walls and pore rings, one no-slip mean, goes whole). Remat off on both
sides (the JAX compiles are the file's time). pt = 2 runs as two 1 x 2
meshes side by side on the 4 ranks (torch_dist_worker.tiled_mesh).

- dp = 4 against the JAX package on JAX's own draws (key 21 MAML, 22
  LEAP): TD-Burgers against make_sharded_{maml,leap}_grad_fn on 4 of
  conftest's 8 virtual devices. The JAX package's shard_map refuses the
  hyperelasticity and steady-Burgers samplers (their while_loop and scan
  carries are not dp-varying: a TypeError at trace time), so those two
  are held to its unsharded multi_task_grad_and_losses on the same key,
  which its sharded fn equals by construction. MAML: every entry within
  rtol 1e-4, atol 1e-6 (tests/test_sharding.py's bars); LEAP: 2e-2 of a
  leaf's scale, 1e-3 of the tree's norm, losses rtol 1e-5
  (tests/test_torch_leap.py's parity bars).
- pt = 2, pt = 4 and 2 x 2 against the port's unsharded meta-gradient on
  the same full draws: MAML every leaf within 1e-4 of its largest |entry|,
  LEAP 2e-3 of a leaf's scale and 1e-3 of the tree's norm; losses rtol
  1e-5.
- pt = 2 on JAX's draws against the JAX package's unsharded step (its own
  pt run draws other points, equal in distribution only): the dp bars.
- three train_step_many steps of TD-Burgers on 2 x 2 against three
  unsharded steps of the same seed (the same host draws): params and
  inner LRs within 1e-4 of a leaf's scale.
- a sharded run() on 2 x 2 of hyperelasticity with branch_aware_val and
  of TD-Burgers (11 output times): rank 0 alone writes; metrics.jsonl's
  validation columns (the branch columns, the per-timestep errors) equal
  the one-process run's within rtol 1e-5 and the branch flags and mask
  exactly; the ground truth is read from the one-process run's cache; the
  JAX package's load_checkpoint reads the final checkpoint.
- the split itself, without a process group: which kinds pt splits and
  which it gives whole at bm7_5's, sbi10_2's and ldb3_2's counts, and
  every split kind's parts joined again.

Measured on a CPU (the largest over families and meshes, of a leaf's
largest |entry|, on this file's fixture): MAML
dp against JAX 7.9e-7, LEAP 3.6e-7; sharded against unsharded MAML
1.2e-6, LEAP 3.6e-6 (4.1e-7 of the tree's norm); pt = 2 against JAX's
unsharded step MAML 1.4e-6, LEAP 4.9e-6 (5.2e-7 of the norm); three 2 x 2
steps: params 3.2e-8, inner LRs 1.1e-6; the run's columns 8.7e-8
relative.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.meta import leap as j_leap
from metapde_tpu.meta import maml as j_maml
from metapde_tpu.parallel.mesh import make_mesh as j_make_mesh
from metapde_tpu.parallel.sharding import make_sharded_leap_grad_fn as j_leap_grad_fn
from metapde_tpu.parallel.sharding import make_sharded_maml_grad_fn as j_maml_grad_fn
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import leap_driver as j_leap_driver
from metapde_tpu.train import maml_driver as j_maml_driver
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.meta import leap, maml
from metapde_tpu_torch.parallel.mesh import Mesh
from metapde_tpu_torch.parallel.sharding import shard_batch, split_kinds
from metapde_tpu_torch.train import leap_driver, maml_driver
from metapde_tpu_torch.utils.trees import tree_leaves
from torch_dist_worker import start_ranks, wait_ranks

torch.set_num_threads(2)

FAMILIES = {
    "td_burgers": (["--task.pde=td_burgers"], 128),
    "hyper_elasticity": (["--task.pde=hyper_elasticity", "--task.max_holes=3",
                          "--task.max_hole_size=0.5", "--task.domain.xmin=0",
                          "--task.domain.ymin=0"], 64),
    "steady_burgers": (["--task.pde=steady_burgers"], 64),
}
JAX_SHARDS = ("td_burgers",)  # the families JAX's shard_map traces
MESHES = {"dp": (4, 1), "pt2": (1, 2), "pt4": (1, 4), "2x2": (2, 2)}
LEAF_BAR = 1e-4
LEAP_LEAF_BAR, LEAP_TREE_BAR = 2e-2, 1e-3  # test_torch_leap.py's GRAD_BARS["paper"]
LEAP_SHARD_BAR = 2e-3
RUN_FLAGS = ["--model.num_layers=2", "--model.layer_size=16", "--maml.bsize=4",
             "--maml.inner_steps=2", "--task.n_eval=2", "--train.viz_every=0",
             "--train.log_every=1", "--train.val_every=1", "--train.outer_steps=2",
             "--model.use_pallas_inference=true"]
# the sharded run()s: (flags, validation columns beside RUN_COLUMNS, the
# mesh line's end, the ground truth's resolution)
RUNS = {
    "hyper_elasticity": (
        FAMILIES["hyper_elasticity"][0] + RUN_FLAGS + [
            "--task.inner_points=64", "--task.outer_points=64", "--task.validation_points=64",
            "--solver.ground_truth_resolution=8", "--train.branch_aware_val=true",
            "--train.best_metric=rel_err_branch"],
        ("per_dim_rel_err", "val_rel_err_branch"),
        f"inner_points [] of {[64] * 6}, outer_points [] of {[64] * 6}", 8),
    "td_burgers": (
        ["--task.pde=td_burgers", "--task.num_tsteps=11"] + RUN_FLAGS + [
            "--task.inner_points=128", "--task.outer_points=128",
            "--task.validation_points=128", "--solver.ground_truth_resolution=32"],
        ("per_time_step_error",),
        "inner_points [63, 63] of [63, 63, 128, 126], outer_points [63, 63] of "
        "[63, 63, 128, 126]", 32),
}
RUN_COLUMNS = ("meta_loss", "val_meta_loss", "val_mse", "val_rel_err", "val_rel_err_std",
               "val_rel_err_median")


def _argv(family):
    flags, n = FAMILIES[family]
    return flags + ["--model.num_layers=2", "--model.layer_size=32", "--maml.bsize=4",
                    "--maml.inner_steps=2", "--leap.bsize=4", "--leap.inner_steps=3",
                    f"--task.inner_points={n}", f"--task.outer_points={n}",
                    "--train.remat_inner_steps=false"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


def _stack(trees):
    """[tuple of arrays] -> tuple of stacked tensors."""
    return tuple(torch.stack([_t(t[j]) for t in trees]) for j in range(len(trees[0])))


def _maml_draws(j_pde, cfg, key, sample):
    """JAX's MAML key chain for one outer step (test_torch_train._jax_draws
    for any family): per task split(.., 3) -> task, rollout, outer-loss
    keys; per inner step split(.., 3) -> inner points, outer points, next.
    sample: j_pde.sample_points, jitted."""
    tps, inner, outer = [], [], []
    for tk in jax.random.split(key, cfg.maml.bsize):
        task_key, k, outer_loss_key = jax.random.split(tk, 3)
        tp = j_pde.sample_params(task_key)
        i_sets, o_sets = [], []
        for _ in range(cfg.maml.inner_steps):
            k1, k2, k = jax.random.split(k, 3)
            i_sets.append(sample(k1, cfg.task.inner_points, tp))
            o_sets.append(sample(k2, cfg.task.outer_points, tp))
        i_sets.append(sample(k, cfg.task.inner_points, tp))
        o_sets.append(sample(outer_loss_key, cfg.task.outer_points, tp))
        tps.append(tp)
        inner.append(_stack(i_sets))
        outer.append(_stack(o_sets))
    return maml.TaskBatch(_stack(tps), tuple(torch.stack(x) for x in zip(*inner)),
                          tuple(torch.stack(x) for x in zip(*outer)))


def _leap_draws(j_pde, cfg, key, sample):
    """JAX's LEAP key chain (test_torch_leap.jax_batch for any family)."""
    tps, points = [], []
    for tk in jax.random.split(key, cfg.leap.bsize):
        task_key, k = jax.random.split(tk, 2)
        tp = j_pde.sample_params(task_key)
        loss0_key, inner_key = jax.random.split(k, 2)
        keys = [loss0_key]
        for kk in jax.random.split(inner_key, cfg.leap.inner_steps):
            keys += list(jax.random.split(kk, 2))
        tps.append(tp)
        points.append(_stack([sample(kk, cfg.task.inner_points, tp) for kk in keys]))
    return leap.TaskBatch(_stack(tps), tuple(torch.stack(x) for x in zip(*points)))


def _leaf_close(got, want, bar, tree_bar=None):
    """Every leaf within `bar` of its reference's largest |entry| (>= 1e-3);
    with tree_bar, the whole difference within tree_bar of the tree's norm."""
    a = [np.asarray(x) for x in tree_leaves(got)]
    b = [np.asarray(y) for y in jax.tree_util.tree_leaves(want)]
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


def _family_inputs(family):
    """JAX's builds, its draws and the shared params; (rank checks, the JAX
    side as thunks, the port's unsharded references)."""
    argv = _argv(family)
    j_cfg = j_parse_overrides(JConfig(), argv)
    jm, jl = j_maml_driver.build(j_cfg), j_leap_driver.build(j_cfg)
    rng = np.random.default_rng(3)
    lrs = jax.tree_util.tree_map(
        lambda x: rng.normal(0.5, 1.0, x.shape).astype(np.float32), _np(jm["inner_lrs"]))
    mkey, lkey = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    sample = jax.jit(jm["pde"].sample_points, static_argnums=1)
    m_args = dict(argv=argv, batch=_maml_draws(jm["pde"], j_cfg, mkey, sample),
                  params=params_from_numpy(_np(jm["init_params"])), lrs=params_from_numpy(lrs))
    l_args = dict(argv=argv, batch=_leap_draws(jm["pde"], j_cfg, lkey, sample),
                  params=params_from_numpy(_np(jl["init_params"])), algo="leap")
    checks = [(f"family_grad:{family}:{algo}:{m}", dict(args, mesh=MESHES[m]))
              for algo, args in (("maml", m_args), ("leap", l_args)) for m in MESHES]
    checks += [(f"checkpoints_under_pt:{family}:{m}",
                {k: v for k, v in dict(m_args, mesh=MESHES[m]).items() if k != "algo"})
               for m in ("dp", "2x2")]
    j_lrs = jax.tree_util.tree_map(jax.numpy.asarray, lrs)
    jax_side = {
        "maml_unsharded": lambda: jax.jit(lambda k, p, l: j_maml.multi_task_grad_and_losses(
            jm["maml_def"], k, p, l))(mkey, jm["init_params"], j_lrs),
        "leap_unsharded": lambda: jax.jit(lambda k, p: j_leap.multi_task_grad_and_losses(
            jl["leap_def"], k, p))(lkey, jl["init_params"])}
    if family in JAX_SHARDS:
        jax_side["maml_dp"] = lambda: j_maml_grad_fn(jm["maml_def"], j_make_mesh(4, 1))(
            mkey, jm["init_params"], j_lrs)
        jax_side["leap_dp"] = lambda: j_leap_grad_fn(jl["leap_def"], j_make_mesh(4, 1))(
            lkey, jl["init_params"])
    else:
        with pytest.raises(TypeError, match="carry"):
            j_maml_grad_fn(jm["maml_def"], j_make_mesh(4, 1))(mkey, jm["init_params"], j_lrs)

    def port():
        cfg = parse_overrides(Config(), argv)
        tm, tl = maml_driver.build(cfg, "cpu"), leap_driver.build(cfg, "cpu")
        return {"maml": tm["grad_fn"](m_args["batch"], m_args["params"], m_args["lrs"]),
                "leap": tl["grad_fn"](l_args["batch"], l_args["params"])}

    return checks, jax_side, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results beside the JAX side and the port's unsharded
    references, computed in this process while the ranks run."""
    assert len(jax.devices()) >= 4, "conftest's 8 virtual CPU devices"
    tmp = tmp_path_factory.mktemp("families")
    # the one-process runs first: each sharded run reads their ground truth cache
    checks, jax_side, ports = [], {}, {}
    for family, (flags, *_) in RUNS.items():
        argv = flags + [f"--train.out_dir={tmp}"]
        maml_driver.run(parse_overrides(Config(), argv + [f"--train.expt_name={family}"]),
                        "cpu")
        checks.append((f"run:{family}", dict(argv=argv + [f"--train.expt_name={family}_mesh"],
                                             mesh=(2, 2))))
    for family in FAMILIES:
        c, jax_side[family], ports[family] = _family_inputs(family)
        checks += c
    td = _argv("td_burgers")
    checks.append(("train_steps", dict(argv=td, mesh=(2, 2), n_steps=3)))
    started = start_ranks(tmp / "ranks", 4, checks, timeout=600)
    # the JAX compiles in threads (they release the GIL), the port's here
    with ThreadPoolExecutor(3) as pool:
        jobs = {(f, k): pool.submit(lambda fn=fn: _np(fn()))
                for f, side in jax_side.items() for k, fn in side.items()}
        out = {"port": {f: port() for f, port in ports.items()}}
        out["jax"] = {f: {k: jobs[f, k].result() for k in side}
                      for f, side in jax_side.items()}
    tc = maml_driver.build(parse_overrides(Config(), td), "cpu")
    p, l = tc["init_params"], tc["inner_lrs"]
    out["steps"] = tc["train_step_many"](tc["generator"], p, l, tc["outer_opt"].init(p),
                                         tc["lr_opt"].init(l), 3)
    out["ranks"] = wait_ranks(started)
    out["run_dir"] = tmp
    return out


def _got(runs, family, algo, mesh):
    return runs["ranks"][0][f"family_grad:{family}:{algo}:{mesh}"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_maml_dp_matches_jax(runs, family):
    grads, losses, (meta, aux) = _got(runs, family, "maml", "dp")
    j = runs["jax"][family]
    j_grads, j_losses, (j_meta, j_aux) = j["maml_dp" if family in JAX_SHARDS
                                           else "maml_unsharded"]
    _allclose(grads, j_grads, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(meta, j_meta, rtol=1e-4, atol=1e-6)
    _allclose(aux, j_aux, rtol=1e-4, atol=1e-6)
    assert losses.shape == (4, 3)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_leap_dp_matches_jax(runs, family):
    grads, losses = _got(runs, family, "leap", "dp")
    j = runs["jax"][family]
    j_grads, j_losses = j["leap_dp" if family in JAX_SHARDS else "leap_unsharded"]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    _leaf_close(grads, j_grads, LEAP_LEAF_BAR, LEAP_TREE_BAR)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("algo", ["maml", "leap"])
def test_pt2_matches_jax_unsharded(runs, family, algo):
    got = _got(runs, family, algo, "pt2")
    want = runs["jax"][family][f"{algo}_unsharded"]
    if algo == "maml":
        (grads, losses, (meta, _)), (j_grads, j_losses, (j_meta, _)) = got, want
        _allclose(grads, j_grads, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(meta, j_meta, rtol=1e-4, atol=1e-6)
    else:
        (grads, losses), (j_grads, j_losses) = got, want
        _leaf_close(grads, j_grads, LEAP_LEAF_BAR, LEAP_TREE_BAR)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("mesh", ["pt2", "pt4", "2x2"])
@pytest.mark.parametrize("algo", ["maml", "leap"])
def test_sharded_equals_unsharded(runs, family, mesh, algo):
    got, ref = _got(runs, family, algo, mesh), runs["port"][family][algo]
    if algo == "maml":
        (grads, losses, (meta, aux)), (r_grads, r_losses, (r_meta, r_aux)) = got, ref
        _leaf_close(grads, _np_t(r_grads), LEAF_BAR)
        np.testing.assert_allclose(meta, r_meta.numpy(), rtol=1e-5)
        _leaf_close(aux, _np_t(r_aux), 1e-5)
    else:
        (grads, losses), (r_grads, r_losses) = got, ref
        _leaf_close(grads, _np_t(r_grads), LEAP_SHARD_BAR, LEAP_TREE_BAR)
    np.testing.assert_allclose(losses, r_losses.numpy(), rtol=1e-5)


def _np_t(tree):
    return [t.detach().numpy() for t in tree_leaves(tree)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_no_remat_under_pt(runs, family):
    """remat on: checkpointed inner steps on dp alone, none under pt (the
    engine's collective would run again in the backward, on the CUDA
    device thread, in an order that varies between ranks)."""
    got = {m: runs["ranks"][0][f"checkpoints_under_pt:{family}:{m}"] for m in ("dp", "2x2")}
    assert got == {"dp": 2, "2x2": 0}, got


def test_every_rank_ends_with_the_same_result(runs):
    ranks = runs["ranks"]
    for name in ("family_grad:td_burgers:maml:2x2", "family_grad:steady_burgers:leap:pt4",
                 "train_steps"):
        for r in ranks[1:]:
            for a, b in zip(tree_leaves(r[name]), tree_leaves(ranks[0][name])):
                assert np.array_equal(a, b), name


def test_td_burgers_three_steps_on_2x2_equal_unsharded(runs):
    got, ref = runs["ranks"][0]["train_steps"], runs["steps"]
    _leaf_close(got["params"], _np_t(ref[0]), LEAF_BAR)
    _leaf_close(got["inner_lrs"], _np_t(ref[1]), LEAF_BAR)
    np.testing.assert_allclose(got["ml_means"], ref[7].numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["losses"], ref[4].numpy(), rtol=1e-5)


@pytest.mark.parametrize("family", list(RUNS))
def test_sharded_run_equals_one_process(runs, family):
    """run() on 2 x 2: rank 0 alone writes, validates as one process does
    (hyperelasticity's mirror and branch columns, TD-Burgers' per-timestep
    errors) from the cached ground truth; the JAX package reads the final
    checkpoint."""
    flags, columns, note, resolution = RUNS[family]
    tmp = runs["run_dir"]
    one, mesh = tmp / family, tmp / f"{family}_mesh"
    for r in runs["ranks"]:
        assert r[f"run:{family}"] == sorted(p.name for p in mesh.iterdir())
    recs = [[json.loads(l) for l in (d / "metrics.jsonl").read_text().splitlines()]
            for d in (one, mesh)]
    assert [r["step"] for r in recs[1]] == [r["step"] for r in recs[0]] == [0, 1]
    for a, b in zip(*recs):
        for k in RUN_COLUMNS + columns:
            assert np.isfinite(b[k]).all(), k
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
        if family == "hyper_elasticity":
            assert b["val_branch_flags"] == a["val_branch_flags"]
            assert b["val_branch_mask"] == a["val_branch_mask"]
    log = (mesh / "log.txt").read_text().splitlines()
    mesh_lines = [l for l in log if l.startswith("mesh: ")]
    assert len(mesh_lines) == 1 and sum(l.startswith("done: ") for l in log) == 1
    assert mesh_lines[0].endswith(f"point kinds given whole to every pt rank: {note}")
    assert f"ground truth at resolution {resolution}: 0 solved, 2 read" in "\n".join(log)
    ckpt = j_ckpt.load_checkpoint(str(mesh / "checkpoint_step_2.pickle"))
    jc = j_maml_driver.build(j_parse_overrides(JConfig(), flags))
    for part in ("params", "inner_lrs"):
        want = jax.tree_util.tree_leaves(jc["init_params" if part == "params" else part])
        got = jax.tree_util.tree_leaves(ckpt[part])
        assert [(np.shape(a), np.asarray(a).dtype) for a in got] == \
            [(np.shape(b), np.asarray(b).dtype) for b in want]


@pytest.mark.parametrize("counts,pooled,n_pt,want", [
    ([63, 63, 1010, 1008], (), 2, [False, False, True, True]),        # bm7_5
    ([63, 63, 1010, 1008], (), 4, [False, False, False, True]),
    ([63, 63, 2018, 2016], (), 2, [False, False, True, True]),        # ldb3_2
    ([85, 85, 170, 172, 1024], ((2, 3),), 2, [False, False, True, True, True]),  # sbi10_2
    ([85, 85, 170, 172, 1024], ((2, 3),), 4, [False, False, False, False, True]),
    ([5, 5, 10, 12, 64], ((2, 3),), 4, [False, False, False, False, True]),
    ([1024] * 6, (), 4, [True] * 6),                                   # em7_9
])
def test_split_kinds(counts, pooled, n_pt, want):
    assert split_kinds(counts, n_pt, pooled) == want


@pytest.mark.parametrize("family", ["td_burgers", "steady_burgers"])
@pytest.mark.parametrize("n_pt", [2, 4])
def test_shard_batch_splits_or_gives_whole(family, n_pt):
    """No process group: every split kind's parts join to the whole, every
    other kind is whole on each pt shard."""
    c = maml_driver.build(parse_overrides(Config(), _argv(family)), "cpu")
    batch = c["draw_all"](torch.Generator().manual_seed(4))
    pooled = c["pde"].pooled_kinds
    parts = [shard_batch(batch, Mesh({"dp": 1, "pt": n_pt}, 0, j, None, None, "gloo"), pooled)
             for j in range(n_pt)]
    for name in ("inner_points", "outer_points"):
        full = getattr(batch, name)
        split = split_kinds([x.shape[2] for x in full], n_pt, pooled)
        assert not all(split) and any(split)
        for k, (x, s) in enumerate(zip(full, split)):
            got = [getattr(p, name)[k] for p in parts]
            if s:
                assert torch.equal(torch.cat(got, dim=2), x)
            else:
                assert all(torch.equal(g, x) for g in got)


def test_distributed_smoke_variants():
    """cli/distributed_smoke's --variant: one set of config flags a variant,
    the common flags first, each variant's split as a shell splits it."""
    from metapde_tpu_torch.cli.distributed_smoke import _variants

    class Args:
        variant = ["--from_run=a --model.compute_dtype=null", "--from_run='b c'"]

    assert _variants(Args, ["--x=1"]) == [
        ["--x=1", "--from_run=a", "--model.compute_dtype=null"], ["--x=1", "--from_run=b c"]]
    Args.variant = None
    assert _variants(Args, ["--x=1"]) == [["--x=1"]]
