"""Branch diagnostics, mirror-symmetric validation and multi-start
deployment: metapde_tpu.train.{energy,validation,multistart} against the
port, and the hyperelasticity slice end to end on the CPU.

- make_validation_fn with symmetry (and with the branch audit) against the
  JAX package's on identical coefficients (one analytic field, evaluated by
  both) and identical energies: every ValidationResult field within rtol
  1e-5, over tasks whose unmirrored branch wins, whose mirrored branch
  wins, one flagged as a branch disagreement and one not; and the
  all-flagged fallback to the plain mean. val_mse is the sum of the
  unmirrored mse over tasks, as in the JAX package and the reference.
- One siren_fused wrapper call per symmetric validation call (the coords
  and the mirrored coords of every task in one [2T, V, 2] call), at k = 0
  (shared weights) and k = 1 (per-task weights), equal to evaluating the
  two branches apart.
- gt_field through the per-point Jacobian branch of the loss, and
  domain_energy, against the JAX package's on the same ground truth and
  points: rtol 1e-5.
- Multi-start: each task keeps the argmin of its candidates' scores, a NaN
  score loses, candidate 0 adapts from the exact model, and jitter_leaves
  moves a leaf by scale x its RMS (the std of the move within 5% of
  scale x RMS on 4096 entries, as JAX's jitter_leaves).
- One LEAP outer step from lde2_3's best checkpoint (10x128, its Adam
  state) on JAX's own draws, cut to bsize 2, 2 inner steps and 64 points:
  params within 1e-4 of each leaf's scale, losses and grad norm rtol 1e-4.
- run() of both drivers with branch_aware_val on a tiny hyperelasticity
  config: metrics.jsonl has the JAX run's keys (val_rel_err_branch,
  val_branch_flags, val_branch_mask), best_metric=rel_err_branch keeps a
  best checkpoint; the log names the oracle energies.
- deploy_bench --energy_audit (and --deploy.n_starts=2) on a copy of
  em7_9, cut to 2 tasks at resolution 8: the audit columns are finite,
  the JAX rows in the copy stay byte-identical.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.solvers import fem_elasticity as j_fe
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import energy as j_energy
from metapde_tpu.train import leap_driver as j_leap_driver
from metapde_tpu.train import multistart as j_ms
from metapde_tpu.train.validation import make_validation_fn as j_make_validation_fn
from metapde_tpu_torch.cli import deploy_bench, leap_pde, maml_pde
from metapde_tpu_torch.config import load_run_config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.ops import siren_fused
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.solvers import fem_elasticity as fe
from metapde_tpu_torch.train import checkpoints, energy, leap_driver, maml_driver
from metapde_tpu_torch.train import multistart, optimizers
from metapde_tpu_torch.train.validation import make_validation_fn, mirror_x, task_generator

from test_torch_hyper_elasticity import (EM7_9, LDE2_3, _close_meta_grads, _close_trees, _gen,
                                         _leap_draws, _t)

torch.set_num_threads(2)


# --- symmetric and branch-aware validation ------------------------------------------

def _field(c, x):
    """An analytic two-output field with a per-task amplitude c."""
    return np.stack([c * np.sin(3 * x[..., 0]) + 0.5 * x[..., 1],
                     np.cos(2 * x[..., 1]) * x[..., 0]], -1).astype(np.float32)


def _validation_case(flag_all):
    rng = np.random.default_rng(0)
    n_eval, v = 4, 64
    coords = rng.uniform(0, 1, (n_eval, v, 2)).astype(np.float32)
    amp = np.asarray([1.0, 0.8, 1.2, 0.9], np.float32)
    gt = np.stack([_field(a, c) for a, c in zip(amp, coords)])
    # task 1's ground truth is the mirrored branch; tasks 2-3 are far off
    mirrored = _field(amp[1], np.stack([1.0 - coords[1][:, 0], coords[1][:, 1]], -1))
    gt[1] = mirrored * np.asarray([-1.0, 1.0], np.float32)
    gt[2] += rng.normal(0, 1.0, gt[2].shape).astype(np.float32)
    gt[3] *= 3.0
    if flag_all:
        gt[0] *= 3.0
        gt[1] *= 3.0
    gt += rng.normal(0, 1e-3, gt.shape).astype(np.float32)
    model_e = np.asarray([0.5, 0.5, 0.5, 2.0] if flag_all else [1.0, 1.0, 0.5, 2.0],
                         np.float32)
    if flag_all:
        model_e[3] = 0.5
    oracle_e = np.ones(n_eval, np.float32)
    return amp, coords, gt, model_e, oracle_e


@pytest.mark.parametrize("flag_all", [False, True])
def test_symmetric_branch_aware_validation_matches_jax(flag_all):
    amp, coords, gt, model_e, oracle_e = _validation_case(flag_all)
    n_eval = len(amp)
    pde = get_pde(load_run_config(str(EM7_9)).task)
    j_pde = j_get_pde(j_load_run_config(str(EM7_9)).task)
    gt_params = [(torch.tensor([a]),) for a in amp]

    def j_coef(key, model, tp, x):
        return jnp.asarray(tp[0][0]) * jnp.stack([jnp.sin(3 * x[:, 0]), 0 * x[:, 0]], -1) + \
            jnp.stack([0.5 * x[:, 1], jnp.cos(2 * x[:, 1]) * x[:, 0]], -1)

    def t_coef(gens, model, task_params, x):
        a = torch.stack([tp[0] for tp in task_params]).reshape(-1, *([1] * (x.ndim - 2)))
        return torch.stack([a * torch.sin(3 * x[..., 0]) + 0.5 * x[..., 1],
                            torch.cos(2 * x[..., 1]) * x[..., 0]], -1)

    j_val = j_make_validation_fn(
        j_pde, j_coef, n_eval, symmetry=True,
        energy_fn=lambda key, model, tp, pts: pts[0],
        audit_points=jnp.asarray(model_e)[:, None], oracle_energy=jnp.asarray(oracle_e))(
        None, (jnp.asarray(amp)[:, None],), jnp.asarray(coords), jnp.asarray(gt))
    val = make_validation_fn(
        pde, t_coef, n_eval, symmetry=True,
        energy_fn=lambda gens, model, tps, pts: torch.stack([p[0] for p in pts]),
        audit_points=[torch.tensor([e]) for e in model_e], oracle_energy=oracle_e)(
        None, gt_params, torch.tensor(coords), torch.tensor(gt))
    for name in val._fields:
        a, b = getattr(val, name), getattr(j_val, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    mask = val.branch_mask.tolist()
    assert mask == ([True] * 4 if flag_all else [False, False, True, False])
    # the mirrored branch scores task 1 (its error is noise-level)
    assert float(val.rel_err_median) < 1.0
    left = ((t_coef(None, None, gt_params, torch.tensor(coords)) - torch.tensor(gt)) ** 2)
    assert float(val.mse) == pytest.approx(float(left.mean(dim=(1, 2)).sum()), rel=1e-5)


def test_one_kernel_call_per_symmetric_validation(monkeypatch):
    cfg = parse_overrides(load_run_config(str(EM7_9)), [
        "--model.num_layers=2", "--model.layer_size=16", "--model.use_pallas_inference=true",
        "--task.inner_points=32", "--maml.inner_steps=1", "--train.viz_every=0"])
    c = maml_driver.build(cfg, "cpu")
    pde = c["pde"]
    gen = _gen(0)
    tps = [pde.sample_params(gen) for _ in range(3)]
    coords = torch.stack([pde.sample_points_in_domain(gen, 40, tp) for tp in tps])
    gt = torch.zeros(3, 40, 2)
    calls = []
    real = siren_fused.siren_apply_fused_batched

    def counted(params, x, cfg_, shared=False):
        calls.append((tuple(x.shape), shared))
        return real(params, x, cfg_, shared)

    monkeypatch.setattr(siren_fused, "siren_apply_fused_batched", counted)
    model = (c["init_params"], c["inner_lrs"])
    for k in (0, 1):
        calls.clear()
        coef = lambda gens, m, tp, x: c["make_coef_func_batched"](gens, m, tp, x, inner_steps=k)
        make_validation_fn(pde, coef, 3, symmetry=True)(model, tps, coords, gt)
        assert calls == [((6, 40, 2), k == 0)], calls
        # the one launch equals the two branches evaluated apart
        gens = [task_generator(i) for i in range(3)]
        both = coef(gens, model, tps, torch.stack([coords, mirror_x(coords)], 1))
        apart = [coef([task_generator(i) for i in range(3)], model, tps, x)
                 for x in (coords, mirror_x(coords))]
        assert torch.equal(both[:, 0], apart[0]) and torch.equal(both[:, 1], apart[1])


def test_oracle_energy_through_the_jacobian_branch_matches_jax():
    j_pde = j_get_pde(j_load_run_config(str(EM7_9)).task)
    pde = get_pde(load_run_config(str(EM7_9)).task)
    jp = j_pde.sample_params(jax.random.PRNGKey(4))
    j_gt = j_fe.solve_direct(jp, resolution=8)
    gt = fe.ElasticityGroundTruth(*(_t(a) for a in j_gt))
    pts = j_pde.sample_points(jax.random.PRNGKey(5), 256, jp)
    j_e = float(j_energy.domain_energy(j_pde, j_energy.gt_field(j_pde, j_gt), pts, jp))
    e = float(energy.domain_energy(pde, energy.gt_field(pde, gt), tuple(_t(p) for p in pts),
                                   tuple(_t(a) for a in jp)))
    assert e == pytest.approx(j_e, rel=1e-5)
    assert 0 < e < 1


# --- multi-start --------------------------------------------------------------------

def test_multistart_keeps_each_task_s_argmin_and_nan_loses():
    # candidate j of task i adapts to params i * 10 + j; scores per (task, j)
    scores = torch.tensor([[3.0, 1.0, 2.0], [float("nan"), 5.0, 4.0]])
    seen = []

    def adapt(gens, model, tp):
        j = len(seen)
        seen.append(model)
        return {"w": torch.tensor([[10.0 * i + j] for i in range(2)])}

    def score(gen, fp, tp):
        i, j = divmod(int(fp["w"][0]), 10)
        return scores[i, j]

    best, aux = multistart.multistart_adapt(
        [_gen(0), _gen(1)], {"w": torch.zeros(1)}, (torch.zeros(2, 1),), adapt, score, 3,
        jitter=0.5, jitter_fn=lambda g, m, s: {"w": m["w"] + s})
    assert aux.best_idx.tolist() == [1, 2]
    assert best["w"].reshape(-1).tolist() == [1.0, 12.0]
    assert bool(torch.isinf(aux.scores[1, 0]))
    # candidate 0 adapts from the exact model, the others from jittered ones
    assert seen[0]["w"].item() == 0.0 and seen[1]["w"].item() == 0.5


def test_jitter_is_relative_to_each_leaf_s_rms():
    rng = np.random.default_rng(0)
    params = {"a": torch.tensor(rng.normal(0, 3.0, 4096), dtype=torch.float32),
              "b": torch.tensor(rng.normal(0, 0.01, 4096), dtype=torch.float32)}
    out = multistart.jitter_leaves(_gen(0), params, 0.1)
    j_out = j_ms.jitter_leaves(jax.random.PRNGKey(0),
                               {k: jnp.asarray(v.numpy()) for k, v in params.items()}, 0.1)
    for k, p in params.items():
        rms = float(torch.sqrt((p ** 2).mean()))
        for moved in ((out[k] - p).numpy(), np.asarray(j_out[k]) - p.numpy()):
            assert moved.std() == pytest.approx(0.1 * rms, rel=0.05)
    same = multistart.jitter_leaves(_gen(0), params, 0.0)
    assert all(torch.equal(same[k], params[k]) for k in params)


# --- LEAP's outer step on the family -------------------------------------------------

def test_leap_step_from_lde2_3_matches_jax():
    """Both packages resume lde2_3's best checkpoint (10x128, its Adam
    state) and take one outer step on the same draws, cut to bsize 2, 2
    inner steps and 64 points.

    The meta-gradient, from the new Adam moments: in LEAP's paper setting
    (lde2_3's: norm, loss_in_distance, stabilize) each increment carries
    d_loss, a difference of two f32 losses (tests/test_torch_leap.py), so
    f32 itself is far from exact on a few leaves. Against the port run in
    float64 on the same draws, JAX's f32 meta-gradient is off by 3.2e-2 of
    one 128 x 128 leaf's largest entry and the port's f32 by 4.5e-2 of
    another; port against JAX measured 3.1e-2 on the worst leaf and
    3.5e-4 of the tree's norm. Bars: 1e-1 of each leaf's largest entry
    and 1e-3 of the tree's norm (a gradient of the wrong sign is 2 off, a
    missing one 1)."""
    cuts = ["--leap.bsize=2", "--leap.inner_steps=2", "--task.inner_points=64",
            "--train.viz_every=0"]
    j_cfg = j_parse_overrides(j_load_run_config(str(LDE2_3)), cuts)
    t_cfg = parse_overrides(load_run_config(str(LDE2_3)), cuts)
    jc, tc = j_leap_driver.build(j_cfg), leap_driver.build(t_cfg, "cpu")
    ck = str(LDE2_3 / "checkpoint_best.pickle")
    js, ts = j_ckpt.load_checkpoint(ck), checkpoints.load_checkpoint(ck)
    j_state = tuple(jax.tree_util.tree_map(jnp.asarray, js[k]) for k in ("params", "opt_state"))
    t_state = (params_from_numpy(ts["params"]), optimizers.from_jax_state("adam", ts["opt_state"]))
    key = jax.random.PRNGKey(12)
    out = jc["train_step"](key, *j_state)
    batch = _leap_draws(jc["pde"], j_cfg, key)
    t_out = tc["step_core"](batch, *t_state)
    _close_trees(t_out[0], out[0], 1e-4)
    _close_meta_grads(t_out[1], out[1], js["opt_state"][0][1], 1e-1, tree_rel=1e-3)
    np.testing.assert_allclose(t_out[2].numpy(), np.asarray(out[2]), rtol=1e-4)
    np.testing.assert_allclose(float(t_out[3]), float(out[3]), rtol=1e-4)


# --- the slice on the CPU ------------------------------------------------------------

TINY = ["--device=cpu", "--task.inner_points=64", "--task.outer_points=64",
        "--task.validation_points=64", "--task.n_eval=2", "--solver.ground_truth_resolution=8",
        "--model.num_layers=2", "--model.layer_size=16", "--train.viz_every=0",
        "--train.log_every=1", "--train.val_every=1", "--train.outer_steps=2",
        "--train.branch_aware_val=true",
        "--train.best_metric=rel_err_branch", "--model.use_pallas_inference=true"]


@pytest.mark.parametrize("algo", ["maml", "leap"])
def test_run_with_branch_aware_validation(algo, tmp_path):
    run = {"maml": EM7_9, "leap": LDE2_3}[algo]
    main, knobs = {"maml": (maml_pde.main, ["--maml.bsize=2", "--maml.inner_steps=2"]),
                   "leap": (leap_pde.main, ["--leap.bsize=2", "--leap.inner_steps=2"])}[algo]
    # the run's config, trained from scratch (no resume) at a tiny width
    main([f"--from_run={run}", "--train.load_model_from_expt="] + TINY + knobs
         + [f"--train.out_dir={tmp_path}", "--train.expt_name=run"])
    out = tmp_path / "run"
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    jax_keys = sorted(json.loads((EM7_9 / "metrics.jsonl").read_text().splitlines()[0]))
    assert [sorted(r) for r in recs] == [jax_keys] * 2
    for r in recs:
        assert np.isfinite(r["val_rel_err_branch"]) and len(r["val_branch_mask"]) == 2
        assert r["val_branch_flags"] == sum(r["val_branch_mask"])
        assert len(r["per_dim_rel_err"]) == 2
    assert (out / "checkpoint_best.pickle").exists()
    assert "branch-aware validation on: oracle energies" in (out / "log.txt").read_text()


def test_deploy_bench_energy_audit_on_a_copy_of_em7_9(tmp_path):
    run = tmp_path / "em7_9"
    run.mkdir()
    for f in ("checkpoint_best.pickle", "config.json", "deploy_bench_n8_best.jsonl"):
        shutil.copy(EM7_9 / f, run / f)
    jax_rows = (run / "deploy_bench_n8_best.jsonl").read_bytes()
    base = ["--device=cpu", "--algo=maml", f"--from_run={run}", "--checkpoint=best",
            "--model.use_pallas_inference=true", "--task.n_eval=2", "--inner-steps-list=0,1",
            "--repeats=1", "--solver.ground_truth_resolution=8", "--task.validation_points=128",
            "--task.inner_points=128", "--energy_audit"]
    rows = deploy_bench.main(base)
    assert [r["inner_steps"] for r in rows] == [0, 1]
    for r in rows:
        assert len(r["model_energy"]) == len(r["oracle_energy_mc"]) == 2
        assert np.isfinite(r["model_energy"] + r["oracle_energy_mc"]).all()
        assert 0 <= r["energy_parity_tasks"] <= 2
    assert rows[0]["oracle_energy_mc"] == rows[1]["oracle_energy_mc"]
    ms = deploy_bench.main(base + ["--deploy.n_starts=2", "--inner-steps-list=1"])
    assert ms[0]["n_starts"] == 2 and np.isfinite(ms[0]["val_rel_err"])
    assert (run / "deploy_bench_n8_best.jsonl").read_bytes() == jax_rows
    assert (run / "deploy_bench_torch_n2_best.jsonl").exists()
    assert len(list((tmp_path / "gt_cache_torch").glob("hyper_elasticity_*.npz"))) == 2
