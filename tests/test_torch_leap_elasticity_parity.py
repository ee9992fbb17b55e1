"""lde2_3's LEAP deployment: metapde_tpu.train.leap_driver.get_final_model
against the port's get_final_model_batched on shared inputs.

The port's lde2_3 deployment median at k = 40 was 1.85x the JAX package's
(PERF.md), each from its own 8-task draw. This file asks whether the
port's rollout drifts from JAX's on the same inputs, or whether the gap is
the draw:

- lde2_3's committed checkpoint_best.pickle (10x128, two outputs) in both
  packages; 2 deployment tasks drawn by JAX from split(PRNGKey(7919)), with
  JAX validation's keys split(PRNGKey(0)).
- At k inner steps JAX's get_final_model(key) draws step j's points from
  split(split(split(key)[1], k)[j])[0] (leap.single_task_rollout, then the
  loss's key); the test replays that chain and hands the same 2048-point
  sets to the port's get_final_model_batched(..., points=...).
- k = 5 and 40, not 5, 20 and 40: each k has its own key chain, so each k
  is a rollout of its own, and the port's 10x128 step on 2 x 2048 points
  takes ~0.5 s on two CPU threads; 5 and 40 keep the file under a minute.
- The adapted fields at 1024 shared validation points (JAX-drawn): within
  1e-4 of the field's largest |value| (measured 1.4e-6 to 4.0e-6; the
  trained omega-30 chain amplifies f32 rounding, tests/test_torch_leap_driver.py).
- Each task's val_rel_err (the mirror-symmetric validation of the port,
  train/validation.py) against one shared ground truth (the port's
  sparse-direct solve at resolution 32 raised by the ligament floor):
  rtol 1e-3 (measured 1.1e-5 at most).

They agree, so the 1.85x gap of the two medians is the task draw and not a
drift of the rollout in f32, and no float64 run is needed.
"""

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.train import leap_driver as j_driver
from metapde_tpu_torch.config import load_run_config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.train import checkpoints, leap_driver
from metapde_tpu_torch.train.validation import make_validation_fn
from metapde_tpu_torch.utils.trees import tree_map, tree_stack

torch.set_num_threads(2)

LDE2_3 = Path(__file__).resolve().parents[1] / "results_elasticity_leap" / "lde2_3"
N_TASKS = 2
N_VAL = 1024
FIELD_TOL = 1e-4
REL_ERR_RTOL = 1e-3


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    argv = ["--train.viz_every=0"]
    jc = j_driver.build(j_parse_overrides(j_load_run_config(str(LDE2_3)), argv))
    t_cfg = parse_overrides(load_run_config(str(LDE2_3)), argv)
    tc = leap_driver.build(t_cfg, "cpu")
    state = checkpoints.load_checkpoint(str(LDE2_3 / "checkpoint_best.pickle"))
    j_pde, t_pde = jc["pde"], tc["pde"]
    tasks = [j_pde.sample_params(k)
             for k in jax.random.split(jax.random.PRNGKey(7919), N_TASKS)]
    t_tasks = [tuple(_t(a) for a in tp) for tp in tasks]
    coords = [_t(j_pde.sample_validation_points(jax.random.PRNGKey(50 + i), N_VAL, tp))
              for i, tp in enumerate(tasks)]
    gt_vals = [t_pde.evaluate_gt(t_pde.solve(tp, resolution=32), c)
               for tp, c in zip(t_tasks, coords)]
    n = t_cfg.task.inner_points
    # one draw of n points a key, jitted and vmapped over the keys
    draw = jax.jit(jax.vmap(lambda kk, tp: j_pde.sample_points(kk, n, tp), in_axes=(0, None)))
    return dict(jc=jc, tc=tc, draw=draw, tasks=tasks, t_tasks=t_tasks,
                coords=coords, gt_vals=gt_vals,
                j_params=jax.tree_util.tree_map(jnp.asarray, state["params"]),
                t_params=params_from_numpy(state["params"]),
                keys=jax.random.split(jax.random.PRNGKey(0), N_TASKS))


def _jax_rollout_points(draw, key, k, task_params):
    """The point sets JAX's get_final_model(key, .., k) draws, per kind
    [k, n, 2]: step j's from split(split(split(key)[1], k)[j])[0] (setup's
    vmapped `draw` gives the same points as k draws)."""
    inner_key = jax.random.split(key)[1]
    keys = jax.vmap(lambda ik: jax.random.split(ik)[0])(jax.random.split(inner_key, k))
    return tuple(_t(kind) for kind in draw(keys, task_params))


def _rel_err(pde, values_fn, coords, gt):
    """One task's val_rel_err through the port's validation (n_eval 1, the
    mirror of hyper_elasticity): values_fn(coords [.., 2]) -> [.., 2]."""
    val_fn = make_validation_fn(pde, lambda gens, m, tps, c: values_fn(c), 1, symmetry=True)
    return float(val_fn(None, [None], coords[None], gt[None]).rel_err)


@pytest.mark.parametrize("k", [5, 40])
def test_lde2_3_rollout_matches_jax_on_shared_draws(setup, k):
    s = setup
    jc, tc = s["jc"], s["tc"]
    j_final = jax.jit(partial(jc["get_final_model"], inner_steps=k))
    per_task = [_jax_rollout_points(s["draw"], key, k, tp)
                for key, tp in zip(s["keys"], s["tasks"])]
    points = tuple(torch.stack(x) for x in zip(*per_task))
    t_final = tc["get_final_model_batched"](None, s["t_params"], tree_stack(s["t_tasks"]), k,
                                            points=points)
    for i, (key, tp) in enumerate(zip(s["keys"], s["tasks"])):
        jp = j_final(key, s["j_params"], tp)
        tp_i = tree_map(lambda x: x[i], t_final)

        def j_values(c, jp=jp):
            return _t(jc["field"].apply(jp, jnp.asarray(c.numpy())))

        def t_values(c, tp_i=tp_i):
            with torch.no_grad():
                return tc["field"].apply(tp_i, c)

        ju, tu = j_values(s["coords"][i]).numpy(), t_values(s["coords"][i]).numpy()
        assert ju.shape == tu.shape == (N_VAL, 2)
        np.testing.assert_allclose(tu, ju, rtol=0, atol=FIELD_TOL * np.abs(ju).max())
        j_rel = _rel_err(tc["pde"], j_values, s["coords"][i], s["gt_vals"][i])
        t_rel = _rel_err(tc["pde"], t_values, s["coords"][i], s["gt_vals"][i])
        assert np.isfinite(j_rel) and 0 < j_rel < 0.1
        np.testing.assert_allclose(t_rel, j_rel, rtol=REL_ERR_RTOL)
