"""LEAP meta-training on TD-Burgers (pipeline/leap_meta.sh's second
command): one outer step of metapde_tpu_torch.train.leap_driver from the
committed ldb3_2 checkpoint against metapde_tpu.train.leap_driver's
train_step, on JAX's own draws.

Both packages resume results_burgers_leap/ldb3_2/checkpoint_step_40000
(10x128, its Adam state; ldb3_2's norm, loss_in_distance and stabilize
all on) and take one step cut to bsize 2, 2 inner steps and 64 points.
Measured on this step: params 9.5e-8 of a leaf's scale, the
meta-gradient (from the new Adam moment) 3.4e-5 of a leaf's largest entry
and 7.0e-6 of the tree's norm, the per-task losses 1.7e-6 and the
meta-gradient norm 3.5e-6 relative. Bars, tighter than the ones
tests/test_torch_energy.py sets for lde2_3 (1e-4, 1e-1, 1e-3, 1e-4: there
the d_loss cancellation under loss_in_distance reaches a few leaves) and
above these by 3x or more: params within 1e-6 of each leaf's scale, the
meta-gradient within 1e-3 of each leaf's largest entry and 1e-4 of the
tree's norm, losses and the norm rtol 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import leap_driver as j_leap_driver
from metapde_tpu_torch.config import load_run_config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.train import checkpoints, leap_driver, optimizers

from test_torch_hyper_elasticity import _close_meta_grads, _close_trees, _leap_draws

torch.set_num_threads(2)

LDB3_2 = Path(__file__).resolve().parents[1] / "results_burgers_leap" / "ldb3_2"
CUTS = ["--leap.bsize=2", "--leap.inner_steps=2", "--task.inner_points=64",
        "--train.viz_every=0"]


def test_leap_step_from_ldb3_2_matches_jax():
    j_cfg = j_parse_overrides(j_load_run_config(str(LDB3_2)), CUTS)
    t_cfg = parse_overrides(load_run_config(str(LDB3_2)), CUTS)
    assert (t_cfg.leap.norm, t_cfg.leap.loss_in_distance, t_cfg.leap.stabilize) == (
        True, True, True)
    jc, tc = j_leap_driver.build(j_cfg), leap_driver.build(t_cfg, "cpu")
    ck = str(LDB3_2 / "checkpoint_step_40000.pickle")
    js, ts = j_ckpt.load_checkpoint(ck), checkpoints.load_checkpoint(ck)
    j_state = tuple(jax.tree_util.tree_map(jnp.asarray, js[k]) for k in ("params", "opt_state"))
    t_state = (params_from_numpy(ts["params"]), optimizers.from_jax_state("adam", ts["opt_state"]))
    key = jax.random.PRNGKey(12)
    out = jc["train_step"](key, *j_state)
    batch = _leap_draws(jc["pde"], j_cfg, key)
    # the four TD-Burgers point kinds, 2K + 1 sets a task
    assert [tuple(p.shape[:2]) for p in batch.points] == [(2, 5)] * 4
    t_out = tc["step_core"](batch, *t_state)
    _close_trees(t_out[0], out[0], 1e-6)
    _close_meta_grads(t_out[1], out[1], js["opt_state"][0][1], 1e-3, tree_rel=1e-4)
    np.testing.assert_allclose(t_out[2].numpy(), np.asarray(out[2]), rtol=1e-5)
    np.testing.assert_allclose(float(t_out[3]), float(out[3]), rtol=1e-5)
