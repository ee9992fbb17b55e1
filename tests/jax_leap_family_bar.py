"""The JAX package's validation of ldb3_2 and lde2_3 on the port's eval
tasks: the bars of chip_smoke.py's leap_burgers_train and
leap_elasticity_train phases.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_leap_family_bar.py [ldb3_2|lde2_3 ...]

For each run: the checkpoint the phase resumes (ldb3_2's step 40000,
lde2_3's latest, step 47999), the eval tasks, validation coords and ground
truth that the port's cli/leap_pde draws when it resumes a JAX checkpoint
(a host generator seeded cfg.seed, after the init draws, gives the eval
seed; train/loop.py::eval_ground_truth), solved by the port on the CPU;
then the JAX package's make_validation_fn (with the family's per-timestep
or mirror options) over its LEAP driver's make_coef_func from that
checkpoint. Prints one JSON line a run: val_rel_err and the per-task
relative errors. The run's own last logged val_rel_err was taken on the
JAX run's eval tasks, which the port cannot draw (its tasks come from
torch generators, not threefry): on the port's 4 tasks ldb3_2's task 3
alone scores 4.7e-2. Not a test: 80 adaptation steps of 4 tasks at
10x128 take minutes on a CPU.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import leap_driver as j_leap_driver
from metapde_tpu.train.validation import make_validation_fn as j_make_validation_fn
from metapde_tpu_torch.config import load_run_config
from metapde_tpu_torch.train import leap_driver, loop

REPO = Path(__file__).resolve().parents[1]
RUNS = {"ldb3_2": (REPO / "results_burgers_leap" / "ldb3_2", "checkpoint_step_40000.pickle"),
        "lde2_3": (REPO / "results_elasticity_leap" / "lde2_3",
                   "checkpoint_step_47999.pickle")}


def port_eval_bundle(run):
    """The eval tasks, coords and ground truth of a resumed port run."""
    cfg = load_run_config(str(run))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, out_dir=""))
    c = leap_driver.build(cfg, "cpu")
    eval_seed = int(torch.randint(0, 2 ** 62, (1,), generator=c["generator"]))
    return loop.eval_ground_truth(cfg, c["pde"], eval_seed, torch.device("cpu"),
                                  lambda *_: None)


def main(names):
    for name in names or list(RUNS):
        run, ckpt = RUNS[name]
        bundle = port_eval_bundle(run)
        j_cfg = j_load_run_config(str(run))
        jc = j_leap_driver.build(j_cfg)
        params = jax.tree_util.tree_map(jnp.asarray, j_ckpt.load_checkpoint(str(run / ckpt))
                                        ["params"])
        gt_params = tuple(jnp.asarray(torch.stack([t[j] for t in bundle.gt_params]).numpy())
                          for j in range(len(bundle.gt_params[0])))
        kw = loop.validation_kwargs(load_run_config(str(run)).task)
        val = j_make_validation_fn(j_get_pde(j_cfg.task), jc["make_coef_func"],
                                   j_cfg.task.n_eval, **kw)(
            params, gt_params, jnp.asarray(bundle.coords.numpy()),
            jnp.asarray(bundle.gt_vals.numpy()))
        print(json.dumps({"run": name, "checkpoint": ckpt, "n_eval": j_cfg.task.n_eval,
                          "val_rel_err": float(val.rel_err),
                          "val_rel_err_median": float(val.rel_err_median),
                          "val_rel_err_std": float(val.rel_err_std),
                          "eval_tasks": [[np.asarray(a).tolist() for a in t]
                                         for t in bundle.gt_params]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
