"""The JAX package's solver sweeps on the port's tasks: the bars of
chip_smoke.py's solver_baseline, solver_baseline_burgers,
solver_baseline_elasticity and gt_convergence_steady phases.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_solver_sweep_bar.py \
        [--n_eval=4] [--ref=32] [--resolutions=4,8,16] [--axis2=NAME:V1,V2] \
        [--gt_convergence [--seed=0] [--n_points=1024]] [config flags]

The sweep (default): draws the tasks and validation coords as the port's
train/baseline_driver.run draws them (a host generator seeded cfg.seed:
the tasks, then each task's coords after its reference solve), solves each
task with the JAX package's float64 reference (the family's solve_ref) at
--ref and its production solve at each resolution (crossed with --axis2's
values, each passed to the solve as that keyword), evaluates every ground
truth as the JAX baseline driver does, and prints one JSON line: rel_mse
per label by that driver's formula (metapde_tpu/train/baseline_driver.py:
104-107) and each task's. --gt_convergence: the port's cli/gt_convergence
tasks instead (a generator seeded --seed: the tasks; task i's points from
one seeded 1000 + i) and its formula (the sums over every task's points).
Not a test: a float64 solve takes seconds to minutes on a CPU.

Config flags (e.g. --task.pde=td_burgers) set the family as the port's
CLIs take them. Measured on an 8-core CPU (JAX 0.9.0), the bars of
chip_smoke.py's JAX_*SAME_TASK* constants (rel_mse by label):
- (no flags) --n_eval=4 --ref=32 --resolutions=4,8,16:
  4 2.5967916313398074e-05, 8 2.6280354278605e-06, 16 1.5730399460911436e-07
- TD=--task.pde=td_burgers --task.domain.xmin=0.0 --task.vary_source=false
  --task.max_reynolds=100 --task.num_tsteps=9;
  $TD --n_eval=8 --ref=512 --resolutions=16,32,64,128,256:
  16 0.02044256393878939, 32 0.0066570638418489095, 64 0.0019484726255065252,
  128 0.00043480284556354906, 256 5.342175209587893e-05;
  $TD --n_eval=1 --ref=512 --resolutions=64 --axis2=num_tsteps:5,9,33:
  5 0.056243572943702934, 9 0.0033910190014777635, 33 0.0033910190014777635
- HE=--task.pde=hyper_elasticity --task.domain.xmin=0.0 --task.domain.ymin=0.0
  --task.max_holes=5 --task.max_hole_size=1.0 --task.vary_source=false
  --task.vary_bc=false;
  $HE --n_eval=1 --ref=64 --resolutions=8,16,32: 8 0.0064991866019509775,
  16 0.002409478116875215, 32 0.00093817434363767;
  $HE --n_eval=1 --ref=64 --resolutions=8 --axis2=boundary_cap:8,192:
  8 0.07490928253134559, 192 0.0064991866019509775
- --task.pde=steady_burgers --gt_convergence --n_eval=1 --ref=48
  --resolutions=16,24,32: 16 0.2555787736267877, 24 0.004443109203005451,
  32 0.0004324142065702798
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.train import baseline_driver


def main(argv):
    opts = {"n_eval": "4", "ref": "32", "resolutions": "4,8,16", "axis2": "", "seed": "0",
            "n_points": "1024"}
    flags, conv = [], False
    for a in argv:
        name, _, value = a[2:].partition("=")
        if a == "--gt_convergence":
            conv = True
        elif name in opts:
            opts[name] = value
        else:
            flags.append(a)
    cfg = parse_overrides(Config(), flags)
    pde, j_pde = get_pde(cfg.task), j_get_pde(j_parse_overrides(JConfig(), flags).task)
    n, ref_res = int(opts["n_eval"]), int(opts["ref"])
    if conv:
        gen = torch.Generator().manual_seed(int(opts["seed"]))
        tasks = [pde.sample_params(gen) for _ in range(n)]
        coords = [pde.sample_validation_points(torch.Generator().manual_seed(1000 + i),
                                               int(opts["n_points"]), tp)
                  for i, tp in enumerate(tasks)]
    else:
        gen = torch.Generator().manual_seed(cfg.seed)
        tasks = [pde.sample_params(gen) for _ in range(n)]
        coords, _ = baseline_driver.reference(pde, tasks, gen, cfg.task.validation_points,
                                              ref_res)
    j_tasks = [tuple(jnp.asarray(a.numpy()) for a in tp) for tp in tasks]
    j_coords = [jnp.asarray(c.numpy()) for c in coords]

    def values(gt, x):
        v = np.asarray(jax.vmap(lambda p: j_pde.evaluate_gt(gt, p))(x), np.float64)
        return v.reshape(v.shape[0], -1)

    solve_ref = j_pde.solve_ref or j_pde.solve
    refs = [values(solve_ref(tp, resolution=ref_res), x) for tp, x in zip(j_tasks, j_coords)]
    ax2_name, ax2_values = (None, (None,))
    if opts["axis2"]:
        ax2_name, vals = opts["axis2"].split(":")
        ax2_values = tuple(int(v) for v in vals.split(","))
    rows = {}
    for res in map(int, opts["resolutions"].split(",")):
        for v2 in ax2_values:
            kw = {} if v2 is None else {ax2_name: v2}
            errs, num, den = [], 0.0, 0.0
            for tp, x, ref in zip(j_tasks, j_coords, refs):
                v = values(j_pde.solve(tp, resolution=res, **kw), x).reshape(ref.shape)
                normalizer = np.mean(ref ** 2, axis=0, keepdims=True).mean()
                errs.append(float(np.mean((v - ref) ** 2 / max(normalizer, 1e-12))))
                num, den = num + float(np.sum((v - ref) ** 2)), den + float(np.sum(ref ** 2))
            label = str(res) if v2 is None else f"{res},{ax2_name}={v2}"
            rows[label] = ({"rel_mse": num / max(den, 1e-30)} if conv else
                           {"rel_mse": float(np.mean(errs)), "per_task": errs})
    print(json.dumps({"pde": cfg.task.pde, "n_eval": n, "ref": ref_res,
                      "gt_convergence": conv, "flags": flags, "rows": rows}))


if __name__ == "__main__":
    main(sys.argv[1:])
