"""How far f32 rounding alone moves a long optimizer deployment of the
committed LEAP run, against how far the port moves from the JAX package.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/measure_opt_deploy_divergence.py \
        [--from_run=results_poisson_leap/lp2_4] [--k=1,10,25,50,100,200]

On one of the JAX deploy_bench's eval tasks (the eighth of its seed's
draw) and the 4096 points JAX's final_model draws for it, k Adam steps at
deploy.inner_lr from lp2_4's checkpoint run three ways: the JAX package,
the JAX package on the same points in another order (the same loss, summed
in another order), and the port (train/deploy.make_opt_final_model). For
each k it prints the largest difference of a leaf over that leaf's scale,
JAX against reordered JAX and port against JAX. Then it deploys all 8 of
JAX's eval tasks at the largest k in both packages on the same points and
prints each task's relative squared error against JAX's cached ground
truth (the run dir's sibling gt_cache/, as the JAX CLI fills it; missing
entries are solved). The CPU takes a few minutes.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from metapde_tpu.config import load_run_config as j_load_run_config
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import leap_driver as j_driver
from metapde_tpu.train.gt_cache import task_cache_extra
from metapde_tpu.train.optimizers import get_optimizer
from metapde_tpu.train.validation import get_ground_truth
from metapde_tpu_torch.config import load_run_config, parse_overrides
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.train import leap_driver
from metapde_tpu_torch.utils.trees import tree_leaves


def _leaf_diff(xs, ys):
    return max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-3)
               for a, b in zip(xs, ys))


def main(argv):
    run_dir, ks = "results_poisson_leap/lp2_4", (1, 10, 25, 50, 100, 200)
    for a in argv:
        if a.startswith("--from_run="):
            run_dir = a.split("=", 1)[1]
        elif a.startswith("--k="):
            ks = tuple(int(k) for k in a.split("=", 1)[1].split(","))
    over = ["--deploy.optimizer=adam", "--task.n_eval=8"]
    cfg = j_parse_overrides(j_load_run_config(run_dir), over)
    jc = j_driver.build(cfg)
    tc = leap_driver.build(parse_overrides(load_run_config(run_dir), over), "cpu")
    pde, n = jc["pde"], cfg.task.inner_points
    fname = j_ckpt.latest_checkpoint(run_dir)
    params = jax.tree_util.tree_map(jnp.asarray, j_ckpt.load_checkpoint(fname)["params"])
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))

    # the JAX deploy_bench's eval tasks and final_model keys
    _, gt_key, pts_key = jax.random.split(jax.random.PRNGKey(cfg.seed + 7919), 3)
    gt_keys = jax.random.split(gt_key, cfg.task.n_eval)
    gt_params = jax.vmap(pde.sample_params)(gt_keys)
    keys = jax.random.split(jax.random.PRNGKey(0), cfg.task.n_eval)
    tasks = [jax.tree_util.tree_map(lambda a: a[i], gt_params) for i in range(len(keys))]
    points = [pde.sample_points(jax.random.split(k)[0], n, tp) for k, tp in zip(keys, tasks)]

    def t_batch(idx):
        return (tuple(torch.stack([torch.tensor(np.asarray(tasks[i][j])) for i in idx])
                      for j in range(3)),
                tuple(torch.stack([torch.tensor(np.asarray(points[i][j]))[None] for i in idx])
                      for j in range(2)))

    # 1. divergence along one task's trajectory
    opt = get_optimizer(cfg.deploy.optimizer, cfg.deploy.inner_lr)
    tp, pts = tasks[-1], points[-1]
    perm = np.random.default_rng(0).permutation(n)

    def jax_trajectory(pts):
        @jax.jit
        def step(p, s):
            g = jax.grad(lambda fp: jc["loss_fn"](jc["field"].bind(fp), pts, tp)[0])(p)
            u, s = opt.update(g, s, p)
            return optax.apply_updates(p, u), s

        p, s, out = params, opt.init(params), {}
        for i in range(1, max(ks) + 1):
            p, s = step(p, s)
            if i in ks:
                out[i] = [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]
        return out

    ref, reordered = jax_trajectory(pts), jax_trajectory(tuple(p[perm] for p in pts))
    final = tc["deploy_final_model_batched"]
    t_tp, t_pts = t_batch([len(tasks) - 1])
    for k in ks:
        ours = [t[0].numpy() for t in tree_leaves(final(None, t_params, t_tp, k, t_pts))]
        print(f"k={k}: JAX vs reordered JAX {_leaf_diff(reordered[k], ref[k]):.3e}, "
              f"port vs JAX {_leaf_diff(ours, ref[k]):.3e}", flush=True)

    # 2. every eval task at the largest k, against JAX's ground truth
    k = max(ks)
    bundle = get_ground_truth(
        pde, gt_params, pts_key, cfg.task.validation_points,
        cfg.solver.ground_truth_resolution,
        cache_dir=os.path.join(os.path.dirname(run_dir.rstrip("/")) or ".", "gt_cache"),
        cache_extra=task_cache_extra(cfg.task), cache_keys=gt_keys)
    j_coefs = np.asarray(jax.jit(jax.vmap(lambda key, tp, c: jc["make_coef_func"](
        key, params, tp, c, inner_steps=k)))(keys, gt_params, bundle.coords))
    t_tp, t_pts = t_batch(range(len(tasks)))
    t_coefs = tc["make_coef_func_batched"](
        None, t_params, [tuple(a[i] for a in t_tp) for i in range(len(tasks))],
        torch.tensor(np.asarray(bundle.coords)), inner_steps=k, points=t_pts).numpy()
    gt = np.asarray(bundle.gt_vals)[..., 0]
    for name, c in (("JAX", j_coefs), ("port", t_coefs)):
        rel = ((c - gt) ** 2).mean(1) / (gt ** 2).mean(1)
        print(f"k={k} {name}: rel err per task {np.array2string(rel, precision=3)}, "
              f"median {np.median(rel):.4e}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
