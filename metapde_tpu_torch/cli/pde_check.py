"""Per-family sampler and oracle check (counterpart of
metapde_tpu/cli/pde_check.py): draw one task's params and point sets,
solve its ground truth, evaluate it at 2048 validation points, and print
one JSON line of stats with the JAX CLI's keys (pde, n_point_sets,
gt_finite, gt_norm, and points_png / solution_png where the PNGs were
written):

    python -m metapde_tpu_torch.cli.pde_check --task.pde=poisson --out=/tmp/check

The PNGs ({out}/{pde}_points.png: the point sets coloured by set;
{out}/{pde}_solution.png: the ground truth at the validation points) are
written only where matplotlib is installed. The draws come from a
torch.Generator seeded --seed (the JAX CLI's PRNGKey(0) draws other
tasks); run() also takes a given task's params and validation points.
CUDA unless given --device=cpu.
"""

import json
import os
import sys

import numpy as np
import torch

from ..config import Config, parse_overrides
from ..device import DEFAULT_DEVICE, pop_device_flag, resolve_device
from ..pdes import get_pde
from ..train.viz import pyplot


def run(cfg: Config, out: str = "/tmp/pde_check", seed: int = 0, n: int = 256,
        resolution=None, device=DEFAULT_DEVICE, params=None, xs=None):
    """The stats dict (also printed). params / xs: the task and its
    validation points [2048, in_dim], drawn here when not given."""
    device = resolve_device(device) if isinstance(device, str) else device
    pde = get_pde(cfg.task)
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = pde.sample_params(gen)
    params = tuple(torch.as_tensor(a).to(device) for a in params)
    point_sets = pde.sample_points(gen, n, params)

    os.makedirs(out, exist_ok=True)
    stats = {"pde": pde.name, "n_point_sets": len(point_sets)}
    plt = pyplot()
    if plt is not None:
        fig, ax = plt.subplots(figsize=(5, 5))
        for i, pts in enumerate(point_sets):
            p = pts.detach().cpu().numpy()
            ax.scatter(p[:, 0], p[:, 1], s=4, label=f"set {i}")
        ax.legend(fontsize=6)
        ax.set_title(f"{pde.name} sampled point sets")
        fname = os.path.join(out, f"{pde.name}_points.png")
        fig.savefig(fname, dpi=140, bbox_inches="tight")
        plt.close(fig)
        stats["points_png"] = fname

    gt = pde.solve(params, resolution=resolution)
    if xs is None:
        xs = pde.sample_validation_points(gen, 2048, params, gt)
    xs = torch.as_tensor(xs).to(device)
    vals = pde.evaluate_gt(gt, xs).detach().cpu().numpy().astype(np.float64)
    vals = vals.reshape(vals.shape[0], -1)
    stats["gt_finite"] = bool(np.isfinite(vals).all())
    stats["gt_norm"] = float(np.sqrt(np.mean(vals ** 2)))

    if plt is not None:
        fig, ax = plt.subplots(figsize=(5.4, 5))
        c = np.linalg.norm(vals, axis=-1) if vals.shape[-1] > 1 else vals[:, 0]
        x = xs.detach().cpu().numpy()
        sc = ax.scatter(x[:, 0], x[:, 1], c=c, s=6)
        fig.colorbar(sc)
        ax.set_title(f"{pde.name} ground truth")
        fname = os.path.join(out, f"{pde.name}_solution.png")
        fig.savefig(fname, dpi=140, bbox_inches="tight")
        plt.close(fig)
        stats["solution_png"] = fname

    print(json.dumps(stats), flush=True)
    return stats


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    out, resolution, seed, rest = "/tmp/pde_check", None, 0, []
    for a in argv:
        if a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--resolution="):
            resolution = int(a.split("=", 1)[1])
        elif a.startswith("--seed="):
            seed = int(a.split("=", 1)[1])
        else:
            rest.append(a)
    cfg = parse_overrides(Config(), rest)
    return run(cfg, out=out, seed=seed, resolution=resolution, device=device)


if __name__ == "__main__":
    main()
