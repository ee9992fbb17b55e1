"""Solution plots from a meta-learned checkpoint (counterpart of
metapde_tpu/cli/solution_viz.py): train/viz.py's ground truth beside the
model adapted k steps, on fresh tasks, after training instead of at
viz_every:

    python -m metapde_tpu_torch.cli.solution_viz --algo=maml \
        --train.load_model_from_expt=results_poisson_maml/p30k_f32_s1 \
        --inner-steps-list=0,2,5 --out=figures/poisson_solutions.png \
        --from_run=results_poisson_maml/p30k_f32_s1  # or the training flags

The tasks are the JAX CLI's fresh ones by seed (cfg.seed + 7919; host
draws, so a CPU and a card run plot the same tasks, which are not JAX's),
their ground truth through deploy_bench's cache, gt_cache_torch/ beside the
run dir; the latest checkpoint. td_burgers draws the (x, t) time series of
the first task at the largest k instead of the 2-D fields. CUDA unless given
--device=cpu. The PNG is written where matplotlib is installed; without it
the figure's name is None (the drawing returns before any adaptation, as
the JAX package's does).
"""

import dataclasses
import os
import sys

import torch

from ..config import Config, parse_overrides
from ..device import DEFAULT_DEVICE, pop_device_flag, resolve_device
from ..train import leap_driver, maml_driver, viz
from .deploy_bench import eval_tasks, load_model


def run(cfg: Config, algo: str, inner_steps_list, out: str, n_tasks: int = 3,
        device=DEFAULT_DEVICE):
    """Render the figure; returns its file name (None without matplotlib)."""
    device = resolve_device(device) if isinstance(device, str) else device
    c = (maml_driver if algo == "maml" else leap_driver).build(cfg, device)
    pde, field = c["pde"], c["field"]
    model = load_model(cfg, c, "latest", device, algo)[0]
    bundle = eval_tasks(dataclasses.replace(
        cfg, task=dataclasses.replace(cfg.task, n_eval=max(n_tasks, 1))), pde, device)

    def adapt(i, task_params, k):
        return c["get_final_model"](torch.Generator().manual_seed(0), model, task_params, k)

    out_dir = os.path.dirname(out) or "."
    os.makedirs(out_dir, exist_ok=True)
    if cfg.task.pde == "td_burgers":
        fname = viz.plot_burgers_time_series(
            out_dir, pde, bundle.gts[0], bundle.gt_params[0], adapt, max(inner_steps_list),
            field.apply, step=None)
    else:
        dom = cfg.task.domain
        fname = viz.compare_plots_with_ground_truth(
            out_dir, pde, bundle.gts, bundle.gt_params, adapt,
            inner_steps_list=tuple(inner_steps_list), n_tasks=n_tasks,
            bounds=(dom.xmin, dom.xmax, dom.ymin, dom.ymax), field_apply=field.apply,
            step=None)
    if fname and os.path.basename(fname) != os.path.basename(out):
        os.replace(fname, os.path.join(out_dir, os.path.basename(out)))
        fname = os.path.join(out_dir, os.path.basename(out))
    print(fname)
    return fname


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    algo, steps, out, n_tasks, rest = "maml", (0, 2, 5), "figures/solutions.png", 3, []
    for a in argv:
        if a.startswith("--algo="):
            algo = a.split("=", 1)[1]
        elif a.startswith("--inner-steps-list="):
            steps = tuple(int(x) for x in a.split("=", 1)[1].split(","))
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--n-tasks="):
            n_tasks = int(a.split("=", 1)[1])
        else:
            rest.append(a)
    cfg = parse_overrides(Config(), rest)
    return run(cfg, algo, steps, out, n_tasks, device=device)


if __name__ == "__main__":
    main()
