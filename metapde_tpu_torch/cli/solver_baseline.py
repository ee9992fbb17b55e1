"""Classical-solver accuracy-vs-time baseline sweep entry point (counterpart
of metapde_tpu/cli/solver_baseline.py; pipeline/baseline.sh runs the JAX
one):

    python -m metapde_tpu_torch.cli.solver_baseline --task.pde=poisson \
        --solver.ground_truth_resolution=64 --task.n_eval=16 \
        --resolutions=2,4,8,16,32

Optional second sweep axis, and the higher-order oracle:

    --axis2=num_tsteps:17,33,65      # td_burgers time resolution
    --axis2=boundary_cap:48,96,192   # hyper_elasticity boundary refinement
    --oracle=richardson              # poisson's Richardson-extrapolated pair

plus the config's dotted flags and --device=NAME (CUDA unless given
--device=cpu). Writes <out_dir>/<expt_name>/errors_by_resolution.json.
"""

import sys

from ..config import Config, parse_overrides
from ..device import pop_device_flag
from ..train import baseline_driver


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    resolutions = (4, 8, 16, 32)
    axis2 = None
    oracle = "p1"
    rest = []
    for a in argv:
        if a.startswith("--resolutions="):
            resolutions = tuple(int(x) for x in a.split("=", 1)[1].split(","))
        elif a.startswith("--axis2="):
            name, vals = a.split("=", 1)[1].split(":", 1)
            axis2 = (name, tuple(int(x) for x in vals.split(",")))
        elif a.startswith("--oracle="):
            oracle = a.split("=", 1)[1]
        else:
            rest.append(a)
    cfg = parse_overrides(Config(), rest)
    return baseline_driver.run(cfg, spatial_resolutions=resolutions, axis2=axis2,
                               oracle=oracle, device=device)


if __name__ == "__main__":
    main()
