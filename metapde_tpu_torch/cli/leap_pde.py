"""LEAP meta-training entry point (counterpart of metapde_tpu/cli/leap_pde.py).

    python -m metapde_tpu_torch.cli.leap_pde --task.pde=poisson \
        --leap.bsize=8 --leap.inner_steps=60 --leap.inner_lr=2.5e-5 \
        --leap.outer_lr=5e-5 --task.inner_points=4096 \
        --train.expt_name=default

The JAX CLI's flags (dotted config paths, config.parse_overrides, including
--from_run=DIR) plus --device=NAME: CUDA unless given --device=cpu.
--task.pde is any family of the JAX package (results_burgers_leap/ldb3_2
and results_elasticity_leap/lde2_3 are committed 10x128 LEAP runs).
Sharded over a (dp, pt) mesh as cli/maml_pde is (its docstring has the
launcher's command): --mesh.n_task_shards / --mesh.n_point_shards under
`python -m torch.distributed.run --nproc_per_node=N`.
"""

import sys

from ..config import Config, parse_overrides
from ..device import pop_device_flag
from ..parallel.mesh import process_group
from ..train import leap_driver


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    cfg = parse_overrides(Config(), argv)
    with process_group(device):
        return leap_driver.run(cfg, device=device)


if __name__ == "__main__":
    main()
