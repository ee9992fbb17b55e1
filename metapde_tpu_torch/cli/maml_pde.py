"""MAML meta-training entry point (counterpart of metapde_tpu/cli/maml_pde.py).

    python -m metapde_tpu_torch.cli.maml_pde --task.pde=poisson \
        --maml.bsize=16 --maml.inner_steps=5 --maml.inner_lr=1e-4 \
        --maml.outer_lr=1e-5 --task.inner_points=1024 --task.outer_points=1024 \
        --train.expt_name=default

The JAX CLI's flags (dotted config paths, config.parse_overrides, including
--from_run=DIR) plus --device=NAME: CUDA unless given --device=cpu.
--task.pde is any family of the JAX package (poisson, td_burgers,
hyper_elasticity, steady_burgers, poisson3d); a td_burgers run validates
against the FV ground truth and writes the per-timestep error to
metrics.jsonl:

    python -m metapde_tpu_torch.cli.maml_pde --from_run=results_burgers_maml/bm7_5 \
        --train.outer_steps=500011 --train.expt_name=more

and a poisson3d run validates against the exact manufactured solution.

Sharded over a (dp, pt) mesh, one process per rank, started by the
launcher (WORLD_SIZE set: the process group starts before the build, with
nccl when every rank has a card of its own, gloo when ranks share one or
on the CPU; rank 0 writes the run directory), e.g. pipeline/maml_meta_3d.sh
on two cards:

    python -m torch.distributed.run --standalone --nproc_per_node=2 \
        -m metapde_tpu_torch.cli.maml_pde --task.pde=poisson3d \
        --mesh.n_task_shards=2 --maml.bsize=32 ...

The world size must equal n_task_shards * n_point_shards; under the
launcher --device=cpu runs gloo ranks on the CPU.
"""

import sys

from ..config import Config, parse_overrides
from ..device import pop_device_flag
from ..parallel.mesh import process_group
from ..train import maml_driver


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    cfg = parse_overrides(Config(), argv)
    with process_group(device):
        return maml_driver.run(cfg, device=device)


if __name__ == "__main__":
    main()
