"""Hybrid entry point: one MAML warm-up adaptation from a meta-learned
checkpoint (with its learned inner LRs), then plain PINN training
(counterpart of metapde_tpu/cli/nn_pde_maml.py):

    python -m metapde_tpu_torch.cli.nn_pde_maml --task.pde=poisson \
        --train.load_model_from_expt=results_poisson_maml/tpu_run6b \
        --maml.inner_steps=5 --maml.inner_lr=1e-4 --maml.outer_lr=1e-5 \
        --train.outer_steps=200

The JAX CLI's flags plus --device=NAME: CUDA unless given --device=cpu.
"""

import sys

from ..config import Config, parse_overrides
from ..device import pop_device_flag
from ..train import nn_driver


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    cfg = parse_overrides(Config(), argv)
    return nn_driver.run(cfg, maml_warmup=True, device=device)


if __name__ == "__main__":
    main()
