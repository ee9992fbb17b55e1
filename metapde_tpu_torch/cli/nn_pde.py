"""Plain-PINN / deployment fine-tune entry point (counterpart of
metapde_tpu/cli/nn_pde.py):

    python -m metapde_tpu_torch.cli.nn_pde --task.pde=poisson \
        --train.load_model_from_expt=results_poisson_leap/lp2_4 \
        --model.num_layers=5 --maml.outer_lr=2.5e-5 --train.outer_steps=200

The JAX CLI's flags (dotted config paths, config.parse_overrides) plus
--device=NAME: CUDA unless given --device=cpu. Seed sweeps go through
cli/sweep.py.
"""

import sys

from ..config import Config, parse_overrides
from ..device import pop_device_flag
from ..train import nn_driver


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device, argv = pop_device_flag(argv)
    cfg = parse_overrides(Config(), argv)
    return nn_driver.run(cfg, maml_warmup=False, device=device)


if __name__ == "__main__":
    main()
