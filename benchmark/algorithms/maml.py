"""Second-order MAML (train/maml_driver.py) under the benchmark."""

import torch

from metapde_tpu_torch.train import maml_driver

from ..reference import maml as reference
from .common import adam_b1, flat, nested, program_config

REFERENCE = reference


class Program:
    """The driver's build; its state is (params, inner LRs, their two
    optimizer states), as train_step_many takes it."""

    def __init__(self, config: dict, device):
        self.cfg = program_config(config)
        self.c = maml_driver.build(self.cfg, device)

    def initial_state(self, init: dict):
        params = nested({k: v.clone() for k, v in init.items()})
        k = self.cfg.maml.inner_steps
        lrs = nested({n: torch.ones((k,) + tuple(v.shape), device=v.device)
                      for n, v in init.items()})
        return (params, lrs, self.c["outer_opt"].init(params), self.c["lr_opt"].init(lrs))

    def call(self, gen, state):
        """The timed call: one outer step of train_step_many."""
        out = self.c["train_step_many"](gen, *state, n_steps=1)
        return out[:4], {"ml": out[7][0], "losses": out[4]}

    def draw(self, gen):
        return self.c["draw_step_inputs"](gen)

    def step_core(self, batch, state):
        out = self.c["step_core"](batch, *state)
        return out[:4], {"ml": out[5][0].mean(), "losses": out[4]}

    def leaves(self, state) -> dict:
        return {**flat(state[0]), **flat(state[1], "lr:")}

    def first_gradient(self, state) -> dict:
        """The gradient each optimizer took in its first step, from its
        first moment m_1 = (1 - b1) g."""
        b1 = adam_b1(self.cfg.train.optimizer)
        return {**{k: m / (1 - b1) for k, m in flat(state[2]["mu"]).items()},
                **{k: m / (1 - 0.9) for k, m in flat(state[3]["mu"], "lr:").items()}}

    def replay(self, gen):
        """The draws of the step that `gen` (in the state that step found it)
        fed: the reference's batch, and the point sets by name for the check
        of the draws."""
        b = self.c["draw_all"](gen)
        k = self.cfg.maml.inner_steps
        batch = {"tp": tuple(b.task_params), "inner": tuple(b.inner_points),
                 "outer": tuple(b.outer_points)}
        points = {"inner_points": batch["inner"], "outer_points": batch["outer"]}
        sets = {"inner_points": (self.cfg.task.inner_points, k + 1),
                "outer_points": (self.cfg.task.outer_points, k + 1)}
        return batch, points, sets, self.cfg.maml.bsize
