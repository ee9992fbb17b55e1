"""Stand-ins for the program that the check of `correct` has to refuse:
the reference put in the program's place at a lower precision (the
control), and faults planted in the program itself.

Each is a context manager that yields the algorithm adapter to hand to
harness.run_cell (or harness.checked_steps): the real one with its
Program replaced, or patched underneath.
"""

import contextlib
import types

from .reference import optim


class ReferenceAsProgram:
    """The reference in the program's place, driven by the program's own
    draws (draw_all) on the program's generator, in TF32 with `tf32`."""

    def __init__(self, algo, tf32: bool):
        self.algo, self.tf32 = algo, tf32

    def __call__(self, config, device):
        self.prog = self.algo.Program(config, device)
        self.hp, self.device = optim.hyper(config), device
        self.block = config.get("reference_block_tasks", 0)
        self.pde = __import__(f"benchmark.reference.pdes.{self.hp['task.pde']}",
                              fromlist=["task_loss"])
        return self

    def initial_state(self, init):
        return self.algo.REFERENCE.init_state({k: v.clone() for k, v in init.items()}, self.hp)

    def call(self, gen, state):
        batch, _, _, _ = self.prog.replay(gen)
        batch = {k: tuple(x.to(self.device) for x in v) for k, v in batch.items()}
        with optim.precision(self.tf32):
            return self.algo.REFERENCE.step(state, batch, self.pde.task_loss, self.hp,
                                            self.block)

    def leaves(self, state):
        return self.algo.REFERENCE.leaves(state)

    def first_gradient(self, state):
        """From the first moments, as the program's is read: m_1 = 0.1 g."""
        return {**{k: m / 0.1 for k, m in state["opt"]["mu"].items()},
                **{"lr:" + k: m / 0.1 for k, m in state["lr_opt"]["mu"].items()}}

    def replay(self, gen):
        return self.prog.replay(gen)


@contextlib.contextmanager
def control(algo, tf32: bool = True):
    """The reference in TF32 in the program's place."""
    yield types.SimpleNamespace(Program=ReferenceAsProgram(algo, tf32),
                                REFERENCE=algo.REFERENCE)


@contextlib.contextmanager
def half_batch(algo):
    """The program's meta-gradient over the first half of the tasks alone,
    the mean taken over those."""
    engine = __import__(f"metapde_tpu_torch.meta.{algo.__name__.rsplit('.', 1)[1]}",
                        fromlist=["multi_task_grad_and_losses"])
    whole = engine.multi_task_grad_and_losses

    def halved(defn, task_loss, batch, *args, **kw):
        n = batch.task_params[0].shape[0] // 2
        part = type(batch)(*(tuple(x[:n] for x in field) for field in batch))
        return whole(defn, task_loss, part, *args, **kw)

    engine.multi_task_grad_and_losses = halved
    try:
        yield algo
    finally:
        engine.multi_task_grad_and_losses = whole


@contextlib.contextmanager
def unchanged_state(algo):
    """A timed call that returns the state it was given."""
    class Stuck(algo.Program):
        def call(self, gen, state):
            _, out = super().call(gen, state)
            return state, out

    yield types.SimpleNamespace(Program=Stuck, REFERENCE=algo.REFERENCE)


FAULTS = {"tf32_control": control, "half_batch": half_batch, "unchanged_state": unchanged_state}


def bf16_program(config: dict) -> dict:
    """The program's own lower-precision chain switched on."""
    return {**config, "settings": {**config["settings"], "model.compute_dtype": "bfloat16"}}
