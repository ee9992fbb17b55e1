"""The whole step's share of the card's peak, in %: the analytic
matrix-product FLOPs of a step (flops.py) times train_steps_per_s of the
run's untraced window, over the dense bf16 peak."""


def read(m):
    if not m["peak_flops"]:
        return None
    return 100.0 * m["flops_per_step"] * m["train_steps_per_s"] / m["peak_flops"]
