"""Self-computable deployment score (counterpart of
metapde_tpu/train/multistart.py::make_score_fn; the multi-start adaptation
itself is not ported yet)."""

from typing import Callable


def make_score_fn(pde, loss_fn, field, n_points: int) -> Callable:
    """The total task loss (bc_weight * boundary + domain, the drivers'
    loss_fn) of field params on a point set drawn from `gen`."""

    def score(gen, field_params, task_params):
        pts = pde.sample_points(gen, n_points, task_params)
        loss, _ = loss_fn(field.bind(field_params), pts, task_params)
        return loss

    return score
