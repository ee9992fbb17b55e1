"""Multi-start deployment: K candidate adaptations per task, the argmin of
a self-computable score kept (counterpart of
metapde_tpu/train/multistart.py).

On multi-stable tasks (post-buckling branches of the compressed porous
sheet) one adaptation can converge into a higher-energy basin; the total
task loss (domain energy plus the weighted BC penalty, the objective the
adaptation minimises) tells the basins apart without ground truth. So each
task runs K adaptations from independent point streams (candidates past 0
optionally from a jittered init), every candidate is scored on one common
fresh point draw of its task, and the argmin is kept; a NaN score loses.

Task-batched: candidate j of every task is one call of the driver's
batched deployment (K calls for T tasks). Candidate j's jitter is drawn
once from a generator seeded j and shared by the tasks of the call (the
JAX package draws it per task from the task's key: each task sees the same
distribution, N(0, 1) scaled by the leaf's RMS); candidate 0 is the exact
meta-learned init. A task's point streams and score draw come from its own
generator, so its result does not depend on the other tasks.
"""

from typing import Callable, NamedTuple

import torch

from ..utils.trees import tree_map, tree_stack


class MultistartAux(NamedTuple):
    scores: torch.Tensor    # [T, n_starts] common-point total loss per candidate
    best_idx: torch.Tensor  # [T] argmin of scores


def jitter_leaves(gen, params, scale):
    """Relative Gaussian init jitter: leaf + scale * rms(leaf) * N(0, 1),
    the rms per leaf (SIREN's layerwise init magnitudes); scale 0 leaves
    the params as they are. Draws on the generator's device."""

    def one(leaf):
        rms = torch.sqrt(torch.mean(leaf ** 2) + 1e-12)
        noise = torch.randn(leaf.shape, generator=gen, device=gen.device, dtype=leaf.dtype)
        return leaf + scale * rms * noise.to(leaf.device)

    return tree_map(one, params)


def make_score_fn(pde, loss_fn, field, n_points: int) -> Callable:
    """The total task loss (bc_weight * boundary + domain, the drivers'
    loss_fn) of field params on a point set drawn from `gen`."""

    def score(gen, field_params, task_params):
        pts = pde.sample_points(gen, n_points, task_params)
        loss, _ = loss_fn(field.bind(field_params), pts, task_params)
        return loss

    return score


def _seeds(gen, n):
    return [int(s) for s in torch.randint(0, 2 ** 62, (n,), generator=gen)]


def multistart_adapt(gens, model, task_params, adapt_batched: Callable, score_fn: Callable,
                     n_starts: int, jitter: float = 0.0, jitter_fn: Callable = None):
    """Adapt T tasks (task params stacked [T, ...]) from n_starts candidate
    streams each and keep each task's best.

    adapt_batched: (gens, model, task_params) -> params [T, ...];
    score_fn: (gen, field params, task params) -> scalar;
    jitter_fn: (gen, model, scale) -> model. Returns (params [T, ...],
    MultistartAux)."""
    n_tasks = task_params[0].shape[0]
    # per task: one seed per candidate's point stream, one for the score draw
    seeds = [_seeds(g, n_starts + 1) for g in gens]
    finals = []
    for j in range(n_starts):
        m = model
        if j > 0 and jitter > 0.0 and jitter_fn is not None:
            m = jitter_fn(torch.Generator().manual_seed(j), model, jitter)
        finals.append(adapt_batched([torch.Generator().manual_seed(s[j]) for s in seeds], m,
                                    task_params))
    with torch.no_grad():
        scores = torch.stack([
            torch.stack([score_fn(torch.Generator().manual_seed(seeds[i][n_starts]),
                                  tree_map(lambda x: x[i], fp),
                                  tuple(a[i] for a in task_params)) for fp in finals])
            for i in range(n_tasks)])                              # [T, n_starts]
        # a diverged candidate (NaN score) loses the selection, never wins it
        scores = torch.where(torch.isnan(scores), torch.full_like(scores, float("inf")), scores)
        best = torch.argmin(scores, dim=1)
        stacked = tree_stack(finals)                               # leaves [n_starts, T, ...]
        rows = torch.arange(n_tasks, device=best.device)
        best_params = tree_map(lambda x: x[best.to(x.device), rows.to(x.device)], stacked)
    return best_params, MultistartAux(scores=scores, best_idx=best)


def wrap_final_model_batched(final_model_batched: Callable, score_fn: Callable, n_starts: int,
                             jitter: float = 0.0, jitter_fn: Callable = None) -> Callable:
    """The multi-start version of a driver's batched deployment
    (gens, model, task_params, inner_steps, points=None) -> params [T, ...],
    with the same signature (the JAX package's wrap_get_final_model).
    Given points, every candidate adapts on them."""

    def ms_final_model_batched(gens, model, task_params, inner_steps: int, points=None):
        best, _ = multistart_adapt(
            gens, model, task_params,
            lambda g, m, tp: final_model_batched(g, m, tp, inner_steps, points),
            score_fn, n_starts, jitter=jitter, jitter_fn=jitter_fn)
        return best

    return ms_final_model_batched


def init_is_the_k0_field(cfg) -> bool:
    """Whether a deployment at k = 0 is the meta-learned init itself: not
    for a jittered multi-start, which picks among jittered inits there too."""
    return cfg.deploy.n_starts <= 1 or cfg.deploy.jitter == 0.0


def wrap_driver_deployment(cfg, pde, loss_fn, field, final_model_batched: Callable,
                           model_is_pair: bool) -> Callable:
    """A driver's batched deployment, wrapped in the multi-start when
    cfg.deploy.n_starts > 1 (scored on deploy.score_points or the
    validation points). model_is_pair: MAML's (params, learned LRs), whose
    LRs are never jittered; LEAP's params."""
    if cfg.deploy.n_starts <= 1:
        return final_model_batched
    score_fn = make_score_fn(pde, loss_fn, field,
                             cfg.deploy.score_points or cfg.task.validation_points)
    jitter_fn = ((lambda g, m, s: (jitter_leaves(g, m[0], s), m[1])) if model_is_pair
                 else jitter_leaves)
    return wrap_final_model_batched(final_model_batched, score_fn, cfg.deploy.n_starts,
                                    jitter=cfg.deploy.jitter, jitter_fn=jitter_fn)
