"""PDE task registry (counterpart of metapde_tpu/pdes/registry.py).

A PdeDef bundles the pure functions of one task family. Samplers take a
torch.Generator (draws happen on the generator's device); loss functions
take explicit points, so tests can pass in the points JAX drew. On a card
the batched point samplers read nothing back to the host: their constants
are filled on the device (constant) and their choices drawn without
torch.multinomial's host checks (multinomial).
"""

from typing import Callable, NamedTuple

import torch

from ..config import TaskConfig


class PdeDef(NamedTuple):
    name: str
    in_dim: int        # coordinate dimension fed to the field
    out_dim: int       # field output dimension
    scalar: bool       # scalar field (out squeezed to [N])
    sample_params: Callable          # gen -> task params (tuple of tensors)
    sample_points: Callable          # (gen, n, params) -> tuple of point sets
    sample_points_in_domain: Callable  # (gen, n, params) -> [n, in_dim]
    loss_fn: Callable  # (field_fn, points, params) -> (boundary_losses, domain_losses)
    solve: Callable    # (params, resolution) -> ground-truth tuple
    evaluate_gt: Callable  # (gt, x [N, in_dim]) -> values [N]
    sample_validation_points: Callable  # (gen, n, params, gt) -> [n, in_dim]
    # (gen, n, params stacked over T tasks, sets) -> point sets [T, sets, n, ...]
    sample_points_batched: Callable = None
    gt_version: int = 1  # bump when the ground-truth scheme changes (cache key)
    solve_ref: Callable = None  # (params, resolution) -> float64 reference solve
    solve_hi: Callable = None   # (params, resolution) -> higher-order oracle
    evaluate_gt_hi: Callable = None  # evaluation matching solve_hi's order
    # (params list, resolution) -> ground truths of several tasks in one solve
    solve_batched: Callable = None
    # (params list, resolution) -> solve_ref of several tasks in one solve
    solve_ref_batched: Callable = None
    # (params, requested resolution) -> the resolution the oracle solves at
    effective_resolution: Callable = None
    # (params, resolution, warm_start, ref=False) -> a re-solve that starts
    # from another resolution's ground truth of the same task
    solve_warm: Callable = None
    # pools of point kinds (indices into the points tuple) that one loss
    # term averages as one set; the pt split keeps a pool all split or all
    # whole (parallel/sharding.py::split_kinds)
    pooled_kinds: tuple = ()


def constant(values, device, dtype=torch.float32):
    """torch.as_tensor(values, dtype=dtype, device=device) of a float or a
    list of floats, filled on the device: the same bits, with no copy from
    the host (a pageable copy to a card waits for its queue). A tensor is
    moved as it is."""
    if torch.is_tensor(values):
        return values.to(device, dtype)
    if isinstance(values, (list, tuple)):
        return torch.stack([constant(v, device, dtype) for v in values])
    return torch.full((), values, dtype=dtype, device=device)


def multinomial(weights, n: int, replacement: bool, gen):
    """torch.multinomial(weights, n, replacement, generator=gen), bit for
    bit. Without replacement or for one sample torch draws by exponential
    keys on every device, after checks that a card reads back to the host;
    this runs the same algorithm without them: keys q ~ Exp(1), the top n
    of weights / q. The families' weights are finite and non-negative by
    construction."""
    if replacement and n > 1:
        return torch.multinomial(weights, n, replacement=True, generator=gen)
    keys = weights / torch.empty_like(weights).exponential_(1.0, generator=gen)
    if n == 1:
        return torch.argmax(keys, dim=-1, keepdim=True)
    return torch.topk(keys, n).indices


def solve_many(pde, params_list, resolution):
    """The ground truths of several tasks: one pde.solve_batched call when
    the family has it, else one pde.solve each."""
    if getattr(pde, "solve_batched", None) is not None:
        return pde.solve_batched(params_list, resolution=resolution)
    return [pde.solve(p, resolution=resolution) for p in params_list]


def get_pde(cfg: TaskConfig) -> PdeDef:
    """Build the PdeDef for cfg.pde in {poisson, td_burgers,
    hyper_elasticity, steady_burgers, poisson3d}."""
    if cfg.pde == "poisson":
        from . import poisson

        return poisson.make_pde(cfg)
    if cfg.pde == "td_burgers":
        from . import td_burgers

        return td_burgers.make_pde(cfg)
    if cfg.pde == "hyper_elasticity":
        from . import hyper_elasticity

        return hyper_elasticity.make_pde(cfg)
    if cfg.pde == "steady_burgers":
        from . import steady_burgers

        return steady_burgers.make_pde(cfg)
    if cfg.pde == "poisson3d":
        from . import poisson3d

        return poisson3d.make_pde(cfg)
    raise ValueError(f"unrecognized pde: {cfg.pde!r}")
