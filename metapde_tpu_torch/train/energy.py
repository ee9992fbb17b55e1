"""Domain-energy branch diagnostics, shared by deploy_bench and validation
(counterpart of metapde_tpu/train/energy.py).

On branch-multistable families (hyperelasticity after buckling) a deployed
model whose Monte-Carlo domain energy is at or below the oracle field's,
scored through the same estimator on the same points, is on another
legitimate solution branch, not under-optimised. This generalises the
reference's x-mirror disambiguation, which handles only the branch
reachable by mirroring.

Regime caveat, as in the JAX package: the gate presumes the boundary
terms are met. An under-trained model (u ~ 0) has near-zero elastic energy
and is flagged on every task; validation then falls back to the plain mean.
"""

import torch

from ..utils.trees import tree_map, tree_stack
from .validation import task_generator


def domain_energy(pde, field_fn, points, task_params):
    """The sum of the domain loss terms (for hyperelasticity the MC
    neo-Hookean energy), a scalar tensor."""
    _, dom = pde.loss_fn(field_fn, points, task_params)
    return sum(torch.as_tensor(v) for v in dom.values())


def gt_field(pde, gt):
    """A ground truth as a field callable, so it goes through the same MC
    loss estimator as the model (compare fields through one estimator,
    never MC against FEM quadrature). Points [N, d] or one point [d]; it
    has no .vjac, so losses take its per-point Jacobian by torch.func."""

    def f(x):
        return pde.evaluate_gt(gt, x[None])[0] if x.ndim == 1 else pde.evaluate_gt(gt, x)

    return f


def audit_points(pde, gt_params, n_points):
    """The fixed audit points of each eval task: pde.sample_points from a
    host generator seeded 31 + i (the JAX package's PRNGKey(31 + i))."""
    return [pde.sample_points(task_generator(31 + i), n_points, tp)
            for i, tp in enumerate(gt_params)]


def oracle_energies(pde, bundle, points):
    """Each eval task's ground-truth domain energy on its audit points, [T]."""
    with torch.no_grad():
        return torch.stack([domain_energy(pde, gt_field(pde, g), p, tp).detach()
                            for g, p, tp in zip(bundle.gts, points, bundle.gt_params)])


def model_energies(pde, field, finals, gt_params, points):
    """The domain energies [T] of adapted field params (leaves [T, ...]) of
    T tasks on points[i]."""
    with torch.no_grad():
        return torch.stack([
            domain_energy(pde, field.bind(tree_map(lambda x: x[i], finals)), p, tp)
            for i, (p, tp) in enumerate(zip(points, gt_params))])


def make_branch_kwargs(pde, bundle, deploy_final_model_batched, field, inner_steps: int,
                       n_points: int):
    """The make_validation_fn branch-audit kwargs of a driver: fixed audit
    points per eval task, each task's oracle energy scored once, and an
    energy_fn that adapts the model with the driver's deployment at the
    training inner-step budget. Returns dict(energy_fn, audit_points,
    oracle_energy)."""
    points = audit_points(pde, bundle.gt_params, n_points)

    def energy_fn(gens, model, gt_params, pts):
        finals = deploy_final_model_batched(gens, model, tree_stack(gt_params), int(inner_steps))
        return model_energies(pde, field, finals, gt_params, pts)

    return dict(energy_fn=energy_fn, audit_points=points,
                oracle_energy=oracle_energies(pde, bundle, points))
