"""The meta-gradient of a task batch sharded over the (dp, pt) mesh
(counterpart of metapde_tpu/parallel/sharding.py).

Every rank runs the same step on its share of one outer step's draws:

- dp: rank (i_dp, .) rolls out tasks [i_dp * T / n_dp, (i_dp + 1) * T / n_dp)
  from the same replicated params; the task-mean meta-gradient is averaged
  over dp and the per-task losses are gathered over dp, so every rank holds
  the global [T, K + 1] losses (JAX's out_specs=P(TASK_AXIS)).
- pt: rank (., i_pt) keeps part i_pt of n_pt equal parts of the point axis
  of every point kind whose count n_pt divides, and the whole of every
  other kind (TD-Burgers' 63 wall points, steady Burgers' 85 inlet points);
  the engine (meta/maml.py, meta/leap.py) averages each inner gradient,
  each logged loss and the meta-gradient over pt.

Why the pt rule is exact: every loss term is a mean over one kind (or over
a pool of kinds, see below), and the engine takes the pt mean of each
rank's losses and gradients. The pt mean of n_pt equal parts' means is the
whole kind's mean; the pt mean of n_pt copies of a whole kind's mean is
that mean. A loss term that takes one mean over several kinds (steady
Burgers' no-slip term over its walls and pore rings, PdeDef.pooled_kinds)
stays exact only when its kinds are all split or all whole, so such a pool
is split only when n_pt divides the count of each of its kinds. The kinds
given whole cost each pt rank their whole forward and backward; they are
the small boundary kinds, which need u only (the run's `mesh:` line in
log.txt lists them).

Draws: every rank draws the whole step from its host generator (seeded
cfg.seed, as in a one-process run) and keeps its slice (shard_batch), so a
sharded run trains on exactly the draws of the one-process run of the same
seed, and its generator state, which the checkpoints carry, stays the same
on every rank. The host cost of a draw is therefore not divided by the
mesh. Departure from the JAX package: its pt shards draw n / n_pt points
of every kind from keys folded with the pt index (maml_driver.py:65-89),
equal to the unsharded run in distribution only; here pt-sharded runs
equal unsharded ones up to rounding.
"""

from ..meta import leap, maml
from ..utils.trees import tree_map
from .mesh import POINT_AXIS, TASK_AXIS, Mesh, all_gather_rows, tree_mean


def check_task_split(bsize: int, mesh: Mesh):
    n_dp = mesh.shape[TASK_AXIS]
    if bsize % n_dp:
        raise ValueError(f"bsize {bsize} is not divisible by n_task_shards={n_dp}")


def split_kinds(counts, n_pt: int, pooled=()) -> list:
    """Per point kind of `counts` points: whether pt splits it into n_pt
    equal parts (n_pt divides its count, and the count of every kind of
    its pool in `pooled`) or gives it whole to every pt rank."""
    split = [n % n_pt == 0 for n in counts]
    for pool in pooled:
        if not all(split[k] for k in pool):
            for k in pool:
                split[k] = False
    return split


def shard_task_loss_points(points, mesh: Mesh, pooled=()):
    """The pt point split of a tuple of point kinds, each [T, sets, n, ...]:
    part i_pt of the n axis of every kind split_kinds splits, every other
    kind whole."""
    n_pt = mesh.shape[POINT_AXIS]
    if n_pt == 1:
        return points
    split = split_kinds([x.shape[2] for x in points], n_pt, pooled)

    def part(x, s):
        if not s:
            return x
        m = x.shape[2] // n_pt
        return x[:, :, mesh.pt_index * m:(mesh.pt_index + 1) * m]

    return tuple(part(x, s) for x, s in zip(points, split))


def shard_batch(batch, mesh: Mesh, pooled=()):
    """This rank's share of a maml.TaskBatch or leap.TaskBatch: its
    T / n_dp tasks, and of those its pt part of every point set
    (shard_task_loss_points; `pooled`: the family's PdeDef.pooled_kinds)."""
    bsize = batch.task_params[0].shape[0]
    check_task_split(bsize, mesh)
    t = bsize // mesh.shape[TASK_AXIS]
    lo = mesh.dp_index * t
    tasks = type(batch)(*tree_map(lambda x: x[lo:lo + t], tuple(batch)))
    return tasks._replace(**{f: shard_task_loss_points(getattr(tasks, f), mesh, pooled)
                             for f in tasks._fields if f.endswith("points")})


def make_sharded_maml_grad_fn(maml_def: maml.MamlDef, task_loss, mesh: Mesh,
                              with_lrs: bool = True):
    """(local batch, params, lrs) -> (meta_grad, losses [T, K + 1],
    (meta_losses [T], outer_aux)) of maml.multi_task_grad_and_losses on the
    whole batch: this rank's tasks and points (shard_batch), the pt means in
    the engine, then the meta-gradient averaged and the losses gathered
    over dp."""
    local_def = maml_def._replace(pt_axis=mesh.pt_group)

    def grad_fn(batch, params, lrs):
        grads, losses, (meta_losses, aux) = maml.multi_task_grad_and_losses(
            local_def, task_loss, batch, params, lrs if with_lrs else None)
        grads = tree_mean(grads, mesh.dp_group)
        losses, meta_losses, aux = all_gather_rows((losses, meta_losses, aux), mesh.dp_group)
        return grads, losses, (meta_losses, aux)

    return grad_fn


def make_sharded_leap_grad_fn(leap_def: leap.LeapDef, task_loss, mesh: Mesh):
    """LEAP counterpart: (local batch, params) -> (meta_grad, losses
    [T, K + 1]) of leap.multi_task_grad_and_losses on the whole batch."""
    local_def = leap_def._replace(pt_axis=mesh.pt_group)

    def grad_fn(batch, params):
        grads, losses = leap.multi_task_grad_and_losses(local_def, task_loss, batch, params)
        return tree_mean(grads, mesh.dp_group), all_gather_rows(losses, mesh.dp_group)

    return grad_fn
