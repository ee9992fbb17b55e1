"""The (dp, pt) mesh of a sharded meta-training run, over torch.distributed
(counterpart of metapde_tpu/parallel/mesh.py).

The JAX package is single-controller: one process shard_maps the step over
a Mesh of devices. The port is SPMD: one process per rank, each rank runs
the same step on its share, and the ranks meet in collectives. The axes:

- TASK_AXIS ("dp"): the task batch is split across ranks; the meta-gradient
  is averaged over dp and the per-task losses gathered.
- POINT_AXIS ("pt"): the collocation points of every task are split across
  ranks; each inner gradient, each logged loss and the meta-gradient are
  averaged over pt (the PINN analogue of sequence parallelism).

Ranks are laid out dp-major, as make_mesh's reshape(n_task_shards,
n_point_shards) lays out devices: rank = i_dp * n_pt + i_pt. A dp group
holds the ranks of one pt index (a column of the mesh), a pt group the
ranks of one dp index (a row).

Departure from the JAX package: JAX takes the first n_dp * n_pt devices and
leaves the rest idle; here the world size must equal the mesh, or
make_mesh raises.

The backend rule (pick_backend): nccl when every rank on the node has a
card of its own; gloo when ranks share a card (NCCL refuses two ranks on
one device; gloo takes CUDA tensors, through the host) and on the CPU. The
choice is made once, before the process group starts, and logged by the
caller; a failed start is an error, never retried on another backend.
"""

import contextlib
import datetime
import functools
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..utils import spans
from ..utils.trees import tree_leaves, tree_unflatten

TASK_AXIS = "dp"
POINT_AXIS = "pt"

# a dead peer ends a collective after this long instead of hanging the run
DEFAULT_TIMEOUT_S = 300


class Mesh(NamedTuple):
    """This rank's place in the (dp, pt) mesh. shape: {"dp": n, "pt": n};
    a group is None on an axis of size 1 (no collective there)."""

    shape: dict
    dp_index: int
    pt_index: int
    dp_group: Optional[object]
    pt_group: Optional[object]
    backend: str


def pick_backend(device_type: str) -> str:
    """nccl when every rank on this node has its own card, else gloo
    (ranks sharing a card, or the CPU)."""
    if device_type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           backend=None, device_type="cuda", timeout_s=DEFAULT_TIMEOUT_S):
    """Start this rank's process group; returns its backend, or None for a
    one-process run (no-op, as in the JAX package).

    Without arguments it takes torchrun's environment (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT). coordinator_address is "host:port" (TCP) or
    an init URL ("file:///path", "tcp://host:port"). backend None applies
    pick_backend(device_type)."""
    if coordinator_address is None and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    backend = backend or pick_backend(device_type)
    if backend == "nccl":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    init = "env://"
    if coordinator_address is not None:
        init = coordinator_address if "://" in coordinator_address else \
            f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


@contextlib.contextmanager
def process_group(device):
    """A launcher-started run's process group (WORLD_SIZE set, as
    torch.distributed.run sets it): started by initialize_distributed with
    the backend rule for `device`, destroyed on the way out. Yields the
    backend, or None for a one-process run (nothing to start)."""
    backend = initialize_distributed(device_type=torch.device(device).type)
    try:
        yield backend
    finally:
        if backend is not None and dist.is_initialized():
            dist.destroy_process_group()


def rank_device(device) -> torch.device:
    """This rank's device: cuda:{LOCAL_RANK % device_count} (made current)
    for a CUDA request, the CPU for a CPU one."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    idx = local_rank() % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def make_mesh(n_task_shards: int = None, n_point_shards: int = 1) -> Mesh:
    """This rank's (dp, pt) mesh over the started process group, every
    group created by every rank in the same order. Defaults to every rank
    on the task axis. Raises without a process group or when the world
    size is not n_task_shards * n_point_shards."""
    if not dist.is_initialized():
        n = "n_task_shards * n_point_shards" if n_task_shards is None else \
            n_task_shards * n_point_shards
        raise RuntimeError(
            f"a mesh of {n_task_shards} task x {n_point_shards} point shards needs a "
            f"process group of {n} ranks: launch with `python -m torch.distributed.run "
            f"--nproc_per_node={n} -m metapde_tpu_torch.cli.<entry> ...`")
    world = dist.get_world_size()
    n_pt = n_point_shards
    n_dp = world // n_pt if n_task_shards is None else n_task_shards
    if n_dp * n_pt != world:
        raise ValueError(f"a mesh of {n_dp} task x {n_pt} point shards needs "
                         f"{n_dp * n_pt} ranks; the process group has {world}")
    i_dp, i_pt = divmod(dist.get_rank(), n_pt)

    # one dp group a pt index (a column), one pt group a dp index (a row)
    dp_group = _group([[i * n_pt + j for i in range(n_dp)] for j in range(n_pt)], i_pt)
    pt_group = _group([[i * n_pt + j for j in range(n_pt)] for i in range(n_dp)], i_dp)
    return Mesh({TASK_AXIS: n_dp, POINT_AXIS: n_pt}, i_dp, i_pt, dp_group, pt_group,
                dist.get_backend())


def _group(rank_lists, mine):
    """This rank's group among `rank_lists` (every rank creates all of
    them, in order): None for groups of one rank, the world for one group."""
    if len(rank_lists[0]) == 1:
        return None
    if len(rank_lists) == 1:
        return dist.group.WORLD
    return [dist.new_group(ranks) for ranks in rank_lists][mine]


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes the run's files (rank 0, or no mesh)."""
    return mesh is None or dist.get_rank() == 0


def barrier(mesh: Optional[Mesh]):
    if mesh is not None:
        dist.barrier()


def gather_values(value, mesh: Optional[Mesh]) -> list:
    """Every rank's `value` (picklable) in rank order; [value] without a mesh."""
    if mesh is None:
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


# --- collectives ------------------------------------------------------------

def _issue(t: torch.Tensor):
    """Count one collective of `t` (counters collective.calls and
    collective.bytes) and return the span `collective` to issue it in: its
    host time is the whole collective under gloo, which blocks, and the
    enqueue under nccl."""
    spans.count("collective.calls")
    spans.count("collective.bytes", t.numel() * t.element_size())
    return spans.span("collective")


def _all_reduce(t, group):
    with _issue(t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) over `group`, differentiable: the backward sums the
    cotangents over the group (each rank seeds the backward with its own,
    local loss; a loss that is already a group sum would be counted once
    per rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _flat(leaves):
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in leaves))
    return torch.cat([t.reshape(-1).to(dtype) for t in leaves])


def _unflat(flat, tree, leaves):
    parts = flat.split([t.numel() for t in leaves])
    return tree_unflatten(tree, [p.reshape(t.shape).to(t.dtype) for p, t in zip(parts, leaves)])


def tree_mean(tree, group, differentiable: bool = False):
    """The mean over `group` of every leaf of `tree`, in one collective on
    a flat buffer. With `differentiable`, through AllReduceSum."""
    n = group_size(group)
    if n == 1:
        return tree
    leaves = tree_leaves(tree)
    if differentiable:
        flat = AllReduceSum.apply(_flat(leaves), group)
    else:
        with torch.no_grad():
            flat = _all_reduce(_flat([t.detach() for t in leaves]), group)
    return _unflat(flat / n, tree, leaves)


def all_gather_rows(tree, group):
    """Every leaf [T_local, ...] of `tree` gathered over `group` in rank
    order into [n * T_local, ...], in one collective."""
    n = group_size(group)
    if n == 1:
        return tree
    leaves = [t.detach() for t in tree_leaves(tree)]
    t_local = leaves[0].shape[0]
    rows = torch.cat([t.reshape(t_local, -1) for t in leaves], dim=1)
    out = [torch.empty_like(rows) for _ in range(n)]
    with _issue(rows):
        dist.all_gather(out, rows.contiguous(), group=group)
    gathered = torch.cat(out, dim=0)
    parts = gathered.split([t[0].numel() for t in leaves], dim=1)
    return tree_unflatten(tree, [p.reshape((n * t_local,) + tuple(t.shape[1:])).to(t.dtype)
                                 for p, t in zip(parts, leaves)])
