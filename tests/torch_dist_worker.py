"""Gloo ranks on the CPU for the sharded-training tests
(tests/test_torch_sharding.py, tests/test_torch_sharding_families.py,
tests/test_torch_distributed.py).

run_ranks(tmp, world, checks) starts `world` processes of this file, each
in a session of its own, joined by a file:// process group under `tmp`
(so concurrent test workers never share a port). Every rank runs the named
checks in order, as SPMD code does, and saves its results; run_ranks kills
what is left at its deadline and returns every rank's results
(start_ranks and wait_ranks split it, so the caller can work while the
ranks run; each rank's output goes to rank<r>.log under `tmp`). A check
returns numpy arrays (or strings), which the test compares; a name
"check:label" runs `check` under its own key. This file
imports nothing of JAX.

    python tests/torch_dist_worker.py INIT_URL WORLD RANK JOB OUT
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def run_ranks(tmp, world: int, checks, timeout: float = 120.0):
    """checks: [(name, kwargs)] of CHECKS. Returns [results dict per rank]."""
    return wait_ranks(start_ranks(tmp, world, checks, timeout))


def start_ranks(tmp, world: int, checks, timeout: float = 120.0):
    """run_ranks without the wait: the started ranks, for wait_ranks, so
    that the caller can work while they run."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    job = tmp / "job.pt"
    torch.save({"checks": checks}, job)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        # output to a file, not a pipe: nobody reads a pipe while the caller works
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, f"file://{tmp / 'pg_init'}", str(world), str(r),
                 str(job), str(tmp / f"out{r}.pt")], env=env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
    return tmp, procs, time.monotonic() + timeout


def wait_ranks(started):
    """The results dict of every rank of start_ranks, once all exited 0;
    what is left at the deadline is killed."""
    tmp, procs, deadline = started
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=10)
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r} exited {p.returncode}: {(tmp / f'rank{r}.log').read_text()[-4000:]}"
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(len(procs))]


# --- the checks (run inside every rank) --------------------------------------

def _np(tree):
    from metapde_tpu_torch.utils.trees import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) else t, tree)


def _cfg(argv, n_dp, n_pt):
    from metapde_tpu_torch.config import Config, parse_overrides
    return parse_overrides(Config(), list(argv) + [f"--mesh.n_task_shards={n_dp}",
                                                   f"--mesh.n_point_shards={n_pt}"])


def maml_grad(argv, mesh, batch, params, lrs, remats=(False,)):
    """The sharded MAML meta-gradient and global losses of the full batch
    (every rank given all of it) on a (dp, pt) mesh, per remat setting."""
    from metapde_tpu_torch.parallel.sharding import make_sharded_maml_grad_fn, shard_batch
    from metapde_tpu_torch.train import maml_driver
    c = maml_driver.build(_cfg(argv, *mesh), "cpu")
    local = shard_batch(batch, c["mesh"])
    out = {}
    for remat in remats:
        fn = make_sharded_maml_grad_fn(c["maml_def"]._replace(remat=remat), c["task_loss"],
                                       c["mesh"])
        out[remat] = _np(fn(local, params, lrs))
    return out


def leap_grad(argv, mesh, batch, params):
    """The sharded LEAP meta-gradient and global losses of the full batch."""
    from metapde_tpu_torch.parallel.sharding import shard_batch
    from metapde_tpu_torch.train import leap_driver
    c = leap_driver.build(_cfg(argv, *mesh), "cpu")
    return _np(c["grad_fn"](shard_batch(batch, c["mesh"]), params))


def pt_exact(theta0, remats=(False, True)):
    """tests/test_sharding.py's exact second-order set through the MAML
    engine on a pt group of every rank: 32 fixed points split over pt,
    three steps t <- t - 0.3 grad of mean((sin(3p) - t p)^2), the
    meta-loss the loss at the final t (outer decay 0, unit LRs, no clip)."""
    from metapde_tpu_torch.meta import maml
    from metapde_tpu_torch.parallel.mesh import make_mesh
    from metapde_tpu_torch.parallel.sharding import shard_batch
    mesh = make_mesh(1, torch.distributed.get_world_size())
    pts = torch.linspace(0.0, 1.0, 32).reshape(1, 1, 32).expand(1, 4, 32)

    def task_loss(params, points, task_params):
        (p,) = points
        return torch.mean((torch.sin(3 * p) - params["t"] * p) ** 2), {}

    batch = shard_batch(maml.TaskBatch((torch.zeros(1),), (pts,), (pts,)), mesh)
    out = {}
    for remat in remats:
        mdef = maml.MamlDef(inner_lr=0.3, inner_steps=3, softplus_lrs=False,
                            outer_loss_decay=0.0, inner_grad_clip=1e30, remat=remat,
                            pt_axis=mesh.pt_group)
        grad, _, (meta, _) = maml.multi_task_grad_and_losses(
            mdef, task_loss, batch, {"t": torch.tensor(theta0)})
        out[remat] = (float(grad["t"]), float(meta[0]))
    return out


def train_steps(argv, mesh, n_steps, algo="maml"):
    """n_steps of train_step_many from the build's init and generator."""
    from metapde_tpu_torch.train import leap_driver, maml_driver
    if algo == "maml":
        c = maml_driver.build(_cfg(argv, *mesh), "cpu")
        p, l = c["init_params"], c["inner_lrs"]
        out = c["train_step_many"](c["generator"], p, l, c["outer_opt"].init(p),
                                   c["lr_opt"].init(l), n_steps)
        return _np({"params": out[0], "inner_lrs": out[1], "ml_means": out[7],
                    "losses": out[4], "meta_grad_norm": out[6]})
    c = leap_driver.build(_cfg(argv, *mesh), "cpu")
    p = c["init_params"]
    out = c["train_step_many"](c["generator"], p, c["outer_opt"].init(p), n_steps)
    return _np({"params": out[0], "ml_means": out[4], "losses": out[2],
                "meta_grad_norm": out[3]})


def refusal(argv, mesh, algo="maml"):
    """The message a build raises (ValueError), or None when it builds."""
    from metapde_tpu_torch.train import leap_driver, maml_driver
    try:
        (maml_driver if algo == "maml" else leap_driver).build(_cfg(argv, *mesh), "cpu")
    except ValueError as e:
        return str(e)
    return None


def tiled_mesh(n_dp, n_pt):
    """The (n_dp, n_pt) mesh of parallel/mesh.py::make_mesh when the world
    has n_dp * n_pt ranks; on a larger world, world / (n_dp * n_pt)
    independent copies of it side by side (rank r in copy r // size, the
    groups made by every rank in the same order), which compute the same."""
    from metapde_tpu_torch.parallel.mesh import POINT_AXIS, TASK_AXIS, Mesh, make_mesh
    dist = torch.distributed
    size, world, rank = n_dp * n_pt, dist.get_world_size(), dist.get_rank()
    if size == world:
        return make_mesh(n_dp, n_pt)
    groups = {"dp": None, "pt": None}
    for base in range(0, world, size):
        for axis, lists in (
                ("dp", [[base + i * n_pt + j for i in range(n_dp)] for j in range(n_pt)]),
                ("pt", [[base + i * n_pt + j for j in range(n_pt)] for i in range(n_dp)])):
            for ranks in lists:
                if len(ranks) > 1:
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[axis] = g
    i_dp, i_pt = divmod(rank % size, n_pt)
    return Mesh({TASK_AXIS: n_dp, POINT_AXIS: n_pt}, i_dp, i_pt, groups["dp"], groups["pt"],
                dist.get_backend())


def family_grad(argv, mesh, batch, params, lrs=None, algo="maml"):
    """The sharded meta-gradient and global losses of the full batch on a
    (dp, pt) mesh (tiled_mesh): shard_batch with the family's pooled
    kinds, then make_sharded_{maml,leap}_grad_fn."""
    from metapde_tpu_torch.config import Config, parse_overrides
    from metapde_tpu_torch.parallel.sharding import (make_sharded_leap_grad_fn,
                                                     make_sharded_maml_grad_fn, shard_batch)
    from metapde_tpu_torch.train import leap_driver, maml_driver
    m = tiled_mesh(*mesh)
    c = (maml_driver if algo == "maml" else leap_driver).build(
        parse_overrides(Config(), argv), "cpu")
    local = shard_batch(batch, m, c["pde"].pooled_kinds)
    if algo == "maml":
        return _np(make_sharded_maml_grad_fn(c["maml_def"], c["task_loss"], m)(
            local, params, lrs))
    return _np(make_sharded_leap_grad_fn(c["leap_def"], c["task_loss"], m)(local, params))


def checkpoints_under_pt(argv, mesh, batch, params, lrs):
    """The torch.utils.checkpoint calls of family_grad's MAML meta-gradient
    with remat on, on a (dp, pt) mesh: the engine takes none under pt."""
    from metapde_tpu_torch.meta import maml
    calls = []
    plain = maml.checkpoint
    maml.checkpoint = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        family_grad(argv + ["--train.remat_inner_steps=true"], mesh, batch, params, lrs)
    finally:
        maml.checkpoint = plain
    return len(calls)


def run(argv, mesh):
    """maml_driver.run on a (dp, pt) mesh; the files of the run dir after it
    (rank 0 writes them, every rank lists them after the last barrier)."""
    from metapde_tpu_torch.train import maml_driver
    cfg = _cfg(argv, *mesh)
    maml_driver.run(cfg, "cpu")
    torch.distributed.barrier()
    return sorted(p.name for p in Path(cfg.train.out_dir, cfg.train.expt_name).iterdir())


CHECKS = {f.__name__: f for f in (maml_grad, leap_grad, pt_exact, train_steps, refusal,
                                  family_grad, checkpoints_under_pt, run)}


def main(init, world, rank, job, out):
    from metapde_tpu_torch.parallel.mesh import initialize_distributed
    torch.set_num_threads(1)
    initialize_distributed(init, int(world), int(rank), backend="gloo", device_type="cpu",
                           timeout_s=120)
    results = {}
    for name, kwargs in torch.load(job, weights_only=False)["checks"]:
        results[name] = CHECKS[name.split(":")[0]](**kwargs)
    torch.save(results, out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
