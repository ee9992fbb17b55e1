"""Gloo ranks on the CPU for the sharded-training tests
(tests/test_torch_sharding.py, tests/test_torch_distributed.py).

run_ranks(tmp, world, checks) starts `world` processes of this file, each
in a session of its own, joined by a file:// process group under `tmp`
(so concurrent test workers never share a port). Every rank runs the named
checks in order, as SPMD code does, and saves its results; run_ranks kills
what is left at its deadline and returns every rank's results. A check
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
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    job = tmp / "job.pt"
    torch.save({"checks": checks}, job)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, f"file://{tmp / 'pg_init'}", str(world), str(r), str(job),
         str(tmp / f"out{r}.pt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=10)
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}: {err[-4000:]}"
    return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]


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


CHECKS = {f.__name__: f for f in (maml_grad, leap_grad, pt_exact, train_steps, refusal)}


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
