"""The JAX package's plain-PINN sweeps from the deployment scripts' own
inits: the bars of chip_smoke.py's nn_deploy_burgers and
nn_deploy_elasticity phases.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_nn_sweep_bar.py \
        [--out=DIR] [--seeds=1,...,8] [--concurrency=2] [burgers_maml ...]

Runs each command of pipeline/deployment_burgers.sh and
pipeline/deployment_elasticity.sh through `python -m metapde_tpu.cli.sweep`
as the script runs it (its flags, its init: results_burgers_maml/tpu_run1,
results_burgers_leap/ldb3_1, results_elasticity_maml/tpu_run1,
results_elasticity_leap/lde1), with --train.outer_steps=100 (the smoke's
cut) and --train.out_dir=DIR (a temporary directory by default: nothing is
written beside the init). Prints one JSON line a command: the median over
the seeds of val_rel_err at steps 0 and 95 and of each seed's best, and
each seed's values. Not a test: a seed takes minutes on a CPU.

Measured on an 8-core CPU (JAX 0.9.0, seeds 1-8, --concurrency=3), the
medians at step 0, step 95 and of each seed's best, then each seed's step 95:
    burgers_maml     0.23263408243656158  8.683187479618937e-05  7.326563354581594e-05
                     8.464e-05 8.74e-05 5.073e-05 5.767e-05 1.763e-04 8.627e-05
                     2.077e-04 1.537e-04
    burgers_leap     0.10147755220532417  0.0019697873503901064  0.0004415438597789034
                     2.629e-03 3.165e-04 2.31e-03 3.844e-04 3.969e-03 4.093e-03
                     1.63e-03 6.212e-04
    elasticity_maml  0.005907169776037335  0.0064213990699499846  0.004898502491414547
                     0.201 4.321e-03 7.099e-03 6.654e-03 2.541e-03 6.189e-03
                     1.235e-02 4.621e-03
    elasticity_leap  0.0018094299593940377  0.00199914030963555  0.0012274113250896335
                     3.44e-03 1.62e-03 3.892e-03 1.736e-03 3.545e-03 2.095e-03
                     1.715e-03 1.903e-03
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
_COMMON = ["--model.omega=30", "--model.omega0=30", "--train.optimizer=adam",
           "--task.bc_weight=1.0", "--task.outer_points=1024",
           "--task.validation_points=1024", "--train.log_every=5", "--train.val_every=5",
           "--train.viz_every=0", "--train.checkpoint_every=0"]
_BURGERS = ["--task.pde=td_burgers", "--task.domain.xmin=0.0", "--task.max_reynolds=100",
            "--task.num_tsteps=201", "--task.vary_source=false",
            "--solver.ground_truth_resolution=512", *_COMMON]
_ELAS = ["--task.pde=hyper_elasticity", "--task.domain.xmin=0.0", "--task.domain.ymin=0.0",
         "--task.max_holes=5", "--task.vary_source=false", "--task.vary_bc=false", *_COMMON]
# name: (driver, flags, init run, expt_name), as the scripts give them
COMMANDS = {
    "burgers_maml": ("nn_pde_maml", _BURGERS + [
        "--model.num_layers=8", "--model.layer_size=64", "--maml.outer_lr=1e-5",
        "--maml.grad_clip=100", "--maml.inner_steps=5", "--maml.inner_lr=1e-4"],
        "results_burgers_maml/tpu_run1", "deploy_maml"),
    "burgers_leap": ("nn_pde", _BURGERS + [
        "--task.vary_bc=false", "--model.num_layers=10", "--model.layer_size=128",
        "--maml.outer_lr=1e-5"], "results_burgers_leap/ldb3_1", "deploy_leap"),
    "elasticity_maml": ("nn_pde_maml", _ELAS + [
        "--task.max_hole_size=1.0", "--solver.ground_truth_resolution=32",
        "--model.num_layers=8", "--model.layer_size=64", "--maml.outer_lr=1e-5",
        "--maml.grad_clip=100", "--maml.inner_steps=5", "--maml.inner_lr=1e-5"],
        "results_elasticity_maml/tpu_run1", "deploy_maml"),
    "elasticity_leap": ("nn_pde", _ELAS + [
        "--task.max_hole_size=0.5", "--solver.ground_truth_resolution=48",
        "--model.num_layers=10", "--model.layer_size=128", "--maml.outer_lr=5e-6"],
        "results_elasticity_leap/lde1", "deploy_leap"),
}
STEPS = 100


def run(name, out, seeds, concurrency):
    driver, flags, init, expt = COMMANDS[name]
    out = Path(out) / name
    cmd = [sys.executable, "-m", "metapde_tpu.cli.sweep", f"--driver={driver}",
           "--seeds=" + ",".join(map(str, seeds)), f"--concurrency={concurrency}", "--",
           *flags, f"--train.outer_steps={STEPS}",
           f"--train.load_model_from_expt={REPO / init}", f"--train.out_dir={out}",
           f"--train.expt_name={expt}"]
    subprocess.run(cmd, cwd=REPO, check=True, stdout=subprocess.DEVNULL)
    vals = {}
    for s in seeds:
        recs = [json.loads(l) for l in
                (out / f"{expt}_seed_{s}" / "metrics.jsonl").read_text().splitlines()]
        vals[s] = {r["step"]: r["val_rel_err"] for r in recs}
    last = STEPS - 5
    return {"command": name, "init": init, "steps": STEPS, "seeds": list(seeds),
            "median": {"step_0": statistics.median(v[0] for v in vals.values()),
                       f"step_{last}": statistics.median(v[last] for v in vals.values()),
                       "best": statistics.median(min(v.values()) for v in vals.values())},
            "per_seed": {s: {"step_0": v[0], f"step_{last}": v[last], "best": min(v.values())}
                         for s, v in vals.items()}}


def main(argv):
    opts = {"seeds": "1,2,3,4,5,6,7,8", "concurrency": "2", "out": ""}
    names = []
    for a in argv:
        if a.startswith("--"):
            k, _, v = a[2:].partition("=")
            opts[k] = v
        else:
            names.append(a)
    seeds = [int(s) for s in opts["seeds"].split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        for name in names or list(COMMANDS):
            row = run(name, opts["out"] or tmp, seeds, int(opts["concurrency"]))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:])
