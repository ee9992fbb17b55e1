"""Experiment sweep runner (counterpart of metapde_tpu/cli/sweep.py): one
port entry point per seed, as local subprocesses with bounded concurrency,
or the command list for an outside scheduler.

    python -m metapde_tpu_torch.cli.sweep --driver=nn_pde_maml --seeds=1,2,3 \
        --concurrency=1 -- --task.pde=poisson --train.outer_steps=200 ...

Runs python -m metapde_tpu_torch.cli.<driver> for each seed with --seed=<s>
and --train.expt_name=<expt_name>_seed_<s> (expt_name from the passed
flags, "sweep" by default); everything after `--` reaches every job,
--device=NAME included. --dry_run prints the commands. Exits 1 when any
job failed.
"""

import subprocess
import sys


def commands(driver, seeds, passthrough):
    """The job commands: one per seed."""
    expt_name = "sweep"
    for a in passthrough:
        if a.startswith("--train.expt_name="):
            expt_name = a.split("=", 1)[1]
    rest = [a for a in passthrough if not a.startswith("--train.expt_name=")]
    return [[sys.executable, "-m", f"metapde_tpu_torch.cli.{driver}", f"--seed={s}",
             f"--train.expt_name={expt_name}_seed_{s}", *rest] for s in seeds]


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if "--" in argv:
        split = argv.index("--")
        own, passthrough = argv[:split], argv[split + 1:]
    else:
        own, passthrough = argv, []

    driver = "nn_pde"
    seeds = [0]
    concurrency = 1
    dry_run = False
    for a in own:
        if a.startswith("--driver="):
            driver = a.split("=", 1)[1]
        elif a.startswith("--seeds="):
            seeds = [int(s) for s in a.split("=", 1)[1].split(",")]
        elif a.startswith("--concurrency="):
            concurrency = int(a.split("=", 1)[1])
        elif a == "--dry_run":
            dry_run = True

    cmds = commands(driver, seeds, passthrough)
    if dry_run:
        for c in cmds:
            print(" ".join(c))
        return

    running = []
    failed = 0
    for cmd in cmds:
        while len(running) >= concurrency:
            done = [p for p in running if p.poll() is not None]
            for p in done:
                running.remove(p)
                failed += p.returncode != 0
            if not done:
                running[0].wait()
        print("launching:", " ".join(cmd), flush=True)
        running.append(subprocess.Popen(cmd))
    for p in running:
        p.wait()
        failed += p.returncode != 0
    print(f"sweep done: {len(cmds) - failed}/{len(cmds)} succeeded", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
