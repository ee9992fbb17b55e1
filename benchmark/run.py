"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are looked up by name from BENCHMARK.json (see
harness.py). The last line on standard output is one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 the
breakdown, and last the numbers that decided `correct`, each beside its
limit, which also end standard error. A run that finds no card, or
fewer than the cell asks for, or that has loaded JAX or the JAX package
by the time its window closes, exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels", "CUDA_CACHE_PATH": "cuda"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "benchmark" / sub)
    # the package by its name, and none of its folders as top-level modules
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
    import torch

    from benchmark import harness

    cell = harness.Cell.load(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload,
                             ROOT)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {cards}",
              file=sys.stderr)
        return 2
    result, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    harness.report(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
