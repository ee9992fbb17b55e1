"""Result analysis: metrics.jsonl -> summary tables and accuracy-vs-time
curves (the port's own copy of metapde_tpu/train/analysis.py; it reads run
dirs of either package, which write the same files).

- load_run / summarize: a run's records and its best-validation row.
- accuracy_vs_time: deployment fine-tune runs (cli/nn_pde from a meta
  init): cumulative training wall clock against val_rel_err, to combine
  with a solver baseline sweep's errors_by_resolution.json (load_baseline)
  for the paper's accuracy-vs-time plots.
- sweep_summary: a seed sweep's median-of-best and the reference
  notebook's mean of the final errors.

    python -m metapde_tpu_torch.train.analysis RUN_DIR ['SWEEP_GLOB*']
"""

import json
import os
from typing import Dict, List, Optional


def load_run(path: str) -> List[dict]:
    """Read {path}/metrics.jsonl into a list of records."""
    fname = os.path.join(path, "metrics.jsonl")
    records = []
    with open(fname) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def summarize(path: str) -> dict:
    """Best validation metrics over a run (notebook min-MSE logic)."""
    records = load_run(path)
    with_val = [r for r in records if r.get("val_rel_err") is not None]
    if not with_val:
        return {"n_records": len(records)}
    best = min(with_val, key=lambda r: r["val_rel_err"])
    last = with_val[-1]
    return {
        "n_records": len(records),
        "best_step": best["step"],
        "best_val_rel_err": best["val_rel_err"],
        "best_val_mse": best.get("val_mse"),
        "final_val_rel_err": last["val_rel_err"],
        "mean_step_time": (
            sum(r.get("step_time", 0.0) for r in records[1:])
            / max(len(records) - 1, 1)
        ),
        "deployment_time": last.get("deployment_time"),
    }


def accuracy_vs_time(paths: List[str]) -> List[dict]:
    """For deployment fine-tune runs (nn_pde from a meta init): cumulative
    training wallclock vs val_rel_err, one curve per run (notebook cells
    6-8, 17)."""
    curves = []
    for path in paths:
        records = load_run(path)
        t = 0.0
        pts = []
        for r in records:
            t += r.get("step_time", 0.0)
            if r.get("val_rel_err") is not None:
                pts.append({"time": t, "val_rel_err": r["val_rel_err"],
                            "step": r["step"]})
        curves.append({"path": path, "points": pts})
    return curves


def sweep_summary(pattern: str) -> dict:
    """Aggregate a deployment fine-tune sweep (seed dirs matching a glob).

    Reports both aggregation conventions: this repo's median-of-best (robust
    to heavy task tails) and the reference notebook's mean of the raw final
    validation error across seeds (resultAnalysis.ipynb cell 22 np.mean over
    seed trajectories — the statistic behind the paper's deployment
    curves)."""
    import glob as globlib
    import statistics

    paths = sorted(p for p in globlib.glob(pattern) if os.path.isdir(p))
    bests, finals = [], []
    for p in paths:
        s = summarize(p)
        if s.get("best_val_rel_err") is not None:
            bests.append(s["best_val_rel_err"])
            finals.append(s["final_val_rel_err"])
    if not bests:
        return {"pattern": pattern, "n_seeds": 0}
    return {
        "pattern": pattern,
        "n_seeds": len(bests),
        "median_best": statistics.median(bests),
        "mean_best": statistics.fmean(bests),
        "min_best": min(bests),
        "max_best": max(bests),
        "median_final": statistics.median(finals),
        "mean_final": statistics.fmean(finals),  # reference statistic
    }


def load_baseline(path: str) -> Optional[Dict]:
    """Read a solver-baseline sweep's errors_by_resolution.json."""
    fname = os.path.join(path, "errors_by_resolution.json")
    if not os.path.exists(fname):
        return None
    with open(fname) as f:
        return json.load(f)


def main(argv=None):
    import sys

    paths = argv if argv is not None else sys.argv[1:]
    for p in paths:
        if any(ch in p for ch in "*?["):
            print(json.dumps(sweep_summary(p), indent=2))
        else:
            print(p, json.dumps(summarize(p), indent=2))


if __name__ == "__main__":
    main()
