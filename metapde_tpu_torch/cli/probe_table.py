"""Seed-parity table for protocol probes (VERDICT r2 item 6; the port's
copy of metapde_tpu/cli/probe_table.py, a host tool over train/analysis.py).

Summarizes matched training probes (e.g. the fast with-replacement+bf16
bench protocol vs the reference-faithful f32 control, seeds 1..3) into one
table: best/final val_rel_err and mean step time per run, plus the
fast/control ratio per seed.

    python -m metapde_tpu_torch.cli.probe_table \
        --dir=results_poisson_maml --a=p30k_fast_s --b=p30k_f32_s --seeds=1,2,3
"""

import json
import os
import sys

from ..train.analysis import summarize


def run(base_dir: str, prefix_a: str, prefix_b: str, seeds):
    rows = []
    for s in seeds:
        row = {"seed": s}
        for tag, prefix in (("a", prefix_a), ("b", prefix_b)):
            path = os.path.join(base_dir, f"{prefix}{s}")
            try:
                d = summarize(path)
            except OSError:
                row[f"{tag}_missing"] = path
                continue
            row[f"{tag}_best"] = d.get("best_val_rel_err")
            row[f"{tag}_final"] = d.get("final_val_rel_err")
            row[f"{tag}_step_time"] = d.get("mean_step_time")
        if row.get("a_final") and row.get("b_final"):
            row["final_ratio_a_over_b"] = row["a_final"] / row["b_final"]
            row["best_ratio_a_over_b"] = row["a_best"] / row["b_best"]
        rows.append(row)
        print(json.dumps(row))
    return rows


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    base, a, b, seeds = "results_poisson_maml", "p30k_fast_s", "p30k_f32_s", (1, 2, 3)
    for arg in argv:
        if arg.startswith("--dir="):
            base = arg.split("=", 1)[1]
        elif arg.startswith("--a="):
            a = arg.split("=", 1)[1]
        elif arg.startswith("--b="):
            b = arg.split("=", 1)[1]
        elif arg.startswith("--seeds="):
            # --seeds= (empty) compares the bare prefixes as one pair
            body = arg.split("=", 1)[1]
            seeds = tuple(int(x) for x in body.split(",") if x) or ("",)
    run(base, a, b, seeds)


if __name__ == "__main__":
    main()
