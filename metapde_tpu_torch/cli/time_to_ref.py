"""Time to a target validation error (the port's own copy of
metapde_tpu/cli/time_to_ref.py's method, without its table of run chains).

For each --row: scan the metrics.jsonl of a run, or of a `a+b+c`
continuation chain concatenated by step, integrate wall time as
sum(delta_step x step_time of the row), the training compute alone
(ground-truth solves and one-time set-up excluded: the drivers report them
apart), and report the first crossing of the target with the run's best.
The time is that of the device the runs were trained on, which the row's
note should name.

    python -m metapde_tpu_torch.cli.time_to_ref \
        --row="label:dirA+dirB:2e-3:note" [--row=...] [--metric=val_rel_err_median] [--json]
"""

import argparse
import glob as globlib
import json
import os


def scan_chain(chain: str, metric: str):
    """(step, value, step_time) rows across a continuation chain, monotone
    in step. Chain elements may be globs (`em7*` covers suffixed resume
    dirs, in lexicographic order); on overlapping steps the earlier-listed
    dir's row wins."""
    dirs = []
    for el in chain.split("+"):
        expanded = sorted(globlib.glob(el)) if any(c in el for c in "*?[") else [el]
        dirs.extend(expanded or [el])
    rows = []
    for d in dirs:
        path = os.path.join(d, "metrics.jsonl")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                v = r.get(metric)
                if v is None or r.get("step") is None:
                    continue
                rows.append((int(r["step"]), float(v), float(r.get("step_time") or 0.0)))
    rows.sort(key=lambda t: t[0])
    out, last = [], -1
    for step, v, st in rows:
        if step <= last:
            continue  # overlapping restart window; keep the earlier row
        out.append((step, v, st))
        last = step
    return out


def time_to_target(rows, target: float):
    """(first step <= target, integrated seconds to that step, best value,
    best step, total integrated seconds)."""
    t = 0.0
    prev_step = 0
    hit_step = hit_time = None
    best_v, best_s = float("inf"), None
    for step, v, st in rows:
        t += (step - prev_step) * st
        prev_step = step
        if v < best_v:
            best_v, best_s = v, step
        if hit_step is None and v <= target:
            hit_step, hit_time = step, t
    return hit_step, hit_time, best_v, best_s, t


def fmt_h(seconds):
    if seconds is None:
        return "-"
    if seconds < 90:
        return f"{seconds:.0f} s"
    if seconds < 5400:
        return f"{seconds / 60:.1f} min"
    return f"{seconds / 3600:.2f} h"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--metric", default="val_rel_err")
    p.add_argument("--row", action="append", required=True,
                   help="label:chain:target[:note]; one per run chain")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line per row instead of markdown")
    args = p.parse_args(argv)

    rows_spec = []
    for spec in args.row:
        parts = spec.split(":")
        label, chain, target = parts[0], parts[1], float(parts[2])
        note = parts[3] if len(parts) > 3 else ""
        rows_spec.append((label, chain, target, note))

    out_rows = []
    for label, chain, target, note in rows_spec:
        rows = scan_chain(chain, args.metric)
        if not rows:
            out_rows.append(dict(label=label, error="no metrics found", chain=chain))
            continue
        hit_step, hit_time, best_v, best_s, total_t = time_to_target(rows, target)
        out_rows.append(dict(
            label=label, target=target, metric=args.metric,
            hit_step=hit_step, hit_seconds=hit_time,
            best_value=best_v, best_step=best_s,
            total_train_seconds=total_t, ref_note=note, chain=chain,
        ))

    if args.json:
        for r in out_rows:
            print(json.dumps(r))
        return out_rows

    print(f"| Run (chain) | target | training time to target | steps to target | "
          f"best ({args.metric}) | note |")
    print("|---|---|---|---|---|---|")
    for r in out_rows:
        if "error" in r:
            print(f"| {r['label']} | - | {r['error']} | - | - | - |")
            continue
        hit = (fmt_h(r["hit_seconds"]) if r["hit_step"] is not None
               else f"not yet (best {r['best_value']:.2e})")
        steps = (f"{r['hit_step']:,}" if r["hit_step"] is not None
                 else f"> {r['best_step']:,}")
        print(f"| {r['label']} | {r['target']:.0e} | {hit} | {steps} | "
              f"{r['best_value']:.2e} @ {r['best_step']:,} | {r['ref_note']} |")
    return out_rows


if __name__ == "__main__":
    main()
