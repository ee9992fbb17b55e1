"""Paper-style accuracy-vs-time Pareto figures (the port's copy of
metapde_tpu/cli/paper_plots.py, a host tool over train/analysis.py).

Reproduces the reference's headline analysis artifact (resultAnalysis.ipynb
cells 6-8/17/24: classical-solver accuracy-vs-time baseline overlaid with
meta-learned deployment curves) from this repo's structured artifacts instead
of regex-scraped logs:

- classical solver sweep: errors_by_resolution.json written by
  cli/solver_baseline (train/baseline_driver.py)
- NN deployment k-sweep: deploy_bench_n<k>[_best].jsonl written by
  cli/deploy_bench (one row per inner-step count: time_per_task_s,
  val_rel_err...). New benches always carry the _n<k> task-count suffix
  (plus optional _<optimizer>/_<dtype>/_best parts); bare
  deploy_bench.jsonl files are frozen pre-suffix legacy rows — pass
  whichever file you mean explicitly.

Usage:
    python -m metapde_tpu_torch.cli.paper_plots --out=figures \
        --title="Poisson" --name=pareto_poisson \
        --baseline=poisson_solver_baseline/sweep \
        --deploy=MAML:results_poisson_maml/tpu_run6b/deploy_bench_n8_best.jsonl \
        --deploy=LEAP:results_poisson_leap/lp2_4/deploy_bench_n8_best.jsonl \
        --ref-point="FEniCS res 8:1.04:4.3e-5" ...

Each --deploy may be LABEL:path; --ref-point adds published reference numbers
(BASELINE.md) as open gray context markers, "label:time_s:rel_err".
"""

import glob as globlib
import json
import os
import sys

from ..train.analysis import accuracy_vs_time, load_baseline

# Categorical slots 1-3 of the validated default palette (dataviz skill
# references/palette.md; the 3-slot prefix passes the all-pairs CVD/normal
# floors in light mode). Color follows the entity across every figure:
# classical solver = blue, MAML = orange, LEAP = aqua. Gray is reserved for
# reference context points.
SERIES_COLORS = ("#2a78d6", "#eb6834", "#1baf7a")
ENTITY_COLORS = {"classical": "#2a78d6", "MAML": "#eb6834", "LEAP": "#1baf7a"}
REF_GRAY = "#52514e"
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT_2 = "#52514e"


def _load_deploy(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    rows = [r for r in rows if r.get("val_rel_err") is not None]
    rows.sort(key=lambda r: r["time_per_task_s"])
    return rows


def _finetune_median_curve(pattern):
    """Median accuracy-vs-cumulative-time curve over seed runs matching
    `pattern` (dirs with metrics.jsonl from nn_pde deployment fine-tunes).
    Returns [(t, err), ...] at each logged step index, with best-so-far
    error per seed before taking the median (the notebook's monotone
    deployment-curve convention, resultAnalysis cells 6-8)."""
    paths = sorted(d for d in globlib.glob(pattern) if os.path.isdir(d))
    curves = accuracy_vs_time(paths)
    series = []
    for c in curves:
        pts, best = [], float("inf")
        raw = c["points"]
        if len(raw) > 2:
            # the first record's dt includes jit compile; replace it with the
            # steady-state median dt (the reference reconstructs deployment
            # curves from steady per-step constants, resultAnalysis cell 6)
            dts = [raw[0]["time"]] + [raw[i]["time"] - raw[i - 1]["time"]
                                      for i in range(1, len(raw))]
            steady = sorted(dts[1:])[len(dts[1:]) // 2]
            dts[0] = steady
            t = 0.0
            for p, dt in zip(raw, dts):
                t += dt
                p = dict(p, time=t)
                best = min(best, p["val_rel_err"])
                pts.append((p["time"], best))
        else:
            for p in raw:
                best = min(best, p["val_rel_err"])
                pts.append((p["time"], best))
        if pts:
            series.append(pts)
    if not series:
        return []
    n = min(len(s) for s in series)
    out = []
    for i in range(n):
        ts = sorted(s[i][0] for s in series)
        es = sorted(s[i][1] for s in series)
        out.append((ts[len(ts) // 2], es[len(es) // 2]))
    return out


def make_figure(title, baseline_dir, deploys, ref_points, out_path,
                finetunes=(), baseline2=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.4, 4.4), dpi=160)
    fig.patch.set_facecolor(SURFACE)
    ax.set_facecolor(SURFACE)

    n_series = 0
    if baseline_dir:
        data = load_baseline(baseline_dir)
        if data:
            pts = sorted(
                ((v["time_per_solve"], v["rel_mse"], res)
                 for res, v in data.items()),
                key=lambda p: int(p[2]),
            )
            c = ENTITY_COLORS["classical"]
            n_series += 1
            ax.plot([p[0] for p in pts], [p[1] for p in pts], "-o",
                    color=c, linewidth=2, markersize=6,
                    label="classical solver (this repo, FEM/FV)")
            # direct-label the endpoints with their resolutions
            for p in (pts[0], pts[-1]):
                ax.annotate(f"res {p[2]}", (p[0], p[1]),
                            textcoords="offset points", xytext=(6, 5),
                            fontsize=7.5, color=TEXT_2)

    if baseline2:
        # second classical line (e.g. the Richardson higher-order oracle,
        # matching the reference's P2-element convergence order) — same
        # entity hue, dashed + open markers to read as a variant
        b2_label, b2_dir = baseline2
        data = load_baseline(b2_dir)
        if data:
            pts = sorted(
                ((v["time_per_solve"], v["rel_mse"], res)
                 for res, v in data.items()),
                key=lambda p: int(p[2]),
            )
            c = ENTITY_COLORS["classical"]
            n_series += 1
            ax.plot([p[0] for p in pts], [p[1] for p in pts], "--o",
                    color=c, linewidth=1.6, markersize=6,
                    markerfacecolor="none", label=b2_label)
            for p in (pts[0], pts[-1]):
                ax.annotate(f"res {p[2]}", (p[0], p[1]),
                            textcoords="offset points", xytext=(6, -10),
                            fontsize=7.5, color=TEXT_2)

    for di, (label, path) in enumerate(deploys):
        rows = _load_deploy(path)
        if not rows:
            continue
        c = ENTITY_COLORS.get(label, SERIES_COLORS[n_series % len(SERIES_COLORS)])
        n_series += 1
        xs = [r["time_per_task_s"] for r in rows]
        ys = [r["val_rel_err"] for r in rows]
        ax.plot(xs, ys, "-o", color=c, linewidth=2, markersize=6,
                label=f"{label} deployment (k-step adaptation)")
        # alternate label offsets so coincident k=0 points don't collide
        dy = 5 if di % 2 == 0 else -12
        for r in (rows[0], rows[-1]):
            ax.annotate(f"k={r['inner_steps']}",
                        (r["time_per_task_s"], r["val_rel_err"]),
                        textcoords="offset points", xytext=(6, dy),
                        fontsize=7.5, color=TEXT_2)

    for label, pattern in finetunes:
        pts = _finetune_median_curve(pattern)
        if not pts:
            continue
        base = label.split()[0]  # e.g. "MAML fine-tune" -> MAML's hue
        c = ENTITY_COLORS.get(base, SERIES_COLORS[n_series % len(SERIES_COLORS)])
        n_series += 1
        ax.plot([p[0] for p in pts], [p[1] for p in pts], "--",
                color=c, linewidth=2,
                label=f"{label} (median of seeds)")

    for label, t, e in ref_points:
        ax.plot([t], [e], "o", markerfacecolor="none",
                markeredgecolor=REF_GRAY, markersize=7,
                markeredgewidth=1.5)
        ax.annotate(label, (t, e), textcoords="offset points",
                    xytext=(6, -9), fontsize=7.5, color=TEXT_2)

    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("wall time per task / solve (s)", color=TEXT)
    ax.set_ylabel("relative error (MSE / mean sq.)", color=TEXT)
    ax.set_title(title, color=TEXT, fontsize=11)
    ax.grid(True, which="both", color="#e6e4df", linewidth=0.6, zorder=0)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color("#c3c2b7")
    ax.tick_params(colors=TEXT_2, labelsize=8)
    if n_series >= 2 or ref_points:
        ax.legend(fontsize=8, frameon=False, labelcolor=TEXT)
    fig.tight_layout()
    fig.savefig(out_path, facecolor=SURFACE)
    plt.close(fig)
    return out_path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    out_dir, title, name, baseline = "figures", "", "pareto", None
    baseline2 = None
    deploys, ref_points, finetunes = [], [], []
    for a in argv:
        if a.startswith("--out="):
            out_dir = a.split("=", 1)[1]
        elif a.startswith("--title="):
            title = a.split("=", 1)[1]
        elif a.startswith("--name="):
            name = a.split("=", 1)[1]
        elif a.startswith("--baseline="):
            baseline = a.split("=", 1)[1]
        elif a.startswith("--baseline2="):
            b2_label, b2_dir = a.split("=", 1)[1].split(":", 1)
            baseline2 = (b2_label, b2_dir)
        elif a.startswith("--deploy="):
            label, path = a.split("=", 1)[1].split(":", 1)
            deploys.append((label, path))
        elif a.startswith("--ref-point="):
            label, t, e = a.split("=", 1)[1].rsplit(":", 2)
            ref_points.append((label, float(t), float(e)))
        elif a.startswith("--finetune="):
            label, pattern = a.split("=", 1)[1].split(":", 1)
            finetunes.append((label, pattern))
        else:
            raise SystemExit(f"unknown arg {a}")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{name}.png")
    make_figure(title, baseline, deploys, ref_points, out_path,
                finetunes=finetunes, baseline2=baseline2)
    print(out_path)


if __name__ == "__main__":
    main()
