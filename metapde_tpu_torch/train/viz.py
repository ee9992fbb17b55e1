"""Solution plots (counterpart of metapde_tpu/train/viz.py): the ground
truth beside the model adapted k steps, on a structured evaluation grid.

Each plot is two parts:
- a panel function that computes on the tasks' device: the grid,
  pde.evaluate_gt, each task's k-step adaptation (`adapt`) and the
  adapted field (`field_apply`, the plain apply, not the inference kernel,
  as the JAX package plots through field.apply); it returns tensors and
  needs no matplotlib;
- the matplotlib drawing, which returns None before any work where
  matplotlib (or, for the gif, PIL) is not installed.

`adapt(i, task_params, k)` returns the params of task i adapted k steps;
the training loop passes the MAML driver's get_final_model from a
generator seeded 0 (the JAX package's PRNGKey(0)), tests pass one that
adapts on the points JAX drew.
"""

import io

import numpy as np
import torch


def pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _device_of(task_params):
    return next(a.device for a in task_params if torch.is_tensor(a))


def grid_2d(n=64, bounds=(-1.0, 1.0, -1.0, 1.0)):
    """The n x n evaluation grid: (xx, yy) [n, n] and points [n * n, 2]
    (numpy, float32 points)."""
    xmin, xmax, ymin, ymax = bounds
    xx, yy = np.meshgrid(np.linspace(xmin, xmax, n), np.linspace(ymin, ymax, n))
    return xx, yy, np.stack([xx.reshape(-1), yy.reshape(-1)], axis=1).astype(np.float32)


def solution_panels(pde, gts_list, params_list, adapt, field_apply, inner_steps_list=(0, 2, 5),
                    n_tasks=3, n=64, bounds=(-1.0, 1.0, -1.0, 1.0)):
    """The values of compare_plots_with_ground_truth for the first n_tasks
    tasks, on their device: (xx, yy [n, n] numpy, truth [T, n * n(, out)],
    {k: adapted field [T, n * n(, out)]})."""
    n_tasks = min(n_tasks, len(gts_list))
    xx, yy, pts_np = grid_2d(n, bounds)
    truth, values = [], {k: [] for k in inner_steps_list}
    for i in range(n_tasks):
        pts = torch.as_tensor(pts_np, device=_device_of(params_list[i]))
        truth.append(pde.evaluate_gt(gts_list[i], pts))
        for k in inner_steps_list:
            final = adapt(i, params_list[i], k)
            with torch.no_grad():
                values[k].append(field_apply(final, pts).detach())
    return xx, yy, torch.stack(truth), {k: torch.stack(v) for k, v in values.items()}


def _as_plot(vals, shape):
    """A task's values [n * n(, out)] as an [n, n] image: vector fields by
    their norm."""
    vals = np.asarray(vals).reshape(shape + vals.shape[1:])
    return np.linalg.norm(vals, axis=-1) if vals.ndim == 3 else vals


def compare_plots_with_ground_truth(path, pde, gts_list, params_list, adapt,
                                    inner_steps_list=(0, 2, 5), n_tasks=3,
                                    bounds=(-1.0, 1.0, -1.0, 1.0), field_apply=None, step=None):
    """Grid of [task x (truth | k-step adapted model ...)] heatmaps, on one
    color scale a row; writes {path}/viz_step_{step}.png (viz.png without a
    step) and returns its name."""
    plt = pyplot()
    if plt is None:
        return None
    xx, yy, truth, values = solution_panels(pde, gts_list, params_list, adapt, field_apply,
                                            inner_steps_list, n_tasks, bounds=bounds)
    truth = truth.cpu().numpy()
    n_tasks, ncols = truth.shape[0], 1 + len(inner_steps_list)
    fig, axes = plt.subplots(n_tasks, ncols, figsize=(3 * ncols, 3 * n_tasks), squeeze=False)
    for i in range(n_tasks):
        tplot = _as_plot(truth[i], xx.shape)
        vmin, vmax = tplot.min(), tplot.max()
        axes[i][0].pcolormesh(xx, yy, tplot, vmin=vmin, vmax=vmax)
        axes[i][0].set_title("ground truth" if i == 0 else "")
        for j, k in enumerate(inner_steps_list):
            axes[i][j + 1].pcolormesh(xx, yy, _as_plot(values[k][i].cpu().numpy(), xx.shape),
                                      vmin=vmin, vmax=vmax)
            axes[i][j + 1].set_title(f"{k} steps" if i == 0 else "")
    for ax_row in axes:
        for ax in ax_row:
            ax.set_xticks([])
            ax.set_yticks([])
    fname = f"{path}/viz_step_{step}.png" if step is not None else f"{path}/viz.png"
    fig.savefig(fname, dpi=160, bbox_inches="tight")
    plt.close(fig)
    return fname


def burgers_panels(pde, gt, params, adapt, inner_steps, field_apply, n_x=128):
    """The values of plot_burgers_time_series on the (x, t) grid of the
    ground truth's output times and n_x points across the domain:
    (xx, tt [num_tsteps, n_x] numpy, truth, adapted field, both
    [num_tsteps, n_x] on the task's device)."""
    t_grid = gt.t_grid.detach().cpu().numpy()
    xs = np.linspace(float(gt.x_grid[0]), float(gt.x_grid[-1]), n_x)
    xx, tt = np.meshgrid(xs, t_grid)
    pts = torch.as_tensor(np.stack([xx.reshape(-1), tt.reshape(-1)], 1).astype(np.float32),
                          device=_device_of(params))
    truth = pde.evaluate_gt(gt, pts).reshape(xx.shape)
    final = adapt(0, params, inner_steps)
    with torch.no_grad():
        vals = field_apply(final, pts).detach().reshape(xx.shape)
    return xx, tt, truth, vals


def plot_burgers_time_series(path, pde, gt, params, adapt, inner_steps, field_apply, step=None,
                             n_x=128):
    """(x, t) heatmaps: truth, adapted model and error; writes
    {path}/viz_ts_step_{step}.png and returns its name."""
    plt = pyplot()
    if plt is None:
        return None
    xx, tt, truth, vals = burgers_panels(pde, gt, params, adapt, inner_steps, field_apply, n_x)
    truth, vals = truth.cpu().numpy(), vals.cpu().numpy()
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    for ax, data, title in zip(axes, [truth, vals, vals - truth], ["truth", "model", "error"]):
        im = ax.pcolormesh(tt, xx, data, cmap="rainbow")
        ax.set_xlabel("t")
        ax.set_ylabel("x")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fname = f"{path}/viz_ts_step_{step}.png" if step is not None else f"{path}/viz_ts.png"
    fig.savefig(fname, dpi=160, bbox_inches="tight")
    plt.close(fig)
    return fname


def plot_burgers_time_series_gif(path, pde, gt, params, adapt, inner_steps, field_apply,
                                 step=None, n_x=128, frame_stride=5, duration_ms=80):
    """u(x) of truth and model at every frame_stride-th output time,
    stitched into an animated gif; returns its name (None without
    matplotlib or PIL)."""
    plt = pyplot()
    if plt is None:
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    xx, tt, truth, vals = burgers_panels(pde, gt, params, adapt, inner_steps, field_apply, n_x)
    xs = xx[0]
    u = gt.u_grid.detach().cpu().numpy()
    ymin, ymax = float(u.min()) - 0.1, float(u.max()) + 0.1
    frames = []
    for t, tr, va in zip(tt[::frame_stride, 0], truth.cpu().numpy()[::frame_stride],
                         vals.cpu().numpy()[::frame_stride]):
        fig, ax = plt.subplots(figsize=(4.5, 3))
        ax.plot(xs, tr, label="truth")
        ax.plot(xs, va, "--", label="model")
        ax.set_ylim(ymin, ymax)
        ax.set_title(f"t = {float(t):.2f}")
        ax.legend(loc="upper right", fontsize=7)
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
        plt.close(fig)
        buf.seek(0)
        frames.append(Image.open(buf).convert("P"))
    fname = f"{path}/viz_ts_step_{step}.gif" if step is not None else f"{path}/viz_ts.gif"
    frames[0].save(fname, save_all=True, append_images=frames[1:], duration=duration_ms, loop=0)
    return fname
