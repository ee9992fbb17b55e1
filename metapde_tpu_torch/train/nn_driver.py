"""Plain-PINN driver: fit one network to one PDE task, from scratch or from
a meta-learned init (counterpart of metapde_tpu/train/nn_driver.py); this is
how the paper's deployment accuracy-vs-time curves are produced
(pipeline/deployment_poisson.sh through cli/sweep.py).

Reference semantics kept:
- n_eval and fixed_num_pdes are forced to 1 and the run seed is folded into
  the task seed (task.seed + seed): every draw resolves to the one pinned
  task, and a seed sweep fine-tunes different tasks.
- batch loss: the SUM over the bsize point sets of (bc_weight * boundary +
  domain); the aux terms are their MEANs.
- the global norm of the whole gradient tree, a clip at maml.grad_clip
  (scale by clip / max(norm, 1e-30) only when norm > clip), then
  train.optimizer at maml.outer_lr.
- steps_per_call blocks cut at the log, checkpoint and grad-norm
  boundaries; a NaN loss anywhere in a block stops the run.
- get_grad_norms: the value and gradient norm of each loss term, every
  measure_grad_norm_every steps (single start only).
- make_coef_func: no adaptation, the model is the solution; one inference
  call over the eval task (one siren_fused launch on the card under
  model.use_pallas_inference).
- maml_warmup (cli/nn_pde_maml): when the loaded checkpoint holds learned
  inner LRs, one learned-LR rollout (SGD at maml.inner_lr, softplus LRs, the
  LR stack cut to maml.inner_steps) before plain training.
- multi-start (deploy.n_starts = K > 1): K candidates on a leading axis,
  candidate 0 the exact init and 1.. jittered (deploy.jitter); each has its
  own draws; the candidates are scored by multistart.make_score_fn on one
  common draw (a NaN score is inf), and validation, the best checkpoint and
  the final checkpoint take the best-scoring one.

Draws happen on the host from torch generators, so a CPU run and a card
run fine-tune the same task on the same points: the pinned task itself is
drawn on the host (the family's fixed_num_pdes draw seeds a generator on
the device of the generator it is given). The training stream is one
generator seeded with cfg.seed after the init draw; multi-start candidates
past 0, their jitter and the selection draws come from a second generator
(seeded cfg.seed + 2**32), so candidate 0 trains on the single-start
stream. draw_step_inputs(gen) draws one step's bsize point sets and moves
them to the device (pinned, without a host wait) as a Batch with the
task's params; step_core takes it, so tests pass in JAX's task and draws. The grad-norm diagnostics draw from a
generator seeded by (seed, step), leaving the training stream alone. The
eval task's validation coords come from a generator seeded cfg.seed, so
runs of one seed validate on the same coords; its ground truth goes through
<out_dir>/gt_cache_torch/, which runs of one seed share.

What differs from the JAX package, on purpose: checkpoints hold the
optimizer state as torch_opt_state (the JAX package's opt_state and
prng_key are optax and JAX objects the port does not write). cfg.mesh is
ignored: the run trains in one process, as the JAX driver, which never
reads it, does.
"""

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..device import DEFAULT_DEVICE, resolve_device
from ..interop import params_from_numpy
from ..meta import maml
from ..models.siren import mixed_precision_scope
from ..utils import Timer, spans
from ..utils.trees import (clip_by_global_norm, global_norm, tree_leaves, tree_map, tree_stack,
                           tree_unflatten)
from . import checkpoints as ckpt
from . import loop
from .metrics import prepare_logging
from .multistart import jitter_leaves, make_score_fn
from .optimizers import apply_updates, get_optimizer
from .validation import make_validation_fn

# the multi-start generator's seed offset from cfg.seed
_MS_SEED_OFFSET = 2 ** 32


class Batch(NamedTuple):
    """Draws on the pinned task: its params and point sets, per kind
    [sets, n, ...] (a step's bsize sets, or the warm-up's K + 1)."""

    task_params: tuple
    points: tuple


def single_task_config(cfg: Config) -> Config:
    """cfg with one pinned eval task whose seed folds in the run seed."""
    task = dataclasses.replace(cfg.task, n_eval=1, fixed_num_pdes=1,
                               seed=cfg.task.seed + cfg.seed)
    return dataclasses.replace(cfg, task=task)


def build(cfg: Config, device=DEFAULT_DEVICE):
    """Construct the pure components of a plain-PINN run on `device` (CUDA
    unless the caller asks for the CPU); returns a dict."""
    cfg = single_task_config(cfg)
    pde, model_cfg, field, loss_fn, task_loss = loop.problem(cfg)
    device = resolve_device(str(device))
    generator = torch.Generator().manual_seed(cfg.seed)
    init_params = field.init(generator, device)
    # the pinned task, on the host: fixed_num_pdes ignores the generator's
    # stream but not its device
    host_task = pde.sample_params(torch.Generator())
    task_params = tuple(a.to(device) for a in host_task)
    bsize = max(cfg.maml.bsize, 1)
    opt = get_optimizer(cfg.train.optimizer, cfg.maml.outer_lr)
    batch_task_loss = torch.func.vmap(task_loss, in_dims=(None, 0, None))

    def _draw(gen, n, sets):
        pts = pde.sample_points_batched(gen, n, tuple(a[None] for a in host_task), sets)
        return Batch(task_params, loop.to_device(tuple(p[0] for p in pts), device))

    def draw_step_inputs(gen):
        """One step's bsize point sets of task.outer_points, from `gen` (on
        the host by default), on the device: a Batch."""
        return _draw(gen, cfg.task.outer_points, bsize)

    def _losses(batch, params):
        """(loss, aux means) of the batch with grad-requiring leaves."""
        with mixed_precision_scope(model_cfg):
            losses, aux = batch_task_loss(params, batch.points, batch.task_params)
        return losses.sum(), {k: v.mean() for k, v in aux.items()}

    def _leaves(params):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        return leaves, tree_unflatten(params, leaves)

    def step_core(batch, params, opt_state):
        """One step on given draws (the JAX package's _step_core). Returns
        (params, opt_state, loss, aux means, grad norm)."""
        leaves, p = _leaves(params)
        with torch.enable_grad():
            loss, aux = _losses(batch, p)
            grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            grads, grad_norm = clip_by_global_norm(grads, cfg.maml.grad_clip)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return (params, opt_state, loss.detach(),
                {k: v.detach() for k, v in aux.items()}, grad_norm)

    def train_step(gen, params, opt_state):
        return step_core(draw_step_inputs(gen), params, opt_state)

    def train_step_many(gen, params, opt_state, n_steps: int):
        """n_steps steps with no host read. Returns the final state, the last
        step's loss, aux and grad norm, and every step's loss [n_steps]."""
        losses = []
        for _ in range(n_steps):
            params, opt_state, loss, aux, gn = train_step(gen, params, opt_state)
            losses.append(loss)
        return params, opt_state, loss, aux, gn, torch.stack(losses)

    def ms_train_step_many(gens, params_k, opt_state_k, n_steps: int):
        """train_step_many of K candidates (leaves [K, ...]), candidate k on
        gens[k]; the outputs stacked on a leading K axis."""
        outs = [train_step_many(g, tree_map(lambda x: x[k], params_k),
                                tree_map(lambda x: x[k], opt_state_k), n_steps)
                for k, g in enumerate(gens)]
        return tuple(tree_stack(list(o)) for o in zip(*outs))

    score = make_score_fn(pde, loss_fn, field,
                          cfg.deploy.score_points or cfg.task.validation_points)

    def ms_scores(gen, params_k):
        """Each candidate's total loss on one common draw from `gen`; NaN ->
        inf. Returns [K]."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        with torch.no_grad():
            scores = torch.stack([
                score(torch.Generator().manual_seed(seed), tree_map(lambda x: x[k], params_k),
                      task_params)
                for k in range(tree_leaves(params_k)[0].shape[0])])
        return torch.where(torch.isnan(scores), torch.full_like(scores, math.inf), scores)

    def get_grad_norms(batch, params):
        """{term: (value, grad norm)} of each loss term's batch mean. A leaf
        a term does not reach has a zero gradient, as in JAX (a
        hyperelasticity edge term skips one output's last-layer leaves)."""
        leaves, p = _leaves(params)
        out = {}
        with torch.enable_grad():
            _, aux = _losses(batch, p)
            for k, v in aux.items():
                g = torch.autograd.grad(v, leaves, retain_graph=True, allow_unused=True)
                g = [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, g)]
                out[k] = (v.detach(), global_norm(g))
        return out

    def make_coef_func(gens, model, task_params, coords):
        """The model itself at coords [1, V, d] of the eval task, or [1, S,
        V, d] (S coordinate sets, e.g. hyperelasticity's mirror): one
        inference call (no adaptation), the sets flattened into its task
        axis."""
        lead = coords.shape[:-2]
        with torch.no_grad():
            out = field.apply_inference_batched(model, coords.reshape(-1, *coords.shape[-2:]),
                                                shared=True)
        return out.reshape(*lead, *out.shape[1:])

    def maml_warmup(gen, params, inner_lrs, batch=None):
        """One learned-LR rollout from a meta init on the pinned task: SGD at
        maml.inner_lr, softplus LRs, the LR stack cut to maml.inner_steps.
        A fresh point set of task.inner_points per inner step and one for
        the final loss, drawn from `gen` unless `batch` gives the task and
        its K + 1 sets."""
        lrs = tree_map(lambda x: x[:cfg.maml.inner_steps], inner_lrs)
        k = tree_leaves(lrs)[0].shape[0]
        if batch is None:
            batch = _draw(gen, cfg.task.inner_points, k + 1)
        sets = iter(range(k + 1))

        def inner_loss(fp):
            s = next(sets)
            return loss_fn(field.bind(fp), tuple(p[s] for p in batch.points),
                           batch.task_params)

        maml_def = maml.MamlDef(inner_lr=cfg.maml.inner_lr, inner_steps=k, softplus_lrs=True,
                                outer_loss_decay=cfg.maml.outer_loss_decay,
                                inner_grad_clip=cfg.maml.inner_grad_clip)
        with mixed_precision_scope(model_cfg):
            final_params, _ = maml.single_task_rollout(maml_def, params, inner_loss, lrs)
        return final_params

    return dict(
        cfg=cfg,
        pde=pde,
        field=field,
        model_cfg=model_cfg,
        loss_fn=loss_fn,
        task_params=task_params,
        opt=opt,
        init_params=init_params,
        draw_step_inputs=draw_step_inputs,
        step_core=step_core,
        train_step=train_step,
        train_step_many=train_step_many,
        ms_train_step_many=ms_train_step_many,
        ms_scores=ms_scores,
        get_grad_norms=get_grad_norms,
        make_coef_func=make_coef_func,
        maml_warmup=maml_warmup,
        generator=generator,
        device=device,
    )


def _load(cfg: Config, c: dict, log):
    """(params, inner LRs or None) of the latest checkpoint of
    train.load_model_from_expt (a run of either package), or the init."""
    params, inner_lrs = c["init_params"], None
    fname = ckpt.latest_checkpoint(cfg.train.load_model_from_expt)
    if fname:
        state = ckpt.load_checkpoint(fname)
        params = params_from_numpy(state["params"], c["device"])
        if state.get("inner_lrs") is not None:
            inner_lrs = params_from_numpy(state["inner_lrs"], c["device"])
        log(f"loaded checkpoint {fname}")
        # deployment fine-tunes intentionally change train.* settings;
        # task/model/solver drift is still worth surfacing
        for d in ckpt.config_drift(cfg.train.load_model_from_expt, cfg):
            log(f"note: differs from loaded run's config: {d}")
    return params, inner_lrs


def _fin(v):
    """A finite float, or None (metrics.jsonl stays strict JSON)."""
    v = float(v)
    return v if math.isfinite(v) else None


def run(cfg: Config, maml_warmup: bool = False, device=DEFAULT_DEVICE):
    """Fit the pinned task: log.txt, metrics.jsonl, the best checkpoint and
    the final one, as the JAX driver writes them, and a closing log line
    with the run's seconds, its ground truth's seconds and the siren_fused
    launches it made. Returns the final params (the selected candidate
    under multi-start)."""
    t_run = time.perf_counter()
    launches0 = spans.counter("siren_fused.launches")
    c = build(cfg, device)
    out_dir = cfg.train.out_dir or f"{cfg.task.pde}_nn_results"
    path, log, metrics = prepare_logging(out_dir, cfg.train.expt_name)
    log(cfg.to_json())
    cfg, pde, device, gen = c["cfg"], c["pde"], c["device"], c["generator"]

    params, inner_lrs = c["init_params"], None
    if cfg.train.load_model_from_expt:
        params, inner_lrs = _load(cfg, c, log)
    if maml_warmup and inner_lrs is not None:
        params = c["maml_warmup"](gen, params, inner_lrs)
        log("applied MAML warm-up adaptation")

    n_starts = max(1, cfg.deploy.n_starts)
    ms_gen = torch.Generator().manual_seed(cfg.seed + _MS_SEED_OFFSET)
    if n_starts > 1:
        # candidate 0 is the exact init on the single-start stream; 1..
        # jittered, each on its own stream
        seeds = [int(s) for s in torch.randint(0, 2 ** 62, (2 * (n_starts - 1),),
                                               generator=ms_gen)]
        cands = [params] + [jitter_leaves(torch.Generator().manual_seed(s), params,
                                          cfg.deploy.jitter) for s in seeds[:n_starts - 1]]
        gens = [gen] + [torch.Generator().manual_seed(s) for s in seeds[n_starts - 1:]]
        params = tree_stack(cands)
        opt_state = tree_stack([c["opt"].init(p) for p in cands])
        log(f"multi-start fine-tune: {n_starts} candidates, jitter={cfg.deploy.jitter}")
    else:
        opt_state = c["opt"].init(params)

    with Timer() as gt_timer:
        bundle = loop.eval_ground_truth(cfg, pde, cfg.seed, device, log)
    validation_fn = make_validation_fn(pde, c["make_coef_func"], cfg.task.n_eval,
                                       **loop.validation_kwargs(cfg.task))
    spc = max(1, cfg.train.steps_per_call)

    def _next_boundary(step):
        n = cfg.train.outer_steps - step
        for every in (cfg.train.log_every, cfg.train.checkpoint_every,
                      cfg.train.measure_grad_norm_every):
            if every and every > 0:
                n = min(n, every - step % every)
        return max(1, min(n, spc))

    def _current_best():
        """(best-candidate params, idx, scores) under multi-start; identity
        otherwise."""
        if n_starts == 1:
            return params, 0, None
        scores = c["ms_scores"](ms_gen, params)
        idx = int(torch.argmin(scores))
        return tree_map(lambda x: x[idx], params), idx, scores

    step = 0
    while step < cfg.train.outer_steps:
        block = _next_boundary(step) if spc > 1 else 1
        with Timer() as t:
            if n_starts > 1:
                params, opt_state, loss_k, aux_k, gn_k, losses_all = c["ms_train_step_many"](
                    gens, params, opt_state, block)
                # the train-loss-best candidate; NaN in some candidates only
                # loses them the selection
                best_k = int(torch.argmin(torch.where(torch.isnan(loss_k),
                                                      torch.full_like(loss_k, math.inf),
                                                      loss_k)))
                nan_now = bool(torch.isnan(losses_all[:, -1]).all())
            else:
                params, opt_state, loss, aux, grad_norm, losses_all = c["train_step_many"](
                    gen, params, opt_state, block)
                nan_now = bool(torch.isnan(losses_all).any())
            loop.device_barrier(device)
        step_time = t.interval / block
        step += block
        log_step = step - 1

        if nan_now:
            log(f"encountered nan at step {log_step}")
            break

        if loop.hit(cfg, cfg.train.val_every or cfg.train.log_every, step):
            val_params, best_idx, scores = _current_best()
            val = validation_fn(val_params, bundle.gt_params, bundle.coords, bundle.gt_vals)
            # under multi-start every stat of the row is the selection-best
            # candidate's; the train-loss-best index is logged apart
            if scores is not None:
                loss, grad_norm = loss_k[best_idx], gn_k[best_idx]
                aux = {k: v[best_idx] for k, v in aux_k.items()}
            ms_txt = ("" if scores is None else ", ms_best: {}, ms_scores: {}".format(
                best_idx, [float(s) for s in scores]))
            log("step: {}, loss: {}, val_mse: {}, val_rel_err: {}, grad_norm: {}, "
                "time: {}{}".format(log_step, float(loss), float(val.mse),
                                    float(val.rel_err), float(grad_norm), step_time, ms_txt))
            if metrics is not None:
                extra = {} if scores is None else {
                    "ms_best_idx": best_idx, "ms_train_best_idx": best_k,
                    "ms_score_best": _fin(scores.min()), "ms_score_worst": _fin(scores.max())}
                metrics.log(
                    log_step,
                    loss=loss,
                    val_mse=val.mse,
                    val_rel_err=val.rel_err,
                    val_rel_err_std=val.rel_err_std,
                    per_time_step_error=val.t_rel_sq_err,
                    grad_norm=grad_norm,
                    step_time=step_time,
                    **{k: _fin(v) for k, v in aux.items()},
                    **extra,
                )
            if path is not None:
                # the best-val state stays durable; under multi-start
                # val_params is the candidate that was scored
                best_val = (val.rel_err_median if cfg.train.best_metric == "rel_err_median"
                            else val.rel_err)
                ckpt.save_best_checkpoint(path, log_step, float(best_val),
                                          {"params": val_params})

        if loop.hit(cfg, cfg.train.measure_grad_norm_every, step) and n_starts == 1:
            draw = c["draw_step_inputs"](torch.Generator().manual_seed(
                cfg.seed * 2 ** 32 + log_step))
            norms = c["get_grad_norms"](draw, params)
            log("loss vals and grad norms: ",
                {k: (float(v[0]), float(v[1])) for k, v in norms.items()})

    final_params, best_idx, scores = _current_best()
    if scores is not None:
        log("multi-start selection: best candidate {} of {}, scores {}".format(
            best_idx, n_starts, [float(s) for s in scores]))
    if path is not None:
        state = {"params": final_params}
        if n_starts == 1:
            state["torch_opt_state"] = opt_state
        else:
            state["ms_scores"] = np.asarray(scores.cpu())
            state["ms_best_idx"] = best_idx
        ckpt.save_checkpoint(path, step, state)
    log(f"done: {step} steps, run {time.perf_counter() - t_run} s, ground truth "
        f"{gt_timer.interval} s, siren_fused launches "
        f"{spans.counter('siren_fused.launches') - launches0}")
    if metrics is not None:
        metrics.close()
    return final_params
