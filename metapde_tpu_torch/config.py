"""Typed, immutable experiment configuration (the port's own copy of
metapde_tpu/config.py; flags and config.json stay identical, so a run
directory written by either package is read by both).

Replaces the reference's global mutable absl flags (reference:
src/util/common_flags.py:10-95 plus per-driver flags, e.g.
src/maml_pde.py:50-58) with frozen dataclasses that are hashable (safe to
close over in jitted code) and serialized with every run. Runtime flag
mutation hazards in the reference (src/get_pde.py:12-20, src/nn_pde.py:51-52)
are designed out: every config is fixed at construction.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class DomainConfig:
    """Spatial/temporal bounding box of the task family.

    Mirrors reference flags xmin/xmax/ymin/ymax/tmin/tmax
    (src/util/common_flags.py:52-62).
    """

    xmin: float = -1.0
    xmax: float = 1.0
    ymin: float = -1.0
    ymax: float = 1.0
    tmin: float = 0.0
    tmax: float = 1.0


@dataclass(frozen=True)
class FieldConfig:
    """SIREN neural-field architecture (reference: src/nets/field.py:146-199).

    Defaults follow the paper configs in pipeline/pipleline_maml_meta.sh
    (omega = omega0 = 30, 3x64 net, learnable log IO scales).
    """

    num_layers: int = 3
    layer_size: int = 64
    siren: bool = True            # sin activations + SIREN init; else swish
    omega: float = 30.0           # per-layer sin frequency multiplier
    omega0: float = 30.0          # first-layer frequency
    log_scale: bool = True        # learnable log input/output scales
    io_scale_lr_factor: float = 10.0  # init scale = 1/factor (field.py:160-164)
    n_fourier: Optional[int] = None
    # route forward-only inference through the fused Pallas kernel
    # (ops/pallas_siren.py). Off by default: measured on v5e, XLA's own
    # pipeline beats the hand-fused chain for <=128-wide layers because the
    # kernel must pad lanes to 128 (see RESULTS.md "Pallas kernel study")
    use_pallas_inference: bool = False   # optional Fourier features (field.py:111)
    out_dim: int = 1              # output dimension of the field
    in_dim: int = 2               # input (coordinate) dimension
    squeeze_scalar: bool = True   # scalar fields return shape [N] (sum last axis)
    dtype: str = "float32"
    # Mixed-precision compute for the apply/vhd/vjac chains: when set
    # (e.g. "bfloat16"), inter-layer carried tensors (activations h and
    # the Taylor-mode J/D tangents) are STORED in this dtype — halving
    # the HBM/VMEM traffic the roofline shows the step is bound by —
    # while every matmul accumulates in f32 (preferred_element_type) and
    # activation/transcendental math runs in f32. Params stay f32 master
    # copies; outputs are cast back to f32. None = pure f32 (default).
    compute_dtype: Optional[str] = None


@dataclass(frozen=True)
class TaskConfig:
    """Which factors of the task distribution vary, and sampling counts.

    Mirrors vary_* / bc_scale / bc_weight / *_points flags
    (src/util/common_flags.py:14-15,46-49,71-76).
    """

    pde: str = "poisson"
    vary_source: bool = True
    vary_bc: bool = True
    vary_geometry: bool = True
    vary_ic: bool = True
    bc_scale: float = 1.0
    bc_weight: float = 100.0
    fixed_num_pdes: Optional[int] = None  # pin task distribution to one task
    seed: int = 0
    inner_points: int = 256
    outer_points: int = 256
    validation_points: int = 1024
    n_eval: int = 16
    # Domain/boundary point draws from the masked candidate pool: False
    # reproduces the reference's no-duplicate subsample
    # (jax.random.choice(replace=False), poisson_common.py:118 — a Gumbel
    # top-k that costs a TPU sort per draw); True draws iid WITH
    # replacement — an equally unbiased Monte-Carlo estimator of the same
    # uniform-domain losses, sort-free and markedly faster per step.
    sample_with_replacement: bool = False
    # td_burgers specific (common_flags.py:54-58)
    num_tsteps: int = 101
    sample_tsteps: int = 64
    sample_time_random: bool = True
    max_reynolds: float = 100.0
    burgers_formulation: str = "default"
    burgers_gt_solver: str = "fv"  # "fv" (Godunov FV) or "fem" (implicit-Euler CG1)
    # hyper_elasticity specific (common_flags.py:63-64)
    max_holes: int = 12
    max_hole_size: float = 0.4
    domain: DomainConfig = field(default_factory=DomainConfig)


@dataclass(frozen=True)
class MamlConfig:
    """MAML meta-learner hyperparameters (reference: src/maml_pde.py:50-58)."""

    bsize: int = 16
    outer_lr: float = 1e-5
    inner_lr: float = 1e-4
    lr_inner_lr: float = 0.5      # Adam LR for the learned inner-LR pytree
    inner_steps: int = 5
    inner_grad_clip: float = 100.0
    grad_clip: float = 100.0
    outer_loss_decay: float = 0.1  # 0 = final-step loss only, 1 = sum of all
    softplus_lrs: bool = True
    # inner-loop lax.scan unroll factor (meta/maml.py MamlDef.unroll):
    # >1 trades compile time/code size for less while-loop overhead
    unroll: int = 1


@dataclass(frozen=True)
class LeapConfig:
    """LEAP meta-learner hyperparameters (reference: src/leap_pde.py:40-48)."""

    bsize: int = 8
    outer_lr: float = 5e-5
    inner_lr: float = 2.5e-5
    inner_steps: int = 60
    inner_grad_clip: float = 1e14
    grad_clip: float = 1e14
    norm: bool = True
    loss_in_distance: bool = True
    stabilize: bool = True


@dataclass(frozen=True)
class SolverConfig:
    """Ground-truth solver settings (replaces FEniCS resolution flags,
    src/util/common_flags.py:17-27,31-38)."""

    ground_truth_resolution: int = 16
    # kept for reference-flag parity (mshr polygon vertex density,
    # common_flags.py:22-27); the structured-chart meshes fix angular
    # density at 16x resolution (fem_poisson.mesh_topology), which exceeds
    # the reference's boundary sampling at every paper setting
    boundary_resolution_factor: float = 3.0
    newton_max_steps: int = 30
    newton_tol: float = 1e-8
    relaxation_parameter: float = 1.0  # Newton damping (back-off on failure)
    krylov_tol: float = 1e-8
    krylov_max_iters: int = 2000
    # Burgers FV solver
    fv_resolution: int = 1024
    fv_cfl: float = 0.4
    # Elasticity load stepping
    load_steps: int = 4


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip execution.

    The reference has no model-math parallelism beyond single-device vmap
    (SURVEY.md section 2.3); here task-batch DP and collocation-point sharding
    are first-class mesh axes.
    """

    n_task_shards: int = 1   # "dp" axis: tasks sharded across devices
    n_point_shards: int = 1  # "pt" axis: collocation points sharded within task


@dataclass(frozen=True)
class DeployConfig:
    """Deployment-time multi-start adaptation (train/multistart.py).

    On multi-stable tasks (post-buckling hyperelasticity branches) a single
    adaptation can land in a higher-energy basin (RESULTS.md audit). With
    n_starts=K, deployment runs K vmapped adaptations under independent
    PRNG streams and keeps the argmin of the self-computable total task
    loss scored on one common point draw. No reference counterpart.
    """

    n_starts: int = 1    # 1 = single-start (the reference's behavior)
    jitter: float = 0.0  # relative init jitter for candidates 1.. (0 = off)
    score_points: int = 0  # points for the selection score; 0 -> task.validation_points
    # Deployment-time adaptation optimizer. "" (default) keeps the
    # algorithm's own rollout: MAML's learned-per-step-LR SGD
    # (maml_pde.py:163-183) / LEAP's inner optimizer. Setting e.g. "adam"
    # replaces the k-step rollout with k steps of that optax optimizer at
    # deploy.inner_lr — the reference's OTHER deployment protocol (nn_pde
    # fine-tune from a meta init, pipeline/pipeline_poisson_maml.sh),
    # measured in deploy_bench with honest per-step timing. On families
    # where the learned-LR stack saturates (steady_burgers: 1.2e-2 median
    # at k=80 vs 4.1e-3 after 50 Adam steps, RESULTS.md), this is the
    # better accuracy-vs-time Pareto frontier.
    optimizer: str = ""
    inner_lr: float = 1e-4  # LR for deploy.optimizer (ignored when "")


@dataclass(frozen=True)
class TrainConfig:
    """Driver-level training loop settings."""

    outer_steps: int = 100_000_000
    optimizer: str = "adam"       # adam | rmsprop | ranger | sgd
    log_every: int = 500
    # validation cadence; 0 (default) = validate at log_every. Setting it
    # denser than log_every densifies the val curve and best-checkpoint
    # tracking at the cost of one extra validation per hit.
    val_every: int = 0
    viz_every: int = 10_000
    measure_grad_norm_every: int = 1000
    out_dir: Optional[str] = None
    expt_name: str = "default"
    load_model_from_expt: Optional[str] = None
    checkpoint_every: int = 10_000
    remat_inner_steps: bool = True  # jax.checkpoint the inner-loop scan body
    # outer steps fused into one device call (lax.scan); recovers the ~60x
    # lost to per-step dispatch+sync latency at this model size. 1 = the
    # reference's step-at-a-time loop.
    steps_per_call: int = 1
    # write a profiler trace of training iterations here (the port:
    # torch.profiler's Chrome trace of MAML loop iterations, train/loop.py;
    # the reference has wall-clock Timers only, SURVEY.md section 5)
    profile_dir: Optional[str] = None
    profile_steps: int = 3  # loop iterations to capture in the trace
    # metric that drives checkpoint_best tracking: "rel_err" (the
    # reference-parity mean) or "rel_err_median". On branch-multistable
    # families (hyperelasticity) the n_eval-task MEAN is dominated by one
    # task's post-buckling branch roulette (RESULTS.md round-4 per-task
    # diagnostic: task 3 swings 0.03<->0.21 within 1k steps), making
    # best-on-mean selection near-random; the median tracks typical-task
    # quality. Default stays "rel_err" so existing chains' best files
    # remain comparable.
    best_metric: str = "rel_err"
    # energy-gated branch-aware validation (train/energy.py; generalizes
    # the reference's mirror-min disambiguation trainer_util.py:525-549):
    # per eval task, compare the adapted model's MC domain energy against
    # the oracle field's through the same estimator on fixed audit points;
    # tasks at energy parity with rel err above threshold are flagged
    # branch-divergent and excluded from the logged val_rel_err_branch.
    # Adds one deploy rollout + loss eval per task per validation.
    branch_aware_val: bool = False


@dataclass(frozen=True)
class Config:
    """Top-level experiment config."""

    task: TaskConfig = field(default_factory=TaskConfig)
    model: FieldConfig = field(default_factory=FieldConfig)
    maml: MamlConfig = field(default_factory=MamlConfig)
    leap: LeapConfig = field(default_factory=LeapConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    deploy: DeployConfig = field(default_factory=DeployConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _set_nested(obj, dotted: str, value: str):
    """Return a copy of frozen-dataclass `obj` with `a.b.c=value` applied."""
    head, _, rest = dotted.partition(".")
    if not hasattr(obj, head):
        raise KeyError(f"unknown config field: {head!r} on {type(obj).__name__}")
    if rest:
        return _replace(obj, **{head: _set_nested(getattr(obj, head), rest, value)})
    cur = getattr(obj, head)
    fld = {f.name: f for f in dataclasses.fields(obj)}[head]
    return _replace(obj, **{head: _coerce(value, cur, fld.type)})


def _coerce(value: str, current, annotation):
    if isinstance(value, (int, float, bool)) or value is None:
        return value
    v = value.strip()
    if v.lower() in ("none", "null"):
        return None
    if isinstance(current, bool):
        return v.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(float(v))
    if isinstance(current, float):
        return float(v)
    if current is None:
        # Optional field: guess from annotation string
        ann = str(annotation)
        if "int" in ann:
            return int(float(v))
        if "float" in ann:
            return float(v)
    return v


def merge_dict(obj, d: dict):
    """Recursively merge a (possibly nested) plain dict into a frozen
    config dataclass, ignoring unknown keys (forward/backward compat with
    configs serialized by older/newer code)."""
    kw = {}
    flds = {f.name: f for f in dataclasses.fields(obj)}
    for k, v in d.items():
        if k not in flds:
            continue
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kw[k] = merge_dict(cur, v)
        elif isinstance(v, str):
            kw[k] = _coerce(v, cur, flds[k].type)
        else:
            kw[k] = v
    return _replace(obj, **kw)


def load_run_config(run_dir: str, base: Optional[Config] = None) -> Config:
    """Reconstruct the Config a previous run serialized to
    `{run_dir}/config.json` (written by every driver at startup)."""
    import os
    with open(os.path.join(run_dir, "config.json")) as f:
        return merge_dict(base or Config(), json.load(f))


def parse_overrides(cfg: Config, argv) -> Config:
    """Apply `--a.b.c=value` style CLI overrides to a Config.

    `--from_run=DIR` (processed first, wherever it appears) loads DIR's
    serialized config.json as the base config and points
    train.load_model_from_expt at DIR — an exact-config continuation in
    one flag. Later `--a.b.c=` overrides still apply on top. This is the
    designed-in fix for the silent config-drift class of incident (a
    relaunch command omitting one flag whose default differs from the
    original run, cf. RESULTS.md hyperelasticity-LEAP caveat); the
    reference has no equivalent (its resume re-reads global absl flags,
    src/maml_pde.py:126-141)."""
    args = [a for a in argv if a.startswith("--")]
    for arg in args:
        if arg.startswith("--from_run="):
            run_dir = arg.split("=", 1)[1]
            cfg = load_run_config(run_dir, base=cfg)
            cfg = _set_nested(cfg, "train.load_model_from_expt", run_dir)
    for arg in args:
        body = arg[2:]
        if body.startswith("from_run="):
            continue
        if "=" in body:
            k, v = body.split("=", 1)
        else:
            k, v = body, "true"
        cfg = _set_nested(cfg, k, v)
    return cfg
