#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (metapde_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (flushed) with its name and seconds:
  0 device    torch and CUDA versions, nvidia-smi's name and power limit
  1 build     nvcc builds csrc/siren_fused.cu for sm_90a (or finds it built),
              with ptxas's register and spill report
  2 kernel    siren_fused against its plain PyTorch version on the card, max
              |diff| <= 1e-5 on twenty-six cases (the last six this slice's:
              LEAP training's validation of ldb3_2, 4 x 1008 at 10x128, and
              of lde2_3, 8 x 1024 with two outputs, and the Burgers and
              hyperelasticity sweeps' one model at 1 x 1008 and 2 x 1024,
              at 8x64 and 10x128; before them `nn_leap_path`, one task
              x 1024 points at 5x64 with one weight set, lp2_4's fine-tune
              validation; `main_path` is tpu_run6b's at 3x64): the four configs of
              tests/test_pallas_siren.py, one task at the main path's shape
              and at 2^20 points, 8 tasks x 1024 points in one launch with
              per-task and with shared weights, 8 layers at width 128 (weights
              streamed through shared memory), a ragged 3 x 1000, and two
              per-task cases with more (task, tile) items than the grid has
              blocks, so that blocks cross task boundaries: 8 x 2^14 at 3x64
              (resident weights reloaded) and 3 x 2^15 at 8 layers of 128
              (the streaming path across items and tasks), and LEAP's
              validation, 8 x 4096 at 5x64 with per-task weights, and
              TD-Burgers' deployments, 8 x 1008 points (not a multiple of the
              64-point tile) at bm7_5's 8x64 and at ldb3_2's 10x128 (weights
              streamed), per-task weights, and hyperelasticity's validation,
              16 x 1024 points (8 tasks and their mirrors) with two outputs
              at em7_9's 8x64 and at lde2_3's 10x128 (streamed), and steady
              Burgers' validation, 4 x 1024 with two outputs at sbi10_2's
              5x64, and poisson3d's, 8 x 2048 at in_dim 3 and the pipeline's
              5x128 (streamed); for the timed
              cases, CUDA-event times (median of 20 after 3 warm-ups) of the
              kernel alone on weights packed beforehand and of the wrapper
              with its packing, the kernel's device time under torch.profiler
              (launch gaps excluded), the plain version's time, and the
              card's least time for the same work, both for this design
              (bound_ms) and as f32 FMAs alone (bound_f32_ms, the bound of
              earlier rows), and the launch plan (resident weights or
              streamed, shared memory a block, blocks an SM)
  3 parity    a small deployment on the card and on the CPU, same tasks and
              points: metrics agree to 1e-2
  4 deploy    the Poisson MAML deployment path end to end through
              cli/deploy_bench: checkpoint results_poisson_maml/p30k_f32_s1,
              4 fresh tasks, FEM ground truth at resolution 16, k = 0, 1, 2, 5
              learned-LR steps, inference through the kernel; checks that the
              kernel launched once per validation call (all tasks in one
              launch: 4 values of k x (1 warm-up + 2 timed calls) = 12), every
              value is finite, and the k = 5 median relative error beats
              k = 0 and is within 3x of the JAX package's
  5 ground_truth_mg  one task solved at resolution 32 (multigrid
              preconditioner) on the card and on the CPU (a process of its
              own with two threads, started at the run's start: the phase
              runs after train_bench, when it is done), each u_grid
              within 3x the JAX package's own f32 distance (1.836e-4 of the
              grid's largest |value|) of the float64 solve on the card (the
              Newton target sits at the f32 floor, so two f32 solves are
              not held to each other: their distance is printed); seconds
              per task, Newton
              steps, BiCGStab iterations per Newton step, kernel launches
              per V-cycle; one BiCGStab solve on the stiffness operator
              with each iteration a CUDA graph and eager: the same iteration
              count and iterates within 1e-5, both timed; and one solve
              under torch.profiler (device busy, idle share, launches)
  6 deploy_mg the same deployment at the checkpoint's own resolution 32
              (multigrid), ground truth through the cache in
              gt_cache_torch/: the same launch count and the same bars, the
              JAX package's CPU median taken at resolution 32; then the same
              deployment with the bf16 chain (deploy_mg_bf16) from the cached
              ground truths: no Newton step, 8 launches of the f32 kernel,
              the same bars, and its k = 0 errors those of the f32 pass
              within 1e-5
  7 train_parity  a tiny meta-training (2 layers of 32, bsize 4, 2 inner
              steps, 128 points, 3 outer steps) on the card and on the CPU
              on the same host draws, TF32 off: params and inner LRs within
              1e-4 of each leaf's scale after every step, meta-losses
              within rtol 1e-3
  8 train_parity_bf16  two outer steps of bench.py's flagship in bf16
              (3x64, bsize 16, 5 inner steps, 1024/1024 points) on the card
              and on the CPU on the same host draws: every leaf within 1e-2
              of its scale, meta-losses within rtol 1e-3
  9 train_resume_jax  one full-width outer step (p30k_f32_s1's config:
              3x64, bsize 16, 5 inner steps, 1024/1024 points, remat on)
              from the JAX package's checkpoint_step_30001.pickle with its
              Adam states, on the card and on the CPU, same draws and bars
 10 train     the training path end to end through cli/maml_pde on a copy
              of p30k_f32_s1's config.json at its full width (its viz_every,
              0), cut to 30 outer steps in blocks of 10 (cuts listed in
              `reduced`), with validation through the kernel every 10 steps
              against ground truth at the config's own resolution 32, cached
              in gt_cache_torch/; checks finite losses and val_rel_err, the
              run directory's files, the final checkpoint's JAX-read keys,
              dtypes and shapes (as in the JAX checkpoint) and no JAX-only
              key, one kernel launch per validation call, and the tb/
              TensorBoard mirror (valid CRCs, one record per mirrored scalar
              per validation, metrics.jsonl's values); then a run() that
              resumes from it in the same out_dir for 3 steps, one a call,
              with profile_dir set, must solve nothing and write a
              torch.profiler trace of loop iteration 1 with CUDA kernels in
              it; and train/viz.py's panel function at that width on 3
              tasks at k = 0 and 5 on the 64 x 64 grid, on the card and on
              the CPU on the same inputs: finite, within 1e-4 of each
              panel's largest |value|
 11 train_bench  cli/train_bench on bench.py's flagship config, bf16 as
              bench.py runs it, then the f32 variant (1 timed block of 2
              outer steps, one profiled block of 2; cuts in `reduced`),
              with the form of the bf16 products that ran
 12 leap_parity  a tiny LEAP meta-training (2 layers of 32, bsize 4, 3
              inner steps, 128 points, 3 outer steps) on the card and on the
              CPU on the same host draws, TF32 off: params within 1e-4 of
              each leaf's scale after every step, meta-losses within rtol
              1e-3
 13 leap_resume_jax  one outer step at the width of
              results_poisson_leap/lp2_4 (5x64, bsize 8, 60 inner steps,
              4096 points) from its checkpoint_step_60000.pickle with its
              Adam state, on the card and on the CPU, same draws and bars
 14 leap_deploy  cli/deploy_bench --algo=leap on a copy of lp2_4 at its
              full width: 4 fresh tasks, 4096 inner and validation points,
              k = 0, 5, 20, 60, ground truth at resolution 32 (multigrid)
              through gt_cache_torch/; 12 kernel launches (one per
              validation call, every task in one batched rollout and one
              launch), finite values, the k = 60 median below k = 0 and
              within 3x of the JAX package's CPU median; then the same with
              --deploy.optimizer=adam at k = 0, 50, 200 from the cached
              ground truths (leap_deploy_adam): 6 launches, no Newton step,
              the same kind of bars at k = 200
 15 leap_train  cli/leap_pde on a copy of lp2_4's config.json at its full
              width, cut to 2 outer steps in one block of 20 of its 60
              inner steps (cuts listed in `reduced`), validation through
              the kernel at step 2 on 1 eval task against ground truth at resolution 32; the checks
              of phase train against lp2_4's files; a resumed run() solves
              nothing; then two unprofiled outer steps (steps/s, draw s a
              step, peak memory) and one under torch.profiler (launches,
              device-busy ms, idle share)
 16 burgers_gt  the FV ground truth of bm7_5's 8 deployment tasks (resolution
              512, 201 output times, 7,400 SSP-RK3 steps) in one batched solve
              on the card (one output segment a CUDA graph, held equal to the
              eager loop bit for bit at resolution 128) and on the CPU:
              u_grids within 1e-5 of the grid's largest |u|; seconds, and one
              solve under torch.profiler (kernels, device busy, idle share);
              then one FEM task (resolution 64, 6 output times) on both,
              within 1e-4, with its Newton and Krylov counts
 17 burgers_parity  train_parity on bm7_5's task family (TD-Burgers)
 18 burgers_deploy  cli/deploy_bench --algo=maml on a copy of
              results_burgers_maml/bm7_5 (8x64, best checkpoint, 8 fresh
              tasks, k = 0, 1, 2, 5, FV ground truth at 512 through
              gt_cache_torch/): 8 launches, the k = 5 median below k = 0 and
              within 3x of the JAX package's CPU median
 19 burgers_train  cli/maml_pde on a copy of bm7_5's config at its full width,
              resumed from its checkpoint_step_500001.pickle with both Adam
              states: 10 outer steps (cuts in `reduced`), validation with the
              per-timestep error, val_rel_err below 1e-2, 201 finite
              per-timestep entries, one launch per validation call, the final
              checkpoint's keys, a resumed run() that solves nothing; then two
              unprofiled steps and one profiled
 20 leap_burgers_deploy  cli/deploy_bench --algo=leap on a copy of
              results_burgers_leap/ldb3_2 (10x128, weights streamed through
              shared memory): k = 0, 5, 20, 80, 8 launches, the k = 80 median
              below k = 0 and within 3x of the JAX package's CPU median
 21 elasticity_gt  two of em7_9's deployment tasks through the sparse-direct
              neo-Hookean solve on the host (float64, scipy's LU, the
              reference's own design) at resolution 32 raised by the ligament
              floor: the floored resolution, seconds, Newton steps and the
              final |g| (<= 1e-5, the solver's acceptance) of each; the P1
              interpolation on the card equal to the CPU's within 1e-6 of the
              field's largest |value| at 1024 validation points
 22 elasticity_parity  a small em7_9 deployment (2 tasks, resolution 8 raised
              by the floor, 256 inner and validation points, k = 0 and 5, the
              mirror-symmetric validation) on the card and on the CPU, same
              tasks and points: metrics agree to 1e-2
 23 elasticity_deploy  cli/deploy_bench --algo=maml on a copy of
              results_elasticity_maml/em7_9 (8x64, two outputs, best
              checkpoint, 8 fresh tasks, k = 0, 1, 2, 5, --energy_audit):
              8 launches (each validation call evaluates every task and its
              mirror in one launch), finite values and audit columns, the
              k = 5 median below k = 0 and within 3x of the JAX package's CPU
              median
 24 leap_elasticity_deploy  cli/deploy_bench --algo=leap on a copy of
              results_elasticity_leap/lde2_3 (10x128, two outputs, weights
              streamed, 2048 inner points): k = 0, 5, 20, 40, 8 launches,
              the k = 40 median below k = 0 and within 3x of the JAX package's
              CPU median
 25 elasticity_train  cli/maml_pde on a copy of em7_9's config at its full
              width, resumed from its checkpoint_step_500001.pickle with both
              Adam states: 6 outer steps (cuts in `reduced`), branch-aware
              validation at 500003 and 500006 on 2 eval tasks: val_rel_err
              below 5e-2, val_rel_err_branch, val_branch_flags and
              val_branch_mask present and finite, one launch per validation
              call; then two unprofiled steps and one profiled
 26 steady_gt  one of sbi10_2's deployment tasks through the steady FEM
              solve at resolution 48 (Jacobi-BiCGStab, the solver's own
              constants) on the card and on the CPU: u_grids within 1e-4 of
              the grid's largest |u|; seconds, Newton steps, Krylov
              iterations, the final residual norm, and one solve under
              torch.profiler (launches an iteration, idle share); the P1
              evaluation on the card within 1e-6 of the CPU's
 27 steady_parity  a 2-task sbi10_2 deployment at k = 0 and 10 on the card
              and on the CPU, shared ground truths: metrics within 1e-4
              relative
 28 steady_deploy  cli/deploy_bench --algo=maml on a copy of
              results_sburgers_maml/sbi10_2 (5x64, two outputs, best
              checkpoint, 4 fresh tasks, k = 0, 10, 80 (20 and 40 cut),
              ground truth at resolution 48): 6 launches, the k = 80 median
              below k = 0
              and within 3x of the JAX package's CPU median; then
              --deploy.optimizer=adam at k = 0, 50 from the cached ground
              truths (steady_deploy_adam): 4 launches, no Newton step, the
              same bars at k = 50
 29 steady_train  cli/maml_pde on a copy of sbi10_2's config at its full
              width (bsize 8, 10 inner steps, remat, 1024 points), resumed
              from its checkpoint_step_100001.pickle with both Adam states:
              4 outer steps (cuts in `reduced`), validation at 100003 and
              100005 on 2 eval tasks at resolution 48, val_rel_err below
              5e-2, one launch per validation call; then two unprofiled
              steps and one profiled
 30 poisson3d_parity  train_parity on poisson3d at the pipeline's 5x128,
              cut to bsize 2 and 256 points, 3 outer steps
 31 poisson3d_train  cli/maml_pde --task.pde=poisson3d with
              pipeline/maml_meta_3d.sh's flags at its one-chip width (5x128,
              bsize 16, 5 inner steps, 2048 points, 8 eval tasks), 4 steps
              from a fresh init, validation against the exact solution
              (every val_rel_err finite and below 1e3); then two unprofiled
              steps and one profiled, and one step's peak memory without
              remat
 32 nn_parity  the plain-PINN driver (train/nn_driver.py) on the card and on
              the CPU on the same host draws, TF32 off: 5 steps of
              train_step_many from lp2_4 at pipeline/deployment_poisson.sh's
              second command (5x64, bsize 16, 512 points), then one MAML
              warm-up from results_poisson_maml/tpu_run6b at its first (3x64,
              5 learned-LR steps): params within 1e-4 of each leaf's scale,
              losses within rtol 1e-3; the pinned task equal on both sides
 33 nn_deploy_maml  the script's first command unchanged in width and depth
              (nn_pde_maml from tpu_run6b: the warm-up, then 200 Adam steps
              at bsize 16 on 1024 points, validation every 5 steps against
              ground truth at 32) through cli/sweep on 2 seeds (the script's
              8 cut to 2, in `reduced`), 2 jobs at once on the one card,
              with the kernel on: "applied MAML warm-up adaptation" in each
              log.txt, one launch per validation call in each job (each job
              counts its own and writes them in log.txt's closing line),
              the median over the seeds of val_rel_err at step 195 at most 3x
              the JAX package's 8-seed median (7.3336e-4), the step-0, -100
              and best medians beside JAX's; then the fine-tune step alone on
              the card (steps/s, host draw, launches, idle share)
 34 nn_deploy_leap  the script's second command (nn_pde from lp2_4, 5x64,
              512 points) on the same seeds and out_dir: every seed reads
              its ground truth from the MAML sweep's cache ("0 solved, 1
              read"), the same checks, bar 3x 8.0948e-4
 35 nn_multistart  cli/nn_pde from lp2_4 with 3 candidates (jitter 0.05),
              10 steps, seed 1, ground truth from the cache: the ms_* keys in
              metrics.jsonl, one launch per validation call, a final
              checkpoint of one unstacked model with 3 scores
 36 solver_baseline  cli/solver_baseline on the card: 4 tasks at
              resolutions 4, 8, 16 against the float64 reference at 32:
              rel_mse falling with resolution and within 10x either way of
              the JAX package's on the same tasks and coords
              (tests/jax_solver_sweep_bar.py), the ratio to baselines/poisson's
              committed sweep printed beside (16 other tasks, reference at
              64, its means carried by a few hard tasks); then cli/gt_convergence
              (one task at 4 and 8 against 16) on the card and, in a process
              of its own, on the CPU: sqrt(rel_mse) within 1e-5 (the Jacobi
              solve at 8 stops at its iteration cap, and rel_mse's relative
              difference magnifies the fields' ~1e-6 by hundreds)
 37 mesh_train  the parallel layer (metapde_tpu_torch/parallel), ranks in
              processes of their own, sharing the card through gloo (each
              with its own card and nccl where the machine has enough): (a)
              bench.py's flagship at full width through cli/distributed_smoke,
              one outer step on the 2 x 2 mesh in f32 (dp = 2 and pt = 2 cut
              in PR 15: the 2 x 2 mesh runs both axes' collectives) and on 2 x 2
              in bf16 against the one-process step on the same draws and card:
              the meta-gradient within 1e-4 of each leaf's scale and the losses
              within rtol 1e-4 (bf16: 1e-2), with steps/s, launches, collectives
              and idle share of rank 0's steps; (b) pipeline/maml_meta_3d.sh's
              config at full width (5x128, 2048 points, 8 eval tasks) through
              the launcher and cli/maml_pde on dp = 2 at bsize 32 (cuts in
              `reduced`), 4 steps in two blocks: rank 0 alone writes the run
              files and validates at steps 1 and 3 while the other rank
              waits, both train on between them,
              val_rel_err finite and below 1e3, one siren_fused launch (rank
              0's) per validation call; steps/s, each rank's peak memory,
              backend; (c) LEAP at lp2_4's width (bsize 2, 10 inner
              steps), one dp = 2 and one pt = 2 step against the
              one-process step; (d) the other families: (d1) one MAML
              step of bm7_5's, em7_9's and sbi10_2's configs at full width
              on 2 x 2, each against one process with (a)'s bars and
              numbers, in (a)'s launch of the ranks (--variant), (d2)
              (c)'s steps at ldb3_2's width in (c)'s launch, (d3)
              cli/maml_pde on 2 x 2 through the launcher resumed from
              bm7_5's checkpoint, 2 steps and one validation in
              burgers_train's out_dir: rank 0 alone writes, 201 finite
              per-timestep entries, one siren_fused launch (rank 0's) per
              validation call, the wall kinds given whole on the mesh line,
              and both eval tasks' ground truth read from burgers_train's
              cache (solved when the phase runs alone); (a)-(d) at once,
              no process left behind
 38 elasticity_cascade  the matrix-free cascade (solvers/fem_elasticity.py::
              solve): uniform compression (tests/test_elasticity.py:83-98)
              and one of em7_9's deployment tasks at resolution 12 on the
              card and on the CPU, u_grids within 1e-4 of the grid's largest
              |u|; that task at em7_9's resolution 32 (the chain 16 -> 32)
              on the card, finite, |u| < 0.5, energy < 1e3, with its
              distance to solve_direct and its |g|; solve_x64 at 12 on the
              card with float64 leaves; s a solve, Newton steps, CG
              iterations, launches of an eager CG iteration, ms of an eager
              and a graphed one, and one solve under torch.profiler (idle
              share)
 39 pde_check cli/pde_check on the card for the five families (each
              committed run's task config): a finite ground truth and the
              JAX CLI's keys, s a family
 40 roofline  cli/roofline on bench.py's flagship, f32 and bf16, 3 blocks
              of 2 steps: steps/s, matmul GFLOP a step (FlopCounterMode),
              sustained TFLOP/s, 0 < MFU against the H100's bf16 peak < 1
 41 tools     cli/solution_viz on a copy of p30k_f32_s1 twice, the second
              reading its 3 ground truths from gt_cache_torch/; the figure
              where matplotlib is installed, else its name is None
 42 leap_family_parity  one LEAP outer step from ldb3_2's
              checkpoint_step_40000 and from lde2_3's best checkpoint, each
              with its Adam state, from sbi10_2's params (steady Burgers,
              5x64, 1024 points) and a fresh poisson3d init (5x128), each
              with a fresh Adam state, at full width and points (bsize 2,
              10 inner steps: cuts in `reduced`), on the card and on the CPU
              on shared host draws: params within 1e-4 of each leaf's scale,
              meta-losses rtol 1e-3, the meta-gradient within 1e-1 of each
              leaf's largest entry and 1e-3 of its norm
 43 leap_burgers_train  pipeline/leap_meta.sh's TD-Burgers command through
              cli/leap_pde --from_run on a copy of ldb3_2, resumed from its
              checkpoint_step_40000 with its Adam state at full width and
              depth (10x128, 80 inner steps, bsize 8, 2048 points, 4 eval
              tasks, FV ground truth at 512 x 201): 2 outer steps in one
              block and one validation through the kernel (one launch), the
              JAX run's metrics keys, 201 finite per-timestep errors,
              val_rel_err within 3x the JAX package's from the same
              checkpoint on the same eval tasks
              (tests/jax_leap_family_bar.py), the final checkpoint's keys;
              a resumed step that solves nothing; one timed and one profiled
              step (steps/s, launches, idle share, peak memory)
 44 leap_elasticity_train  the same for its hyperelasticity command on
              lde2_3 (20 inner steps, mirror-symmetric validation, the host
              ground truth at 32), resumed from its latest checkpoint
 45 nn_deploy_burgers  pipeline/deployment_burgers.sh's two commands through
              cli/sweep (nn_pde_maml from results_burgers_maml/tpu_run1 at
              8x64 with the MAML warm-up, nn_pde from
              results_burgers_leap/ldb3_1 at 10x128; 1024 points,
              validation every 5 steps against the FV ground truth at 512),
              cut to 100 of the 200 Adam steps and 2 of the 8 seeds (in
              `reduced`), the jobs of both commands at once: one launch per
              validation call,
              201 finite per-timestep errors in every row, the median over
              the seeds of the step-95 val_rel_err within 3x the JAX
              package's 8-seed median of 100-step runs from the same init
              (tests/jax_nn_sweep_bar.py; the committed runs' cross-init
              medians printed beside); then each command's step alone on
              the card
 46 nn_deploy_elasticity  the same for pipeline/deployment_elasticity.sh
              (tpu_run1 at 8x64, ground truth at 32, max_hole_size 1.0;
              lde1 at 10x128, ground truth at 48, 0.5; the task and its
              mirror in one launch a validation)
 47 solver_baseline_burgers  pipeline/baseline.sh's TD-Burgers command
              through cli/solver_baseline (FV reference at 512 in float64,
              8 tasks, 9 output times, resolutions 16 to 256), then the
              num_tsteps axis (5, 9, 33) at 64 on one task, also on the CPU:
              rel_mse falling with resolution, each within 1e-2 relative of
              the JAX package's on the same tasks
              (tests/jax_solver_sweep_bar.py), card vs CPU by sqrt(rel_mse)
              within 1e-5; the committed JAX sweeps printed beside
 48 solver_baseline_elasticity  the same for its hyperelasticity command
              (reference at 64; 1 task at 8, 16, 32 and the boundary_cap
              axis 8, 192 at 8: cuts in `reduced`), with the host solve's
              seconds and the card's evaluate_p1 milliseconds apart
 49 gt_convergence_steady  cli/gt_convergence on one steady Burgers task
              at 16, 24, 32 against its float64 reference at 48 (cuts in
              `reduced`), on the card and on the CPU, with the bars of 47;
              baselines/steady_burgers/gt_convergence.jsonl beside
Then a JSON line with every kernel's numbers (with the training and LEAP
paths' launches), one with the training numbers and the total seconds, and
last the ok line. A failed check raises: the exit code is then not 0. A
watchdog ends a hung run after WATCHDOG_S seconds with every thread's stack.
Needs a CUDA device; imports nothing of JAX or metapde_tpu. The phases that
run an entry point in processes of their own (cli/sweep's jobs, the CPU's
gt_convergence) start them in a session of their own (_spawn); the whole
session is killed when the phase ends, fails or times out, when the
watchdog fires, on SIGTERM and at exit, and so is every process below the
script, which is their subreaper (the launcher and cli/distributed_smoke
start ranks in sessions of their own), so it leaves no process behind.

    python3 chip_smoke.py PHASE [PHASE ...]

runs the device and build phases and then only the named phases (for
development; it prints no kernel line and no ok line).
"""

import atexit
import contextlib
import ctypes
import faulthandler
import io
import json
import math
import os
import shlex
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from metapde_tpu_torch.cli import (deploy_bench, gt_convergence, leap_pde, maml_pde, nn_pde,
                                   pde_check, roofline, solution_viz, solver_baseline,
                                   train_bench)
from metapde_tpu_torch.cli.profile_deploy import _busy_us
from metapde_tpu_torch.config import Config, FieldConfig, load_run_config, parse_overrides
from metapde_tpu_torch.device import full_f32_matmuls
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.models import make_field
from metapde_tpu_torch.ops import _build, siren_fused
from metapde_tpu_torch.pdes import get_pde
from metapde_tpu_torch.pdes.burgers_formulations import default as burgers_default
from metapde_tpu_torch.solvers import fem_elasticity, fem_poisson, fv_burgers, multigrid, newton
from metapde_tpu_torch.train import (checkpoints, leap_driver, loop, maml_driver, nn_driver,
                                     optimizers, viz)
from metapde_tpu_torch.utils import spans, tb_writer
from metapde_tpu_torch.utils.trees import tree_leaves, tree_map

# the watchdog: well inside the 1200 s a caller may give the whole run
WATCHDOG_S = 1080
_CHILDREN = []
# _spawn'ed processes that a later phase still waits on: started early so
# that their CPU work runs beside the card's phases (_kill_children spares
# them until their phase has read them)
_AWAITED = []


def _spawn(cmd, **kwargs):
    """subprocess.Popen(cmd) in a session of its own, registered so that
    _kill_children ends it and every process it started."""
    proc = subprocess.Popen(cmd, start_new_session=True, **kwargs)
    _CHILDREN.append(proc)
    return proc


def _descendants(pid):
    """Every live process below `pid` (zombies left out), from /proc's
    parent links."""
    kids = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            with contextlib.suppress(OSError, IndexError, ValueError):
                state, ppid = Path(f"/proc/{d}/stat").read_text().rsplit(")", 1)[1].split()[:2]
                if state != "Z":
                    kids.setdefault(int(ppid), []).append(int(d))
    out, todo = [], [pid]
    while todo:
        for child in kids.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def _kill_children(keep=None):
    """SIGKILL every process below this one (the script is their
    subreaper, so the ranks that the launcher and cli/distributed_smoke
    start in sessions of their own stay below it when their parent dies)
    and the process group of every _spawn'ed process, and reap; `keep`
    (_AWAITED by default; () at exit, on the watchdog and on SIGTERM) are
    spared with what they started (orphans are then reaped at a later
    call)."""
    keep = tuple(_AWAITED) if keep is None else keep
    spared = {pid for proc in keep for pid in (proc.pid, *_descendants(proc.pid))}
    for pid in _descendants(os.getpid()):
        if pid not in spared:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.kill(pid, signal.SIGKILL)
    for proc in _CHILDREN:
        if proc in keep:
            continue
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(proc.pid, signal.SIGKILL)
        with contextlib.suppress(Exception):
            proc.wait(timeout=10)
    # orphans reparented to this subreaper (not while a kept process could
    # be reaped before its own wait reads its exit code)
    with contextlib.suppress(ChildProcessError):
        while not keep and os.waitpid(-1, os.WNOHANG)[0]:
            pass


def _on_timeout():
    sys.stderr.write(f"chip_smoke: watchdog at {WATCHDOG_S} s, every thread's stack:\n")
    faulthandler.dump_traceback(all_threads=True)
    _kill_children(keep=())
    os._exit(1)


def _on_sigterm(signum, frame):
    _kill_children(keep=())
    os._exit(128 + signum)


def _start_watchdog():
    """The Python watchdog (kills the children, then exits 1), and
    faulthandler's, a minute later, for a main thread that holds the
    interpreter's lock."""
    # PR_SET_CHILD_SUBREAPER: orphaned descendants stay below this process
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    timer = threading.Timer(WATCHDOG_S, _on_timeout)
    timer.daemon = True
    timer.start()
    faulthandler.dump_traceback_later(WATCHDOG_S + 60, exit=True)
    signal.signal(signal.SIGTERM, _on_sigterm)
    atexit.register(_kill_children, ())

REPO = Path(__file__).resolve().parent
RUN_DIR = REPO / "results_poisson_maml" / "p30k_f32_s1"
KERNEL_TOL = 1e-5  # the bar of tests/test_pallas_siren.py
# p30k_f32_s1's deployments run on 4 fresh tasks (8 before hyperelasticity: the
# ground truths were a fifth of the run)
P30K_N_EVAL = 4
# Median val_rel_err at k=5 from the JAX package's own deploy_bench on the
# CPU, same checkpoint, resolution, task count and k (command and output
# in PERF.md):
#   python -m metapde_tpu.cli.deploy_bench --algo=maml \
#     --train.load_model_from_expt=<copy of p30k_f32_s1> \
#     --model.use_pallas_inference=true --solver.ground_truth_resolution=16 \
#     --task.n_eval=4 --inner-steps-list=0,1,2,5 --checkpoint=best
JAX_CPU_K5_MEDIAN = 0.00026290814275853336
# the same command at the checkpoint's own resolution (multigrid):
#   ... --solver.ground_truth_resolution=32 (the rest as above)
JAX_CPU_K5_MEDIAN_RES32 = 0.00026380622875876725
# the resolution-32 multigrid solve on the card and on the CPU: one task
# (two before hyperelasticity), then one more solve of it under torch.profiler
GT_MG_TASKS = 1
K5_FACTOR = 3.0
# card against CPU on the same deployment: the two FEM solves stop at
# different iterates inside the Newton tolerance, and sums run in other orders
PARITY_RTOL = 1e-2
DEPLOY_KS = (0, 1, 2, 5)
# timed calls a value of k after its warm-up (deploy_bench --repeats): 1,
# cut from the CLI's 3 for the smoke's time (to 2, then to 1 to pay for the
# classical-solver phases); time_per_task_s is that call's
DEPLOY_REPEATS = 1
# card against CPU on the same training draws (TF32 off on the card)
TRAIN_LEAF_TOL = 1e-4   # of each leaf's scale, params and inner LRs
TRAIN_LOSS_RTOL = 1e-3  # meta-losses
JAX_CKPT = RUN_DIR / "checkpoint_step_30001.pickle"
TRAIN_CUTS = {"train.outer_steps": 30, "train.steps_per_call": 10, "train.val_every": 10,
              "train.checkpoint_every": 20, "task.n_eval": 2}
# the resumed pass: 3 steps one a loop iteration, iteration 1 traced
TRAIN_PROFILED = 3
# the solution plots' panels (train/viz.py) at p30k_f32_s1's width, card
# against CPU on the same inputs, of the panel's largest |value|
PANEL_TASKS = 3
PANEL_KS = (0, 5)
PANEL_RES = 16
PANEL_TOL = 1e-4
# bench.py's flagship in bf16, card against CPU: the bf16 rounding of the
# carried tensors flips single ulps where the two sums differ by 1e-7
BF16_LEAF_TOL = 1e-2
# the multigrid ground truth at resolution 32: each f32 solve (card, CPU)
# against the float64 solve of the same discrete problem (on the card, to a
# Newton tolerance far below f32's), within 3x the distance at which the JAX
# package's own f32 solve of the same task stops (of the grid's largest
# |value|). The f32 solves cannot be held to each other: the Newton target,
# rel_tol 5e-6 x |r0|, lies at the float32 floor of the residual (a field
# rounded to f32 has a float64 residual of 1.15e-4 to 1.26e-4 against the
# task's target 1.27e-4), so the acceptance admits fields up to ~2e-4
# apart; JAX's solve stops 1.836e-4 from the float64 solve and the port's
# CPU solves 2.6e-7 to 1.2e-6, so card and CPU once landed 4.8e-4 apart
# against the 1e-4 they were held to (PERF.md; tests/test_torch_gt_floor.py):
#   env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_gt_floor_bar.py
MG_RES = 32
JAX_MG_F32_DIST = 1.836e-4
MG_X64_TOL = 3.0 * JAX_MG_F32_DIST
MG_X64_REL_TOL = 1e-11
MG_X64_NEWTON = 40
MG_X64_KRYLOV_TOL = 1e-12
LEAP_RUN = REPO / "results_poisson_leap" / "lp2_4"
LEAP_CKPT = LEAP_RUN / "checkpoint_step_60000.pickle"
# lp2_4's deployments run on 4 fresh tasks (8 before hyperelasticity: their 8
# resolution-32 solves were most of the run's longest phase)
LEAP_N_EVAL = 4
# Median val_rel_err from the JAX package's deploy_bench on the CPU on a
# copy of lp2_4 (its config: 4096 inner and validation points, ground truth
# at resolution 32), at the largest k of each protocol (command and output
# in PERF.md):
#   python -m metapde_tpu.cli.deploy_bench --algo=leap --from_run=<copy of lp2_4> \
#     --model.use_pallas_inference=true --task.n_eval=4 --inner-steps-list=0,5,20,60
JAX_CPU_LEAP_K60_MEDIAN = 0.0006325524300336838
#   ... --deploy.optimizer=adam --inner-steps-list=0,50,200 (the rest as above)
JAX_CPU_LEAP_ADAM_K200_MEDIAN = 0.0006944101769477129
LEAP_KS = (0, 5, 20, 60)
LEAP_ADAM_KS = (0, 50, 200)
# what the bar command sets (lp2_4's own viz_every of 10,000 stands: LEAP
# ignores it, as the JAX LEAP driver does)
LEAP_OVERRIDES = {"model.use_pallas_inference": "true"}
LEAP_TRAIN_CUTS = {"train.outer_steps": 2, "train.steps_per_call": 2, "train.val_every": 2,
                   "train.checkpoint_every": 2, "task.n_eval": 1, "leap.inner_steps": 20}
# TD-Burgers: the committed MAML run (8x64) and LEAP run (10x128)
BURGERS_RUN = REPO / "results_burgers_maml" / "bm7_5"
BURGERS_CKPT = BURGERS_RUN / "checkpoint_step_500001.pickle"
LDB_RUN = REPO / "results_burgers_leap" / "ldb3_2"
LDB_CKPT = LDB_RUN / "checkpoint_step_40000.pickle"
# Median val_rel_err from the JAX package's deploy_bench on the CPU, on a
# copy of each run with its own config (FV ground truth at resolution 512,
# 201 output times), at the largest k (commands and output in PERF.md):
#   python -m metapde_tpu.cli.deploy_bench --algo=maml --from_run=<copy of bm7_5> \
#     --model.use_pallas_inference=true --task.n_eval=8 --inner-steps-list=0,1,2,5 \
#     --checkpoint=best
JAX_CPU_BURGERS_K5_MEDIAN = 0.0001788014778867364
#   python -m metapde_tpu.cli.deploy_bench --algo=leap --from_run=<copy of ldb3_2> \
#     --model.use_pallas_inference=true --task.n_eval=8 --inner-steps-list=0,5,20,80
JAX_CPU_LDB_K80_MEDIAN = 0.0027619556058198214
LDB_KS = (0, 5, 20, 80)
# card against CPU, of the grid's largest |u|: the FV scheme is elementwise
# with no reductions; the FEM stops inside its Newton tolerance
FV_TOL = 1e-5
FEM_TOL = 1e-4
# burgers_gt's FEM task: 6 output times (cut from 11), for the smoke's time
BURGERS_FEM_TSTEPS = 6
BURGERS_OVERRIDES = {"model.use_pallas_inference": "true"}
# resumed at bm7_5's step 500001: 10 more outer steps in blocks ending on
# multiples of 5 (3, 5, 2), validation at 500005 and 500010 on 2 eval tasks
BURGERS_TRAIN_CUTS = {"train.outer_steps": 500012, "train.steps_per_call": 5,
                      "train.val_every": 5, "train.log_every": 5, "task.n_eval": 2}
# Hyperelasticity: the committed MAML run (8x64) and LEAP run (10x128),
# two-output fields
EM_RUN = REPO / "results_elasticity_maml" / "em7_9"
EM_CKPT = EM_RUN / "checkpoint_step_500001.pickle"
LDE_RUN = REPO / "results_elasticity_leap" / "lde2_3"
# Median val_rel_err from the JAX package's deploy_bench on the CPU, on a
# copy of each run with its own config (the sparse-direct ground truth at
# resolution 32 raised by the ligament floor, the mirror-symmetric
# validation), at the largest k (commands and output in PERF.md):
#   python -m metapde_tpu.cli.deploy_bench --algo=maml --from_run=<copy of em7_9> \
#     --checkpoint=best --model.use_pallas_inference=true --task.n_eval=8 \
#     --inner-steps-list=0,1,2,5 --energy_audit
JAX_CPU_EM_K5_MEDIAN = 0.0021251493599265814
#   python -m metapde_tpu.cli.deploy_bench --algo=leap --from_run=<copy of lde2_3> \
#     --checkpoint=best --model.use_pallas_inference=true --task.n_eval=8 \
#     --inner-steps-list=0,5,20,40
JAX_CPU_LDE_K40_MEDIAN = 0.0021451401989907026
LDE_KS = (0, 5, 20, 40)
EM_OVERRIDES = {"model.use_pallas_inference": "true"}
# resumed at em7_9's step 500001: 6 more outer steps in blocks ending on
# multiples of 3 (2, 3, 1), validation at 500003 and 500006 on 2 eval tasks
EM_TRAIN_CUTS = {"train.outer_steps": 500008, "train.steps_per_call": 3,
                 "train.val_every": 3, "train.log_every": 3, "task.n_eval": 2}
# the solver's own acceptance of a converged state (fem_elasticity)
EM_GNORM_TOL = 1e-5
# the P1 interpolation, card against CPU, of the field's largest |value|
P1_TOL = 1e-6
# Steady Burgers: the committed MAML run (5x64, two outputs, 10 inner
# steps, ground truth at resolution 48)
SB_RUN = REPO / "results_sburgers_maml" / "sbi10_2"
SB_CKPT = SB_RUN / "checkpoint_step_100001.pickle"
SB_N_EVAL = 4
# k = 20 and 40 cut from the sweep, for the smoke's time
SB_KS = (0, 10, 80)
SB_ADAM_KS = (0, 50)
# Median val_rel_err from the JAX package's deploy_bench on the CPU, on a
# copy of sbi10_2 with its own config (FEM ground truth at resolution 48), 4
# tasks, at the largest k of each protocol (commands and output in PERF.md):
#   python -m metapde_tpu.cli.deploy_bench --algo=maml --from_run=<copy of sbi10_2> \
#     --checkpoint=best --model.use_pallas_inference=true --task.n_eval=4 \
#     --inner-steps-list=0,10,20,40,80
JAX_CPU_SB_K80_MEDIAN = 0.005983772687613964
#   ... --deploy.optimizer=adam --inner-steps-list=0,50 (the rest as above)
JAX_CPU_SB_ADAM_K50_MEDIAN = 0.010178269818425179
# card against CPU: the steady FEM solve (of the grid's largest |u|), and a
# 2-task deployment at k = 10 on shared ground truths (relative): ten
# learned-LR steps of the omega-30 chain carry f32 summation order into
# the metrics (1.83e-5 on one H100, PERF.md), above a bar of 1e-5
SB_GT_TOL = 1e-4
SB_PARITY_RTOL = 1e-4
SB_OVERRIDES = {"model.use_pallas_inference": "true"}
# resumed at sbi10_2's step 100001: 4 more outer steps in blocks of 2,
# validation at 100003 and 100005 on 2 eval tasks (resolution 48)
SB_TRAIN_CUTS = {"train.outer_steps": 100006, "train.steps_per_call": 2,
                 "train.val_every": 2, "train.log_every": 2, "task.n_eval": 2}
SB_TRAIN_BAR = 5e-2
# poisson3d: pipeline/maml_meta_3d.sh at its one-chip width (its lines 5-6:
# no task shards, bsize 16), validation against the exact solution
P3D_FLAGS = ["--task.pde=poisson3d", "--model.num_layers=5", "--model.layer_size=128",
             "--model.omega=30", "--model.omega0=30", "--maml.inner_steps=5",
             "--maml.inner_lr=1e-4", "--maml.outer_lr=1e-5", "--maml.inner_grad_clip=100",
             "--maml.grad_clip=100", "--maml.bsize=16", "--task.bc_weight=1.0",
             "--task.inner_points=2048", "--task.outer_points=2048",
             "--task.validation_points=2048", "--task.n_eval=8", "--train.optimizer=adam"]
P3D_TRAIN_CUTS = {"train.outer_steps": 4, "train.steps_per_call": 2, "train.val_every": 2,
                  "train.log_every": 2, "train.checkpoint_every": 4,
                  "model.use_pallas_inference": "true"}
P3D_TRAIN_BAR = 1e3  # tests/test_poisson3d.py:123-145
# pipeline/deployment_poisson.sh: its first command (nn_pde_maml from the
# MAML init tpu_run6b, 3x64) and its second (nn_pde from the LEAP init
# lp2_4, 5x64), their flags as the script passes them
MAML_INIT_RUN = REPO / "results_poisson_maml" / "tpu_run6b"
MAML_INIT_CKPT = MAML_INIT_RUN / "checkpoint_step_500001.pickle"
NN_COMMON = ["--task.pde=poisson", "--solver.ground_truth_resolution=32", "--model.omega=30",
             "--model.omega0=30", "--train.optimizer=adam", "--task.bc_weight=1.0",
             "--train.outer_steps=200", "--task.validation_points=1024",
             "--train.log_every=5", "--train.val_every=5", "--train.viz_every=0",
             "--train.checkpoint_every=0"]
NN_MAML_FLAGS = NN_COMMON + ["--model.num_layers=3", "--model.layer_size=64",
                             "--maml.outer_lr=1e-5", "--maml.grad_clip=100",
                             "--maml.inner_steps=5", "--maml.inner_lr=1e-4",
                             "--task.outer_points=1024"]
NN_LEAP_FLAGS = NN_COMMON + ["--model.num_layers=5", "--model.layer_size=64",
                             "--maml.outer_lr=2.5e-5", "--task.outer_points=512"]
# the script's 8 seeds, cut to 4, then to 2 to pay for the classical-solver
# phases; their jobs all at once
NN_SEEDS = (1, 2)
NN_FACTOR = 3.0
# Median over the 8 seeds of val_rel_err at steps 0, 100 and 195 and of
# each seed's best, from the JAX package's runs of the two commands,
# results_poisson_deploy/deploy_maml_seed_{1..8}/metrics.jsonl and
# results_poisson_deploy/deploy_leap_seed_{1..8}/metrics.jsonl
JAX_NN_MAML = {"step_0": 0.8098624646663666, "step_100": 0.006778831128031015,
               "step_195": 0.0007333587855100632, "best": 0.0004312469682190567}
JAX_NN_LEAP = {"step_0": 0.45151934027671814, "step_100": 0.0008246789511758834,
               "step_195": 0.0008094840741250664, "best": 0.0006973171985009685}
NN_PARITY_STEPS = 5
NN_MS_CUTS = {"deploy.n_starts": 3, "deploy.jitter": 0.05, "train.outer_steps": 10}
# rel_mse of the JAX package's sweep on the same BASELINE_N_EVAL tasks and
# coords (the port's host draw) against its float64 reference at 32, on a
# CPU: env JAX_PLATFORMS=cpu python tests/jax_solver_sweep_bar.py (output
# in PERF.md). The port's sweep is held to it within 10x either way.
JAX_SAME_TASKS_REL_MSE = {4: 2.5967916313398074e-05, 8: 2.6280354278605e-06,
                          16: 1.5730399460911436e-07}
# the JAX package's committed pipeline/baseline.sh sweep (16 other tasks,
# reference at 64): its means are carried by a few hard tasks (std above
# the mean), so the port's 4 tasks are set beside it, not held to it
BASELINE_JSON = REPO / "baselines" / "poisson" / "errors_by_resolution.json"
BASELINE_REF = 32
BASELINE_RESOLUTIONS = (4, 8, 16)
BASELINE_N_EVAL = 4
BASELINE_FACTOR = 10.0
# card against CPU, one task at resolutions 4 and 8 against a reference at
# 16: the RMS relative errors (sqrt of rel_mse) within 1e-5 of each other.
# rel_mse itself is ill-posed card against CPU: at 8 the Jacobi BiCGStab of
# both packages stops at its 200-iteration cap in the last Newton steps,
# leaving fields ~1e-6 (of the grid's max) apart, and rel_mse (2.8e-7 here)
# moves by 2 x that over its square root, 5.3e-4: a relative 4e-3, above
# the 1e-3 relative bar it was once held to (PERF.md;
# tests/test_torch_gt_floor.py). The square roots differ by at most the
# fields' distance over the reference's RMS: 1e-5 is 10x the largest
# measured (9.8e-7)
BASELINE_PARITY_REF = 16
BASELINE_PARITY_RESOLUTIONS = (4, 8)
BASELINE_PARITY_RMS_TOL = 1e-5
BASELINE_CONV_ARGS = ["--task.pde=poisson", f"--ref_resolution={BASELINE_PARITY_REF}",
                      "--resolutions=" + ",".join(map(str, BASELINE_PARITY_RESOLUTIONS)),
                      "--n_tasks=1"]
# H100 SXM published peaks (dense, at the 700 W limit): TF32 on the tensor
# cores, f32 outside them, and HBM bandwidth. The SFU returns 16 sines per
# clock per SM where the CUDA cores do 128 f32 FMAs (2 flops each): the CUDA
# C++ programming guide's throughput table for compute capability 9.0.
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_SFU_OPS = PEAK_F32_FLOPS * 16 / 256
PEAK_HBM_BYTES = 3.35e12

T_START = time.perf_counter()


def emit(phase, t0, **numbers):
    print(json.dumps({"phase": phase, "s": time.perf_counter() - t0, **numbers}),
          flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel="siren_fused_kernel", reps=20, warmup=3, tries=2):
    """Median device time in ms of the kernel named `kernel` per call of fn,
    from torch.profiler's CUDA kernel events (launch gaps excluded); None
    when the profiler records no such kernel in `tries` traces (a trace
    of the card now and then comes back without its kernel events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        if times:
            return statistics.median(times) / 1e3
    return None


def _siren_bytes_ms(cfg, n, weight_sets):
    """x, every weight set and out, each once, over HBM bandwidth."""
    h, L = cfg.layer_size, cfg.num_layers
    n_params = (cfg.in_dim * h + (L - 1) * h * h + h * cfg.out_dim
                + L * h + cfg.out_dim + cfg.in_dim + cfg.out_dim)
    return 1e3 * 4.0 * (n * (cfg.in_dim + cfg.out_dim) + weight_sets * n_params) / PEAK_HBM_BYTES


def siren_bound_f32_ms(cfg, n, weight_sets=1):
    """Least time for the fused chain on n points in all with every
    multiply-add as an f32 FMA on the CUDA cores (the bound of the earlier
    rows, kept so that rows compare across designs), against the bytes."""
    h, L = cfg.layer_size, cfg.num_layers
    macs = cfg.in_dim * h + (L - 1) * h * h + h * cfg.out_dim
    t_ops = 1e3 * 2.0 * macs * n / PEAK_F32_FLOPS
    t_bytes = _siren_bytes_ms(cfg, n, weight_sets)
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def siren_bound_ms(cfg, n, weight_sets=1):
    """Least time for this kernel's design on n points in all: the larger of
    the bytes and the slowest of the three pipes the work runs on, each at
    its peak and all at once: the hidden x hidden layers as three TF32
    tensor-core products (3xTF32), the first and output layers as f32 FMAs,
    one SFU sine per hidden unit. Returns (ms, bound_by, {pipe: ms})."""
    h, L = cfg.layer_size, cfg.num_layers
    parts = {
        "tensor_ms": 1e3 * 3 * 2.0 * (L - 1) * h * h * n / PEAK_TF32_FLOPS,
        "fma_ms": 1e3 * 2.0 * (cfg.in_dim * h + h * cfg.out_dim) * n / PEAK_F32_FLOPS,
        "sfu_ms": 1e3 * L * h * n / PEAK_SFU_OPS,
        "bytes_ms": _siren_bytes_ms(cfg, n, weight_sets),
    }
    t_ops = max(parts["tensor_ms"], parts["fma_ms"], parts["sfu_ms"])
    by = "operations" if t_ops >= parts["bytes_ms"] else "bytes"
    return max(t_ops, parts["bytes_ms"]), by, parts


def phase_device():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(smi, flush=True)
    emit("device", t0, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi)


def phase_build():
    t0 = time.perf_counter()
    res = _build.build("siren_fused")
    emit("build", t0, library=str(res.path.relative_to(REPO)), cached=res.cached,
         nvcc_s=res.seconds, nvcc_flags=" ".join(_build.NVCC_FLAGS),
         ptxas=[l.strip() for l in res.log.splitlines() if l.strip()])


KERNEL_CASES = [  # (name, FieldConfig overrides, tasks, points, weights)
    ("default", {}, 1, 1500, "one"),
    ("no_log_scale", dict(log_scale=False), 1, 1500, "one"),
    ("out_dim_2", dict(out_dim=2, squeeze_scalar=False), 1, 1500, "one"),
    ("8_layers", dict(num_layers=8), 1, 1500, "one"),
    # one eval task's validation points: also the plain-PINN fine-tune's
    # validation from tpu_run6b (nn_deploy_maml, 3x64, one weight set)
    ("main_path", {}, 1, 1024, "one"),
    ("main_path_2pow20", {}, 1, 1 << 20, "one"),
    # p30k_f32_s1's deployment: P30K_N_EVAL tasks x 1024 validation points
    ("main_path_batched", {}, P30K_N_EVAL, 1024, "per_task"),  # at k >= 1
    ("main_path_shared", {}, P30K_N_EVAL, 1024, "shared"),     # at k = 0
    ("wide_deep", dict(num_layers=8, layer_size=128), 1, 1500, "one"),
    ("ragged", {}, 3, 1000, "per_task"),
    # more items than blocks: a block walks several (task, tile) items and
    # crosses task boundaries (reloading resident weights; streaming the
    # next item's first layer while the last one computes)
    ("tasks_cross", {}, 8, 1 << 14, "per_task"),
    ("wide_deep_tasks", dict(num_layers=8, layer_size=128), 3, 1 << 15, "per_task"),
    # LEAP's validation: LEAP_N_EVAL tasks x 4096 points at lp2_4's 5x64,
    # adapted weights (the smoke's leap_deploy)
    ("leap_path", dict(num_layers=5), LEAP_N_EVAL, 4096, "per_task"),
    # TD-Burgers deployment: 8 tasks x 1008 points (1024 // 63 * 63, not a
    # multiple of the 64-point tile), bm7_5's 8x64 and ldb3_2's 10x128
    # (weights streamed: they exceed shared memory)
    ("burgers_path", dict(num_layers=8), 8, 1008, "per_task"),
    ("ldb3_path", dict(num_layers=10, layer_size=128), 8, 1008, "per_task"),
    # hyperelasticity's validation: 8 tasks and their mirrors (16 "tasks")
    # x 1024 points, two outputs, em7_9's 8x64 (resident) and lde2_3's
    # 10x128 (streamed)
    ("em7_9_path", dict(num_layers=8, out_dim=2, squeeze_scalar=False), 16, 1024,
     "per_task"),
    ("lde2_3_path", dict(num_layers=10, layer_size=128, out_dim=2, squeeze_scalar=False), 16,
     1024, "per_task"),
    # steady Burgers' validation: SB_N_EVAL tasks x 1024 points, two
    # outputs, sbi10_2's 5x64 (resident)
    ("sburgers_path", dict(num_layers=5, out_dim=2, squeeze_scalar=False), SB_N_EVAL, 1024,
     "per_task"),
    # poisson3d's validation: 8 tasks x 2048 points at in_dim 3, the
    # pipeline's 5x128 (streamed)
    ("poisson3d_path", dict(num_layers=5, layer_size=128, in_dim=3), 8, 2048, "per_task"),
    # the plain-PINN fine-tune's validation from lp2_4 (nn_deploy_leap):
    # one task x 1024 points at 5x64, one weight set
    ("nn_leap_path", dict(num_layers=5), 1, 1024, "one"),
    # LEAP training's validation of ldb3_2 (its 4 eval tasks x 1008 points,
    # 1024 cut to a multiple of the 63 time slices, at 10x128, streamed) and
    # of lde2_3 (4 tasks and their mirrors x 1024, two outputs)
    ("ldb3_2_train_path", dict(num_layers=10, layer_size=128), 4, 1008, "per_task"),
    ("lde2_3_train_path", dict(num_layers=10, layer_size=128, out_dim=2, squeeze_scalar=False),
     8, 1024, "per_task"),
    # the plain-PINN sweeps' validation, one model: Burgers' one task x 1008
    # at tpu_run1's 8x64 and ldb3_1's 10x128; hyperelasticity's task and its
    # mirror x 1024, two outputs, at tpu_run1's 8x64 and lde1's 10x128
    ("nn_burgers_maml_path", dict(num_layers=8), 1, 1008, "shared"),
    ("nn_burgers_leap_path", dict(num_layers=10, layer_size=128), 1, 1008, "shared"),
    ("nn_elasticity_maml_path", dict(num_layers=8, out_dim=2, squeeze_scalar=False), 2, 1024,
     "shared"),
    ("nn_elasticity_leap_path", dict(num_layers=10, layer_size=128, out_dim=2,
                                     squeeze_scalar=False), 2, 1024, "shared"),
]
# the cases of the slice's new paths (PR 15): their rows in the kernels line
FAMILY_CASES = ("ldb3_2_train_path", "lde2_3_train_path", "nn_burgers_maml_path",
                "nn_burgers_leap_path", "nn_elasticity_maml_path", "nn_elasticity_leap_path")
CROSSING = ("tasks_cross", "wide_deep_tasks")
TIMED = ("main_path", "main_path_2pow20", "main_path_batched", "main_path_shared",
         "tasks_cross", "leap_path", "burgers_path", "ldb3_path", "em7_9_path", "lde2_3_path",
         "sburgers_path", "poisson3d_path", "nn_leap_path", *FAMILY_CASES)
# csrc/siren_fused.cu: points per (task, tile) item, and the most blocks of
# its 256 threads an SM holds (2048 threads), so the most its persistent
# grid can have per SM
KERNEL_TILE = 64
MAX_BLOCKS_PER_SM = 8


def _case_inputs(cfg, n_tasks, n, weights, seed):
    """Params (stacked over tasks for "per_task", with biases and log scales
    moved so that no two tasks share a leaf) and points, from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    field = make_field(cfg)
    if weights == "per_task":
        sets = [field.init(gen, "cuda") for _ in range(n_tasks)]
        params = tree_map(lambda *p: torch.stack(p), *sets)
        params = tree_map(lambda t: t if t.ndim == 3 else t + 0.1 * torch.randn(
            t.shape, device="cuda", generator=gen), params)
    else:
        params = field.init(gen, "cuda")
    shape = (n, cfg.in_dim) if weights == "one" else (n_tasks, n, cfg.in_dim)
    x = torch.empty(shape, device="cuda").uniform_(-1.0, 1.0, generator=gen)
    return params, x


def phase_kernel():
    t0 = time.perf_counter()
    with full_f32_matmuls():  # the plain version's products in f32
        results = _kernel_cases()
    emit("kernel", t0, name="siren_fused", tol=KERNEL_TOL, cases=results)
    return results


def _kernel_cases():
    base = dict(num_layers=3, layer_size=64, in_dim=2)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for i, (name, kw, n_tasks, n, weights) in enumerate(KERNEL_CASES):
        cfg = FieldConfig(**{**base, **kw})
        params, x = _case_inputs(cfg, n_tasks, n, weights, 1000 + i)
        shared = weights == "shared"
        if weights == "one":
            wrapper = lambda: siren_fused.siren_apply_fused(params, x, cfg)
            plain = lambda: siren_fused.siren_apply_fused_reference(params, x, cfg)
        else:
            wrapper = lambda: siren_fused.siren_apply_fused_batched(params, x, cfg, shared)
            plain = lambda: siren_fused.siren_apply_fused_batched_reference(
                params, x, cfg, shared)
        out = wrapper()
        torch.cuda.synchronize()
        ref = plain()
        if out.shape != ref.shape:
            raise AssertionError(f"{name}: kernel shape {tuple(out.shape)} "
                                 f"!= plain {tuple(ref.shape)}")
        err = float((out - ref).abs().max())
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain max|diff| {err} > {KERNEL_TOL}")
        row = {"tasks": n_tasks, "n": n, "weights": weights, "max_abs_err": err}
        if name in CROSSING:
            row["items"] = n_tasks * -(-n // KERNEL_TILE)
            if not row["items"] > MAX_BLOCKS_PER_SM * n_sm:
                raise AssertionError(f"{name}: {row['items']} items could each have a block")
        if name in TIMED:
            x3 = x if x.ndim == 3 else x[None]
            dims = siren_fused.layer_dims(params, x3, cfg, weights != "per_task")
            packed = siren_fused.pack(params, cfg, n_tasks, weights != "per_task", dims)
            row["ms"] = cuda_ms(lambda: siren_fused.launch(packed, x3, cfg.omega))
            row["device_ms"] = device_ms(lambda: siren_fused.launch(packed, x3, cfg.omega))
            row["wrapper_ms"] = cuda_ms(wrapper)
            row["plain_ms"] = cuda_ms(plain)
            sets = n_tasks if weights == "per_task" else 1
            row["bound_ms"], row["bound_by"], row["bound_parts"] = siren_bound_ms(
                cfg, n_tasks * n, sets)
            row["bound_f32_ms"], _ = siren_bound_f32_ms(cfg, n_tasks * n, sets)
            row["sin_per_point"] = cfg.num_layers * cfg.layer_size
            row.update(siren_fused.launch_plan(dims, x.device)._asdict())
        results[name] = row
    return results


def _run_copy(tmp, run, files):
    """A copy of `files` of the run dir `run` under `tmp`: the CLIs write
    into a run dir, so nothing is written into the repository."""
    run_dir = Path(tmp) / run.name
    run_dir.mkdir(exist_ok=True)
    for f in files:
        shutil.copy(run / f, run_dir / f)
    return run_dir


def _deploy(tmp, args):
    """deploy_bench.main on a copy of the run dir under `tmp`."""
    run_dir = _run_copy(tmp, RUN_DIR, ("checkpoint_best.pickle", "config.json"))
    return deploy_bench.main(["--algo=maml", f"--train.load_model_from_expt={run_dir}",
                              "--model.use_pallas_inference=true",
                              "--checkpoint=best", *args])


def _deploy_parity(name, t0, gpu, cpu, rtol):
    """Card rows against CPU rows of the same deployment: every metric
    within `rtol` relative, or an error naming each one beyond it."""
    rels = [(g["inner_steps"], key, g[key], c[key], abs(g[key] - c[key]) / abs(c[key]))
            for g, c in zip(gpu, cpu)
            for key in ("val_mse", "val_rel_err", "val_rel_err_median", "self_loss_mean")]
    bad = [r for r in rels if not r[4] <= rtol]
    if bad:
        raise AssertionError(f"{name}: card vs cpu (k, metric, card, cpu, rel) beyond "
                             f"{rtol}: {bad}")
    emit(name, t0, rtol=rtol, worst_rel_diff=max(r[4] for r in rels),
         card={r["inner_steps"]: r["val_rel_err_median"] for r in gpu},
         cpu={r["inner_steps"]: r["val_rel_err_median"] for r in cpu})


def phase_parity():
    """The same small deployment (2 tasks, FEM at resolution 8, k = 0 and 5)
    on the card and on the CPU: the tasks and points are drawn on the host,
    so both sides see the same inputs. The CPU side is the port's plain
    path, which tests/test_torch_deploy.py holds against the JAX package."""
    t0 = time.perf_counter()
    args = ["--solver.ground_truth_resolution=8", "--task.n_eval=2",
            "--task.validation_points=256", "--inner-steps-list=0,5", "--repeats=1"]
    with tempfile.TemporaryDirectory() as tmp:
        gpu = _deploy(tmp, args)
        cpu = _deploy(tmp, ["--device=cpu", *args])
    _deploy_parity("parity", t0, gpu, cpu, PARITY_RTOL)


def _deploy_checked(tmp, name, deploy, ks, jax_median, n_eval=8, **numbers):
    """deploy() (cli/deploy_bench on n_eval fresh tasks, a run dir and its
    gt_cache_torch/ under `tmp`) with the launches counted from 0 over the
    run, held to the phase's bars at the largest k: one launch per
    validation call, n_eval cached ground truths, finite values, below k = 0 and
    within K5_FACTOR of the JAX package's CPU median. Returns (launches,
    the median val_rel_err for each k)."""
    t0 = time.perf_counter()
    launches0 = spans.counter("siren_fused.launches")
    rows = deploy()
    torch.cuda.synchronize()
    launches = spans.counter("siren_fused.launches") - launches0
    cached = sorted(p.name for p in (Path(tmp) / "gt_cache_torch").glob("*.npz"))
    # one launch per validation call: a warm-up and the timed repeats per k
    expected = len(ks) * (1 + DEPLOY_REPEATS)
    if launches != expected:
        raise AssertionError(f"{name} launched the siren_fused kernel {launches} times, "
                             f"expected {expected}")
    if len(cached) != n_eval:
        raise AssertionError(f"{len(cached)} ground truths in gt_cache_torch, "
                             f"expected {n_eval}")
    for r in rows:
        bad = [k for k, v in r.items() if not all(
            math.isfinite(x) for x in (v if isinstance(v, list) else [v])
            if isinstance(x, float))]
        if bad:
            raise AssertionError(f"{name} k={r['inner_steps']}: non-finite {bad}")
    med = {r["inner_steps"]: r["val_rel_err_median"] for r in rows}
    if sorted(med) != list(ks):
        raise AssertionError(f"{name} rows for k={sorted(med)}, expected {ks}")
    top = ks[-1]
    if not med[top] < med[0]:
        raise AssertionError(f"{name}: k={top} median rel err {med[top]} not below k=0 {med[0]}")
    if not med[top] <= K5_FACTOR * jax_median:
        raise AssertionError(f"{name}: k={top} median rel err {med[top]} above {K5_FACTOR} x "
                             f"the JAX CPU median {jax_median}")
    numbers.setdefault("reduced", {})["deploy_bench --repeats"] = f"3 -> {DEPLOY_REPEATS}"
    emit(name, t0, launches=launches, median_rel_err=med, jax_cpu_median={top: jax_median},
         time_per_task_s={r["inner_steps"]: r["time_per_task_s"] for r in rows},
         self_loss_median={r["inner_steps"]: r["self_loss_median"] for r in rows}, **numbers)
    return launches, med


def _maml_deploy_checked(tmp, name, resolution, jax_median, extra=()):
    """p30k_f32_s1's best checkpoint at k = 0, 1, 2, 5, ground truth at
    `resolution`."""
    return _deploy_checked(
        tmp, name, lambda: _deploy(tmp, [
            f"--solver.ground_truth_resolution={resolution}", f"--task.n_eval={P30K_N_EVAL}",
            "--inner-steps-list=" + ",".join(map(str, DEPLOY_KS)),
            f"--repeats={DEPLOY_REPEATS}", *extra]),
        DEPLOY_KS, jax_median, n_eval=P30K_N_EVAL, resolution=resolution)


def phase_deploy():
    """The deployment at resolution 16 (Jacobi-BiCGStab ground truth)."""
    with tempfile.TemporaryDirectory() as tmp:
        return _maml_deploy_checked(tmp, "deploy", 16, JAX_CPU_K5_MEDIAN)[0]


def phase_deploy_mg():
    """The deployment at the checkpoint's own resolution 32 (multigrid
    ground truth), then the same deployment with the bf16 chain
    (--model.compute_dtype=bfloat16) from the ground truths the first pass
    cached: it solves nothing, its validation still launches the f32 kernel
    once per call, and at k = 0 (the meta-learned init, no adaptation) it
    gives the f32 pass's errors."""
    with tempfile.TemporaryDirectory() as tmp:
        launches, med = _maml_deploy_checked(tmp, "deploy_mg", MG_RES,
                                             JAX_CPU_K5_MEDIAN_RES32)
        newton.newton_krylov.steps = 0
        bf16_launches, bf16_med = _maml_deploy_checked(
            tmp, "deploy_mg_bf16", MG_RES, JAX_CPU_K5_MEDIAN_RES32,
            ["--model.compute_dtype=bfloat16"])
    if newton.newton_krylov.steps:
        raise AssertionError(f"the bf16 pass ran {newton.newton_krylov.steps} Newton "
                             "steps: its ground truths were not read from the cache")
    k0_diff = abs(bf16_med[0] - med[0]) / med[0]
    if not k0_diff <= KERNEL_TOL:
        raise AssertionError(f"k=0 under bf16 {bf16_med[0]} vs f32 {med[0]} (rel {k0_diff} "
                             f"> {KERNEL_TOL}): bf16 validation left the f32 kernel")
    return launches, bf16_launches


def _timed(fn, device):
    """(fn(), its seconds between two barriers of `device`)."""
    loop.device_barrier(torch.device(device))
    t0 = time.perf_counter()
    out = fn()
    loop.device_barrier(torch.device(device))
    return out, time.perf_counter() - t0


def _solve_counted(solve, task, device):
    """solve(task on `device`): (ground truth, seconds, Newton steps,
    BiCGStab iterations)."""
    task = tuple(a.to(device) for a in task)
    newton.bicgstab.iterations, newton.newton_krylov.steps = 0, 0
    gt, secs = _timed(lambda: solve(task), device)
    return gt, secs, newton.newton_krylov.steps, newton.bicgstab.iterations


def _gt_mg_tasks():
    """The first GT_MG_TASKS eval tasks (host draws, deploy_bench's seed)."""
    pde = get_pde(Config().task)
    gen = torch.Generator().manual_seed(Config().seed + 7919)
    return [pde.sample_params(gen) for _ in range(GT_MG_TASKS)]


def _gt_mg_solve(task):
    return fem_poisson.solve(task, resolution=MG_RES)


def gt_mg_cpu_main(out):
    """ground_truth_mg's CPU side, in a process of its own (python -c):
    each task's solve on the CPU, its counts and seconds, and the threads,
    saved to `out`."""
    torch.save({"solves": [_solve_counted(_gt_mg_solve, task, "cpu")
                           for task in _gt_mg_tasks()],
                "threads": torch.get_num_threads()}, out)


_GT_MG_CPU = []


def _gt_mg_cpu():
    """ground_truth_mg's CPU process (started once, at the run's start in
    main, so that it solves beside the phases before it): (process, file)."""
    if not _GT_MG_CPU:
        out = Path(tempfile.mkdtemp(prefix="chip_smoke_mg_")) / "cpu.pt"
        atexit.register(shutil.rmtree, out.parent, True)
        # two threads: the solve at 32 is bound by its Python loop, and the
        # card's phases beside it by their host thread
        proc = _spawn([sys.executable, "-c", "import sys, chip_smoke; "
                       "chip_smoke.gt_mg_cpu_main(sys.argv[1])", str(out)], cwd=REPO,
                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                      env=dict(os.environ, OMP_NUM_THREADS="2"))
        _AWAITED.append(proc)
        _GT_MG_CPU.append((proc, out))
    return _GT_MG_CPU[0]


def phase_ground_truth_mg():
    """The first GT_MG_TASKS eval tasks (host draws, deploy_bench's seed)
    solved at resolution 32 with the multigrid preconditioner on the card
    and on the CPU (in a process of its own, started at the run's start),
    each held to the float64 solve on the card, then the card side's
    V-cycle, BiCGStab and profiled solve on a quiet host."""
    t0 = time.perf_counter()
    tasks = _gt_mg_tasks()
    proc, cpu_file = _gt_mg_cpu()
    rows = []
    card_solves = [_solve_counted(_gt_mg_solve, task, "cuda") for task in tasks]
    _awaited_output(proc, "ground_truth_mg")
    cpu_side = torch.load(cpu_file, weights_only=False)
    for task, (g, g_s, g_steps, g_iters), (c, c_s, c_steps, c_iters) in zip(
            tasks, card_solves, cpu_side["solves"]):
        ref, x_s, x_steps, x_iters = _solve_counted(
            lambda t: fem_poisson.solve_x64(t, resolution=MG_RES, rel_tol=MG_X64_REL_TOL,
                                            max_newton_steps=MG_X64_NEWTON,
                                            krylov_tol=MG_X64_KRYLOV_TOL), task, "cuda")
        ref = ref.u_grid.cpu()
        scale = float(ref.abs().max())
        card_err = float((g.u_grid.cpu().double() - ref).abs().max()) / scale
        cpu_err = float((c.u_grid.double() - ref).abs().max()) / scale
        rows.append({"card_s": g_s, "cpu_s": c_s, "newton_steps": g_steps,
                     "krylov_iters": g_iters, "krylov_per_newton": g_iters / max(g_steps, 1),
                     "cpu_newton_steps": c_steps, "cpu_krylov_iters": c_iters,
                     "cpu_threads": cpu_side["threads"],
                     "residual_norm": float(g.residual_norm),
                     "cpu_residual_norm": float(c.residual_norm),
                     "card_vs_x64": card_err, "cpu_vs_x64": cpu_err,
                     "card_vs_cpu": float((g.u_grid.cpu() - c.u_grid).abs().max()) / scale,
                     "x64_s": x_s, "x64_newton_steps": x_steps, "x64_krylov_iters": x_iters})
        if not (bool(torch.isfinite(g.u_grid).all()) and max(card_err, cpu_err) <= MG_X64_TOL):
            raise AssertionError(f"resolution-{MG_RES} u_grid: card {card_err}, CPU {cpu_err} "
                                 f"of the grid's max from the float64 solve (> {MG_X64_TOL}), "
                                 f"or not finite: {rows[-1]}")
    card_side = _ground_truth_mg_card(tasks)
    emit("ground_truth_mg", t0, resolution=MG_RES, tol=MG_X64_TOL,
         jax_f32_vs_x64=JAX_MG_F32_DIST, tasks=rows, **card_side)
    return {"s_per_task": statistics.mean(r["card_s"] for r in rows),
            "vcycle_launches": card_side["vcycle_launches"]}


def _ground_truth_mg_card(tasks):
    """ground_truth_mg's card side beyond the solves: one V-cycle (launches,
    time), BiCGStab graphed and eager, one profiled solve."""
    # one V-cycle: its kernel launches and its time
    geo = tasks[0][2].to("cuda")
    M = multigrid.make_polar_mg_preconditioner(geo, MG_RES, pre_sweeps=3, post_sweeps=3)
    n_nodes = 1 + 4 * MG_RES * 16 * MG_RES
    v = torch.randn(n_nodes, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    vcycle_ms = cuda_ms(lambda: M(v))
    vcycle_prof = _profile(lambda: M(v))
    # BiCGStab on the level-0 stiffness operator with the V-cycle, each
    # iteration one CUDA graph and eager: the same kernels, so the same
    # iterate and iteration count
    A = multigrid.polar_levels(geo, MG_RES)[0].apply
    krylov = {}
    for graphed in (True, False):
        newton.bicgstab.iterations = 0
        x, secs = _timed(lambda: newton.bicgstab(A, v, tol=1e-5, maxiter=150, M=M,
                                                 cuda_graph=graphed), "cuda")
        krylov[graphed] = (x, secs, newton.bicgstab.iterations)
    graph_diff = float((krylov[True][0] - krylov[False][0]).abs().max()
                       / krylov[False][0].abs().max())
    if krylov[True][2] != krylov[False][2] or not graph_diff <= KERNEL_TOL:
        raise AssertionError(f"graphed BiCGStab: {krylov[True][2]} iterations, rel diff "
                             f"{graph_diff} against eager's {krylov[False][2]}")
    newton.bicgstab.iterations = 0
    solve_prof = _profile(lambda: fem_poisson.solve(tuple(a.to("cuda") for a in tasks[-1]),
                                                    resolution=MG_RES))
    solve_prof["krylov_iters"] = newton.bicgstab.iterations
    return dict(vcycle_ms=vcycle_ms, vcycle_launches=vcycle_prof["launches"],
                vcycle_device_ms=vcycle_prof["device_busy_ms"],
                vcycle_wall_ms=vcycle_prof["wall_ms"],
                bicgstab_graph={"iterations": krylov[True][2], "graph_s": krylov[True][1],
                                "eager_s": krylov[False][1], "rel_diff": graph_diff,
                                "bit_equal": bool(torch.equal(krylov[True][0],
                                                              krylov[False][0]))},
                solve_profiled=solve_prof)


def _profile(fn):
    """fn() once under torch.profiler, tracing the card only (a solve makes
    hundreds of thousands of host ops): wall ms, device-busy ms (the union
    of the CUDA events), idle share and the count of device launches. The
    events are read from the profiler's raw results: building its Python
    event list takes ~1.5 ms a thousand events (75 s for an FV solve)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    busy_us = _busy_us((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                       for e in events)
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / wall_us, "launches": len(events)}


def _leaf_err(card_tree, cpu_tree):
    """The largest |card - cpu| over leaves, each over its leaf's scale."""
    worst = 0.0
    for a, b in zip(tree_leaves(card_tree), tree_leaves(cpu_tree)):
        scale = max(float(b.abs().max()), 1e-3)
        worst = max(worst, float((a.cpu() - b).abs().max()) / scale)
    return worst


def _train_both(cfg, steps, state, leaf_tol=TRAIN_LEAF_TOL):
    """`steps` outer steps of step_core on the card and on the CPU from the
    same start `state` (params, LRs, optimizer states, on the CPU), each on
    one host draw; returns per-step (leaf err, meta-loss rel diff) and the
    seconds of each side. Every step is taken before the bars are checked,
    so a failure reports every step."""
    cards = maml_driver.build(cfg, "cuda")
    cpus = maml_driver.build(cfg, "cpu")
    gen = torch.Generator().manual_seed(cfg.seed + 17)
    cpu_state = state
    card_state = tree_map(lambda t: t.to("cuda"), state)
    rows, t_card, t_cpu = [], 0.0, 0.0
    for step in range(steps):
        batch = cpus["draw_step_inputs"](gen)
        t0 = time.perf_counter()
        with full_f32_matmuls():
            out_card = cards["step_core"](tree_map(lambda t: t.to("cuda"), batch), *card_state)
            torch.cuda.synchronize()
        t_card += time.perf_counter() - t0
        t0 = time.perf_counter()
        out_cpu = cpus["step_core"](batch, *cpu_state)
        t_cpu += time.perf_counter() - t0
        card_state, cpu_state = out_card[:4], out_cpu[:4]
        ml_card, ml_cpu = out_card[5][0].cpu(), out_cpu[5][0]
        rows.append({
            "leaf_err": _leaf_err(card_state[:2], cpu_state[:2]),
            "param_leaf_err": _leaf_err(card_state[0], cpu_state[0]),
            "lr_leaf_err": _leaf_err(card_state[1], cpu_state[1]),
            "meta_loss_rel": float(((ml_card - ml_cpu).abs() / ml_cpu.abs()).max()),
            "grad_norm_rel": abs(float(out_card[6]) - float(out_cpu[6])) / float(out_cpu[6]),
            "meta_loss_mean": float(ml_cpu.mean())})
    for step, r in enumerate(rows):
        if not r["leaf_err"] <= leaf_tol:
            raise AssertionError(f"step {step}: params/LRs differ by {r['leaf_err']} of a "
                                 f"leaf's scale (> {leaf_tol}); every step: {rows}")
        if not r["meta_loss_rel"] <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"step {step}: meta-losses differ by rel {r['meta_loss_rel']} "
                                 f"(> {TRAIN_LOSS_RTOL}); every step: {rows}")
    return rows, t_card, t_cpu


def phase_train_parity():
    t0 = time.perf_counter()
    cfg = parse_overrides(Config(), [
        "--model.num_layers=2", "--model.layer_size=32", "--maml.bsize=4",
        "--maml.inner_steps=2", "--task.inner_points=128", "--task.outer_points=128"])
    c = maml_driver.build(cfg, "cpu")
    state = (c["init_params"], c["inner_lrs"], c["outer_opt"].init(c["init_params"]),
             c["lr_opt"].init(c["inner_lrs"]))
    rows, t_card, t_cpu = _train_both(cfg, 3, state)
    emit("train_parity", t0, leaf_tol=TRAIN_LEAF_TOL, loss_rtol=TRAIN_LOSS_RTOL, steps=rows,
         card_s=t_card, cpu_s=t_cpu)


def phase_train_parity_bf16():
    """Two outer steps of bench.py's flagship, bf16 as bench.py runs it
    (cut from 3)."""
    t0 = time.perf_counter()
    cfg = train_bench.FLAGSHIP
    c = maml_driver.build(cfg, "cpu")
    state = (c["init_params"], c["inner_lrs"], c["outer_opt"].init(c["init_params"]),
             c["lr_opt"].init(c["inner_lrs"]))
    rows, t_card, t_cpu = _train_both(cfg, 2, state, leaf_tol=BF16_LEAF_TOL)
    emit("train_parity_bf16", t0, leaf_tol=BF16_LEAF_TOL, loss_rtol=TRAIN_LOSS_RTOL,
         compute_dtype=cfg.model.compute_dtype, steps=rows, card_s=t_card, cpu_s=t_cpu,
         reduced={"outer steps": "3 -> 2"})


def phase_train_resume_jax():
    """One outer step from the JAX package's 30k checkpoint, optimizer
    states included, on both sides."""
    t0 = time.perf_counter()
    cfg = load_run_config(str(RUN_DIR))
    ck = checkpoints.load_checkpoint(str(JAX_CKPT))
    state = (params_from_numpy(ck["params"]), params_from_numpy(ck["inner_lrs"]),
             optimizers.from_jax_state(cfg.train.optimizer, ck["opt_state"]),
             optimizers.from_jax_state("adam", ck["lr_opt_state"]))
    rows, t_card, t_cpu = _train_both(cfg, 1, state)
    emit("train_resume_jax", t0, checkpoint=str(JAX_CKPT.relative_to(REPO)),
         step=int(ck["step"]), opt_count=int(state[2]["count"]), leaf_tol=TRAIN_LEAF_TOL,
         loss_rtol=TRAIN_LOSS_RTOL, steps=rows, card_s=t_card, cpu_s=t_cpu)


def _check_final_checkpoint(fname, ref_fname=JAX_CKPT, keys=("params", "inner_lrs")):
    """The JAX-read keys with the JAX checkpoint's types, dtypes and
    shapes, and none of the keys only the JAX package writes."""
    ours = checkpoints.load_checkpoint(str(fname))
    ref = checkpoints.load_checkpoint(str(ref_fname))
    bad = [k for k in checkpoints.JAX_ONLY_KEYS if k in ours]
    if bad:
        raise AssertionError(f"{fname.name} holds JAX-only keys {bad}")
    if type(ours["step"]) is not type(ref["step"]):
        raise AssertionError(f"step is {type(ours['step'])}, JAX writes {type(ref['step'])}")
    for key in keys:
        a, b = tree_leaves(ours[key]), tree_leaves(ref[key])
        if [(x.dtype, x.shape) for x in a] != [(y.dtype, y.shape) for y in b]:
            raise AssertionError(f"{key}: leaves differ from the JAX checkpoint's")
    return sorted(ours)


def _gt_log(run):
    """(solved, read) from run()'s ground-truth line in log.txt."""
    line = next(l for l in (run / "log.txt").read_text().splitlines()
                if l.startswith("ground truth"))
    words = line.split(": ", 1)[1].split()
    return int(words[0]), int(words[2])


def _check_tb_mirror(run, recs):
    """tb/'s event file parses with valid CRCs and holds one record per
    mirrored scalar per validation (numeric, not NaN, by the JAX rule) with
    metrics.jsonl's values in float32."""
    (events,) = (run / "tb").glob("events.out.tfevents.*")
    got = tb_writer.read_scalars(events)
    want = [(r["step"], k, v) for r in recs for k, v in r.items()
            if k not in ("step", "time") and isinstance(v, (int, float)) and v == v]
    if [(s, t) for s, t, _ in got] != [(s, t) for s, t, _ in want] or any(
            g != float(torch.tensor(float(w), dtype=torch.float32))
            for (_, _, g), (_, _, w) in zip(got, want)):
        raise AssertionError(f"tb/ holds {got}, metrics.jsonl {want}")
    return {"records": len(got), "tags": sorted({t for _, t, _ in got}),
            "bytes": events.stat().st_size}


def _check_trace(fname, log):
    """The profile_dir trace: written, one loop iteration traced (the
    span loop_iteration_1), CUDA kernels in it."""
    events = json.loads(fname.read_text())["traceEvents"]
    spans = sorted({e["name"] for e in events if e.get("name", "").startswith("loop_iteration_")})
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if spans != ["loop_iteration_1"] or kernels == 0 or "wrote profiler trace" not in \
            log.read_text():
        raise AssertionError(f"trace spans {spans}, {kernels} kernel events")
    return {"spans": spans, "kernel_events": kernels, "bytes": fname.stat().st_size}


def _check_panels():
    """train/viz.py's panel function at p30k_f32_s1's width on its best
    checkpoint: PANEL_TASKS tasks (ground truth at PANEL_RES on the card,
    the same values on the CPU) at k = 0 and 5 on the 64 x 64 grid, on the
    card and on the CPU on the same inputs: finite, and within PANEL_TOL of
    the panel's largest |value|."""
    cfg = parse_overrides(load_run_config(str(RUN_DIR)), [])
    state = checkpoints.load_checkpoint(str(RUN_DIR / "checkpoint_best.pickle"))
    gen = torch.Generator().manual_seed(cfg.seed + 7919)
    pde = get_pde(cfg.task)
    tasks = [pde.sample_params(gen) for _ in range(PANEL_TASKS)]
    gts = [pde.solve(tuple(a.to("cuda") for a in t), resolution=PANEL_RES) for t in tasks]
    dom = cfg.task.domain
    out, secs = {}, {}
    for device in ("cuda", "cpu"):
        c = maml_driver.build(cfg, device)
        model = (params_from_numpy(state["params"], device),
                 params_from_numpy(state["inner_lrs"], device))
        adapt = lambda i, p, k: c["get_final_model"](torch.Generator().manual_seed(0), model, p, k)
        (_, _, truth, values), secs[device] = _timed(lambda: viz.solution_panels(
            c["pde"], [type(g)(*(a.to(device) for a in g)) for g in gts],
            [tuple(a.to(device) for a in t) for t in tasks], adapt, c["field"].apply,
            inner_steps_list=PANEL_KS, n_tasks=PANEL_TASKS,
            bounds=(dom.xmin, dom.xmax, dom.ymin, dom.ymax)), device)
        out[device] = {"truth": truth.cpu(), **{k: v.cpu() for k, v in values.items()}}
    errs = {}
    for name, cpu in out["cpu"].items():
        card = out["cuda"][name]
        errs[str(name)] = float((card - cpu).abs().max() / cpu.abs().max())
        if not (bool(torch.isfinite(card).all()) and errs[str(name)] <= PANEL_TOL):
            raise AssertionError(f"panel {name}: card vs CPU {errs[str(name)]} of its max "
                                 f"(> {PANEL_TOL}), or not finite")
    return {"tasks": PANEL_TASKS, "ks": list(PANEL_KS), "grid": [64, 64],
            "ground_truth_resolution": PANEL_RES, "tol": PANEL_TOL, "card_vs_cpu": errs,
            "card_s": secs["cuda"], "cpu_s": secs["cpu"]}


def phase_train():
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        src = _run_copy(tmp, RUN_DIR, ("config.json",))
        out = Path(tmp) / "out"
        args = [f"--from_run={src}", *(f"--{k}={v}" for k, v in TRAIN_CUTS.items()),
                "--model.use_pallas_inference=true", f"--train.out_dir={out}"]
        launches0 = spans.counter("siren_fused.launches")
        maml_pde.main(args + ["--train.expt_name=smoke"])
        torch.cuda.synchronize()
        launches = spans.counter("siren_fused.launches") - launches0
        run = out / "smoke"
        for f in ("log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle",
                  f"checkpoint_step_{TRAIN_CUTS['train.outer_steps']}.pickle"):
            if not (run / f).exists():
                raise AssertionError(f"the training run wrote no {f}")
        recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
        keys = sorted(recs[0]) if recs else []
        jax_keys = sorted(json.loads((RUN_DIR / "metrics.jsonl").read_text()
                                     .splitlines()[0]))
        if keys != jax_keys:
            raise AssertionError(f"metrics.jsonl keys {keys} != the JAX run's {jax_keys}")
        n_val = TRAIN_CUTS["train.outer_steps"] // TRAIN_CUTS["train.val_every"]
        if len(recs) != n_val:
            raise AssertionError(f"{len(recs)} validation records, expected {n_val}")
        for r in recs:
            for k in ("meta_loss", "val_meta_loss", "val_rel_err", "val_mse"):
                if not math.isfinite(r[k]):
                    raise AssertionError(f"step {r['step']}: {k} = {r[k]}")
        if launches != len(recs):
            raise AssertionError(f"the training path launched siren_fused {launches} times "
                                 f"for {len(recs)} validation calls")
        ckpt_keys = _check_final_checkpoint(
            run / f"checkpoint_step_{TRAIN_CUTS['train.outer_steps']}.pickle")
        best = checkpoints.load_checkpoint(str(run / "checkpoint_best.pickle"))
        config = json.loads((run / "config.json").read_text())
        resolution = config["solver"]["ground_truth_resolution"]
        first = _gt_log(run)
        tb = _check_tb_mirror(run, recs)
        # a run() that resumes from it in the same out_dir, TRAIN_PROFILED
        # more steps one a call, the second traced (profile_dir): every
        # ground truth from gt_cache_torch/
        t1 = time.perf_counter()
        prof_dir = Path(tmp) / "prof"
        maml_pde.main(args + [
            "--train.expt_name=resumed", f"--train.load_model_from_expt={run}",
            f"--train.outer_steps={TRAIN_CUTS['train.outer_steps'] + TRAIN_PROFILED}",
            "--train.steps_per_call=1", f"--train.profile_dir={prof_dir}",
            "--train.profile_steps=1"])
        resumed_s = time.perf_counter() - t1
        resumed = _gt_log(out / "resumed")
        trace = _check_trace(prof_dir / "trace.json", out / "resumed" / "log.txt")
    panels = _check_panels()
    n_eval = TRAIN_CUTS["task.n_eval"]
    if resolution != 32 or first != (n_eval, 0) or resumed != (0, n_eval):
        raise AssertionError(f"ground truth at resolution {resolution}: (solved, read) "
                             f"{first} then {resumed} on resume")
    step_s = statistics.mean(r["step_time"] for r in recs[1:] or recs)
    emit("train", t0, reduced=TRAIN_CUTS, launches=launches, validations=len(recs),
         ground_truth_resolution=resolution, gt_solved_read=first,
         resumed_gt_solved_read=resumed, resumed_s=resumed_s,
         meta_loss=[r["meta_loss"] for r in recs],
         val_rel_err=[r["val_rel_err"] for r in recs],
         val_rel_err_median=[r["val_rel_err_median"] for r in recs],
         deployment_time=[r["deployment_time"] for r in recs],
         step_time=[r["step_time"] for r in recs], steps_per_s=1.0 / step_s,
         best_step=best["step"], checkpoint_keys=ckpt_keys, tb=tb, trace=trace,
         panels=panels)
    return {"launches": launches, "steps_per_s": 1.0 / step_s,
            "deployment_time": recs[-1]["deployment_time"],
            "val_rel_err": recs[-1]["val_rel_err"], "gt_solved_read": first,
            "resumed_gt_solved_read": resumed}


# 1 timed block of 2 outer steps (cut from 3, then 2, for the smoke's time)
# and one profiled block of 2
BENCH_CUTS = {"block": 2, "blocks": 1}
BENCH_KEYS = ("outer_steps_per_s", "residual_pt_evals_per_s", "draw_s_per_step",
              "device_busy_ms_per_step", "device_idle_share", "kernels_per_step",
              "max_memory_allocated_bytes", "bf16_gemm", "nvidia_smi", "config")


def phase_train_bench():
    """bench.py's flagship as bench.py runs it (bf16), then the f32 variant,
    with what the card's torch offers for bf16 GEMMs (bf16_gemm_support)."""
    t0 = time.perf_counter()
    # blocks of 2 steps: the profiled block's trace (~10,000 kernels and
    # ~60,000 host ops a step) takes longer to read than to run
    depth = [f"--{k}={v}" for k, v in BENCH_CUTS.items()]
    rows = {"bf16": train_bench.main(depth),
            "f32": train_bench.main(depth + ["--model.compute_dtype=null"])}
    emit("train_bench", t0, reduced=BENCH_CUTS,
         bf16_gemm_support=rows["bf16"]["bf16_gemm_support"],
         runs={k: {b: r[b] for b in BENCH_KEYS} for k, r in rows.items()})
    return rows


def _meta_grad_err(card_opt, cpu_opt, old_mu):
    """The meta-gradient each side's outer Adam took, recovered from its
    new first moment (mu = b1 mu_old + (1 - b1) g, b1 = 0.9): the largest
    |card - cpu| over each leaf's largest |g|, and over the tree's norm."""
    b1, worst, diff_sq, norm_sq = 0.9, 0.0, 0.0, 0.0
    for a, b, m in zip(tree_leaves(card_opt["mu"]), tree_leaves(cpu_opt["mu"]),
                       tree_leaves(old_mu)):
        m = m.cpu().double()
        g_card = (a.cpu().double() - b1 * m) / (1 - b1)
        g_cpu = (b.double() - b1 * m) / (1 - b1)
        worst = max(worst, float((g_card - g_cpu).abs().max() / g_cpu.abs().max()))
        diff_sq += float(((g_card - g_cpu) ** 2).sum())
        norm_sq += float((g_cpu ** 2).sum())
    return worst, math.sqrt(diff_sq / norm_sq)


def _leap_train_both(cfg, steps, state):
    """LEAP's _train_both: `steps` outer steps of step_core on the card and
    on the CPU from the same (params, optimizer state), on the same host
    draws; returns per-step rows and each side's seconds. Every step is
    taken before the bars are checked."""
    cards, cpus = leap_driver.build(cfg, "cuda"), leap_driver.build(cfg, "cpu")
    gen = torch.Generator().manual_seed(cfg.seed + 17)
    cpu_state, card_state = state, tree_map(lambda t: t.to("cuda"), state)
    rows, t_card, t_cpu = [], 0.0, 0.0
    for _ in range(steps):
        batch = cpus["draw_step_inputs"](gen)
        t0 = time.perf_counter()
        with full_f32_matmuls():
            out_card = cards["step_core"](tree_map(lambda t: t.to("cuda"), batch), *card_state)
            torch.cuda.synchronize()
        t_card += time.perf_counter() - t0
        t0 = time.perf_counter()
        out_cpu = cpus["step_core"](batch, *cpu_state)
        t_cpu += time.perf_counter() - t0
        grad_leaf, grad_tree = _meta_grad_err(out_card[1], out_cpu[1], cpu_state[1]["mu"])
        card_state, cpu_state = out_card[:2], out_cpu[:2]
        ml_card, ml_cpu = out_card[2][:, -1].cpu(), out_cpu[2][:, -1]
        rows.append({
            "meta_grad_leaf_err": grad_leaf, "meta_grad_tree_err": grad_tree,
            "param_leaf_err": _leaf_err(card_state[0], cpu_state[0]),
            "meta_loss_rel": float(((ml_card - ml_cpu).abs() / ml_cpu.abs()).max()),
            "losses_rel": float(((out_card[2].cpu() - out_cpu[2]).abs()
                                 / out_cpu[2].abs()).max()),
            "grad_norm_rel": abs(float(out_card[3]) - float(out_cpu[3])) / float(out_cpu[3]),
            "meta_loss_mean": float(ml_cpu.mean())})
    for step, r in enumerate(rows):
        if not r["param_leaf_err"] <= TRAIN_LEAF_TOL:
            raise AssertionError(f"step {step}: params differ by {r['param_leaf_err']} of a "
                                 f"leaf's scale (> {TRAIN_LEAF_TOL}); every step: {rows}")
        if not r["meta_loss_rel"] <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"step {step}: meta-losses differ by rel {r['meta_loss_rel']} "
                                 f"(> {TRAIN_LOSS_RTOL}); every step: {rows}")
    return rows, t_card, t_cpu


def phase_leap_parity():
    t0 = time.perf_counter()
    cfg = parse_overrides(Config(), [
        "--model.num_layers=2", "--model.layer_size=32", "--leap.bsize=4",
        "--leap.inner_steps=3", "--task.inner_points=128"])
    c = leap_driver.build(cfg, "cpu")
    state = (c["init_params"], c["outer_opt"].init(c["init_params"]))
    rows, t_card, t_cpu = _leap_train_both(cfg, 3, state)
    emit("leap_parity", t0, leaf_tol=TRAIN_LEAF_TOL, loss_rtol=TRAIN_LOSS_RTOL, steps=rows,
         card_s=t_card, cpu_s=t_cpu)


def phase_leap_resume_jax():
    """One outer step from lp2_4's JAX checkpoint with its Adam state, at
    its full width, on both sides."""
    t0 = time.perf_counter()
    cfg = load_run_config(str(LEAP_RUN))
    ck = checkpoints.load_checkpoint(str(LEAP_CKPT))
    state = (params_from_numpy(ck["params"]),
             optimizers.from_jax_state(cfg.train.optimizer, ck["opt_state"]))
    rows, t_card, t_cpu = _leap_train_both(cfg, 1, state)
    emit("leap_resume_jax", t0, checkpoint=str(LEAP_CKPT.relative_to(REPO)),
         step=int(ck["step"]), opt_count=int(state[1]["count"]),
         width=f"{cfg.model.num_layers}x{cfg.model.layer_size}", bsize=cfg.leap.bsize,
         inner_steps=cfg.leap.inner_steps, points=cfg.task.inner_points,
         leaf_tol=TRAIN_LEAF_TOL, loss_rtol=TRAIN_LOSS_RTOL, steps=rows, card_s=t_card,
         cpu_s=t_cpu)


def _leap_deploy_checked(tmp, name, ks, jax_median, extra=()):
    """cli/deploy_bench --algo=leap on a copy of lp2_4 under `tmp`, with its
    config (4096 inner and validation points, ground truth at resolution
    32)."""
    run_dir = _run_copy(tmp, LEAP_RUN, (LEAP_CKPT.name, "config.json"))
    overrides = [f"--{k}={v}" for k, v in LEAP_OVERRIDES.items()]
    cfg = parse_overrides(load_run_config(str(LEAP_RUN)), overrides)
    return _deploy_checked(
        tmp, name, lambda: deploy_bench.main([
            "--algo=leap", f"--from_run={run_dir}", *overrides,
            f"--task.n_eval={LEAP_N_EVAL}", "--inner-steps-list=" + ",".join(map(str, ks)),
            f"--repeats={DEPLOY_REPEATS}", *extra]),
        ks, jax_median, n_eval=LEAP_N_EVAL, resolution=cfg.solver.ground_truth_resolution,
        points=cfg.task.inner_points, overrides=LEAP_OVERRIDES)


def phase_leap_deploy():
    """LEAP's own rollout, then the optimizer protocol from the cached
    ground truths."""
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = _leap_deploy_checked(tmp, "leap_deploy", LEAP_KS, JAX_CPU_LEAP_K60_MEDIAN)
        newton.newton_krylov.steps = 0
        adam_launches, _ = _leap_deploy_checked(
            tmp, "leap_deploy_adam", LEAP_ADAM_KS, JAX_CPU_LEAP_ADAM_K200_MEDIAN,
            ["--deploy.optimizer=adam"])
    if newton.newton_krylov.steps:
        raise AssertionError(f"the adam pass ran {newton.newton_krylov.steps} Newton steps: "
                             "its ground truths were not read from the cache")
    return launches, adam_launches


def _step_numbers(cfg, c, state, read, timed=2):
    """`timed` unprofiled outer steps of the driver build `c` at cfg's width
    from `state` (step_core's state arguments; host draw timed apart), then
    one step under torch.profiler tracing the card. read(out) -> (the new
    state, the host read the training loop makes)."""
    gen = torch.Generator().manual_seed(cfg.seed + 23)
    torch.cuda.reset_peak_memory_stats()
    draw_s, step_s = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        batch = c["draw_step_inputs"](gen)
        t1 = time.perf_counter()
        state, host = read(c["step_core"](batch, *state))
        float(host)
        t2 = time.perf_counter()
        draw_s.append(t1 - t0)
        step_s.append(t2 - t0)
    peak = torch.cuda.max_memory_allocated()
    batch = c["draw_step_inputs"](gen)
    torch.cuda.synchronize()
    prof = _profile(lambda: c["step_core"](batch, *state))
    return {"outer_steps_per_s": 1.0 / statistics.mean(step_s),
            "step_s": step_s, "draw_s_per_step": statistics.mean(draw_s),
            "max_memory_allocated_bytes": peak,
            "profiled_step": {"launches": prof["launches"], "wall_ms": prof["wall_ms"],
                              "device_busy_ms": prof["device_busy_ms"],
                              "idle_share": prof["idle_share"]},
            "device_idle_share": 1.0 - prof["device_busy_ms"] / (
                1e3 * (statistics.mean(step_s) - statistics.mean(draw_s)))}


def phase_leap_train():
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        src = _run_copy(tmp, LEAP_RUN, ("config.json",))
        out = Path(tmp) / "out"
        cuts = {**LEAP_TRAIN_CUTS, **LEAP_OVERRIDES}
        args = [f"--from_run={src}", *(f"--{k}={v}" for k, v in cuts.items()),
                f"--train.out_dir={out}"]
        launches0 = spans.counter("siren_fused.launches")
        leap_pde.main(args + ["--train.expt_name=smoke"])
        torch.cuda.synchronize()
        launches = spans.counter("siren_fused.launches") - launches0
        run = out / "smoke"
        steps = LEAP_TRAIN_CUTS["train.outer_steps"]
        for f in ("log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle",
                  f"checkpoint_step_{steps}.pickle"):
            if not (run / f).exists():
                raise AssertionError(f"the LEAP training run wrote no {f}")
        recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
        jax_keys = sorted(json.loads((LEAP_RUN / "metrics.jsonl").read_text().splitlines()[0]))
        if not recs or sorted(recs[0]) != jax_keys:
            raise AssertionError(f"metrics.jsonl keys {sorted(recs[0]) if recs else []} != "
                                 f"the JAX run's {jax_keys}")
        n_val = steps // LEAP_TRAIN_CUTS["train.val_every"]
        if len(recs) != n_val:
            raise AssertionError(f"{len(recs)} validation records, expected {n_val}")
        for r in recs:
            for k in ("meta_loss", "val_meta_loss", "val_rel_err", "val_mse"):
                if not math.isfinite(r[k]):
                    raise AssertionError(f"step {r['step']}: {k} = {r[k]}")
        if launches != len(recs):
            raise AssertionError(f"the LEAP training path launched siren_fused {launches} "
                                 f"times for {len(recs)} validation calls")
        ckpt_keys = _check_final_checkpoint(run / f"checkpoint_step_{steps}.pickle",
                                            LEAP_CKPT, keys=("params",))
        config = json.loads((run / "config.json").read_text())
        resolution = config["solver"]["ground_truth_resolution"]
        first = _gt_log(run)
        t1 = time.perf_counter()
        leap_pde.main(args + ["--train.expt_name=resumed", f"--train.load_model_from_expt={run}",
                              f"--train.outer_steps={steps + 1}"])
        resumed_s = time.perf_counter() - t1
        resumed = _gt_log(out / "resumed")
        final = checkpoints.load_checkpoint(str(run / f"checkpoint_step_{steps}.pickle"))
    n_eval = LEAP_TRAIN_CUTS["task.n_eval"]
    if resolution != 32 or first != (n_eval, 0) or resumed != (0, n_eval):
        raise AssertionError(f"ground truth at resolution {resolution}: (solved, read) "
                             f"{first} then {resumed} on resume")
    cfg = parse_overrides(load_run_config(str(LEAP_RUN)),
                          [f"--leap.inner_steps={LEAP_TRAIN_CUTS['leap.inner_steps']}"])
    bench = _step_numbers(cfg, leap_driver.build(cfg, "cuda"),
                          (params_from_numpy(final["params"], "cuda"),
                           params_from_numpy(final["torch_opt_state"], "cuda", dtype=None)),
                          lambda out: (out[:2], out[2][:, -1].mean()))
    emit("leap_train", t0, reduced=cuts, launches=launches, validations=len(recs),
         ground_truth_resolution=resolution, gt_solved_read=first,
         resumed_gt_solved_read=resumed, resumed_s=resumed_s,
         meta_loss=[r["meta_loss"] for r in recs],
         val_rel_err=[r["val_rel_err"] for r in recs],
         val_rel_err_median=[r["val_rel_err_median"] for r in recs],
         deployment_time=[r["deployment_time"] for r in recs],
         step_time=[r["step_time"] for r in recs], checkpoint_keys=ckpt_keys, bench=bench)
    return {"launches": launches, **bench, "deployment_time": recs[-1]["deployment_time"],
            "val_rel_err": recs[-1]["val_rel_err"], "gt_solved_read": first,
            "resumed_gt_solved_read": resumed}


def _eval_tasks(run, n):
    """deploy_bench's eval tasks of `run`'s config (host draws from seed +
    7919), and its family."""
    cfg = load_run_config(str(run))
    pde = get_pde(cfg.task)
    gen = torch.Generator().manual_seed(cfg.seed + 7919)
    return cfg, pde, [pde.sample_params(gen) for _ in range(n)]


def phase_burgers_gt():
    """The FV ground truth of bm7_5's 8 deployment tasks (resolution 512,
    201 output times) in one batched solve on the card and on the CPU, one
    more under torch.profiler; then one FEM task (resolution 64, 11 output
    times) on both."""
    t0 = time.perf_counter()
    cfg, pde, tasks = _eval_tasks(BURGERS_RUN, 8)
    res = cfg.solver.ground_truth_resolution

    def solve(device):
        return pde.solve_batched([tuple(a.to(device) for a in t) for t in tasks],
                                 resolution=res)

    # the CUDA graph of an output segment against the eager loop, on the
    # card: the same kernels, so the same bits (at resolution 128, 1,600 RK
    # steps: the eager loop is host-bound)
    dom = cfg.task.domain
    kw = dict(resolution=128, num_tsteps=cfg.task.num_tsteps,
              max_reynolds=cfg.task.max_reynolds, ic_fn=burgers_default.ic_fn,
              xmin=dom.xmin, xmax=dom.xmax, tmax=dom.tmax)
    on_card = [tuple(a.to("cuda") for a in t) for t in tasks]
    graphed, graph_s = _timed(lambda: fv_burgers.solve_batched(on_card, **kw), "cuda")
    eager, eager_s = _timed(lambda: fv_burgers.solve_batched(on_card, cuda_graph=False, **kw),
                            "cuda")
    if not all(torch.equal(g.u_grid, e.u_grid) for g, e in zip(graphed, eager)):
        raise AssertionError("the CUDA graph's FV solve differs from the eager loop's")
    card, card_s = _timed(lambda: solve("cuda"), "cuda")
    cpu, cpu_s = _timed(lambda: solve("cpu"), "cpu")
    scale = max(float(c.u_grid.abs().max()) for c in cpu)
    err = max(float((g.u_grid.cpu() - c.u_grid).abs().max()) for g, c in zip(card, cpu)) / scale
    if not (all(bool(torch.isfinite(g.u_grid).all()) for g in card) and err <= FV_TOL):
        raise AssertionError(f"FV u_grids: card vs CPU {err} of the grid's max (> {FV_TOL}), "
                             "or not finite")
    steps, per_seg = fv_burgers.n_substeps(res, dom.xmax - dom.xmin, dom.tmax,
                                           cfg.task.max_reynolds, 0.4, 5.0, cfg.task.num_tsteps)
    prof = _profile(lambda: solve("cuda"))
    fem_cfg = parse_overrides(cfg, ["--task.burgers_gt_solver=fem",
                                    f"--task.num_tsteps={BURGERS_FEM_TSTEPS}"])
    fem_pde = get_pde(fem_cfg.task)
    fem = {device: _solve_counted(lambda t: fem_pde.solve(t, resolution=64), tasks[0], device)
           for device in ("cuda", "cpu")}
    fem_scale = float(fem["cpu"][0].u_grid.abs().max())
    fem_err = float((fem["cuda"][0].u_grid.cpu() - fem["cpu"][0].u_grid).abs().max()) / fem_scale
    if not (bool(torch.isfinite(fem["cuda"][0].u_grid).all()) and fem_err <= FEM_TOL):
        raise AssertionError(f"FEM u_grid: card vs CPU {fem_err} of the grid's max "
                             f"(> {FEM_TOL}), or not finite")
    out = {"tasks": len(tasks), "resolution": res, "num_tsteps": cfg.task.num_tsteps,
           "rk_steps": steps, "rk_steps_per_segment": per_seg, "tol": FV_TOL, "rel_err": err,
           "card_s": card_s, "card_s_per_task": card_s / len(tasks), "cpu_s": cpu_s,
           "graph_vs_eager_res128": {"equal": True, "graph_s": graph_s, "eager_s": eager_s},
           "kernels": prof["launches"], "kernels_per_rk_step": prof["launches"] / steps,
           "graph_replays": cfg.task.num_tsteps - 1,
           "device_busy_ms": prof["device_busy_ms"], "wall_ms": prof["wall_ms"],
           "idle_share": prof["idle_share"], "reynolds": float(tasks[0][0][0]),
           "fem": {"resolution": 64, "num_tsteps": BURGERS_FEM_TSTEPS, "tol": FEM_TOL,
                   "reduced": {"num_tsteps": f"11 -> {BURGERS_FEM_TSTEPS}"}, "rel_err": fem_err,
                   "card_s": fem["cuda"][1], "cpu_s": fem["cpu"][1],
                   "newton_steps": fem["cuda"][2], "krylov_iters": fem["cuda"][3],
                   "cpu_newton_steps": fem["cpu"][2], "cpu_krylov_iters": fem["cpu"][3]}}
    emit("burgers_gt", t0, **out)
    return out


def phase_burgers_parity():
    """A tiny MAML meta-training on bm7_5's task family (2 layers of 32,
    bsize 4, 2 inner steps, 128 points, 3 outer steps) on the card and on
    the CPU on the same host draws, TF32 off."""
    t0 = time.perf_counter()
    cfg = parse_overrides(load_run_config(str(BURGERS_RUN)), [
        "--model.num_layers=2", "--model.layer_size=32", "--maml.bsize=4",
        "--maml.inner_steps=2", "--task.inner_points=128", "--task.outer_points=128"])
    c = maml_driver.build(cfg, "cpu")
    state = (c["init_params"], c["inner_lrs"], c["outer_opt"].init(c["init_params"]),
             c["lr_opt"].init(c["inner_lrs"]))
    rows, t_card, t_cpu = _train_both(cfg, 3, state)
    emit("burgers_parity", t0, leaf_tol=TRAIN_LEAF_TOL, loss_rtol=TRAIN_LOSS_RTOL, steps=rows,
         card_s=t_card, cpu_s=t_cpu)


def _plan_of(run):
    """The kernel's launch plan at `run`'s width (num_layers hidden layers
    and the output layer of its family's out_dim)."""
    cfg = load_run_config(str(run))
    dims = (2, cfg.model.layer_size, cfg.model.num_layers, get_pde(cfg.task).out_dim)
    return siren_fused.launch_plan(dims, torch.device("cuda"))._asdict()


def phase_burgers_deploy():
    """cli/deploy_bench --algo=maml on a copy of bm7_5 with its config: its
    best checkpoint, 8 fresh tasks, k = 0, 1, 2, 5, FV ground truth at
    resolution 512 through gt_cache_torch/."""
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = _run_copy(tmp, BURGERS_RUN, ("checkpoint_best.pickle", "config.json"))
        return _deploy_checked(
            tmp, "burgers_deploy", lambda: deploy_bench.main([
                "--algo=maml", f"--from_run={run_dir}", "--model.use_pallas_inference=true",
                "--checkpoint=best", "--task.n_eval=8",
                "--inner-steps-list=" + ",".join(map(str, DEPLOY_KS)),
                f"--repeats={DEPLOY_REPEATS}"]),
            DEPLOY_KS, JAX_CPU_BURGERS_K5_MEDIAN, plan=_plan_of(BURGERS_RUN))[0]


def phase_leap_burgers_deploy():
    """cli/deploy_bench --algo=leap on a copy of ldb3_2 (10x128, 2048 inner
    and 1024 validation points, FV at resolution 512): k = 0, 5, 20, 80,
    every task in one batched rollout and one launch, the weights streamed."""
    plan = _plan_of(LDB_RUN)
    if plan["resident"]:
        raise AssertionError(f"ldb3_2's 10x128 weights planned resident: {plan}")
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = _run_copy(tmp, LDB_RUN, (LDB_CKPT.name, "config.json"))
        return _deploy_checked(
            tmp, "leap_burgers_deploy", lambda: deploy_bench.main([
                "--algo=leap", f"--from_run={run_dir}", "--model.use_pallas_inference=true",
                "--task.n_eval=8", "--inner-steps-list=" + ",".join(map(str, LDB_KS)),
                f"--repeats={DEPLOY_REPEATS}"]),
            LDB_KS, JAX_CPU_LDB_K80_MEDIAN, plan=plan)[0]


_BURGERS_OUT = []


def _burgers_out():
    """The out_dir of burgers_train's runs (and its gt_cache_torch/), which
    mesh_train's sharded bm7_5 run shares; removed when the process ends."""
    if not _BURGERS_OUT:
        _BURGERS_OUT.append(tempfile.TemporaryDirectory())
    return Path(_BURGERS_OUT[0].name)


def phase_burgers_train():
    """cli/maml_pde on a copy of bm7_5's config.json at its full width,
    resumed from its checkpoint_step_500001.pickle with both Adam states:
    10 outer steps, validation through the kernel against the FV ground
    truth (per-timestep error included), a final checkpoint; then a
    resumed run() that must solve nothing, and the step's numbers. Its
    out_dir (_burgers_out) outlives the phase: mesh_train's sharded run
    reads the ground truth it cached."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        src = _run_copy(tmp, BURGERS_RUN, ("config.json", BURGERS_CKPT.name))
        out = _burgers_out()
        cuts = {**BURGERS_TRAIN_CUTS, **BURGERS_OVERRIDES}
        args = [f"--from_run={src}", *(f"--{k}={v}" for k, v in cuts.items()),
                f"--train.out_dir={out}"]
        launches0 = spans.counter("siren_fused.launches")
        maml_pde.main(args + ["--train.expt_name=smoke"])
        torch.cuda.synchronize()
        launches = spans.counter("siren_fused.launches") - launches0
        run = out / "smoke"
        last = BURGERS_TRAIN_CUTS["train.outer_steps"]
        for f in ("log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle",
                  f"checkpoint_step_{last}.pickle"):
            if not (run / f).exists():
                raise AssertionError(f"the Burgers training run wrote no {f}")
        log_text = (run / "log.txt").read_text()
        if "resuming optimizer state at step 500002" not in log_text:
            raise AssertionError("the run did not resume bm7_5's optimizer states")
        recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
        jax_keys = sorted(json.loads((BURGERS_RUN / "metrics.jsonl").read_text()
                                     .splitlines()[0]))
        if not recs or sorted(recs[0]) != jax_keys:
            raise AssertionError(f"metrics.jsonl keys {sorted(recs[0]) if recs else []} != "
                                 f"the JAX run's {jax_keys}")
        if [r["step"] for r in recs] != [500004, 500009]:
            raise AssertionError(f"validation records at {[r['step'] for r in recs]}")
        nt = load_run_config(str(BURGERS_RUN)).task.num_tsteps
        for r in recs:
            for k in ("meta_loss", "val_meta_loss", "val_rel_err", "val_mse"):
                if not math.isfinite(r[k]):
                    raise AssertionError(f"step {r['step']}: {k} = {r[k]}")
            if not r["val_rel_err"] < 1e-2:
                raise AssertionError(f"step {r['step']}: val_rel_err {r['val_rel_err']} >= 1e-2")
            pts = r["per_time_step_error"]
            if len(pts) != nt or not all(math.isfinite(v) for v in pts):
                raise AssertionError(f"step {r['step']}: per_time_step_error has {len(pts)} "
                                     f"entries (expected {nt} finite)")
        if launches != len(recs):
            raise AssertionError(f"the Burgers training path launched siren_fused {launches} "
                                 f"times for {len(recs)} validation calls")
        ckpt_keys = _check_final_checkpoint(run / f"checkpoint_step_{last}.pickle", BURGERS_CKPT)
        first = _gt_log(run)
        t1 = time.perf_counter()
        maml_pde.main(args + ["--train.expt_name=resumed", f"--train.load_model_from_expt={run}",
                              f"--train.outer_steps={last + 1}"])
        resumed_s = time.perf_counter() - t1
        resumed = _gt_log(out / "resumed")
        final = checkpoints.load_checkpoint(str(run / f"checkpoint_step_{last}.pickle"))
    n_eval = BURGERS_TRAIN_CUTS["task.n_eval"]
    if first != (n_eval, 0) or resumed != (0, n_eval):
        raise AssertionError(f"ground truth (solved, read) {first} then {resumed} on resume")
    cfg = load_run_config(str(BURGERS_RUN))
    state = (params_from_numpy(final["params"], "cuda"),
             params_from_numpy(final["inner_lrs"], "cuda"),
             *(params_from_numpy(final[f"torch_{k}"], "cuda", dtype=None)
               for k in ("opt_state", "lr_opt_state")))
    bench = _step_numbers(cfg, maml_driver.build(cfg, "cuda"), state,
                          lambda o: (o[:4], o[5][0].mean()))
    step_s = statistics.mean(r["step_time"] for r in recs)
    emit("burgers_train", t0, reduced=cuts, launches=launches, validations=len(recs),
         gt_solved_read=first, resumed_gt_solved_read=resumed, resumed_s=resumed_s,
         meta_loss=[r["meta_loss"] for r in recs],
         val_rel_err=[r["val_rel_err"] for r in recs],
         val_rel_err_median=[r["val_rel_err_median"] for r in recs],
         per_time_step_error_max=[max(r["per_time_step_error"]) for r in recs],
         deployment_time=[r["deployment_time"] for r in recs],
         step_time=[r["step_time"] for r in recs], steps_per_s=1.0 / step_s,
         checkpoint_keys=ckpt_keys, bench=bench)
    return {"launches": launches, "steps_per_s": 1.0 / step_s, **bench,
            "deployment_time": recs[-1]["deployment_time"],
            "val_rel_err": recs[-1]["val_rel_err"], "gt_solved_read": first,
            "resumed_gt_solved_read": resumed}


def phase_elasticity_gt():
    """Two of em7_9's deployment tasks (host draws, deploy_bench's seed)
    through solve_direct at resolution 32 raised by the ligament floor,
    then the P1 interpolation of each on the card against the CPU."""
    t0 = time.perf_counter()
    cfg, pde, tasks = _eval_tasks(EM_RUN, 2)
    res = cfg.solver.ground_truth_resolution
    rows = []
    for i, task in enumerate(tasks):
        fem_elasticity.solve_direct.newton_steps = 0
        t1 = time.perf_counter()
        gt = pde.solve(task, resolution=res)
        secs = time.perf_counter() - t1
        pts = pde.sample_validation_points(torch.Generator().manual_seed(i), 1024, task, gt)
        cpu = fem_elasticity.evaluate(gt, pts)
        card_gt = fem_elasticity.ElasticityGroundTruth(*(a.to("cuda") for a in gt))
        card, card_s = _timed(lambda: fem_elasticity.evaluate(card_gt, pts.to("cuda")), "cuda")
        scale = float(cpu.abs().max())
        err = float((card.cpu() - cpu).abs().max()) / scale
        row = {"resolution": res, "floored_resolution": pde.effective_resolution(task, res),
               "s": secs, "newton_steps": fem_elasticity.solve_direct.newton_steps,
               "final_gnorm": float(gt.final_gnorm), "final_energy": float(gt.final_energy),
               "p1_card_vs_cpu": err, "p1_card_s": card_s,
               "dead_elements": float((1 - gt.elem_alive).mean())}
        rows.append(row)
        if not float(gt.final_gnorm) <= EM_GNORM_TOL:
            raise AssertionError(f"task {i}: final |g| {float(gt.final_gnorm)} > {EM_GNORM_TOL}")
        if not (bool(torch.isfinite(card).all()) and err <= P1_TOL):
            raise AssertionError(f"task {i}: P1 on the card vs CPU {err} of the field's max "
                                 f"(> {P1_TOL}), or not finite")
    emit("elasticity_gt", t0, tol_gnorm=EM_GNORM_TOL, tol_p1=P1_TOL, tasks=rows,
         host_threads=torch.get_num_threads())
    return rows


def _em_deploy(tmp, args):
    """deploy_bench.main on a copy of em7_9 under `tmp` (its best checkpoint
    and config)."""
    run_dir = _run_copy(tmp, EM_RUN, ("checkpoint_best.pickle", "config.json"))
    return deploy_bench.main(["--algo=maml", f"--from_run={run_dir}", "--checkpoint=best",
                              "--model.use_pallas_inference=true", *args])


def phase_elasticity_parity():
    """A small em7_9 deployment on the card and on the CPU: the tasks and
    points are host draws, so both sides see the same inputs; the two
    share the ground truths through gt_cache_torch/."""
    t0 = time.perf_counter()
    args = ["--solver.ground_truth_resolution=8", "--task.n_eval=2",
            "--task.validation_points=256", "--task.inner_points=256",
            "--inner-steps-list=0,5", "--repeats=1"]
    with tempfile.TemporaryDirectory() as tmp:
        gpu = _em_deploy(tmp, args)
        cpu = _em_deploy(tmp, ["--device=cpu", *args])
    _deploy_parity("elasticity_parity", t0, gpu, cpu, PARITY_RTOL)


def phase_elasticity_deploy():
    """The em7_9 command: best checkpoint, 8 fresh tasks, k = 0, 1, 2, 5,
    the energy audit, ground truth through gt_cache_torch/."""
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = _deploy_checked(
            tmp, "elasticity_deploy", lambda: _em_deploy(tmp, [
                "--task.n_eval=8", "--inner-steps-list=" + ",".join(map(str, DEPLOY_KS)),
                f"--repeats={DEPLOY_REPEATS}", "--energy_audit"]),
            DEPLOY_KS, JAX_CPU_EM_K5_MEDIAN, plan=_plan_of(EM_RUN))
    return launches


def phase_leap_elasticity_deploy():
    """cli/deploy_bench --algo=leap on a copy of lde2_3 (10x128, 2048 inner
    and 1024 validation points): k = 0, 5, 20, 40, every task and its
    mirror in one launch, the weights streamed."""
    plan = _plan_of(LDE_RUN)
    if plan["resident"]:
        raise AssertionError(f"lde2_3's 10x128 weights planned resident: {plan}")
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = _run_copy(tmp, LDE_RUN, ("checkpoint_best.pickle", "config.json"))
        return _deploy_checked(
            tmp, "leap_elasticity_deploy", lambda: deploy_bench.main([
                "--algo=leap", f"--from_run={run_dir}", "--checkpoint=best",
                "--model.use_pallas_inference=true", "--task.n_eval=8",
                "--inner-steps-list=" + ",".join(map(str, LDE_KS)),
                f"--repeats={DEPLOY_REPEATS}"]),
            LDE_KS, JAX_CPU_LDE_K40_MEDIAN, plan=plan)[0]


def phase_elasticity_train():
    """cli/maml_pde on a copy of em7_9's config.json at its full width,
    resumed from its checkpoint_step_500001.pickle with both Adam states:
    6 outer steps, branch-aware validation through the kernel against the
    host-solved ground truth, a final checkpoint; then the step's numbers."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        src = _run_copy(tmp, EM_RUN, ("config.json", EM_CKPT.name))
        out = Path(tmp) / "out"
        cuts = {**EM_TRAIN_CUTS, **EM_OVERRIDES}
        args = [f"--from_run={src}", *(f"--{k}={v}" for k, v in cuts.items()),
                f"--train.out_dir={out}", "--train.expt_name=smoke"]
        launches0 = spans.counter("siren_fused.launches")
        fem_elasticity.solve_direct.newton_steps = 0
        maml_pde.main(args)
        torch.cuda.synchronize()
        launches = spans.counter("siren_fused.launches") - launches0
        run = out / "smoke"
        last = EM_TRAIN_CUTS["train.outer_steps"]
        for f in ("log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle",
                  f"checkpoint_step_{last}.pickle"):
            if not (run / f).exists():
                raise AssertionError(f"the elasticity training run wrote no {f}")
        log_text = (run / "log.txt").read_text()
        for line in ("resuming optimizer state at step 500002",
                     "branch-aware validation on: oracle energies"):
            if line not in log_text:
                raise AssertionError(f"log.txt lacks {line!r}")
        recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
        jax_keys = sorted(json.loads((EM_RUN / "metrics.jsonl").read_text().splitlines()[0]))
        if not recs or sorted(recs[0]) != jax_keys:
            raise AssertionError(f"metrics.jsonl keys {sorted(recs[0]) if recs else []} != "
                                 f"the JAX run's {jax_keys}")
        if [r["step"] for r in recs] != [500003, 500006]:
            raise AssertionError(f"validation records at {[r['step'] for r in recs]}")
        n_eval = EM_TRAIN_CUTS["task.n_eval"]
        for r in recs:
            for k in ("meta_loss", "val_meta_loss", "val_rel_err", "val_mse",
                      "val_rel_err_branch"):
                if not math.isfinite(r[k]):
                    raise AssertionError(f"step {r['step']}: {k} = {r[k]}")
            if not r["val_rel_err"] < 5e-2:
                raise AssertionError(f"step {r['step']}: val_rel_err {r['val_rel_err']} >= 5e-2")
            if (len(r["val_branch_mask"]) != n_eval
                    or r["val_branch_flags"] != sum(r["val_branch_mask"])):
                raise AssertionError(f"step {r['step']}: branch mask {r['val_branch_mask']}, "
                                     f"flags {r['val_branch_flags']}")
        if launches != len(recs):
            raise AssertionError(f"the elasticity training path launched siren_fused {launches} "
                                 f"times for {len(recs)} validation calls")
        ckpt_keys = _check_final_checkpoint(run / f"checkpoint_step_{last}.pickle", EM_CKPT)
        gt_solved = _gt_log(run)
        final = checkpoints.load_checkpoint(str(run / f"checkpoint_step_{last}.pickle"))
    cfg = load_run_config(str(EM_RUN))
    state = (params_from_numpy(final["params"], "cuda"),
             params_from_numpy(final["inner_lrs"], "cuda"),
             *(params_from_numpy(final[f"torch_{k}"], "cuda", dtype=None)
               for k in ("opt_state", "lr_opt_state")))
    bench = _step_numbers(cfg, maml_driver.build(cfg, "cuda"), state,
                          lambda o: (o[:4], o[5][0].mean()))
    step_s = statistics.mean(r["step_time"] for r in recs)
    emit("elasticity_train", t0, reduced=cuts, launches=launches, validations=len(recs),
         gt_solved_read=gt_solved, newton_steps=fem_elasticity.solve_direct.newton_steps,
         meta_loss=[r["meta_loss"] for r in recs],
         val_rel_err=[r["val_rel_err"] for r in recs],
         val_rel_err_median=[r["val_rel_err_median"] for r in recs],
         val_rel_err_branch=[r["val_rel_err_branch"] for r in recs],
         val_branch_flags=[r["val_branch_flags"] for r in recs],
         val_branch_mask=[r["val_branch_mask"] for r in recs],
         per_dim_rel_err=[r["per_dim_rel_err"] for r in recs],
         deployment_time=[r["deployment_time"] for r in recs],
         step_time=[r["step_time"] for r in recs], steps_per_s=1.0 / step_s,
         checkpoint_keys=ckpt_keys, bench=bench)
    return {"launches": launches, "steps_per_s": 1.0 / step_s, **bench,
            "deployment_time": recs[-1]["deployment_time"],
            "val_rel_err": recs[-1]["val_rel_err"], "gt_solved_read": gt_solved}


def phase_steady_gt():
    """One of sbi10_2's deployment tasks (host draws, deploy_bench's seed)
    solved at the config's resolution 48 on the card and on the CPU, with
    the solver's own constants (Jacobi-BiCGStab, krylov_max_iters 960); one
    more solve on the card under torch.profiler; then the P1 evaluation on
    the card against the CPU's at 1024 validation points."""
    t0 = time.perf_counter()
    cfg, pde, tasks = _eval_tasks(SB_RUN, 1)
    res = cfg.solver.ground_truth_resolution

    def solve(task):
        return pde.solve(task, resolution=res)

    g, g_s, g_steps, g_iters = _solve_counted(solve, tasks[0], "cuda")
    c, c_s, c_steps, c_iters = _solve_counted(solve, tasks[0], "cpu")
    scale = float(c.u_grid.abs().max())
    err = float((g.u_grid.cpu() - c.u_grid).abs().max()) / scale
    if not (bool(torch.isfinite(g.u_grid).all()) and err <= SB_GT_TOL):
        raise AssertionError(f"resolution-{res} u_grid: card vs CPU {err} of the grid's max "
                             f"(> {SB_GT_TOL}), or not finite")
    on_card = tuple(a.to("cuda") for a in tasks[0])
    newton.bicgstab.iterations = 0
    prof = _profile(lambda: solve(on_card))
    prof["krylov_iters"] = newton.bicgstab.iterations
    prof["launches_per_krylov_iter"] = prof["launches"] / max(newton.bicgstab.iterations, 1)
    pts = pde.sample_validation_points(torch.Generator().manual_seed(0), 1024, tasks[0], c)
    cpu_vals = pde.evaluate_gt(c, pts)
    card_gt = type(c)(*(a.to("cuda") for a in c))
    card_vals, card_eval_s = _timed(lambda: pde.evaluate_gt(card_gt, pts.to("cuda")), "cuda")
    p1_err = float((card_vals.cpu() - cpu_vals).abs().max()) / float(cpu_vals.abs().max())
    if not (bool(torch.isfinite(card_vals).all()) and p1_err <= P1_TOL):
        raise AssertionError(f"P1 on the card vs CPU {p1_err} of the field's max (> {P1_TOL})")
    row = {"resolution": res, "card_s": g_s, "cpu_s": c_s, "newton_steps": g_steps,
           "krylov_iters": g_iters, "cpu_newton_steps": c_steps, "cpu_krylov_iters": c_iters,
           "residual_norm": float(g.residual_norm), "cpu_residual_norm": float(c.residual_norm),
           "rel_err": err, "p1_card_vs_cpu": p1_err, "p1_card_s": card_eval_s,
           "dead_elements": float((1 - g.elem_alive).mean())}
    emit("steady_gt", t0, tol=SB_GT_TOL, tol_p1=P1_TOL, task=row, solve_profiled=prof,
         host_threads=torch.get_num_threads())
    return {**row, "launches_per_krylov_iter": prof["launches_per_krylov_iter"],
            "idle_share": prof["idle_share"]}


def _sb_deploy(tmp, args):
    """deploy_bench.main --algo=maml on a copy of sbi10_2 under `tmp` (its
    best checkpoint and config)."""
    run_dir = _run_copy(tmp, SB_RUN, ("checkpoint_best.pickle", "config.json"))
    return deploy_bench.main(["--algo=maml", f"--from_run={run_dir}", "--checkpoint=best",
                              "--model.use_pallas_inference=true", *args])


def phase_steady_parity():
    """A 2-task sbi10_2 deployment at k = 0 and 10 on the card and on the
    CPU, the same host draws; the CPU reads the card's ground truths from
    gt_cache_torch/, so the two differ only in the adaptation and the
    inference."""
    t0 = time.perf_counter()
    args = ["--task.n_eval=2", "--inner-steps-list=0,10", "--repeats=1"]
    with tempfile.TemporaryDirectory() as tmp:
        gpu = _sb_deploy(tmp, args)
        cpu = _sb_deploy(tmp, ["--device=cpu", *args])
    _deploy_parity("steady_parity", t0, gpu, cpu, SB_PARITY_RTOL)


def phase_steady_deploy():
    """The sbi10_2 command (best checkpoint, SB_N_EVAL fresh tasks, k = 0,
    10, 20, 40, 80, ground truth at resolution 48 through gt_cache_torch/),
    then the same tasks with --deploy.optimizer=adam at k = 0, 50 from the
    cached ground truths (steady_deploy_adam)."""
    plan = _plan_of(SB_RUN)
    with tempfile.TemporaryDirectory() as tmp:
        def sb(ks, extra=()):
            return _sb_deploy(tmp, [f"--task.n_eval={SB_N_EVAL}",
                                    "--inner-steps-list=" + ",".join(map(str, ks)),
                                    f"--repeats={DEPLOY_REPEATS}", *extra])

        newton.newton_krylov.steps, newton.bicgstab.iterations = 0, 0
        launches, _ = _deploy_checked(tmp, "steady_deploy", lambda: sb(SB_KS), SB_KS,
                                      JAX_CPU_SB_K80_MEDIAN, n_eval=SB_N_EVAL, plan=plan)
        solve_counts = (newton.newton_krylov.steps, newton.bicgstab.iterations)
        newton.newton_krylov.steps = 0
        adam_launches, _ = _deploy_checked(
            tmp, "steady_deploy_adam", lambda: sb(SB_ADAM_KS, ["--deploy.optimizer=adam"]),
            SB_ADAM_KS, JAX_CPU_SB_ADAM_K50_MEDIAN, n_eval=SB_N_EVAL,
            steady_deploy_gt_newton_krylov=solve_counts)
        if newton.newton_krylov.steps:
            raise AssertionError(f"the adam pass ran {newton.newton_krylov.steps} Newton "
                                 "steps: its ground truths were not read from the cache")
    return launches, adam_launches


def phase_steady_train():
    """cli/maml_pde on a copy of sbi10_2's config.json at its full width
    (bsize 8, 10 inner steps, remat, 1024 points), resumed from its
    checkpoint_step_100001.pickle with both Adam states: 4 outer steps,
    validation through the kernel on 2 eval tasks at resolution 48, a final
    checkpoint; then the step's numbers."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        src = _run_copy(tmp, SB_RUN, ("config.json", SB_CKPT.name))
        out = Path(tmp) / "out"
        cuts = {**SB_TRAIN_CUTS, **SB_OVERRIDES}
        args = [f"--from_run={src}", *(f"--{k}={v}" for k, v in cuts.items()),
                f"--train.out_dir={out}", "--train.expt_name=smoke"]
        launches0 = spans.counter("siren_fused.launches")
        newton.newton_krylov.steps, newton.bicgstab.iterations = 0, 0
        maml_pde.main(args)
        torch.cuda.synchronize()
        launches = spans.counter("siren_fused.launches") - launches0
        solve_counts = (newton.newton_krylov.steps, newton.bicgstab.iterations)
        run = out / "smoke"
        last = SB_TRAIN_CUTS["train.outer_steps"]
        for f in ("log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle",
                  f"checkpoint_step_{last}.pickle"):
            if not (run / f).exists():
                raise AssertionError(f"the steady Burgers training run wrote no {f}")
        if "resuming optimizer state at step 100002" not in (run / "log.txt").read_text():
            raise AssertionError("log.txt lacks the resume from step 100002")
        recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
        jax_keys = sorted(json.loads((SB_RUN / "metrics.jsonl").read_text().splitlines()[0]))
        if not recs or sorted(recs[0]) != jax_keys:
            raise AssertionError(f"metrics.jsonl keys {sorted(recs[0]) if recs else []} != "
                                 f"the JAX run's {jax_keys}")
        if [r["step"] for r in recs] != [100003, 100005]:
            raise AssertionError(f"validation records at {[r['step'] for r in recs]}")
        for r in recs:
            for k in ("meta_loss", "val_meta_loss", "val_rel_err", "val_mse"):
                if not math.isfinite(r[k]):
                    raise AssertionError(f"step {r['step']}: {k} = {r[k]}")
            if not r["val_rel_err"] < SB_TRAIN_BAR:
                raise AssertionError(f"step {r['step']}: val_rel_err {r['val_rel_err']} >= "
                                     f"{SB_TRAIN_BAR}")
        if launches != len(recs):
            raise AssertionError(f"the steady Burgers training path launched siren_fused "
                                 f"{launches} times for {len(recs)} validation calls")
        ckpt_keys = _check_final_checkpoint(run / f"checkpoint_step_{last}.pickle", SB_CKPT)
        gt_solved = _gt_log(run)
        final = checkpoints.load_checkpoint(str(run / f"checkpoint_step_{last}.pickle"))
    cfg = load_run_config(str(SB_RUN))
    state = (params_from_numpy(final["params"], "cuda"),
             params_from_numpy(final["inner_lrs"], "cuda"),
             *(params_from_numpy(final[f"torch_{k}"], "cuda", dtype=None)
               for k in ("opt_state", "lr_opt_state")))
    bench = _step_numbers(cfg, maml_driver.build(cfg, "cuda"), state,
                          lambda o: (o[:4], o[5][0].mean()))
    step_s = statistics.mean(r["step_time"] for r in recs)
    emit("steady_train", t0, reduced=cuts, launches=launches, validations=len(recs),
         gt_solved_read=gt_solved, gt_newton_krylov=solve_counts,
         meta_loss=[r["meta_loss"] for r in recs],
         val_rel_err=[r["val_rel_err"] for r in recs],
         val_rel_err_median=[r["val_rel_err_median"] for r in recs],
         per_dim_rel_err=[r["per_dim_rel_err"] for r in recs],
         deployment_time=[r["deployment_time"] for r in recs],
         step_time=[r["step_time"] for r in recs], steps_per_s=1.0 / step_s,
         checkpoint_keys=ckpt_keys, bench=bench)
    return {"launches": launches, "steps_per_s": 1.0 / step_s, **bench,
            "deployment_time": recs[-1]["deployment_time"],
            "val_rel_err": recs[-1]["val_rel_err"], "gt_solved_read": gt_solved}


def phase_poisson3d_parity():
    """train_parity on poisson3d at the pipeline's 5x128 (5 inner steps),
    cut to bsize 2 and 256 points: 3 outer steps on the card and on the
    CPU on the same host draws, TF32 off."""
    t0 = time.perf_counter()
    cfg = parse_overrides(Config(), P3D_FLAGS + ["--maml.bsize=2", "--task.inner_points=256",
                                                 "--task.outer_points=256"])
    c = maml_driver.build(cfg, "cpu")
    state = (c["init_params"], c["inner_lrs"], c["outer_opt"].init(c["init_params"]),
             c["lr_opt"].init(c["inner_lrs"]))
    rows, t_card, t_cpu = _train_both(cfg, 3, state)
    emit("poisson3d_parity", t0, leaf_tol=TRAIN_LEAF_TOL, loss_rtol=TRAIN_LOSS_RTOL,
         steps=rows, card_s=t_card, cpu_s=t_cpu)


def phase_poisson3d_train():
    """cli/maml_pde --task.pde=poisson3d at the pipeline's one-chip width
    (5x128, bsize 16, 5 inner steps, 2048 inner, outer and validation
    points, 8 eval tasks) from a fresh init: 4 outer steps in blocks of 2,
    validation through the kernel (in_dim 3) against the exact solution;
    then the step's numbers, and one step's peak memory without remat."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out"
        args = [*P3D_FLAGS, *(f"--{k}={v}" for k, v in P3D_TRAIN_CUTS.items()),
                f"--train.out_dir={out}", "--train.expt_name=smoke"]
        launches0 = spans.counter("siren_fused.launches")
        maml_pde.main(args)
        torch.cuda.synchronize()
        launches = spans.counter("siren_fused.launches") - launches0
        run = out / "smoke"
        last = P3D_TRAIN_CUTS["train.outer_steps"]
        for f in ("log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle",
                  f"checkpoint_step_{last}.pickle"):
            if not (run / f).exists():
                raise AssertionError(f"the poisson3d training run wrote no {f}")
        recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
        if [r["step"] for r in recs] != [1, 3]:
            raise AssertionError(f"validation records at {[r['step'] for r in recs]}")
        for r in recs:
            for k in ("meta_loss", "val_meta_loss", "val_rel_err", "val_mse"):
                if not math.isfinite(r[k]):
                    raise AssertionError(f"step {r['step']}: {k} = {r[k]}")
            if not r["val_rel_err"] < P3D_TRAIN_BAR:
                raise AssertionError(f"step {r['step']}: val_rel_err {r['val_rel_err']} >= "
                                     f"{P3D_TRAIN_BAR}")
        if launches != len(recs):
            raise AssertionError(f"the poisson3d training path launched siren_fused "
                                 f"{launches} times for {len(recs)} validation calls")
        gt_solved = _gt_log(run)
        final = checkpoints.load_checkpoint(str(run / f"checkpoint_step_{last}.pickle"))
    cfg = parse_overrides(Config(), P3D_FLAGS)
    state = (params_from_numpy(final["params"], "cuda"),
             params_from_numpy(final["inner_lrs"], "cuda"),
             *(params_from_numpy(final[f"torch_{k}"], "cuda", dtype=None)
               for k in ("opt_state", "lr_opt_state")))
    bench = _step_numbers(cfg, maml_driver.build(cfg, "cuda"), state,
                          lambda o: (o[:4], o[5][0].mean()))
    # the same step without remat (train.remat_inner_steps=false): its peak
    no_remat = maml_driver.build(
        parse_overrides(cfg, ["--train.remat_inner_steps=false"]), "cuda")
    batch = no_remat["draw_step_inputs"](torch.Generator().manual_seed(cfg.seed + 29))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, no_remat_s = _timed(lambda: no_remat["step_core"](batch, *state), "cuda")
    no_remat_peak = torch.cuda.max_memory_allocated()
    step_s = statistics.mean(r["step_time"] for r in recs)
    emit("poisson3d_train", t0, reduced=P3D_TRAIN_CUTS, launches=launches,
         validations=len(recs), gt_solved_read=gt_solved,
         meta_loss=[r["meta_loss"] for r in recs],
         val_rel_err=[r["val_rel_err"] for r in recs],
         val_rel_err_median=[r["val_rel_err_median"] for r in recs],
         deployment_time=[r["deployment_time"] for r in recs],
         step_time=[r["step_time"] for r in recs], steps_per_s=1.0 / step_s, bench=bench,
         no_remat_step_s=no_remat_s, no_remat_max_memory_allocated_bytes=no_remat_peak)
    return {"launches": launches, "steps_per_s": 1.0 / step_s, **bench,
            "no_remat_max_memory_allocated_bytes": no_remat_peak,
            "deployment_time": recs[-1]["deployment_time"],
            "val_rel_err": recs[-1]["val_rel_err"], "gt_solved_read": gt_solved}


# --- the comparison side: plain-PINN fine-tunes and the solver sweep -----

_NN_OUT = []


def _nn_out():
    """The out_dir the nn phases share (and its gt_cache_torch/), removed
    when the process ends."""
    if not _NN_OUT:
        _NN_OUT.append(tempfile.TemporaryDirectory())
    return Path(_NN_OUT[0].name)


def _nn_state(fname, device, lrs=False):
    """A checkpoint's params (and inner LRs) on `device`."""
    ck = checkpoints.load_checkpoint(str(fname))
    out = params_from_numpy(ck["params"], device)
    return (out, params_from_numpy(ck["inner_lrs"], device)) if lrs else out


def phase_nn_parity():
    """nn_driver on the card and on the CPU on the same host draws (TF32
    off on the card): NN_PARITY_STEPS steps of train_step_many from lp2_4
    at the second command's width, then one MAML warm-up from tpu_run6b at
    the first's. The pinned task is drawn on the host on both sides."""
    t0 = time.perf_counter()
    rows = {}
    leap_cfg = parse_overrides(Config(), NN_LEAP_FLAGS + ["--seed=1"])
    cards, cpus = nn_driver.build(leap_cfg, "cuda"), nn_driver.build(leap_cfg, "cpu")
    task_err = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(cards["task_params"], cpus["task_params"]))
    if task_err != 0.0:
        raise AssertionError(f"the pinned task differs between card and CPU by {task_err}")
    params = _nn_state(LEAP_CKPT, "cpu")
    outs = {}
    for name, c in (("card", cards), ("cpu", cpus)):
        p = tree_map(lambda t: t.to(c["device"]), params)
        with full_f32_matmuls():
            outs[name], secs = _timed(lambda: c["train_step_many"](
                torch.Generator().manual_seed(17), p, c["opt"].init(p), NN_PARITY_STEPS),
                c["device"].type)
        rows[f"{name}_s"] = secs
    losses_card, losses_cpu = outs["card"][5].cpu(), outs["cpu"][5]
    rows["leaf_err"] = _leaf_err(outs["card"][0], outs["cpu"][0])
    rows["loss_rel"] = float(((losses_card - losses_cpu).abs() / losses_cpu.abs()).max())
    rows["losses"] = losses_cpu.tolist()
    maml_cfg = parse_overrides(Config(), NN_MAML_FLAGS + ["--seed=1"])
    warm = {}
    for dev in ("cuda", "cpu"):
        c = nn_driver.build(maml_cfg, dev)
        with full_f32_matmuls():
            warm[dev] = c["maml_warmup"](torch.Generator().manual_seed(19),
                                         *_nn_state(MAML_INIT_CKPT, dev, lrs=True))
    rows["warmup_leaf_err"] = _leaf_err(warm["cuda"], warm["cpu"])
    rows["warmup_moved"] = _leaf_err(warm["cpu"], _nn_state(MAML_INIT_CKPT, "cpu"))
    if not (rows["leaf_err"] <= TRAIN_LEAF_TOL and rows["warmup_leaf_err"] <= TRAIN_LEAF_TOL
            and rows["loss_rel"] <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"nn_parity beyond {TRAIN_LEAF_TOL} of a leaf's scale or losses "
                             f"beyond rtol {TRAIN_LOSS_RTOL}: {rows}")
    emit("nn_parity", t0, leaf_tol=TRAIN_LEAF_TOL, loss_rtol=TRAIN_LOSS_RTOL,
         steps=NN_PARITY_STEPS, **rows)


def _done_line(run):
    """(run s, ground-truth s, siren_fused launches) from nn_driver's
    closing line of log.txt."""
    line = next(l for l in (run / "log.txt").read_text().splitlines()
                if l.startswith("done: "))
    words = line.replace(",", "").split()
    return float(words[4]), float(words[8]), int(words[12])


def _nn_sweeps(specs, seeds=NN_SEEDS, steps=200, report=(0, 100)):
    """cli/sweep over `seeds` for each command of `specs` ((name, driver,
    flags, init run, JAX medians, warm-up, num_tsteps)), every job of every
    command at once, with the command's flags from its init run, the kernel
    on, `steps` Adam steps, into the shared out_dir; each job counts its own
    siren_fused launches from 0 (a fresh process) and writes them in its
    log.txt's closing line. Holds each seed to one launch per validation
    call (and with num_tsteps, every row to that many finite per-timestep
    errors) and each command's median over the seeds of the last
    validation's val_rel_err (step steps - 5) to NN_FACTOR x the JAX
    package's 8-seed median at that step; the medians at the steps of
    `report` and of each seed's best are printed beside. Returns name ->
    row."""
    t0 = time.perf_counter()
    out = _nn_out()
    concurrency = len(seeds)
    # the jobs share the host's cores for their draws and launches
    env = {**os.environ, "OMP_NUM_THREADS": str(max(
        1, len(os.sched_getaffinity(0)) // (concurrency * len(specs))))}
    procs = {}
    try:
        for name, driver, flags, init_run, *_ in specs:
            cmd = [sys.executable, "-m", "metapde_tpu_torch.cli.sweep", f"--driver={driver}",
                   "--seeds=" + ",".join(map(str, seeds)), f"--concurrency={concurrency}",
                   "--", *flags, f"--train.outer_steps={steps}",
                   "--model.use_pallas_inference=true",
                   f"--train.load_model_from_expt={init_run}", f"--train.out_dir={out}",
                   f"--train.expt_name={name}"]
            procs[name] = _spawn(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True, env=env)
        texts = {name: proc.communicate(timeout=600)[0] for name, proc in procs.items()}
    finally:
        _kill_children()
    wall = time.perf_counter() - t0
    rows = {}
    for name, driver, flags, init_run, jax_medians, warmup, num_tsteps in specs:
        if procs[name].returncode != 0:
            raise AssertionError(f"{name}: the sweep exited {procs[name].returncode}: "
                                 f"{texts[name][-4000:]}")
        per_seed = {}
        for s in seeds:
            run = out / f"{name}_seed_{s}"
            log = (run / "log.txt").read_text()
            recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
            run_s, gt_s, launches = _done_line(run)
            val = {r["step"]: r["val_rel_err"] for r in recs}
            if sorted(val) != list(range(0, steps, 5)) or not all(map(math.isfinite,
                                                                       val.values())):
                raise AssertionError(f"{name} seed {s}: validation steps {sorted(val)}, "
                                     f"values {list(val.values())}")
            for r in recs if num_tsteps else ():
                pts = r["per_time_step_error"]
                if len(pts) != num_tsteps or not all(map(math.isfinite, pts)):
                    raise AssertionError(f"{name} seed {s} step {r['step']}: "
                                         f"per_time_step_error has {len(pts)} entries "
                                         f"(expected {num_tsteps} finite)")
            if warmup and "applied MAML warm-up adaptation" not in log:
                raise AssertionError(f"{name} seed {s}: no MAML warm-up in log.txt")
            if launches != len(recs):
                raise AssertionError(f"{name} seed {s}: {launches} siren_fused launches for "
                                     f"{len(recs)} validation calls")
            per_seed[s] = {"val": val, "run_s": run_s, "gt_s": gt_s, "launches": launches,
                           "gt_solved_read": _gt_log(run),
                           "steps_per_s": 1.0 / statistics.median(r["step_time"]
                                                                  for r in recs[1:])}
        last = steps - 5
        med = {f"step_{k}": statistics.median(d["val"][k] for d in per_seed.values())
               for k in (*report, last)}
        med["best"] = statistics.median(min(d["val"].values()) for d in per_seed.values())
        bar = NN_FACTOR * jax_medians[f"step_{last}"]
        if not med[f"step_{last}"] <= bar:
            raise AssertionError(f"{name}: step-{last} median {med[f'step_{last}']} above "
                                 f"{NN_FACTOR} x the JAX package's "
                                 f"{jax_medians[f'step_{last}']}")
        rows[name] = {
            "reduced": {"seeds": len(seeds), "of": 8, "steps": steps, "of_steps": 200},
            "concurrency": concurrency, "commands_at_once": len(specs), "wall_s": wall,
            "median": med, "jax_median": jax_medians, "compared_step": last, "bar": bar,
            "launches": sum(d["launches"] for d in per_seed.values()),
            "validations": steps // 5 * len(seeds),
            "per_seed": {s: {f"step_{last}": d["val"][last], "best": min(d["val"].values()),
                             **{k: d[k] for k in ("run_s", "gt_s", "launches",
                                                  "gt_solved_read", "steps_per_s")}}
                         for s, d in per_seed.items()},
            # the jobs start together: the sweeps' wall time less the longest
            # run, one process's start-up (interpreter, imports, CUDA
            # context) and the sweep's own
            "startup_s": wall - max(d["run_s"] for d in per_seed.values())}
    return rows


def _nn_step_numbers(flags, params):
    """The fine-tune step at a command's width, alone on the card:
    _step_numbers' steps/s, host draw, launches, device busy and idle."""
    cfg = parse_overrides(Config(), flags + ["--seed=1"])
    c = nn_driver.build(cfg, "cuda")
    return _step_numbers(cfg, c, (params, c["opt"].init(params)),
                         lambda out: (out[:2], out[2]))


def phase_nn_deploy_maml():
    """pipeline/deployment_poisson.sh's first command through cli/sweep
    (nn_pde_maml from tpu_run6b: the MAML warm-up, then 200 Adam steps at
    bsize 16 on 1024 points, validation every 5 steps against ground truth
    at 32), with the kernel on; then one step of it alone on the card,
    profiled."""
    t0 = time.perf_counter()
    row = _nn_sweeps([("deploy_maml", "nn_pde_maml", NN_MAML_FLAGS, MAML_INIT_RUN, JAX_NN_MAML,
                       True, None)])["deploy_maml"]
    row["step"] = _nn_step_numbers(NN_MAML_FLAGS, _nn_state(MAML_INIT_CKPT, "cuda"))
    emit("nn_deploy_maml", t0, **row)
    return row


def phase_nn_deploy_leap():
    """The script's second command (nn_pde from lp2_4, 512 points) on the
    same seeds and out_dir: its pinned tasks are the MAML sweep's, so each
    reads its ground truth from the MAML sweep's cache when that ran first
    in this process."""
    t0 = time.perf_counter()
    maml_ran = (_nn_out() / "deploy_maml_seed_1").exists()
    row = _nn_sweeps([("deploy_leap", "nn_pde", NN_LEAP_FLAGS, LEAP_RUN, JAX_NN_LEAP, False,
                       None)])["deploy_leap"]
    reads = {s: d["gt_solved_read"] for s, d in row["per_seed"].items()}
    if maml_ran and set(reads.values()) != {(0, 1)}:
        raise AssertionError(f"nn_deploy_leap: (solved, read) {reads}: the ground truths "
                             "were not read from the MAML sweep's cache")
    row["step"] = _nn_step_numbers(NN_LEAP_FLAGS, _nn_state(LEAP_CKPT, "cuda"))
    emit("nn_deploy_leap", t0, gt_from_maml_cache=maml_ran, **row)
    return row


def phase_nn_multistart():
    """cli/nn_pde from lp2_4 with 3 candidates (jitter 0.05), 10 steps, seed
    1: the ms_* keys in every metrics row, one launch per validation call,
    and a final checkpoint of one unstacked model with 3 scores."""
    t0 = time.perf_counter()
    out = _nn_out()
    launches0 = spans.counter("siren_fused.launches")
    nn_pde.main(NN_LEAP_FLAGS + [
        "--seed=1", "--model.use_pallas_inference=true",
        f"--train.load_model_from_expt={LEAP_RUN}", f"--train.out_dir={out}",
        "--train.expt_name=multistart", *(f"--{k}={v}" for k, v in NN_MS_CUTS.items())])
    torch.cuda.synchronize()
    launches = spans.counter("siren_fused.launches") - launches0
    run = out / "multistart"
    recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
    ms_keys = ("ms_best_idx", "ms_train_best_idx", "ms_score_best", "ms_score_worst")
    if not recs or any(k not in r for r in recs for k in ms_keys):
        raise AssertionError(f"nn_multistart: metrics rows without {ms_keys}: {recs}")
    steps = NN_MS_CUTS["train.outer_steps"]
    final = checkpoints.load_checkpoint(str(run / f"checkpoint_step_{steps}.pickle"))
    ref = checkpoints.load_checkpoint(str(LEAP_CKPT))
    shapes = [x.shape for x in tree_leaves(final["params"])]
    if shapes != [x.shape for x in tree_leaves(ref["params"])]:
        raise AssertionError(f"nn_multistart: final params {shapes} are not one model")
    if len(final["ms_scores"]) != NN_MS_CUTS["deploy.n_starts"] or launches != len(recs):
        raise AssertionError(f"nn_multistart: {len(final['ms_scores'])} scores, {launches} "
                             f"launches for {len(recs)} validation calls")
    emit("nn_multistart", t0, reduced=NN_MS_CUTS, launches=launches, validations=len(recs),
         gt_solved_read=_gt_log(run), ms_scores=[float(x) for x in final["ms_scores"]],
         ms_best_idx=int(final["ms_best_idx"]),
         val_rel_err=[r["val_rel_err"] for r in recs],
         ms_train_best_idx=[r["ms_train_best_idx"] for r in recs],
         checkpoint_keys=sorted(final))
    return {"launches": launches}


# --- the paper's Burgers and hyperelasticity pipelines: LEAP meta-training
# (pipeline/leap_meta.sh) and the plain-PINN sweeps
# (pipeline/deployment_burgers.sh, pipeline/deployment_elasticity.sh) -------

# ldb3_2 and lde2_3 resumed through cli/leap_pde at their full width and
# inner depth (10x128, 80 and 20 inner steps, bsize 8, 2048 points, their
# 4 eval tasks): LEAP_FAMILY_STEPS outer steps in one block that ends on the
# run's one validation, the final checkpoint, then one step resumed from it.
# lde2_3 resumes from its latest checkpoint, the one the CLI picks; the
# card-vs-CPU step takes its best one
LDE_LATEST_CKPT = LDE_RUN / "checkpoint_step_47999.pickle"
LDE_BEST_CKPT = LDE_RUN / "checkpoint_best.pickle"
LEAP_FAMILY_STEPS = 2
# The bar: val_rel_err at most 3x the JAX package's validation from the
# same checkpoint on the same eval tasks, coords and ground truths (the
# port's: host draws), by its own make_validation_fn and LEAP adaptation:
#   env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_leap_family_bar.py
# Each run's last logged val_rel_err (its metrics.jsonl) is printed beside:
# it was taken on the JAX run's eval tasks, which the port cannot draw, and
# on the port's 4 Burgers tasks one alone scores 4.7e-2 in JAX (PERF.md)
JAX_LDB_SAME_TASKS_VAL = 0.013073156587779522   # ldb3_2, step 40000
JAX_LDE_SAME_TASKS_VAL = 0.00353615521453321    # lde2_3, step 47999
JAX_LDB_LAST_VAL = 0.002114271279424429    # ldb3_2, step 39,999
JAX_LDE_LAST_VAL = 0.0031538025941699743   # lde2_3, step 47,999
LEAP_FAMILY_FACTOR = 3.0
# one LEAP step of each on the card and on the CPU from its checkpoint with
# its Adam state, on shared host draws, at full width and 2048 points, the
# depth cut to bsize 2 and 10 inner steps (the CPU side at full depth takes
# minutes). The meta-gradient (from the new Adam moment) within 1e-1 of each
# leaf's largest entry and 1e-3 of the tree's norm: under loss_in_distance
# each increment carries d_loss, a difference of two f32 losses, so f32 is
# far from exact on a few leaves (tests/test_torch_energy.py sets the same
# bars for lde2_3 against JAX)
LEAP_FAMILY_PARITY_CUTS = ["--leap.bsize=2", "--leap.inner_steps=10"]
LEAP_GRAD_LEAF_TOL = 1e-1
LEAP_GRAD_TREE_TOL = 1e-3
# the two scripts' commands, their flags as they pass them (the steps come
# from NN_FAMILY_STEPS), from their inits
BURGERS_MAML_INIT = REPO / "results_burgers_maml" / "tpu_run1"
LDB_INIT = REPO / "results_burgers_leap" / "ldb3_1"
EM_INIT = REPO / "results_elasticity_maml" / "tpu_run1"
LDE_INIT = REPO / "results_elasticity_leap" / "lde1"
_NN_FAMILY_COMMON = ["--model.omega=30", "--model.omega0=30", "--train.optimizer=adam",
                     "--task.bc_weight=1.0", "--task.outer_points=1024",
                     "--task.validation_points=1024", "--train.log_every=5",
                     "--train.val_every=5", "--train.viz_every=0",
                     "--train.checkpoint_every=0"]
_NN_BURGERS = ["--task.pde=td_burgers", "--task.domain.xmin=0.0", "--task.max_reynolds=100",
               "--task.num_tsteps=201", "--task.vary_source=false",
               "--solver.ground_truth_resolution=512", *_NN_FAMILY_COMMON]
NN_BURGERS_MAML_FLAGS = _NN_BURGERS + ["--model.num_layers=8", "--model.layer_size=64",
                                       "--maml.outer_lr=1e-5", "--maml.grad_clip=100",
                                       "--maml.inner_steps=5", "--maml.inner_lr=1e-4"]
NN_BURGERS_LEAP_FLAGS = _NN_BURGERS + ["--task.vary_bc=false", "--model.num_layers=10",
                                       "--model.layer_size=128", "--maml.outer_lr=1e-5"]
_NN_ELAS = ["--task.pde=hyper_elasticity", "--task.domain.xmin=0.0", "--task.domain.ymin=0.0",
            "--task.max_holes=5", "--task.vary_source=false", "--task.vary_bc=false",
            *_NN_FAMILY_COMMON]
NN_ELAS_MAML_FLAGS = _NN_ELAS + ["--task.max_hole_size=1.0",
                                 "--solver.ground_truth_resolution=32",
                                 "--model.num_layers=8", "--model.layer_size=64",
                                 "--maml.outer_lr=1e-5", "--maml.grad_clip=100",
                                 "--maml.inner_steps=5", "--maml.inner_lr=1e-5"]
NN_ELAS_LEAP_FLAGS = _NN_ELAS + ["--task.max_hole_size=0.5",
                                 "--solver.ground_truth_resolution=48",
                                 "--model.num_layers=10", "--model.layer_size=128",
                                 "--maml.outer_lr=5e-6"]
# cut for the smoke's time, the steps first, then the seeds: 100 of the
# scripts' 200 steps, compared with the JAX medians at step 95, on 2 of
# their 8 seeds (the runs are deterministic: the 200-step runs of 4 seeds
# gave the same medians to 4 digits in two calls)
NN_FAMILY_STEPS = 100
NN_FAMILY_SEEDS = (1, 2)
NN_FAMILY_REPORT = (0,)
# The bar: the JAX package's median over seeds 1-8 of val_rel_err at step
# 95 of 100 (and at step 0, and of each seed's best) from the same init
# checkpoint with the script's other flags, on a CPU:
#   env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_nn_sweep_bar.py
JAX_NN_BURGERS_MAML = {"step_0": 0.23263408243656158, "step_95": 8.683187479618937e-05,
                       "best": 7.326563354581594e-05}
JAX_NN_BURGERS_LEAP = {"step_0": 0.10147755220532417, "step_95": 0.0019697873503901064,
                       "best": 0.0004415438597789034}
JAX_NN_ELAS_MAML = {"step_0": 0.005907169776037335, "step_95": 0.0064213990699499846,
                    "best": 0.004898502491414547}
JAX_NN_ELAS_LEAP = {"step_0": 0.0018094299593940377, "step_95": 0.00199914030963555,
                    "best": 0.0012274113250896335}
# Printed beside, not held to: the 8-seed medians of the JAX package's runs
# in results_burgers_deploy/ and results_elasticity_deploy/ (200 steps;
# deploy_{maml,leap}_seed_{1..8}/metrics.jsonl), which loaded other inits
# (their log.txt: bm6, ldb3_2, em5 and lde1_1), the bar before these
JAX_NN_CROSS_INIT = {
    "burgers_maml": {"step_0": 0.36352650821208954, "step_95": 6.968272646190599e-05,
                     "step_195": 6.590400153072551e-05, "best": 4.374263698991854e-05},
    "burgers_leap": {"step_0": 0.28711598366498947, "step_95": 0.000805711024440825,
                     "step_195": 0.000432249580626376, "best": 0.00030512696685036644},
    "elasticity_maml": {"step_0": 0.0063771759159862995, "step_95": 0.007547663291916251,
                        "step_195": 0.007870134664699435, "best": 0.005118096945807338},
    "elasticity_leap": {"step_0": 0.0039778961800038815, "step_95": 0.0019869357347488403,
                        "step_195": 0.00209752784576267, "best": 0.0012615617597475648}}


def phase_leap_family_parity():
    """One LEAP outer step from ldb3_2's checkpoint_step_40000 and from
    lde2_3's best checkpoint, each with its Adam state, from sbi10_2's
    params (steady Burgers, 5x64) and from a fresh poisson3d init at the
    one-chip width (5x128), each with a fresh Adam state, on the card and on
    the CPU on shared host draws (TF32 off): params within TRAIN_LEAF_TOL of
    each leaf's scale, meta-losses within TRAIN_LOSS_RTOL, the meta-gradient
    within LEAP_GRAD_LEAF_TOL of each leaf's largest entry and
    LEAP_GRAD_TREE_TOL of its norm."""
    t0 = time.perf_counter()
    runs = {}
    cases = [(name, parse_overrides(load_run_config(str(run)), LEAP_FAMILY_PARITY_CUTS), ckpt,
              True) for name, run, ckpt in (("ldb3_2", LDB_RUN, LDB_CKPT),
                                            ("lde2_3", LDE_RUN, LDE_BEST_CKPT))]
    # LEAP on steady Burgers from sbi10_2's MAML params and on poisson3d
    # from a fresh init, each with a fresh Adam state
    cases += [("sbi10_2", parse_overrides(load_run_config(str(SB_RUN)),
                                          LEAP_FAMILY_PARITY_CUTS), SB_CKPT, False),
              ("poisson3d", parse_overrides(Config(), P3D_FLAGS + LEAP_FAMILY_PARITY_CUTS),
               None, False)]
    for name, cfg, ckpt, with_adam in cases:
        ck = checkpoints.load_checkpoint(str(ckpt)) if ckpt else {"step": 0}
        if with_adam:
            state = (params_from_numpy(ck["params"]),
                     optimizers.from_jax_state(cfg.train.optimizer, ck["opt_state"]))
        else:
            c = leap_driver.build(cfg, "cpu")
            params = params_from_numpy(ck["params"]) if ckpt else c["init_params"]
            state = (params, c["outer_opt"].init(params))
        rows, t_card, t_cpu = _leap_train_both(cfg, 1, state)
        r = rows[0]
        if not (r["meta_grad_leaf_err"] <= LEAP_GRAD_LEAF_TOL
                and r["meta_grad_tree_err"] <= LEAP_GRAD_TREE_TOL):
            raise AssertionError(f"{name}: meta-gradient card vs CPU beyond "
                                 f"{LEAP_GRAD_LEAF_TOL} of a leaf's largest entry or "
                                 f"{LEAP_GRAD_TREE_TOL} of its norm: {r}")
        runs[name] = {"checkpoint": str(ckpt.relative_to(REPO)) if ckpt else None,
                      "step": int(ck["step"]), "family": cfg.task.pde,
                      "width": f"{cfg.model.num_layers}x{cfg.model.layer_size}",
                      "points": cfg.task.inner_points, "card_s": t_card, "cpu_s": t_cpu, **r}
    emit("leap_family_parity", t0, reduced=LEAP_FAMILY_PARITY_CUTS, leaf_tol=TRAIN_LEAF_TOL,
         loss_rtol=TRAIN_LOSS_RTOL, grad_leaf_tol=LEAP_GRAD_LEAF_TOL,
         grad_tree_tol=LEAP_GRAD_TREE_TOL, runs=runs)


def _leap_family_train(name, run, ckpt, jax_same, jax_last, num_tsteps=None):
    """cli/leap_pde --from_run on a copy of `run` (its config.json and
    `ckpt`), resumed from `ckpt` with its Adam state at full width and
    depth: LEAP_FAMILY_STEPS steps and one validation through the kernel
    against the ground truth of the config's resolution, the run's files,
    metrics keys and final checkpoint held to the JAX run's; a resumed run
    that solves nothing; then one timed step and one profiled."""
    t0 = time.perf_counter()
    start = int(checkpoints.load_checkpoint(str(ckpt))["step"]) + 1
    end = start + LEAP_FAMILY_STEPS
    cuts = {"train.outer_steps": end, "train.steps_per_call": LEAP_FAMILY_STEPS,
            "train.val_every": end, "train.log_every": end, "train.checkpoint_every": 0,
            "model.use_pallas_inference": "true"}
    with tempfile.TemporaryDirectory() as tmp:
        src = _run_copy(tmp, run, ("config.json", ckpt.name))
        out = Path(tmp) / "out"
        args = [f"--from_run={src}", *(f"--{k}={v}" for k, v in cuts.items()),
                f"--train.out_dir={out}"]
        launches0 = spans.counter("siren_fused.launches")
        leap_pde.main(args + ["--train.expt_name=smoke", f"--train.load_model_from_expt={src}"])
        torch.cuda.synchronize()
        launches = spans.counter("siren_fused.launches") - launches0
        run_dir = out / "smoke"
        for f in ("log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle",
                  f"checkpoint_step_{end}.pickle"):
            if not (run_dir / f).exists():
                raise AssertionError(f"{name}: the LEAP training run wrote no {f}")
        if f"resuming optimizer state at step {start}" not in (run_dir / "log.txt").read_text():
            raise AssertionError(f"{name}: the run did not resume {ckpt.name}'s Adam state")
        recs = [json.loads(l) for l in (run_dir / "metrics.jsonl").read_text().splitlines()]
        jax_keys = sorted(json.loads((run / "metrics.jsonl").read_text().splitlines()[0]))
        if [r["step"] for r in recs] != [end - 1] or sorted(recs[0]) != jax_keys:
            raise AssertionError(f"{name}: records at {[r['step'] for r in recs]} with keys "
                                 f"{sorted(recs[0]) if recs else []}; the JAX run's {jax_keys}")
        r = recs[0]
        bar = LEAP_FAMILY_FACTOR * jax_same
        for k in ("meta_loss", "val_meta_loss", "val_rel_err", "val_mse"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{name} step {r['step']}: {k} = {r[k]}")
        if not all(map(math.isfinite, r["per_step_losses"])):
            raise AssertionError(f"{name}: per_step_losses {r['per_step_losses']}")
        if not r["val_rel_err"] <= bar:
            raise AssertionError(f"{name}: val_rel_err {r['val_rel_err']} above {bar} "
                                 f"({LEAP_FAMILY_FACTOR} x the JAX package's {jax_same} on "
                                 "the same eval tasks)")
        if num_tsteps is not None and (len(r["per_time_step_error"]) != num_tsteps or not all(
                map(math.isfinite, r["per_time_step_error"]))):
            raise AssertionError(f"{name}: per_time_step_error has "
                                 f"{len(r['per_time_step_error'])} entries, not {num_tsteps} "
                                 "finite")
        if launches != len(recs):
            raise AssertionError(f"{name}: siren_fused launched {launches} times for "
                                 f"{len(recs)} validation calls")
        ckpt_keys = _check_final_checkpoint(run_dir / f"checkpoint_step_{end}.pickle", ckpt,
                                            keys=("params",))
        first = _gt_log(run_dir)
        t1 = time.perf_counter()
        leap_pde.main(args + ["--train.expt_name=resumed",
                              f"--train.load_model_from_expt={run_dir}",
                              f"--train.outer_steps={end + 1}"])
        resumed_s = time.perf_counter() - t1
        resumed = _gt_log(out / "resumed")
        if f"resuming optimizer state at step {end}" not in (
                out / "resumed" / "log.txt").read_text():
            raise AssertionError(f"{name}: the resumed run did not take the port's checkpoint")
        final = checkpoints.load_checkpoint(str(run_dir / f"checkpoint_step_{end}.pickle"))
    cfg = load_run_config(str(run))
    n_eval = cfg.task.n_eval
    if first != (n_eval, 0) or resumed != (0, n_eval):
        raise AssertionError(f"{name}: ground truth (solved, read) {first} then {resumed}")
    bench = _step_numbers(cfg, leap_driver.build(cfg, "cuda"),
                          (params_from_numpy(final["params"], "cuda"),
                           params_from_numpy(final["torch_opt_state"], "cuda", dtype=None)),
                          lambda o: (o[:2], o[2][:, -1].mean()), timed=1)
    row = {"launches": launches, "validations": len(recs), "val_rel_err": r["val_rel_err"],
           "val_rel_err_median": r["val_rel_err_median"], "bar": bar,
           "meta_loss": r["meta_loss"], "deployment_time": r["deployment_time"],
           "step_time": r["step_time"], "gt_solved_read": first,
           "resumed_gt_solved_read": resumed, "resumed_s": resumed_s, **bench}
    emit(name, t0, reduced=cuts, resumed_from=str(ckpt.relative_to(REPO)),
         width=f"{cfg.model.num_layers}x{cfg.model.layer_size}", bsize=cfg.leap.bsize,
         inner_steps=cfg.leap.inner_steps, points=cfg.task.inner_points, n_eval=n_eval,
         ground_truth_resolution=cfg.solver.ground_truth_resolution,
         jax_same_tasks_val_rel_err=jax_same, jax_last_val_rel_err=jax_last,
         ratio_to_jax_last=r["val_rel_err"] / jax_last, checkpoint_keys=ckpt_keys,
         per_time_step_error_max=(max(r["per_time_step_error"]) if num_tsteps else None),
         **row)
    return row


def phase_leap_burgers_train():
    return _leap_family_train("leap_burgers_train", LDB_RUN, LDB_CKPT, JAX_LDB_SAME_TASKS_VAL,
                              JAX_LDB_LAST_VAL,
                              num_tsteps=load_run_config(str(LDB_RUN)).task.num_tsteps)


def phase_leap_elasticity_train():
    return _leap_family_train("leap_elasticity_train", LDE_RUN, LDE_LATEST_CKPT,
                              JAX_LDE_SAME_TASKS_VAL, JAX_LDE_LAST_VAL)


def _nn_family(name, sweeps):
    """Both commands of one script through cli/sweep, their jobs all at once
    (sweeps: (expt name, driver, flags, init run, its checkpoint, JAX
    medians, warm-up)), then each command's fine-tune step alone on the
    card."""
    t0 = time.perf_counter()
    rows = _nn_sweeps(
        [(expt, driver, flags, init, jax_med, warm,
          201 if "--task.pde=td_burgers" in flags else None)
         for expt, driver, flags, init, _, jax_med, warm in sweeps],
        seeds=NN_FAMILY_SEEDS, steps=NN_FAMILY_STEPS, report=NN_FAMILY_REPORT)
    for expt, _, flags, _, ckpt, _, _ in sweeps:
        rows[expt]["jax_cross_init_median"] = JAX_NN_CROSS_INIT[expt]
        rows[expt]["step"] = _nn_step_numbers(flags, _nn_state(ckpt, "cuda"))
    emit(name, t0, **rows)
    return rows


def phase_nn_deploy_burgers():
    """pipeline/deployment_burgers.sh's two commands through cli/sweep:
    nn_pde_maml from results_burgers_maml/tpu_run1 (8x64, the MAML warm-up)
    and nn_pde from results_burgers_leap/ldb3_1 (10x128), FV ground truth
    at 512 x 201 through the shared cache, per-timestep validation."""
    return _nn_family("nn_deploy_burgers", (
        ("burgers_maml", "nn_pde_maml", NN_BURGERS_MAML_FLAGS, BURGERS_MAML_INIT,
         BURGERS_MAML_INIT / "checkpoint_step_60001.pickle", JAX_NN_BURGERS_MAML, True),
        ("burgers_leap", "nn_pde", NN_BURGERS_LEAP_FLAGS, LDB_INIT,
         LDB_INIT / "checkpoint_step_19999.pickle", JAX_NN_BURGERS_LEAP, False)))


def phase_nn_deploy_elasticity():
    """pipeline/deployment_elasticity.sh's two commands through cli/sweep:
    nn_pde_maml from results_elasticity_maml/tpu_run1 (8x64, ground truth
    at 32, max_hole_size 1.0) and nn_pde from results_elasticity_leap/lde1
    (10x128, ground truth at 48, 0.5), the mirror-symmetric validation."""
    return _nn_family("nn_deploy_elasticity", (
        ("elasticity_maml", "nn_pde_maml", NN_ELAS_MAML_FLAGS, EM_INIT,
         EM_INIT / "checkpoint_step_60001.pickle", JAX_NN_ELAS_MAML, True),
        ("elasticity_leap", "nn_pde", NN_ELAS_LEAP_FLAGS, LDE_INIT,
         LDE_INIT / "checkpoint_step_27999.pickle", JAX_NN_ELAS_LEAP, False)))


def _baseline(tmp, name, args):
    """cli/solver_baseline into `tmp`; (its rows, its reference seconds a task)."""
    rows = solver_baseline.main(["--task.pde=poisson", f"--train.out_dir={tmp}",
                                 f"--train.expt_name={name}", *args])
    line = next(l for l in (Path(tmp) / name / "log.txt").read_text().splitlines()
                if l.startswith("reference solves: "))
    return rows, float(line.split()[2])


def phase_solver_baseline():
    """cli/solver_baseline on the card: BASELINE_N_EVAL tasks at
    resolutions 4, 8, 16 against the float64 reference at 32, rel_mse
    falling with resolution and within BASELINE_FACTOR either way of the
    JAX package's on the same tasks (the committed JAX sweep's ratio
    printed beside); then cli/gt_convergence (Poisson, one task
    at 4 and 8 against 16) on the card and on the CPU (_solver_cpu, started
    with the later solver phases' CPU sides): sqrt(rel_mse) within
    BASELINE_PARITY_RMS_TOL."""
    t0 = time.perf_counter()
    _solver_cpu("solver_baseline")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rows, ref_s = _baseline(tmp, "res_sweep", [
                f"--solver.ground_truth_resolution={BASELINE_REF}",
                "--resolutions=" + ",".join(map(str, BASELINE_RESOLUTIONS)),
                f"--task.n_eval={BASELINE_N_EVAL}"])
            written = (Path(tmp) / "res_sweep" / "errors_by_resolution.json").exists()
        t1 = time.perf_counter()
        with io.StringIO() as buf, contextlib.redirect_stdout(buf):
            card = gt_convergence.main(BASELINE_CONV_ARGS)
        conv_s = time.perf_counter() - t1
        out = _cpu_result("solver_baseline")
    finally:
        _kill_children()
    cpu_rows = [json.loads(l) for l in out.splitlines() if l.startswith('{"resolution"')]
    committed = json.loads(BASELINE_JSON.read_text())
    mse = [rows[str(r)]["rel_mse"] for r in BASELINE_RESOLUTIONS]
    ratio = {r: rows[str(r)]["rel_mse"] / JAX_SAME_TASKS_REL_MSE[r]
             for r in BASELINE_RESOLUTIONS}
    rel = {a["resolution"]: abs(a["rel_mse"] - b["rel_mse"]) / b["rel_mse"]
           for a, b in zip(card, cpu_rows)}
    rms = {a["resolution"]: abs(math.sqrt(a["rel_mse"]) - math.sqrt(b["rel_mse"]))
           for a, b in zip(card, cpu_rows)}
    if not (written and all(a > b for a, b in zip(mse, mse[1:]))):
        raise AssertionError(f"solver_baseline: rel_mse {mse} not falling, or no JSON written")
    if not all(1 / BASELINE_FACTOR <= q <= BASELINE_FACTOR for q in ratio.values()):
        raise AssertionError(f"solver_baseline: rel_mse / the JAX package's on the same tasks "
                             f"{ratio}, beyond {BASELINE_FACTOR}x")
    if len(rms) != len(BASELINE_PARITY_RESOLUTIONS) or not max(rms.values()) <= \
            BASELINE_PARITY_RMS_TOL:
        raise AssertionError(f"gt_convergence: card vs CPU sqrt(rel_mse) {rms} beyond "
                             f"{BASELINE_PARITY_RMS_TOL}")
    emit("solver_baseline", t0, tasks=BASELINE_N_EVAL, reference_resolution=BASELINE_REF,
         reference_s_per_task=ref_s, rows=rows, jax_same_tasks=JAX_SAME_TASKS_REL_MSE,
         ratio_to_jax_same_tasks=ratio, factor=BASELINE_FACTOR,
         committed_jax_rows={str(r): committed[str(r)] for r in BASELINE_RESOLUTIONS},
         ratio_to_committed={r: rows[str(r)]["rel_mse"] / committed[str(r)]["rel_mse"]
                             for r in BASELINE_RESOLUTIONS},
         committed_note="baselines/poisson: 16 other tasks, reference at 64, means carried "
         "by a few hard tasks; set beside, not held to",
         gt_convergence={"card": card, "cpu": cpu_rows, "rel": rel, "rms_diff": rms,
                         "rms_tol": BASELINE_PARITY_RMS_TOL, "card_s": conv_s})


# --- the classical-solver side of TD-Burgers, hyperelasticity and steady
# Burgers (pipeline/baseline.sh, cpu_queue_round14.sh's two-axis sweeps,
# baselines/steady_burgers/gt_convergence.jsonl) --------------------------

# Each rel_mse within 1e-2 relative of the JAX package's on the port's own
# tasks and coords (its solvers, its float64 reference, its evaluation),
# from tests/jax_solver_sweep_bar.py on a CPU with the command beside each
# table; the card against the CPU on one task by sqrt(rel_mse) within
# BASELINE_PARITY_RMS_TOL (1e-5)
SWEEP_JAX_RTOL = 1e-2
# baseline.sh's TD-Burgers command uncut (FV reference at 512 in float64, 8
# tasks, 9 output times), then cpu_queue_round14.sh's num_tsteps axis (51,
# 201, 801 about its 201) about the 9 at one resolution on one task (the
# card-vs-CPU comparison)
BURGERS_SWEEP_FLAGS = ["--task.pde=td_burgers", "--task.domain.xmin=0.0",
                       "--task.vary_source=false", "--task.max_reynolds=100",
                       "--task.num_tsteps=9", "--solver.ground_truth_resolution=512",
                       "--task.n_eval=8"]
BURGERS_SWEEP_RESOLUTIONS = (16, 32, 64, 128, 256)
BURGERS_SWEEP_AXIS2 = (64, "num_tsteps", (5, 9, 33))
BURGERS_SWEEP_REDUCED = {"axis2 num_tsteps": "51,201,801 about 201 on 4 tasks -> 5,9,33 "
                                             "about 9 at resolution 64 on 1 task"}
# tests/jax_solver_sweep_bar.py <the flags> --n_eval=8 --ref=512
#   --resolutions=16,32,64,128,256; then --n_eval=1 --resolutions=64
#   --axis2=num_tsteps:5,9,33
JAX_BURGERS_SAME_TASKS = {"16": 0.02044256393878939, "32": 0.0066570638418489095,
                          "64": 0.0019484726255065252, "128": 0.00043480284556354906,
                          "256": 5.342175209587893e-05, "64,num_tsteps=5": 0.056243572943702934,
                          "64,num_tsteps=9": 0.0033910190014777635,
                          "64,num_tsteps=33": 0.0033910190014777635}
# baseline.sh's hyperelasticity command (reference at 64, resolutions 4, 8,
# 16, 32, 8 tasks) cut to the clock: 1 task (its ligament floor is 11, so 4
# and 8 solve one lattice: 4 dropped) and cpu_queue_round14.sh's
# boundary_cap axis at resolution 8, a cap of 8 beside the default 192
ELAS_SWEEP_FLAGS = ["--task.pde=hyper_elasticity", "--task.domain.xmin=0.0",
                    "--task.domain.ymin=0.0", "--task.max_holes=5",
                    "--task.max_hole_size=1.0", "--task.vary_source=false",
                    "--task.vary_bc=false", "--solver.ground_truth_resolution=64",
                    "--task.n_eval=1"]
ELAS_SWEEP_RESOLUTIONS = (8, 16, 32)
ELAS_SWEEP_AXIS2 = (8, "boundary_cap", (8, 192))
ELAS_SWEEP_REDUCED = {"task.n_eval": "8 -> 1", "resolutions": "4,8,16,32 -> 8,16,32",
                      "axis2 boundary_cap": "48,96,192 -> 8,192 at resolution 8"}
# tests/jax_solver_sweep_bar.py <the flags> --n_eval=1 --ref=64
#   --resolutions=8,16,32; then --resolutions=8 --axis2=boundary_cap:8,192
JAX_ELAS_SAME_TASKS = {"8": 0.0064991866019509775, "16": 0.002409478116875215,
                       "32": 0.00093817434363767, "8,boundary_cap=8": 0.07490928253134559,
                       "8,boundary_cap=192": 0.0064991866019509775}
# cli/gt_convergence on one steady Burgers task (seed 0) at 16, 24 and 32
# against its float64 reference at 48 (the committed run's 96 cut: a
# float64 solve at 96 takes minutes on a CPU)
STEADY_CONV_ARGS = ["--task.pde=steady_burgers", "--resolutions=16,24,32",
                    "--ref_resolution=48", "--n_tasks=1"]
STEADY_CONV_REDUCED = {"ref_resolution": "96 -> 48", "n_tasks": "4 -> 1",
                       "resolutions": "16,24,32,48 -> 16,24,32"}
# tests/jax_solver_sweep_bar.py --task.pde=steady_burgers --gt_convergence
#   --n_eval=1 --ref=48 --resolutions=16,24,32
JAX_STEADY_SAME_TASK = {"16": 0.2555787736267877, "24": 0.004443109203005451,
                        "32": 0.0004324142065702798}
STEADY_CONV_JSONL = REPO / "baselines" / "steady_burgers" / "gt_convergence.jsonl"


def _one_task(flags):
    return [a for a in flags if not a.startswith("--task.n_eval=")] + ["--task.n_eval=1"]


def _res_arg(resolutions):
    return "--resolutions=" + ",".join(map(str, resolutions))


def _axis_args(flags, axis2):
    """The second-axis command of a family's flags on one task: axis2 =
    (resolution, keyword, values)."""
    res, key, values = axis2
    return [*_one_task(flags), f"--resolutions={res}",
            f"--axis2={key}:" + ",".join(map(str, values))]


# The CPU side of each solver phase: every one is started, each in a
# process of its own (_spawn) with a quarter of the host's cores, when the
# first is asked for, so that they run beside the card's sweeps; a phase
# spares the others' when it ends (_AWAITED)
_SOLVER_CPU = {}


def _solver_cpu_args(out):
    """Phase -> (cli module, its arguments) of each CPU side; the sweeps
    write into `out`."""
    def sweep(name, flags, axis2):
        return ("solver_baseline", [*_axis_args(flags, axis2), f"--train.out_dir={out}",
                                    f"--train.expt_name={name}"])
    return {"solver_baseline": ("gt_convergence", BASELINE_CONV_ARGS),
            "solver_baseline_burgers": sweep("solver_baseline_burgers", BURGERS_SWEEP_FLAGS,
                                             BURGERS_SWEEP_AXIS2),
            "solver_baseline_elasticity": sweep("solver_baseline_elasticity",
                                                ELAS_SWEEP_FLAGS, ELAS_SWEEP_AXIS2),
            "gt_convergence_steady": ("gt_convergence", STEADY_CONV_ARGS)}


def _solver_cpu(name):
    """The CPU side of solver phase `name`, every phase's started at the
    first call: (its process, the directory a sweep writes to)."""
    if not _SOLVER_CPU:
        out = Path(tempfile.mkdtemp(prefix="chip_smoke_cpu_"))
        atexit.register(shutil.rmtree, out, True)
        env = dict(os.environ, OMP_NUM_THREADS=str(max(1, len(os.sched_getaffinity(0)) // 4)))
        for phase, (module, args) in _solver_cpu_args(out).items():
            _SOLVER_CPU[phase] = (_spawn(
                [sys.executable, "-m", f"metapde_tpu_torch.cli.{module}", "--device=cpu",
                 *args], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env), out)
            _AWAITED.append(_SOLVER_CPU[phase][0])
    return _SOLVER_CPU[name]


def _awaited_output(proc, name, timeout=600):
    """The stdout of an awaited process once it exits 0; no longer spared."""
    out, err = proc.communicate(timeout=timeout)
    if proc in _AWAITED:
        _AWAITED.remove(proc)
    if proc.returncode != 0:
        raise AssertionError(f"{name}: the process exited {proc.returncode}: {err[-3000:]}")
    return out


def _cpu_result(name, timeout=600):
    """The stdout of phase `name`'s CPU side once it exits 0."""
    return _awaited_output(_solver_cpu(name)[0], name, timeout)


def _rms_diffs(card, cpu):
    """|sqrt(card rel_mse) - sqrt(cpu rel_mse)| by label; both must hold the
    same labels."""
    if sorted(card) != sorted(cpu):
        raise AssertionError(f"card labels {sorted(card)}, CPU labels {sorted(cpu)}")
    return {k: abs(math.sqrt(card[k]) - math.sqrt(cpu[k])) for k in card}


def _hold_to_jax(name, rows, jax_rows):
    """Each label's rel_mse / the JAX package's on the same tasks, within
    SWEEP_JAX_RTOL of 1."""
    if sorted(rows) != sorted(jax_rows):
        raise AssertionError(f"{name}: labels {sorted(rows)}, the JAX bar's {sorted(jax_rows)}")
    rel = {k: rows[k] / jax_rows[k] - 1.0 for k in rows}
    if not max(map(abs, rel.values())) <= SWEEP_JAX_RTOL:
        raise AssertionError(f"{name}: rel_mse against the JAX package's on the same tasks "
                             f"off by {rel} (bar {SWEEP_JAX_RTOL})")
    return rel


def _solver_family(name, flags, resolutions, axis2, jax_same, committed):
    """cli/solver_baseline on the card with `flags` at `resolutions`, then
    on one task at axis2 = (resolution, keyword, values), that command also
    on the CPU (_solver_cpu). Bars: rel_mse falling with resolution, every
    label within SWEEP_JAX_RTOL of the JAX package's on the same tasks, card
    vs CPU sqrt(rel_mse) within BASELINE_PARITY_RMS_TOL. The committed JAX
    sweeps (`committed`: name -> path) are printed beside."""
    t0 = time.perf_counter()
    _, cpu_out = _solver_cpu(name)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            t1 = time.perf_counter()
            rows, ref_s = _baseline(tmp, "res_sweep", [*flags, _res_arg(resolutions)])
            sweep_s = time.perf_counter() - t1
            rows2, _ = _baseline(tmp, "sweep2axis", _axis_args(flags, axis2))
            _cpu_result(name)
            cpu_rows = json.loads((cpu_out / name / "errors_by_resolution.json").read_text())
        finally:
            _kill_children()
    mse = [rows[str(r)]["rel_mse"] for r in resolutions]
    if not all(a > b for a, b in zip(mse, mse[1:])):
        raise AssertionError(f"{name}: rel_mse {mse} at {resolutions} not falling")
    every = {**{k: r["rel_mse"] for k, r in rows.items()},
             **{k: r["rel_mse"] for k, r in rows2.items()}}
    rel = _hold_to_jax(name, every, jax_same)
    rms = _rms_diffs({k: r["rel_mse"] for k, r in rows2.items()},
                     {k: r["rel_mse"] for k, r in cpu_rows.items()})
    if not max(rms.values()) <= BASELINE_PARITY_RMS_TOL:
        raise AssertionError(f"{name}: card vs CPU sqrt(rel_mse) {rms} beyond "
                             f"{BASELINE_PARITY_RMS_TOL}")
    beside = {}
    for label, path in committed.items():
        saved = json.loads(path.read_text())
        beside[label] = {"rows": {k: saved[k]["rel_mse"] for k in saved},
                         "ratio": {k: every[k] / saved[k]["rel_mse"] for k in saved
                                   if k in every}}
    return {"rows": rows, "axis2_rows": rows2, "reference_s_per_task": ref_s,
            "sweep_s": sweep_s, "jax_same_tasks": jax_same, "rel_to_jax": rel,
            "jax_rtol": SWEEP_JAX_RTOL, "cpu_axis2_rows": cpu_rows,
            "rms_diff": rms, "rms_tol": BASELINE_PARITY_RMS_TOL,
            "committed_jax": beside, "t0": t0}


def phase_solver_baseline_burgers():
    """pipeline/baseline.sh's TD-Burgers command through cli/solver_baseline
    on the card (FV reference at 512 in float64, 8 tasks, resolutions 16 to
    256), then the num_tsteps axis at resolution 64 (_solver_family)."""
    r = _solver_family("solver_baseline_burgers", BURGERS_SWEEP_FLAGS,
                       BURGERS_SWEEP_RESOLUTIONS, BURGERS_SWEEP_AXIS2, JAX_BURGERS_SAME_TASKS,
                       {"baselines/td_burgers": REPO / "baselines" / "td_burgers" /
                        "errors_by_resolution.json",
                        "baselines/td_burgers/sweep2axis": REPO / "baselines" / "td_burgers" /
                        "sweep2axis" / "errors_by_resolution.json"})
    emit("solver_baseline_burgers", r.pop("t0"), flags=BURGERS_SWEEP_FLAGS,
         axis2=BURGERS_SWEEP_AXIS2, reduced=BURGERS_SWEEP_REDUCED, **r,
         committed_note="baselines/td_burgers: other tasks (the JAX package's key chain); "
         "sweep2axis at num_tsteps 201 and a reference at 1024: set beside, not held to")


def phase_solver_baseline_elasticity():
    """pipeline/baseline.sh's hyperelasticity command through
    cli/solver_baseline on the card, cut (ELAS_SWEEP_REDUCED), then the
    boundary_cap axis at resolution 8 (_solver_family); then one task's
    solve at 32 timed on the host and the card's evaluate_p1 of its 1024
    validation points timed apart (CUDA events)."""
    r = _solver_family("solver_baseline_elasticity", ELAS_SWEEP_FLAGS, ELAS_SWEEP_RESOLUTIONS,
                       ELAS_SWEEP_AXIS2, JAX_ELAS_SAME_TASKS,
                       {"baselines/hyper_elasticity": REPO / "baselines" / "hyper_elasticity" /
                        "errors_by_resolution.json",
                        "baselines/hyper_elasticity/sweep2axis": REPO / "baselines" /
                        "hyper_elasticity" / "sweep2axis" / "errors_by_resolution.json"})
    cfg = parse_overrides(Config(), ELAS_SWEEP_FLAGS)
    pde = get_pde(cfg.task)
    gen = torch.Generator().manual_seed(cfg.seed)
    task = tuple(a.to("cuda") for a in pde.sample_params(gen))
    pts = pde.sample_validation_points(gen, cfg.task.validation_points, task).to("cuda")
    solve_s = []
    for _ in range(2):
        t1 = time.perf_counter()
        gt = pde.solve(task, resolution=32)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t1)
    eval_ms = cuda_ms(lambda: pde.evaluate_gt(gt, pts))
    emit("solver_baseline_elasticity", r.pop("t0"), flags=ELAS_SWEEP_FLAGS,
         axis2=ELAS_SWEEP_AXIS2, reduced=ELAS_SWEEP_REDUCED, **r,
         solve_host_s_at_32=solve_s[-1], evaluate_p1_card_ms=eval_ms,
         evaluate_points=int(pts.shape[0]),
         committed_note="baselines/hyper_elasticity: other tasks, the JAX package's "
         "resolutions 12, 24, 48 (sweep2axis 8, 16, 32 by boundary_cap 48, 96, 192, 4 tasks): "
         "set beside, not held to")


def phase_gt_convergence_steady():
    """cli/gt_convergence on one steady Burgers task at 16, 24 and 32
    against its float64 reference at 48 (STEADY_CONV_REDUCED), on the card
    and on the CPU (_solver_cpu): rel_mse falling
    with resolution, within SWEEP_JAX_RTOL of the JAX package's on the
    same task and points, card vs CPU sqrt(rel_mse) within
    BASELINE_PARITY_RMS_TOL; the committed JSONL (4 other tasks, reference
    at 96) printed beside."""
    t0 = time.perf_counter()
    _solver_cpu("gt_convergence_steady")
    try:
        t1 = time.perf_counter()
        with io.StringIO() as buf, contextlib.redirect_stdout(buf):
            card = gt_convergence.main(STEADY_CONV_ARGS)
        card_s = time.perf_counter() - t1
        cpu_rows = [json.loads(l) for l in _cpu_result("gt_convergence_steady").splitlines()
                    if l.startswith('{"resolution"')]
    finally:
        _kill_children()
    rows = {str(r["resolution"]): r["rel_mse"] for r in card}
    mse = list(rows.values())
    if not all(a > b for a, b in zip(mse, mse[1:])):
        raise AssertionError(f"gt_convergence_steady: rel_mse {rows} not falling")
    rel = _hold_to_jax("gt_convergence_steady", rows, JAX_STEADY_SAME_TASK)
    rms = _rms_diffs(rows, {str(r["resolution"]): r["rel_mse"] for r in cpu_rows})
    if not max(rms.values()) <= BASELINE_PARITY_RMS_TOL:
        raise AssertionError(f"gt_convergence_steady: card vs CPU sqrt(rel_mse) {rms} beyond "
                             f"{BASELINE_PARITY_RMS_TOL}")
    committed = [json.loads(l) for l in STEADY_CONV_JSONL.read_text().splitlines()]
    emit("gt_convergence_steady", t0, args=STEADY_CONV_ARGS, reduced=STEADY_CONV_REDUCED,
         rows=rows, time_per_solve_s={str(r["resolution"]): r["time_per_solve_s"]
                                      for r in card},
         card_s=card_s, jax_same_task=JAX_STEADY_SAME_TASK, rel_to_jax=rel,
         jax_rtol=SWEEP_JAX_RTOL, cpu=cpu_rows, rms_diff=rms, rms_tol=BASELINE_PARITY_RMS_TOL,
         committed_jax=committed[-1]["rel_mse_by_resolution"],
         committed_note="baselines/steady_burgers: 4 other tasks against 96; set beside")


# --- the parallel layer: sharded meta-training over torch.distributed -----

# bench.py's flagship (train_bench.FLAGSHIP) as CLI flags; the phase checks
# that they parse to it
FLAGSHIP_FLAGS = ["--task.inner_points=1024", "--task.outer_points=1024",
                  "--task.validation_points=1024", "--task.n_eval=8", "--task.bc_weight=1.0",
                  "--task.sample_with_replacement=true", "--model.num_layers=3",
                  "--model.layer_size=64", "--model.omega=30", "--model.omega0=30",
                  "--model.compute_dtype=bfloat16", "--maml.bsize=16", "--maml.inner_steps=5",
                  "--maml.inner_lr=1e-4", "--maml.outer_lr=1e-5", "--maml.inner_grad_clip=100",
                  "--maml.grad_clip=100", "--maml.unroll=5", "--train.remat_inner_steps=false"]
# (a) the flagship on the 2 x 2 mesh, f32 and bf16 (2 x 1 and 1 x 2 cut
# to pay for the Burgers and hyperelasticity pipelines: the 2 x 2
# mesh runs both the task and the point collectives, and (c) keeps LEAP's
# one-axis meshes; each flagship mesh took 45-50 s on one H100), and (d1)
# one MAML step of bm7_5's, em7_9's and sbi10_2's configs (cli/distributed_
# smoke's MAML bars, 1e-4): one launch of the ranks, 1 timed and 1 profiled
# step each (the flagship's second timed step cut to pay for (d))
MESH_FLAGSHIP_MESHES = "2x2"
MESH_VARIANTS = {"flagship_f32": FLAGSHIP_FLAGS + ["--model.compute_dtype=null"],
                 "flagship_bf16": FLAGSHIP_FLAGS,
                 **{f"maml_{run.name}": [f"--from_run={run}"]
                    for run in (BURGERS_RUN, EM_RUN, SB_RUN)}}
MESH_P3D_RANKS = 2
# pipeline/maml_meta_3d.sh's bsize 256 on 8 task shards, cut to 32 on 2
MESH_P3D_FLAGS = ["--maml.bsize=32", f"--mesh.n_task_shards={MESH_P3D_RANKS}"]
MESH_P3D_REDUCED = {"maml.bsize": "256 -> 32", "mesh.n_task_shards": "8 -> 2",
                    **{k: v for k, v in P3D_TRAIN_CUTS.items()}}
MESH_LEAP_MESHES = "2x1,1x2"
# (c) lp2_4 and (d2) ldb3_2 in one launch of the ranks, both cut as
# leap_family_parity cuts (lp2_4's bsize 8 and 60 inner steps cut to pay
# for (d))
MESH_LEAP_RUNS = (LEAP_RUN, LDB_RUN)
MESH_LEAP_REDUCED = {"leap.bsize": "8 -> 2 (lp2_4), 16 -> 2 (ldb3_2)",
                     "leap.inner_steps": "60 -> 10 (lp2_4), 80 -> 10 (ldb3_2)",
                     "outer steps": "1 compared"}
# LEAP's bars at lp2_4's width, from measurement (this phase on one H100
# 80GB HBM3 at 700 W: meta-gradient 3.0e-6 of a leaf's scale, losses 2.5e-7
# relative, at 60 inner steps; ldb3_2 at 10: 7.6e-7 and 9.2e-8), tighter
# than tests/test_torch_leap.py's parity bars (2e-2, 1e-5)
MESH_LEAP_BARS = ("--grad_bar=1e-4", "--loss_bar=1e-5")
MESH_TIMEOUT_S = 300


def _run_json(cmd, timeout=MESH_TIMEOUT_S, n_lines=1):
    """cmd in a session of its own (_spawn); its last stdout line as JSON
    (with n_lines > 1, a list of its last n_lines). Every process it started
    is killed when it ends, fails or times out."""
    proc = _spawn(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        _kill_children()
    if proc.returncode != 0:
        # a disagreement exits 1 with the compared numbers on stdout
        raise AssertionError(f"{' '.join(cmd[:6])} ... exited {proc.returncode}: "
                             f"{err[-4000:]}{out[-12000:]}")
    lines = [json.loads(l) for l in out.strip().splitlines()[-n_lines:]]
    return lines if n_lines > 1 else lines[0]


def _mesh_rows(line):
    """The printed numbers of each mesh of a distributed_smoke line."""
    rows = []
    for m in line["meshes"]:
        r0 = m["rank0"]
        prof = r0.get("profiled_step", {})
        rows.append({"mesh": m["mesh"], "ok": m["ok"], "backend": r0["backend"],
                     "device": r0["device"], "rel_diffs": m["rel_diffs"],
                     "meta_grad_leaf_err": m["meta_grad_leaf_err"],
                     "losses_rel": m["losses_rel"], "meta_losses_rel": m["meta_losses_rel"],
                     "steps_per_s": r0.get("steps_per_s"),
                     "draw_s_per_step": r0.get("draw_s_per_step"),
                     "collectives_per_step": r0.get("collectives_per_step"),
                     "launches_per_step": prof.get("launches"),
                     "device_busy_ms": prof.get("device_busy_ms"),
                     "idle_share": prof.get("idle_share"),
                     "nccl_device_ms": prof.get("nccl_device_ms"),
                     "max_memory_allocated_bytes": r0.get("max_memory_allocated_bytes"),
                     "seconds": m["seconds"], "stage_s": r0.get("stage_s")})
    ref = line["reference"]
    return {"rows": rows, "reference": {k: ref.get(k) for k in (
        "steps_per_s", "draw_s_per_step", "params_norm_after_step", "mean_meta_loss",
        "stage_s")},
        "grad_bar": line["grad_bar"], "loss_bar": line["loss_bar"], "tol": line["tol"],
        "seconds": line["seconds"]}


def _smoke_cmd(*args):
    return [sys.executable, "-m", "metapde_tpu_torch.cli.distributed_smoke", "--device=cuda",
            *args]


def _smoke(*args, n_lines=1):
    return _run_json(_smoke_cmd(*args), n_lines=n_lines)


# (d3) cli/maml_pde on 2 x 2 resumed from bm7_5's checkpoint: 2 steps and
# one validation, in burgers_train's out_dir, whose ground truth of the
# same eval tasks it reads ((d1) shares (a)'s launch, (d2) (c)'s)
MESH_BURGERS_MESH = (2, 2)
MESH_BURGERS_CUTS = {"train.outer_steps": 500004, "train.steps_per_call": 2,
                     "train.val_every": 2, "train.log_every": 2,
                     "task.n_eval": BURGERS_TRAIN_CUTS["task.n_eval"]}
# bm7_5's kinds (left and right walls, initial, domain) and those pt = 2
# gives whole to every pt rank
MESH_BURGERS_KINDS = "inner_points [63, 63] of [63, 63, 1010, 1008]"


def _sharded_run(run, steps):
    """The checks of a sharded cli/maml_pde run dir `run` whose last step
    is steps[-1] + 1: rank 0 alone wrote it (one mesh and one done line in
    log.txt, the run files), its validation records at `steps`, one
    siren_fused launch (rank 0's) per validation call. Returns (records,
    launches, peak memory by rank, the mesh line)."""
    names = {p.name for p in run.iterdir()}
    want = {"log.txt", "metrics.jsonl", "config.json", "checkpoint_best.pickle",
            f"checkpoint_step_{steps[-1] + 1}.pickle", "tb"}
    if not want <= names or any(not n.startswith("checkpoint_step_") for n in names - want):
        raise AssertionError(f"the sharded run dir holds {sorted(names)}; want "
                             f"{sorted(want)} and periodic checkpoints")
    log = (run / "log.txt").read_text().splitlines()
    mesh_lines = [l for l in log if l.startswith("mesh: ")]
    done = [l for l in log if l.startswith("done: ")]
    if len(mesh_lines) != 1 or len(done) != 1:
        raise AssertionError(f"log.txt has {len(mesh_lines)} mesh and {len(done)} done "
                             "lines: not one writer")
    recs = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()]
    if [r["step"] for r in recs] != list(steps):
        raise AssertionError(f"validation records at {[r['step'] for r in recs]}")
    words = done[0].split()
    launches = int(words[words.index("process") + 1].rstrip(","))
    if launches != len(recs):
        raise AssertionError(f"rank 0 launched siren_fused {launches} times for "
                             f"{len(recs)} validation calls")
    return recs, launches, json.loads(done[0].split("by rank ", 1)[1]), mesh_lines[0]


def _pipe(cmd, **env):
    """_spawn(cmd) from the repo root with its output piped, awaited."""
    proc = _spawn(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                  env=dict(os.environ, **env))
    _AWAITED.append(proc)
    return proc


def _launcher(n_ranks, *args, threads=1):
    """cli/maml_pde under torch.distributed.run with n_ranks ranks."""
    return _pipe([sys.executable, "-m", "torch.distributed.run", "--standalone",
                  f"--nproc_per_node={n_ranks}", "-m", "metapde_tpu_torch.cli.maml_pde", *args],
                 OMP_NUM_THREADS=str(threads))


def _burgers_run_start(tmp):
    """(d3)'s launcher; with the number of ground truths burgers_train
    cached for it."""
    src = _run_copy(tmp, BURGERS_RUN, ("config.json", BURGERS_CKPT.name))
    cached = len(list((_burgers_out() / "gt_cache_torch").glob("*.npz")))
    n_dp, n_pt = MESH_BURGERS_MESH
    return _launcher(n_dp * n_pt, f"--from_run={src}",
                     *(f"--{k}={v}" for k, v in {**MESH_BURGERS_CUTS,
                                                  **BURGERS_OVERRIDES}.items()),
                     f"--mesh.n_task_shards={n_dp}", f"--mesh.n_point_shards={n_pt}",
                     f"--train.out_dir={_burgers_out()}", "--train.expt_name=mesh"), cached


def _burgers_run_read(proc, cached):
    """(d3)'s run dir, checked."""
    _awaited_output(proc, "mesh_train (d3)", MESH_TIMEOUT_S)
    run = _burgers_out() / "mesh"
    last = MESH_BURGERS_CUTS["train.outer_steps"]
    recs, launches, peaks, mesh_line = _sharded_run(run, [last - 1])
    if MESH_BURGERS_KINDS not in mesh_line:
        raise AssertionError(f"the mesh line does not give {MESH_BURGERS_KINDS} whole: "
                             f"{mesh_line}")
    nt = load_run_config(str(BURGERS_RUN)).task.num_tsteps
    for r in recs:
        pts = r["per_time_step_error"]
        if len(pts) != nt or not all(math.isfinite(v) for v in pts):
            raise AssertionError(f"step {r['step']}: per_time_step_error has {len(pts)} "
                                 f"entries (expected {nt} finite)")
        if not (math.isfinite(r["meta_loss"]) and r["val_rel_err"] < 1e-2):
            raise AssertionError(f"step {r['step']}: meta_loss {r['meta_loss']}, "
                                 f"val_rel_err {r['val_rel_err']}")
    n_eval = MESH_BURGERS_CUTS["task.n_eval"]
    gt = _gt_log(run)
    # burgers_train cached these eval tasks' ground truth, unless the phase
    # runs without it (python3 chip_smoke.py mesh_train): then it solves
    if gt != ((0, n_eval) if cached >= n_eval else (n_eval, 0)):
        raise AssertionError(f"ground truth (solved, read) {gt} with {cached} cached")
    return {
        "mesh": "x".join(map(str, MESH_BURGERS_MESH)), "launches": launches,
        "validations": len(recs), "gt_solved_read": gt,
        "steps_per_s": 1.0 / statistics.mean(r["step_time"] for r in recs),
        "step_time": [r["step_time"] for r in recs],
        "val_rel_err": [r["val_rel_err"] for r in recs],
        "per_time_step_error_max": [max(r["per_time_step_error"]) for r in recs],
        "deployment_time": [r["deployment_time"] for r in recs],
        "max_memory_allocated_bytes_by_rank": peaks, "mesh_line": mesh_line,
        "reduced": {"train.outer_steps": "500001 + 2", **{
            k: v for k, v in MESH_BURGERS_CUTS.items() if k != "train.outer_steps"}}}


def phase_mesh_train():
    """The parallel layer on the card, ranks in processes of their own
    (_spawn; gloo when they share the card, nccl when each has its own):
    (a) bench.py's flagship at full width through cli/distributed_smoke,
    one outer step on the 2 x 2 mesh in f32 and in bf16 against the
    one-process step on the same draws and card (meta-gradient
    within 1e-4 of each leaf's scale, losses rtol 1e-4; bf16 1e-2); (b)
    pipeline/maml_meta_3d.sh's config at full width (5x128, 2048 points)
    through the launcher and cli/maml_pde on dp = 2 at bsize 32: rank 0
    alone writes the run files, val_rel_err finite and below
    P3D_TRAIN_BAR, one siren_fused launch (rank 0's) per validation call;
    (c) LEAP at lp2_4's width (bsize 2, 10 inner steps), one dp = 2 and one
    pt = 2 step against the one-process step (MESH_LEAP_BARS); (d) the
    other families: (d1) one MAML step of bm7_5's, em7_9's and sbi10_2's
    configs at full width on 2 x 2 against one process, with (a)'s bars, in
    (a)'s launch of the ranks (--variant), (d2) the same LEAP steps as (c)
    at ldb3_2's width, in (c)'s launch, (d3) cli/maml_pde on 2 x 2
    through the launcher resumed from bm7_5's checkpoint: rank 0 alone
    writes, 201 finite per-timestep entries, one siren_fused launch (rank
    0's) per validation call, the pt split's whole kinds on the mesh line,
    and no ground truth solved that burgers_train cached. (a)-(d) run at
    once on the one card, so their steps/s share it. No process is left
    behind."""
    t0 = time.perf_counter()
    if parse_overrides(Config(), FLAGSHIP_FLAGS) != train_bench.FLAGSHIP:
        raise AssertionError("FLAGSHIP_FLAGS no longer parse to train_bench.FLAGSHIP")
    torch.cuda.empty_cache()
    parts, seconds = {}, {}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out"
        # every part at once, their ranks on the one card; the others are
        # spared by (a)'s cleanup until they are read
        procs = {}
        procs["d3"], cached = _burgers_run_start(tmp)
        procs["b"] = _launcher(
            MESH_P3D_RANKS, *P3D_FLAGS, *MESH_P3D_FLAGS,
            *(f"--{k}={v}" for k, v in P3D_TRAIN_CUTS.items()),
            f"--train.out_dir={out}", "--train.expt_name=mesh",
            # the launcher's default is 1 thread a rank: the host draw,
            # beside the other parts' ranks
            threads=max(1, len(os.sched_getaffinity(0)) // (2 * MESH_P3D_RANKS)))
        procs["c"] = _pipe(_smoke_cmd(
            "--algo=leap", *(f"--variant={shlex.join([f'--from_run={r}'])}"
                             for r in MESH_LEAP_RUNS),
            f"--meshes={MESH_LEAP_MESHES}", "--timed_steps=0", *LEAP_FAMILY_PARITY_CUTS,
            *MESH_LEAP_BARS))
        try:
            # (a) and (d1) in one launch of the ranks: one start-up, one group
            lines = _smoke(f"--meshes={MESH_FLAGSHIP_MESHES}", "--timed_steps=1",
                           *(f"--variant={shlex.join(v)}" for v in MESH_VARIANTS.values()),
                           n_lines=len(MESH_VARIANTS))
            for name, line in zip(MESH_VARIANTS, lines):
                timed = "1 timed (cut from 2)" if name.startswith("flagship") else "1 timed"
                parts[name] = {**_mesh_rows(line),
                               "reduced": {"outer steps": f"1 compared, {timed}, 1 profiled"}}
            seconds["a"] = time.perf_counter() - t
            lines = _awaited_output(procs["c"], "mesh_train (c), (d2)",
                                    MESH_TIMEOUT_S).strip().splitlines()
            for name, line in zip(("leap", "leap_ldb3_2"), lines[-len(MESH_LEAP_RUNS):]):
                parts[name] = {**_mesh_rows(json.loads(line)), "reduced": MESH_LEAP_REDUCED}
            seconds["c"] = time.perf_counter() - t
            _awaited_output(procs["b"], "mesh_train (b)", MESH_TIMEOUT_S)
            seconds["b"] = time.perf_counter() - t
            last = P3D_TRAIN_CUTS["train.outer_steps"]
            recs, launches, peaks, mesh_line = _sharded_run(out / "mesh", [1, last - 1])
            parts["burgers_run"] = _burgers_run_read(procs["d3"], cached)
            seconds["d3"] = time.perf_counter() - t
        finally:
            for p in procs.values():
                if p in _AWAITED:
                    _AWAITED.remove(p)
            _kill_children()
    parts["flagship_f32"]["reduced"]["meshes"] = "2x1,1x2,2x2 -> 2x2"
    for r in recs:
        if not (math.isfinite(r["val_rel_err"]) and r["val_rel_err"] < P3D_TRAIN_BAR
                and math.isfinite(r["meta_loss"])):
            raise AssertionError(f"step {r['step']}: val_rel_err {r['val_rel_err']}, "
                                 f"meta_loss {r['meta_loss']}")
    parts["poisson3d"] = {
        "backend": mesh_line.split("backend ", 1)[1].split(",")[0],
        "ranks": MESH_P3D_RANKS,
        "steps_per_s": 1.0 / statistics.mean(r["step_time"] for r in recs),
        "step_time": [r["step_time"] for r in recs],
        "max_memory_allocated_bytes_by_rank": peaks,
        "val_rel_err": [r["val_rel_err"] for r in recs],
        "meta_loss": [r["meta_loss"] for r in recs],
        "deployment_time": [r["deployment_time"] for r in recs],
        "launches": launches, "validations": len(recs), "reduced": MESH_P3D_REDUCED}
    seconds["all"] = time.perf_counter() - t
    left = _descendants(os.getpid())
    if left:
        raise AssertionError(f"processes left behind: {left}")
    cards = torch.cuda.device_count()
    emit("mesh_train", t0, cards=cards, seconds=seconds, **parts)
    failed = [(name, r["mesh"]) for name, part in parts.items() if "rows" in part
              for r in part["rows"] if not r["ok"]]
    if failed:
        raise AssertionError(f"sharded steps disagree with the one-process step: {failed}")
    return {"launches": launches + parts["burgers_run"]["launches"],
            "poisson3d_launches": launches,
            "burgers_run_launches": parts["burgers_run"]["launches"],
            "poisson3d": parts["poisson3d"], "burgers_run": parts["burgers_run"],
            "flagship_f32": parts["flagship_f32"]["rows"],
            "families": {k: parts[k]["rows"] for k in parts if k.startswith(("maml_", "leap_"))},
            "seconds": seconds}


# The matrix-free elasticity cascade (solvers/fem_elasticity.py::solve):
# tests/test_elasticity.py:83-98's uniform compression and one of em7_9's
# deployment tasks at resolution 12 on the card and on the CPU, of the grid's
# largest |u|; that task at em7_9's resolution 32 (the chain 16 -> 32) on the
# card with tests/test_elasticity.py::test_solver_with_pores_converges's bars
CASCADE_UNIFORM = {"resolution": 12, "load_steps": 2, "newton_steps": 15}
CASCADE_RES = 12
CASCADE_TOL = 1e-4
CASCADE_FULL_RES = 32
CASCADE_CG_PROFILED = 50  # eager CG iterations profiled for their launches
CASCADE_CG_TIMED = 200    # at most, a timed CG solve, eager and graphed


def _cascade_counted(fn, device):
    """fn() between two barriers of `device`: (ground truth, seconds, Newton
    steps, CG iterations)."""
    newton.cg.iterations, fem_elasticity.solve.newton_steps = 0, 0
    gt, secs = _timed(fn, device)
    return gt, secs, fem_elasticity.solve.newton_steps, newton.cg.iterations


def phase_elasticity_cascade():
    t0 = time.perf_counter()
    cfg, _, (task,) = _eval_tasks(EM_RUN, 1)
    dom = cfg.task.domain
    bounds = {"xmin": dom.xmin, "xmax": dom.xmax, "ymin": dom.ymin, "ymax": dom.ymax}
    uniform = (torch.zeros(2), torch.tensor([1.0, 1.0]), torch.zeros(1, 5),
               torch.tensor(0, dtype=torch.int32))
    on = lambda params, device: tuple(a.to(device) for a in params)
    rows, card_gts = {}, {}
    for name, params, kw in (("uniform", uniform, CASCADE_UNIFORM),
                             ("pored", task, {"resolution": CASCADE_RES, **bounds})):
        g, g_s, g_newton, g_cg = _cascade_counted(
            lambda: fem_elasticity.solve(on(params, "cuda"), **kw), "cuda")
        c, c_s, _, c_cg = _cascade_counted(
            lambda: fem_elasticity.solve(on(params, "cpu"), **kw), "cpu")
        scale = float(c.u_grid.abs().max())
        err = float((g.u_grid.cpu() - c.u_grid).abs().max()) / scale
        card_gts[name] = g
        rows[name] = {"resolution": kw["resolution"], "card_s": g_s, "cpu_s": c_s,
                      "newton_steps": g_newton, "cg_iters": g_cg, "cpu_cg_iters": c_cg,
                      "final_gnorm": float(g.final_gnorm),
                      "cpu_final_gnorm": float(c.final_gnorm), "rel_err": err}
        if not (bool(torch.isfinite(g.u_grid).all()) and err <= CASCADE_TOL):
            raise AssertionError(f"cascade {name}: card vs CPU {err} of the grid's max "
                                 f"(> {CASCADE_TOL}), or not finite")
    # em7_9's resolution, the chain 16 -> 32, against the family's oracle
    full, full_s, full_newton, full_cg = _cascade_counted(
        lambda: fem_elasticity.solve(on(task, "cuda"), resolution=CASCADE_FULL_RES, **bounds),
        "cuda")
    u = full.u_grid.cpu()
    direct = fem_elasticity.solve_direct(task, resolution=CASCADE_FULL_RES, **bounds)
    to_direct = float((u - direct.u_grid).abs().max() / direct.u_grid.abs().max())
    if not (bool(torch.isfinite(u).all()) and float(u.abs().max()) < 0.5
            and float(full.final_energy) < 1e3):
        raise AssertionError(f"cascade at {CASCADE_FULL_RES}: max |u| {float(u.abs().max())}, "
                             f"energy {float(full.final_energy)}")
    # float64 at 12 on the card
    g64, g64_s, g64_newton, g64_cg = _cascade_counted(
        lambda: fem_elasticity.solve_x64(on(task, "cuda"), resolution=CASCADE_RES, **bounds),
        "cuda")
    if g64.u_grid.dtype != torch.float64 or not bool(torch.isfinite(g64.u_grid).all()):
        raise AssertionError(f"solve_x64: {g64.u_grid.dtype}, finite "
                             f"{bool(torch.isfinite(g64.u_grid).all())}")
    # launches a CG iteration (eager, on the pored task's first Hessian),
    # and one graphed solve under the profiler
    prob = fem_elasticity._torch_problem(on(task, "cuda"), CASCADE_RES, **bounds)
    grad, hvp = prob["grad_hess"](torch.zeros(2 * prob["n_nodes"], device="cuda"),
                                  -0.12 / 4)
    newton.cg.iterations = 0
    cg_prof = _profile(lambda: newton.cg(hvp, -grad, tol=0.0, maxiter=CASCADE_CG_PROFILED,
                                         cuda_graph=False))
    cg_iters = newton.cg.iterations
    cg_ms = {}
    for graphed in (False, True):
        run_cg = lambda: newton.cg(hvp, -grad, tol=0.0, maxiter=CASCADE_CG_TIMED,
                                   cuda_graph=graphed)
        newton.cg.iterations = 0
        run_cg()
        iterations = newton.cg.iterations
        cg_ms[graphed] = cuda_ms(run_cg, reps=3, warmup=1) / max(iterations, 1)
    newton.cg.iterations = 0
    solve_prof = _profile(lambda: fem_elasticity.solve(on(uniform, "cuda"), **CASCADE_UNIFORM))
    solve_prof["cg_iters"] = newton.cg.iterations
    emit("elasticity_cascade", t0, tol=CASCADE_TOL, cases=rows,
         full={"resolution": CASCADE_FULL_RES, "card_s": full_s, "newton_steps": full_newton,
               "cg_iters": full_cg, "final_gnorm": float(full.final_gnorm),
               "final_energy": float(full.final_energy), "max_abs_u": float(u.abs().max()),
               "rel_to_solve_direct": to_direct,
               "solve_direct_gnorm": float(direct.final_gnorm)},
         x64={"resolution": CASCADE_RES, "card_s": g64_s, "newton_steps": g64_newton,
              "cg_iters": g64_cg, "final_gnorm": float(g64.final_gnorm),
              "rel_to_f32": float((g64.u_grid.cpu() - card_gts["pored"].u_grid.cpu().double())
                                  .abs().max() / g64.u_grid.abs().max())},
         cg={"launches_per_iteration_eager": cg_prof["launches"] / max(cg_iters, 1),
             "ms_per_iteration_eager": cg_ms[False],
             "ms_per_iteration_graphed": cg_ms[True]},
         solve_profiled=solve_prof)
    return {"s_per_solve": {k: r["card_s"] for k, r in rows.items()},
            "full_s": full_s, "cg_iters_full": full_cg,
            "launches_per_cg_iteration_eager": cg_prof["launches"] / max(cg_iters, 1),
            "idle_share": solve_prof["idle_share"]}


# pde_check on each family, with each committed run's task config
PDE_CHECK_FAMILIES = (("poisson", RUN_DIR), ("td_burgers", BURGERS_RUN),
                      ("hyper_elasticity", EM_RUN), ("steady_burgers", SB_RUN),
                      ("poisson3d", None))


def phase_pde_check():
    """cli/pde_check on the card for the five families: the JSON keys, a
    finite ground truth, seconds a family."""
    t0 = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for family, run in PDE_CHECK_FAMILIES:
            cfg = (load_run_config(str(run)) if run is not None
                   else parse_overrides(Config(), P3D_FLAGS))
            stats, secs = _timed(lambda: pde_check.run(cfg, out=f"{tmp}/{family}",
                                                       device="cuda"), "cuda")
            if stats["pde"] != family or stats["gt_finite"] is not True or not (
                    {"n_point_sets", "gt_norm"} <= set(stats)):
                raise AssertionError(f"pde_check {family}: {stats}")
            rows[family] = {"s": secs, **{k: stats[k] for k in ("n_point_sets", "gt_norm",
                                                               "gt_finite")},
                            "pngs": sorted(k for k in stats if k.endswith("_png"))}
    emit("pde_check", t0, families=rows)
    return {k: r["s"] for k, r in rows.items()}


# cli/roofline on bench.py:266-295's flagship (3x64, bsize 16, 5 inner
# steps, 1024 points, the with-replacement sampler, remat off), f32 and the
# bf16 chain, 3 timed blocks of 2 steps
ROOFLINE_FLAGS = ["--fast_sampler", "--no_remat", "--block=2", "--blocks=3"]
ROOFLINE_KEYS = ("steps_per_sec", "ms_per_step", "matmul_gflops_per_step", "sustained_tflops",
                 "mfu_vs_bf16_peak", "ridge_flops_per_byte", "nvidia_smi")


def phase_roofline():
    t0 = time.perf_counter()
    rows = {"f32": roofline.main(ROOFLINE_FLAGS),
            "bf16": roofline.main(ROOFLINE_FLAGS + ["--compute_dtype=bfloat16"])}
    for name, r in rows.items():
        if not (r["steps_per_sec"] > 0 and r["matmul_gflops_per_step"] > 0
                and r["sustained_tflops"] > 0 and 0 < r.get("mfu_vs_bf16_peak", 0) < 1):
            raise AssertionError(f"roofline {name}: {r}")
    emit("roofline", t0, reduced={"block": 2, "blocks": 3},
         runs={k: {b: r.get(b) for b in ROOFLINE_KEYS} for k, r in rows.items()})
    return {k: {b: r.get(b) for b in ROOFLINE_KEYS} for k, r in rows.items()}


def phase_tools():
    """cli/solution_viz on a copy of p30k_f32_s1 end to end, twice: the
    second reads its 3 ground truths from gt_cache_torch/. The figure is
    written where matplotlib is installed, else its name is None."""
    t0 = time.perf_counter()
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    lines, secs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        src = _run_copy(tmp, RUN_DIR, ("config.json", "checkpoint_step_30001.pickle"))
        out = Path(tmp) / "fig" / "solutions.png"
        for _ in range(2):
            buf = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                fname = solution_viz.main([f"--from_run={src}", "--inner-steps-list=0,2,5",
                                           f"--out={out}"])
            secs.append(time.perf_counter() - t1)
            lines.append(next(l for l in buf.getvalue().splitlines()
                              if l.startswith("ground truth")))
            if (fname is None) == have_mpl or (have_mpl and not out.exists()):
                raise AssertionError(f"solution_viz returned {fname}, matplotlib {have_mpl}")
    if "0 solved, 3 read" not in lines[1]:
        raise AssertionError(f"the second solution_viz: {lines[1]}")
    emit("tools", t0, solution_viz={"s": secs, "ground_truth": lines, "matplotlib": have_mpl,
                                    "figure": fname is not None})
    return {"solution_viz_s": secs}


PHASES = {
    "kernel": phase_kernel, "parity": phase_parity, "deploy": phase_deploy,
    "ground_truth_mg": phase_ground_truth_mg, "deploy_mg": phase_deploy_mg,
    "train_parity": phase_train_parity, "train_parity_bf16": phase_train_parity_bf16,
    "train_resume_jax": phase_train_resume_jax, "train": phase_train,
    "train_bench": phase_train_bench, "leap_parity": phase_leap_parity,
    "leap_resume_jax": phase_leap_resume_jax, "leap_deploy": phase_leap_deploy,
    "leap_train": phase_leap_train, "burgers_gt": phase_burgers_gt,
    "burgers_parity": phase_burgers_parity, "burgers_deploy": phase_burgers_deploy,
    "burgers_train": phase_burgers_train, "leap_burgers_deploy": phase_leap_burgers_deploy,
    "elasticity_gt": phase_elasticity_gt, "elasticity_parity": phase_elasticity_parity,
    "elasticity_deploy": phase_elasticity_deploy,
    "leap_elasticity_deploy": phase_leap_elasticity_deploy,
    "elasticity_train": phase_elasticity_train, "steady_gt": phase_steady_gt,
    "steady_parity": phase_steady_parity, "steady_deploy": phase_steady_deploy,
    "steady_train": phase_steady_train, "poisson3d_parity": phase_poisson3d_parity,
    "poisson3d_train": phase_poisson3d_train, "nn_parity": phase_nn_parity,
    "nn_deploy_maml": phase_nn_deploy_maml, "nn_deploy_leap": phase_nn_deploy_leap,
    "nn_multistart": phase_nn_multistart, "solver_baseline": phase_solver_baseline,
    "mesh_train": phase_mesh_train, "elasticity_cascade": phase_elasticity_cascade,
    "pde_check": phase_pde_check, "roofline": phase_roofline, "tools": phase_tools,
    "leap_family_parity": phase_leap_family_parity,
    "leap_burgers_train": phase_leap_burgers_train,
    "leap_elasticity_train": phase_leap_elasticity_train,
    "nn_deploy_burgers": phase_nn_deploy_burgers,
    "nn_deploy_elasticity": phase_nn_deploy_elasticity,
    "solver_baseline_burgers": phase_solver_baseline_burgers,
    "solver_baseline_elasticity": phase_solver_baseline_elasticity,
    "gt_convergence_steady": phase_gt_convergence_steady,
}


def main(argv):
    phase_device()
    phase_build()
    if not argv or "ground_truth_mg" in argv:
        _gt_mg_cpu()
    if argv:
        for name in argv:
            PHASES[name]()
        return
    kern = phase_kernel()
    phase_parity()
    deploy_launches = phase_deploy()
    deploy_mg_launches, deploy_mg_bf16_launches = phase_deploy_mg()
    phase_train_parity()
    phase_train_parity_bf16()
    phase_train_resume_jax()
    train = phase_train()
    bench = phase_train_bench()
    # its CPU solve, started at the run's start, is done by now
    gt_mg = phase_ground_truth_mg()
    phase_leap_parity()
    phase_leap_resume_jax()
    leap_deploy_launches, leap_deploy_adam_launches = phase_leap_deploy()
    leap_train = phase_leap_train()
    burgers_gt = phase_burgers_gt()
    phase_burgers_parity()
    burgers_deploy_launches = phase_burgers_deploy()
    burgers_train = phase_burgers_train()
    leap_burgers_deploy_launches = phase_leap_burgers_deploy()
    elasticity_gt = phase_elasticity_gt()
    phase_elasticity_parity()
    elasticity_deploy_launches = phase_elasticity_deploy()
    leap_elasticity_deploy_launches = phase_leap_elasticity_deploy()
    elasticity_train = phase_elasticity_train()
    steady_gt = phase_steady_gt()
    phase_steady_parity()
    steady_deploy_launches, steady_deploy_adam_launches = phase_steady_deploy()
    steady_train = phase_steady_train()
    phase_poisson3d_parity()
    poisson3d_train = phase_poisson3d_train()
    phase_nn_parity()
    nn_maml = phase_nn_deploy_maml()
    nn_leap = phase_nn_deploy_leap()
    nn_ms = phase_nn_multistart()
    phase_leap_family_parity()
    leap_burgers_train = phase_leap_burgers_train()
    leap_elasticity_train = phase_leap_elasticity_train()
    nn_burgers = phase_nn_deploy_burgers()
    nn_elasticity = phase_nn_deploy_elasticity()
    # the four solver phases' CPU sides start with the first (_solver_cpu);
    # Poisson's card side is the shortest, so its CPU side has the longest
    # to finish
    phase_solver_baseline_burgers()
    phase_solver_baseline_elasticity()
    phase_gt_convergence_steady()
    phase_solver_baseline()
    mesh = phase_mesh_train()
    cascade = phase_elasticity_cascade()
    pde_checks = phase_pde_check()
    roof = phase_roofline()
    tools = phase_tools()
    main_row, big = kern["main_path_batched"], kern["main_path_2pow20"]
    timing_keys = ("ms", "device_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                   "bound_f32_ms")
    kernels = [{
        "name": "siren_fused",
        "route": "cuda",
        "source": "metapde_tpu_torch/csrc/siren_fused.cu",
        "replaces": "metapde_tpu/ops/pallas_siren.py:91",
        "launches": deploy_launches,
        "deploy_mg_launches": deploy_mg_launches,
        "deploy_mg_bf16_launches": deploy_mg_bf16_launches,
        "train_launches": train["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "bound_f32_ms": main_row["bound_f32_ms"],
        "library_ms": None,  # no single PyTorch call computes the chain
        "device_ms": main_row["device_ms"],
        "wrapper_ms": main_row["wrapper_ms"],
        "tasks": main_row["tasks"],
        "n": main_row["n"],
        "sin_per_point": main_row["sin_per_point"],
        "at_n_1048576": {k: big[k] for k in timing_keys},
        "leap_deploy_launches": leap_deploy_launches,
        "leap_deploy_adam_launches": leap_deploy_adam_launches,
        "leap_train_launches": leap_train["launches"],
        "at_leap_shape": {k: kern["leap_path"][k] for k in (
            "tasks", "n", "max_abs_err", *timing_keys, "resident", "smem_bytes",
            "blocks_per_sm", "n_sm")},
        "burgers_deploy_launches": burgers_deploy_launches,
        "burgers_train_launches": burgers_train["launches"],
        "leap_burgers_deploy_launches": leap_burgers_deploy_launches,
        **{f"at_{case.split('_')[0]}_shape": {k: kern[case][k] for k in (
            "tasks", "n", "max_abs_err", *timing_keys, "resident", "smem_bytes",
            "blocks_per_sm", "n_sm")} for case in ("burgers_path", "ldb3_path")},
        "elasticity_deploy_launches": elasticity_deploy_launches,
        "leap_elasticity_deploy_launches": leap_elasticity_deploy_launches,
        "elasticity_train_launches": elasticity_train["launches"],
        **{f"at_{case[:-5]}_shape": {k: kern[case][k] for k in (
            "tasks", "n", "max_abs_err", *timing_keys, "resident", "smem_bytes",
            "blocks_per_sm", "n_sm")} for case in ("em7_9_path", "lde2_3_path")},
        "steady_deploy_launches": steady_deploy_launches,
        "steady_deploy_adam_launches": steady_deploy_adam_launches,
        "steady_train_launches": steady_train["launches"],
        "poisson3d_train_launches": poisson3d_train["launches"],
        **{f"at_{case[:-5]}_shape": {k: kern[case][k] for k in (
            "tasks", "n", "max_abs_err", *timing_keys, "resident", "smem_bytes",
            "blocks_per_sm", "n_sm")} for case in ("sburgers_path", "poisson3d_path")},
        # the plain-PINN fine-tunes: one launch per validation call
        "nn_deploy_maml_launches": nn_maml["launches"],
        "nn_deploy_leap_launches": nn_leap["launches"],
        "nn_multistart_launches": nn_ms["launches"],
        **{f"at_{case}_shape": {k: kern[row][k] for k in (
            "tasks", "n", "max_abs_err", *timing_keys, "resident", "smem_bytes",
            "blocks_per_sm", "n_sm")}
           for case, row in (("nn_maml", "main_path"), ("nn_leap", "nn_leap_path"))},
        # the sharded poisson3d and bm7_5 runs (rank 0's validation calls)
        "mesh_train_launches": mesh["launches"],
        "mesh_train_poisson3d_launches": mesh["poisson3d_launches"],
        "mesh_train_burgers_launches": mesh["burgers_run_launches"],
        # the paper's Burgers and hyperelasticity pipelines (PR 15)
        "leap_burgers_train_launches": leap_burgers_train["launches"],
        "leap_elasticity_train_launches": leap_elasticity_train["launches"],
        **{f"{expt}_launches": row["launches"]
           for rows in (nn_burgers, nn_elasticity) for expt, row in rows.items()},
        **{f"at_{case[:-5]}_shape": {k: kern[case][k] for k in (
            "tasks", "n", "max_abs_err", *timing_keys, "resident", "smem_bytes",
            "blocks_per_sm", "n_sm")} for case in FAMILY_CASES},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"training": {"train": train,
                                   "train_bench": {k: {b: r[b] for b in BENCH_KEYS}
                                                   for k, r in bench.items()},
                                   "leap_train": leap_train,
                                   "burgers_train": burgers_train,
                                   "burgers_gt": burgers_gt,
                                   "elasticity_train": elasticity_train,
                                   "elasticity_gt": elasticity_gt,
                                   "steady_train": steady_train,
                                   "steady_gt": steady_gt,
                                   "poisson3d_train": poisson3d_train,
                                   "nn_deploy_maml": nn_maml["step"],
                                   "nn_deploy_leap": nn_leap["step"],
                                   "mesh_train": mesh,
                                   "leap_burgers_train": leap_burgers_train,
                                   "leap_elasticity_train": leap_elasticity_train,
                                   **{expt: row["step"] for rows in (nn_burgers, nn_elasticity)
                                      for expt, row in rows.items()}},
                      "ground_truth_mg": gt_mg, "elasticity_cascade": cascade,
                      "pde_check": pde_checks, "roofline": roof, "tools": tools,
                      "total_s": time.perf_counter() - T_START}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    _start_watchdog()
    main(sys.argv[1:])
    faulthandler.cancel_dump_traceback_later()
    sys.exit(0)
