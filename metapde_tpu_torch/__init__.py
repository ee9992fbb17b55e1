"""PyTorch/CUDA port of metapde_tpu.

The package mirrors the JAX package's module paths (``metapde_tpu.X.Y`` ->
``metapde_tpu_torch.X.Y``) and keeps its parameter layouts, so each module
is held against its JAX counterpart by tests that feed both the same
inputs. It imports torch, numpy and scipy only: nothing of JAX, optax or
metapde_tpu.

Ported so far: Poisson MAML meta-training in f32 and bf16 mixed precision
(the second-order meta-gradient through the unroll, the outer optimizers,
``train_step_many``, ``run()``, checkpoints the JAX package reads,
``cli/maml_pde`` and ``cli/train_bench``), the deployment path (checkpoint
load, k-step learned-LR adaptation, FEM ground truth with the multigrid
preconditioner and a ground-truth cache, validation metrics,
``cli/deploy_bench``), the differential operators and the fused SIREN
inference kernel (``csrc/siren_fused.cu``).
"""
