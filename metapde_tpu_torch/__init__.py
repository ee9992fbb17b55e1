"""PyTorch/CUDA port of metapde_tpu.

The package mirrors the JAX package's module paths (``metapde_tpu.X.Y`` ->
``metapde_tpu_torch.X.Y``) and keeps its parameter layouts, so each module
is held against its JAX counterpart by tests that feed both the same
inputs. It imports torch, numpy and scipy only: nothing of JAX, optax or
metapde_tpu.

Ported so far: the Poisson MAML deployment path (checkpoint load, k-step
learned-LR adaptation, FEM ground truth, validation metrics,
``cli/deploy_bench``) and the fused SIREN inference kernel
(``csrc/siren_fused.cu``).
"""
