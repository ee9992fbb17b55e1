"""Deployment-side drivers: checkpoints, ground truth and validation, MAML
build (counterpart of metapde_tpu/train)."""
