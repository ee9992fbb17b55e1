"""Drivers: the MAML build and meta-training loop, optimizers, checkpoints,
metrics, ground truth and validation (counterpart of metapde_tpu/train)."""
