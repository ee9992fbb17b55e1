"""The parallel layer: the (dp, pt) mesh over torch.distributed and the
sharded meta-gradients (counterpart of metapde_tpu/parallel)."""
