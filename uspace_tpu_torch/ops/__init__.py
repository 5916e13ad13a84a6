"""Kernels and their plain PyTorch twins (counterpart of uspace_tpu/ops)."""
