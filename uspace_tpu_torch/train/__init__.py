"""Train state, optimizer, train step, checkpoints (counterpart of
uspace_tpu/train)."""
