"""Sampling drivers (counterpart of ``uspace_tpu/evals``)."""
