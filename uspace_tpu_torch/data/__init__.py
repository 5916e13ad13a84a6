"""Datasets (counterpart of uspace_tpu/data)."""
