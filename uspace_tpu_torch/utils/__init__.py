"""Utilities (counterpart of ``uspace_tpu/utils``)."""
