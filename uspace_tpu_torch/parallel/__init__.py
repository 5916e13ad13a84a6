"""Multi-process training (counterpart of ``uspace_tpu/parallel``)."""
