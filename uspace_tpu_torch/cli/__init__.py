"""Command-line entry points (counterpart of uspace_tpu/cli)."""
