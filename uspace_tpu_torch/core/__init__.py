"""Flow decode/encode and ODE solvers (counterpart of uspace_tpu/core)."""
