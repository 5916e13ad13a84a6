"""Process-group initialization and cross-process collectives
(counterpart of ``uspace_tpu/parallel/distributed.py``).

The reference scales out with ``accelerate launch --multi_gpu`` (an NCCL
process group). Here ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``) starts one process
per card; :func:`initialize` joins them into one ``torch.distributed``
group, NCCL where the process has a card and gloo on the CPU. Data
parallelism itself is ``train/step.py``'s: each process feeds its shard of
the global batch, the weights are replicated and the gradients averaged.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def is_active() -> bool:
    """True when this process is in an initialized process group of more
    than one process."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def initialize(backend: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Join the process group the launcher describes in the environment.

    A no-op on a single process (no launcher variables, or WORLD_SIZE 1)
    and when already initialized. In a multi-process environment it fails
    fast, as the JAX package's does: a silent single-process run would
    train independent copies into one workdir. ``backend`` defaults to
    NCCL when a card is visible, else gloo; each process takes the card of
    its ``LOCAL_RANK``."""
    if dist.is_available() and dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    missing = [v for v in _LAUNCH_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} but {missing} unset: start "
                           "the processes with torchrun")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s))


def process_index() -> int:
    return dist.get_rank() if is_active() else 0


def process_count() -> int:
    return dist.get_world_size() if is_active() else 1


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the card under
    NCCL, the CPU under gloo."""
    if is_active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(x) -> np.ndarray:
    """Every process's ``x`` (the same shape on each), stacked along a new
    leading axis in rank order, on every process (the reference's
    ``accelerator.gather``); ``x`` itself on one process."""
    arr = np.asarray(torch.as_tensor(x).cpu())
    if not is_active():
        return arr
    t = torch.as_tensor(arr).to(collective_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def barrier(name: str = "barrier") -> None:
    """Cross-process sync (the reference's ``wait_for_everyone``)."""
    del name  # a label, as the JAX package's, for call-site readability
    if is_active():
        dist.barrier()


def any_process(flag: bool) -> bool:
    """True on every process when ``flag`` is true on any (an all-reduce
    with max); ``flag`` itself on one process."""
    if not is_active():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
