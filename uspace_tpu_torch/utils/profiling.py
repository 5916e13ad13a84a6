"""Profiling and step-time accounting (counterpart of
``uspace_tpu/utils/profiling.py``).

A ``torch.profiler`` trace context (CPU and, where there is a card, CUDA
activities; written as a TensorBoard / Chrome trace) and a StepTimer
producing steps/sec and images/sec.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``with trace("/tmp/tb"):`` captures a profile of the enclosed steps
    into ``log_dir``. No-op if ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(prof)


def start_trace(log_dir: str):
    """Start a ``torch.profiler`` trace written to ``log_dir`` when
    :func:`stop_trace` is given the returned profiler."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def stop_trace(prof) -> None:
    prof.stop()


class StepTimer:
    """Windowed step/images throughput with compile-step exclusion."""

    def __init__(self, batch_size: int, skip_first: int = 1):
        self.batch_size = batch_size
        self.skip = skip_first
        self._t0 = None
        self._n = 0

    def tick(self) -> Optional[dict]:
        if self.skip > 0:  # warm-up steps pollute the window
            self.skip -= 1
            return None
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._n = 0
            return None
        self._n += 1
        dt = time.perf_counter() - self._t0
        return {
            "steps_per_sec": self._n / dt,
            "imgs_per_sec": self._n * self.batch_size / dt,
        }

    def reset(self):
        self._t0 = None
        self._n = 0
