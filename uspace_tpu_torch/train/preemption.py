"""Graceful-preemption handling for long training runs (counterpart of
``uspace_tpu/train/preemption.py``).

Clusters preempt: maintenance events, autoscaling and SLURM requeues
deliver SIGTERM with a short grace window. A signal here merely latches a
flag; the training loop checks it at step boundaries, writes one final
checkpoint and returns cleanly, so resume loses at most the in-flight step
(and, with the loader's ``infinite(start_step=...)`` fast-forward and the
draw generator's state in the checkpoint, is bit-exact with an
uninterrupted run).

Under ``torch.distributed`` a SIGTERM may reach the ranks at different
steps: the loop all-reduces the latched flag at every step boundary
(``train/checkpoint.CheckpointManager.reached_preemption``), so every rank
stops at the same step.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class GracefulShutdown:
    """Context manager latching SIGTERM (and optionally others) into a flag
    checked at step boundaries.

    The handler does no real work on purpose: checkpoint writes from a
    signal frame can re-enter arbitrary interrupted code (the allocator, a
    collective) and deadlock. Installing handlers is only legal from the
    main thread; elsewhere this is an inert guard (``requested`` stays
    False) rather than raising, so library code can use it
    unconditionally. A previous Python handler is chained from
    ``_handler``, so the guard is transparent to surrounding latches, and
    ``__exit__`` restores it.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.requested = False
        self._prev = {}
        self.installed = False

    def _handler(self, signum, frame):
        self.requested = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
            self.installed = True
        return self

    def __exit__(self, *exc) -> bool:
        for s, prev in self._prev.items():
            # prev is None when the prior handler was installed at the C
            # level (not via the signal module): signal.signal(s, None)
            # raises, and SIG_DFL would be a lie either way; leave ours
            if prev is not None:
                signal.signal(s, prev)
        self._prev = {}
        self.installed = False
        return False
