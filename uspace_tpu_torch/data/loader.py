"""Host-side batch loader: shuffled epochs, per-process shards, threaded
prefetch (counterpart of ``uspace_tpu/data/loader.py``).

The batch sequence is the JAX package's for the same dataset, batch size,
seed and shard: each epoch's order is ``np.random.default_rng(seed +
epoch).permutation(n)`` (index order without ``shuffle``), each process
takes every ``process_count``-th index of it, and every process emits the
same number of batches an epoch. Batches are dicts of stacked numpy arrays
(lists for string fields), made by a producer thread ``prefetch`` batches
ahead of the consumer, each from ``num_workers`` threads.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np


def _stack(samples) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = vals if isinstance(vals[0], str) else np.stack(vals)
    return out


class DataLoader:
    """Deterministically shuffled, process-sharded, prefetching loader over
    a map-style dataset (``len`` and ``__getitem__`` -> dict of arrays).
    ``batch_size`` is the per-process batch."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count

    def n_batches(self) -> int:
        """Batches every process emits an epoch, from the dataset's size
        alone (so a step maps to (epoch, batch) without building indices)."""
        n = len(self.dataset)
        if self.drop_last:
            return n // (self.process_count * self.batch_size)
        longest = -(-n // self.process_count)
        return -(-longest // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        """This process's shard of the epoch's order. Without ``drop_last``
        a shorter shard wraps to the longest one's length, so that every
        process emits the same number of batches."""
        n = len(self.dataset)
        idx = (np.random.default_rng(self.seed + epoch).permutation(n)
               if self.shuffle else np.arange(n))
        shard = idx[self.process_index::self.process_count]
        if not self.drop_last:
            longest = -(-n // self.process_count)
            if len(shard) < longest:
                shard = np.concatenate([shard, shard[:longest - len(shard)]])
        return shard

    def epoch(self, epoch: int = 0,
              start_batch: int = 0) -> Iterator[Dict[str, Any]]:
        """The batches of ``epoch`` from ``start_batch`` on. A dataset with
        ``set_epoch`` is told the epoch first (per-epoch draws)."""
        set_fn = getattr(self.dataset, "set_epoch", None)
        if set_fn is not None:
            set_fn(epoch)
        shard, n_batches = self._epoch_indices(epoch), self.n_batches()
        if n_batches == 0 or start_batch >= n_batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has gone, so an
            # abandoned epoch leaves no producer blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(start_batch, n_batches):
                        if stop.is_set():
                            return
                        ids = shard[b * self.batch_size:
                                    (b + 1) * self.batch_size]
                        samples = list(pool.map(self.dataset.__getitem__,
                                                ids))
                        if not put(_stack(samples)):
                            return
            except BaseException as e:  # raised in the consumer
                put(e)
                return
            put(None)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()

    def __iter__(self):
        return self.epoch(0)

    def infinite(self, start_step: int = 0) -> Iterator[Dict[str, Any]]:
        """Epochs one after the other, each reshuffled, from the batch that
        step ``start_step`` consumes (epoch ``start_step // n_batches``,
        batch ``start_step % n_batches``): a resumed run sees the batches
        of an uninterrupted one."""
        nb = self.n_batches()
        if nb == 0:
            raise ValueError(
                f"DataLoader yields 0 batches/epoch: len(dataset)="
                f"{len(self.dataset)} < process_count({self.process_count})"
                f" * batch_size({self.batch_size}) with drop_last="
                f"{self.drop_last}")
        epoch, skip = divmod(start_step, nb)
        while True:
            yield from self.epoch(epoch, start_batch=skip)
            epoch += 1
            skip = 0
