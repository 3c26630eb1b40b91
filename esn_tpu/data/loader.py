"""Batch loading + device prefetch.

Reference: ``torch.utils.data.DataLoader(num_workers, pin_memory,
drop_last)`` [R: builders/dataset_builder.py]. Equivalent here: a
thread-pooled host loader that stacks numpy batches and a double-buffered
device feeder — batch N+1 is decoded and transferred while batch N computes,
so the accelerator never stalls on host IO (SURVEY.md §2.5 input-pipeline
row).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import jax
import numpy as np


class BatchLoader:
    """Shuffling, batching host loader over a Dataset (len + __getitem__)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, limit, self.batch_size):
                idx = order[start:start + self.batch_size]
                items = list(pool.map(self.dataset.__getitem__, idx))
                yield _stack(items)


def _stack(items):
    batch: Dict[str, np.ndarray] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        else:
            batch[key] = vals  # e.g. names
    return batch


def device_prefetch(iterator, *, size: int = 2, sharding=None,
                    device_keys=("image", "label"), put_fn=None):
    """Double-buffer batches onto the device (optionally sharded).

    Non-array fields (names) pass through on host. ``size=2`` is the classic
    compute/transfer overlap; larger only helps very jittery loaders.
    ``put_fn`` overrides the transfer entirely (batch -> device batch) — used
    by the Trainer to apply per-key mesh shardings off the critical path.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err_holder = []
    stop = threading.Event()

    def put(batch):
        if put_fn is not None:
            return put_fn(batch)
        out = dict(batch)
        for k in device_keys:
            if k in out and isinstance(out[k], np.ndarray):
                out[k] = jax.device_put(out[k], sharding) if sharding is not None \
                    else jax.device_put(out[k])
        return out

    def enqueue(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                if not enqueue(put(batch)):
                    return  # consumer gone: drop device refs, exit cleanly
        except BaseException as e:  # propagate into consumer
            err_holder.append(e)
        finally:
            enqueue(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err_holder:
                    raise err_holder[0]
                return
            yield item
    finally:
        # consumer abandoned mid-epoch (exception/GeneratorExit): unblock and
        # retire the producer so queued device batches are released
        stop.set()
        while True:  # drain whatever the producer managed to enqueue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
