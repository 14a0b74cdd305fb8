"""Threaded prefetching batch loader (copy of `passion_tpu/data/loader.py`).

The counterpart of the reference's `MultiEpochsDataLoader`
(utils/lr_scheduler.py:91-109): instead of persistent worker *processes*, a
thread pool loads and augments items (numpy/scipy release the GIL for the
heavy ops) while a background prefetcher keeps `prefetch` batches ready, so
host data work overlaps device steps. Batches are numpy; the train loop
moves them to the device.

Reproducibility: item randomness comes from a per-(seed, epoch, index)
`numpy.random.Generator`, strictly stronger than the reference's per-worker
reseeding (data/data_utils.py:9-13) — results are independent of thread
scheduling.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _stack(items):
    out = {}
    for k in items[0]:
        v0 = items[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([it[k] for it in items])
        else:
            out[k] = [it[k] for it in items]
    return out


class PrefetchLoader:
    def __init__(self, dataset, batch_size=1, shuffle=True, seed=1037,
                 drop_last=False, num_threads=8, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self, epoch):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield order[i:i + self.batch_size]

    def _load_item(self, epoch, index):
        rng = np.random.default_rng((self.seed, epoch, int(index)))
        return self.dataset.get(int(index), rng)

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item):
            # bounded put that gives up when the consumer is gone, so an
            # abandoned iterator never leaves a thread blocked forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def producer():
            end = None
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idxs in self._batches(epoch):
                        if stop.is_set():
                            return
                        items = list(pool.map(
                            lambda i: self._load_item(epoch, i), idxs))
                        _put(_stack(items))
            except BaseException as e:  # forward to the consumer: a worker
                end = e                 # error must raise there, not hang it
            _put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
