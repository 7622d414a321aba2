"""Host data pipeline: a multi-threaded prefetching batch loader, the port
of ``magicmirror/data/loader.py``.

Worker threads run the decode and augmentation steps while the previous
batch trains on the card; batches are stacked NHWC numpy, dropped-last like
the reference, in the JAX package's index order (a shuffle by
``random.Random(seed + epoch)``, the epoch counted from 1).  The multi-host
split (``shard`` over more than one process) is not ported: given, it
raises.
"""
from __future__ import annotations

import queue
import random as _random
import threading

import numpy as np


def _collate(samples):
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # paths etc.
    return out


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 num_workers=4, prefetch_factor=3, seed=None, shard=None):
        """``shard=(process_index, process_count)`` is the JAX package's
        multi-host data split; the port runs one process, so a count above
        1 raises."""
        if shard is not None and shard[1] > 1:
            raise NotImplementedError(
                "the multi-host data split (shard over more than one process) is not "
                "ported")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_factor = prefetch_factor
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            rng = _random.Random(None if self.seed is None
                                 else self.seed + self._epoch)
            rng.shuffle(idx)
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if chunk:
                yield chunk

    def __iter__(self):
        self._epoch += 1
        batches = list(self._batches())
        task_q: "queue.Queue" = queue.Queue()
        results = {}
        results_cv = threading.Condition()
        max_ahead = self.prefetch_factor * self.num_workers
        next_out = [0]

        for i, chunk in enumerate(batches):
            task_q.put((i, chunk))

        def worker():
            while True:
                try:
                    i, chunk = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = _collate([self.dataset[j] for j in chunk])
                except Exception as e:  # surface worker errors to the consumer
                    batch = e
                with results_cv:
                    # backpressure: don't decode unboundedly ahead of training
                    while i - next_out[0] > max_ahead:
                        results_cv.wait()
                    results[i] = batch
                    results_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        for i in range(len(batches)):
            with results_cv:
                while i not in results:
                    results_cv.wait()
                batch = results.pop(i)
                next_out[0] = i + 1
                results_cv.notify_all()
            if isinstance(batch, Exception):
                raise batch
            yield batch
