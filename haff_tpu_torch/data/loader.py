"""Background prefetching loader with a worker pool (port of
haff_tpu/data/loader.py).

The reference uses torch DataLoader workers (train_ds.py --num_workers,
launched via the DeepSpeed engine at train_ds.py:381-393). Here a pool
of threads builds collated numpy batches ahead of the device while the
card computes. Threads, not processes: the batches are numpy arrays
built by cv2 and numpy, which release the GIL in their hot loops, so
nothing is pickled across a process boundary. Batches are delivered
strictly in index order regardless of worker completion order.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, Optional


class PrefetchLoader:
    def __init__(self, make_batch: Callable[[int], dict],
                 num_batches: int, prefetch: int = 2,
                 num_workers: int = 1):
        assert num_workers >= 1
        self.make_batch = make_batch
        self.num_batches = num_batches
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._next_build = 0           # next index a worker may claim
        self._next_out = 0             # next index the consumer emits
        self._results: Dict[int, dict] = {}
        self._err: Optional[BaseException] = None
        # bound on batches built-but-not-consumed (+ one in flight per
        # worker) so a fast producer can't run ahead of the device
        self._window = prefetch + num_workers
        self._threads = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(num_workers)]
        for t in self._threads:
            t.start()

    def _work(self):
        while True:
            with self._lock:
                while (self._err is None
                       and self._next_build - self._next_out >= self._window):
                    self._ready.wait()
                if self._err is not None or self._next_build >= self.num_batches:
                    return
                i = self._next_build
                self._next_build += 1
            try:
                batch = self.make_batch(i)
            except BaseException as e:  # surfaced on the consumer side
                with self._lock:
                    self._err = e
                    self._ready.notify_all()
                return
            with self._lock:
                self._results[i] = batch
                self._ready.notify_all()

    def __iter__(self) -> Iterator[dict]:
        while self._next_out < self.num_batches:
            with self._lock:
                # deliver every in-order batch that IS built before
                # surfacing a later batch's error (the single-producer
                # loader delivered all pre-error batches; keep that)
                while self._next_out not in self._results:
                    if self._err is not None:
                        raise self._err
                    self._ready.wait()
                item = self._results.pop(self._next_out)
                self._next_out += 1
                self._ready.notify_all()
            yield item
