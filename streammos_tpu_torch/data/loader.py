"""Input pipeline: background prefetching and a multi-process sample loader.

Counterpart of `streammos_tpu/data/loader.py`. `SampleWorkerPool` runs
``dataset[i]`` in worker processes (the per-sample host work — file IO,
ego alignment, copy-paste, 3 windows of filter/resample/augment — is
single-threaded numpy), the parent collates, and `PrefetchLoader` overlaps
collation and the copy to the card with device compute.

The workers are started with ``spawn``, not ``fork``: the parent has made
its CUDA context (and its threads) before the pool starts, and a forked
child inherits that state. A spawned worker starts from a fresh
interpreter and imports only the dataset's modules, which are numpy: it
touches neither torch nor CUDA. The datasets return numpy arrays; the
parent makes the tensors. As with any spawn pool, a worker imports the
parent's main module again, so a script that starts a pool keeps its work
under ``if __name__ == "__main__":``.
"""
from __future__ import annotations

import collections
import itertools
import multiprocessing as mp
import os
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Sequence


class PrefetchLoader:
    """Wrap an iterator; a daemon thread keeps ``depth`` items ready. An
    exception raised by the iterator is raised again by the consumer."""

    _DONE = object()

    def __init__(self, it: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # handed to the consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item


# the dataset of this worker process (set once by `_worker_init`)
_WORKER_DS = None


def _worker_init(dataset, base_seed: int) -> None:
    global _WORKER_DS
    _WORKER_DS = dataset
    # an augmentation stream of its own for each worker: base_seed + 1000 *
    # the worker's process identity (1, 2, ... in the order the parent
    # created processes)
    ident = mp.current_process()._identity
    wid = ident[0] if ident else 0
    if hasattr(dataset, "reseed"):
        dataset.reseed(base_seed + 1000 * wid)


def _worker_get(index: int):
    return _WORKER_DS[index]


class SampleWorkerPool:
    """Run ``dataset[i]`` across worker processes, results in order.

    ``num_workers=0`` loads inline, in the calling process. The number of
    workers is capped at the host's cores less 2 (left to the parent for
    collation, the copies to the card and the launches)."""

    def __init__(self, dataset, num_workers: int, seed: int = 0):
        cores = os.cpu_count() or 1
        num_workers = min(num_workers, max(cores - 2, 0))
        self.dataset = dataset
        self.num_workers = num_workers
        self._pool = None
        if num_workers > 0:
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(num_workers, initializer=_worker_init,
                                  initargs=(dataset, seed))

    def map_ordered(self, indices: Sequence[int]) -> Iterator:
        """Yield dataset[i] for each index, in order, loaded in parallel.
        At most two samples a worker are in flight, so a consumer that
        stops early (``--max-steps``) leaves no epoch's worth of loading
        queued ahead of the next epoch."""
        if self._pool is None:
            for i in indices:
                yield self.dataset[int(i)]
            return
        todo = iter([int(i) for i in indices])
        pending = collections.deque(
            self._pool.apply_async(_worker_get, (i,))
            for i in itertools.islice(todo, 2 * self.num_workers))
        while pending:
            sample = pending.popleft().get()
            for i in itertools.islice(todo, 1):
                pending.append(self._pool.apply_async(_worker_get, (i,)))
            yield sample

    def batches(self, indices: Sequence[int], batch_size: int,
                collate: Callable[[List], object]) -> Iterator:
        """Collated batches of ``batch_size`` over ``indices``; a short
        tail is dropped (`parallel.process_shard_indices` pads the order
        to a multiple of the batch)."""
        buf: List = []
        for sample in self.map_ordered(indices):
            buf.append(sample)
            if len(buf) == batch_size:
                yield collate(buf)
                buf = []

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
