"""Host-side data loading: shuffling, batching, thread prefetch
(``deco_tpu/data/loader.py``).

One process feeds one card, so the shard is rank 0 of 1 unless the caller
gives ``process_index``/``process_count``. The per-epoch shuffle is
``RandomState(seed + epoch)``, the padding and batching are the JAX
loader's, so the same dataset gives the same batches in the same order.
Batches are prepared on a thread pool; image decode (``zlib``, libjpeg) and
the resampler's matmuls release the interpreter lock.

Streaming datasets (no ``__len__``/``__getitem__``: the packed t2i
readers) go through :class:`IterableLoader`, which batches and prefetches
on one thread and shards nothing (the dataset shards itself). It has no
``set_position``: a resumed run restarts its stream, as the JAX loop does.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


def collate(samples):
    """Stack (x, y, metadata) tuples; metadata values stacked when array-like,
    numbers as arrays, anything else as lists. (The JAX collate's
    ``micro_batch`` mode serves datasets the port does not have yet.)"""
    xs = np.stack([np.asarray(s[0], np.float32) for s in samples])
    ys_raw = [s[1] for s in samples]
    if isinstance(ys_raw[0], (int, np.integer)):
        ys = np.asarray(ys_raw, np.int64)
    elif isinstance(ys_raw[0], np.ndarray):
        ys = np.stack(ys_raw)
    else:
        ys = ys_raw  # strings (prompts)
    metadata = {}
    for k in samples[0][2].keys():
        vals = [s[2][k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            metadata[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            metadata[k] = np.asarray(vals)
        else:
            metadata[k] = vals
    return xs, ys, metadata


def _prefetched(batches: Iterator, prefetch: int) -> Iterator:
    """The items of ``batches``, produced on a daemon thread at most
    ``prefetch`` ahead of the consumer. An error raised while producing
    them is raised to the consumer at its place in the stream; once the
    consumer has left, the producer stops at its next item."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            for b in batches:
                if stop.is_set():
                    return
                q.put(b)
                if stop.is_set():
                    return
            q.put(None)
        except BaseException as e:  # raised again in the consumer
            # once the consumer has left (e.g. its pool shut down mid-submit),
            # nobody reads the queue: dropped
            if not stop.is_set():
                q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # unblock a producer stuck in q.put so it can see stop
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


class ShardedLoader:
    """Map-style dataset -> shard of this process -> shuffled batches, prefetched."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, num_workers: int = 4, prefetch: int = 4,
                 process_index: Optional[int] = None, process_count: Optional[int] = None,
                 infinite: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.infinite = infinite
        self.rank = 0 if process_index is None else process_index
        self.world = 1 if process_count is None else process_count
        self.epoch = 0
        self._start_offset = 0  # first-epoch batch offset (set_position)

    def set_position(self, global_batch: int) -> None:
        """Fast-forward to the ``global_batch``-th batch of the stream.

        The shuffle is a pure function of (seed, epoch), so (epoch, offset)
        fixes the stream and skipping costs index arithmetic only. A fit
        resumed at step S calls ``set_position(S)`` (one batch per step).
        """
        if global_batch < 0:
            raise ValueError(f"global_batch must be >= 0, got {global_batch}")
        per_epoch = len(self)
        self.epoch = global_batch // per_epoch
        self._start_offset = global_batch % per_epoch

    def _shard_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.RandomState(self.seed + epoch).permutation(n)
        # pad to a multiple of world, and to at least one full batch per shard
        per = max(-(-n // self.world), self.batch_size if self.drop_last else 1)
        target = per * self.world
        while len(idx) < target:
            idx = np.concatenate([idx, idx[:target - len(idx)]])
        return idx[self.rank::self.world]

    def __len__(self):
        per = len(self._shard_indices(0))
        if self.drop_last:
            return per // self.batch_size
        return -(-per // self.batch_size)

    def _epoch_batches(self, epoch: int, skip: int = 0) -> Iterator:
        idx = self._shard_indices(epoch)
        nb = (len(idx) // self.batch_size if self.drop_last
              else -(-len(idx) // self.batch_size))
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)][skip:]

        def fetch(bidx):
            return collate([self.dataset[int(i)] for i in bidx])

        def fetched(pool):
            futures = [pool.submit(fetch, b) for b in batches[:self.prefetch]]
            for i in range(len(batches)):
                yield futures[i].result()
                if i + self.prefetch < len(batches):
                    futures.append(pool.submit(fetch, batches[i + self.prefetch]))

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            yield from _prefetched(fetched(pool), self.prefetch)

    def __iter__(self):
        epoch = self.epoch
        skip, self._start_offset = self._start_offset, 0
        while True:
            yield from self._epoch_batches(epoch, skip=skip)
            skip = 0
            epoch += 1
            if not self.infinite:
                break
        self.epoch = epoch


class IterableLoader:
    """Batches of a streaming dataset, collated and prefetched on a thread.

    ``drop_last`` drops a short last batch; ``infinite`` iterates the
    dataset again after it ends. An error in the stream is raised to the
    consumer at its place in the stream.
    """

    def __init__(self, dataset, batch_size: int, drop_last: bool = True, prefetch: int = 4,
                 infinite: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.infinite = infinite

    def _batches(self) -> Iterator:
        while True:
            buf = []
            for sample in self.dataset:
                buf.append(sample)
                if len(buf) == self.batch_size:
                    yield collate(buf)
                    buf = []
            if buf and not self.drop_last:
                yield collate(buf)
            if not self.infinite:
                return

    def __iter__(self):
        return _prefetched(self._batches(), self.prefetch)


def make_loader(dataset, batch_size: int, **kwargs):
    """A :class:`ShardedLoader` for a map-style dataset, an
    :class:`IterableLoader` for a stream (which takes no shuffle, seed,
    workers or process arguments: the stream shards and shuffles itself)."""
    if hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__"):
        return ShardedLoader(dataset, batch_size, **kwargs)
    for k in ("shuffle", "seed", "num_workers", "process_index", "process_count"):
        kwargs.pop(k, None)
    return IterableLoader(dataset, batch_size, **kwargs)
