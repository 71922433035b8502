"""Host-side data loading: shuffling, batching, thread prefetch
(``deco_tpu/data/loader.py``).

``process_index``/``process_count`` are this process's rank and the size of
the mesh's data axis (default 0 of 1): the loader walks the global batches
of ``batch_size * process_count`` rows that one process over the whole
world would load and decodes only this rank's rows of each
(``parallel.mesh.rank_rows``: its 1/count of each of the ``microbatches``),
so a fit on W ranks sees the world-1 fit's global batch. The per-epoch
shuffle is ``RandomState(seed + epoch)``, and the padding and batching of
one rank are the JAX loader's, so the same dataset gives the same batches
in the same order.
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

from deco_tpu_torch.parallel.mesh import rank_rows


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
                 infinite: bool = False, microbatches: int = 1):
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
        self.rows = rank_rows(self.rank, self.world, batch_size, microbatches)
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

    def _global_indices(self, epoch: int) -> np.ndarray:
        """The epoch's dataset indices in order, padded to at least one
        global batch (drop_last) by repeating from the start."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.RandomState(self.seed + epoch).permutation(n)
        target = max(n, self.batch_size * self.world if self.drop_last else 1)
        while len(idx) < target:
            idx = np.concatenate([idx, idx[:target - len(idx)]])
        return idx

    def __len__(self):
        n, g = len(self._global_indices(0)), self.batch_size * self.world
        return n // g if self.drop_last else -(-n // g)

    def _epoch_batches(self, epoch: int, skip: int = 0) -> Iterator:
        idx = self._global_indices(epoch)
        g = self.batch_size * self.world
        nb = len(idx) // g if self.drop_last else -(-len(idx) // g)
        batches = [idx[j * g:(j + 1) * g] for j in range(nb)][skip:]
        batches = [b[self.rows[self.rows < len(b)]] for b in batches]

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
    workers or process arguments: the stream shuffles itself, and reads the
    shard of ``process_index`` of ``process_count`` unless its config fixed
    one)."""
    if hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__"):
        return ShardedLoader(dataset, batch_size, **kwargs)
    if kwargs.get("process_count") is not None and hasattr(dataset, "use_loader_shard"):
        dataset.use_loader_shard(kwargs.get("process_index") or 0, kwargs["process_count"])
    for k in ("shuffle", "seed", "num_workers", "process_index", "process_count",
              "microbatches"):
        kwargs.pop(k, None)
    return IterableLoader(dataset, batch_size, **kwargs)
