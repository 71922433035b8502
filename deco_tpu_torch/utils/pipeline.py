"""Software-pipelined device -> host prediction loop
(``deco_tpu/utils/pipeline.py``).

CUDA launches are asynchronous: PyTorch returns from a kernel launch while
the card is still running earlier work on the stream, and only a copy to
the host (``.cpu()``, ``.item()``) waits for it. A serial predict loop
reads each batch back before it launches the next, so the card idles while
the host writes PNGs and the npz and makes the next batch's noise.
:func:`pipelined_map` keeps up to ``depth`` batches in flight: the host
reads back and consumes batch ``k`` while the card runs batch ``k + 1``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable


def pipelined_map(batches: Iterable[Any], dispatch: Callable[[Any], Any],
                  consume: Callable[[Any, Any], None], depth: int = 1) -> int:
    """Run ``consume(dispatch(b), b)`` over ``batches`` with overlap.

    ``dispatch`` only launches device work and returns its (device) outputs;
    ``consume`` does the blocking host work (the copy to the host and the
    hooks). Up to ``depth`` dispatched batches stay in flight before the
    oldest is consumed; ``depth=0`` is the serial loop.

    Returns the number of batches processed, in batch order. If ``dispatch``
    (or the ``batches`` iterator) raises, every batch already dispatched is
    consumed first, then the error propagates. ``consume`` errors propagate
    at once.
    """
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")
    inflight: deque = deque()
    n = 0

    def drain(limit: int) -> None:
        nonlocal n
        while len(inflight) > limit:
            out, bb = inflight.popleft()
            consume(out, bb)
            n += 1

    it = iter(batches)
    while True:
        try:
            b = next(it)
            inflight.append((dispatch(b), b))
        except StopIteration:
            break
        except BaseException:
            drain(0)
            raise
        drain(depth)
    drain(0)
    return n
