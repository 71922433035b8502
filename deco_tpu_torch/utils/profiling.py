"""Tracing and profiling hooks (``deco_tpu/utils/profiling.py``).

- :func:`trace`: a context manager that records a ``torch.profiler`` trace
  of the CPU and, where there is one, the CUDA device, and writes it into
  ``logdir`` (a Chrome trace that TensorBoard's profile plugin and
  ``chrome://tracing`` open).
- :func:`annotate`: a named range (``torch.profiler.record_function``) that
  the trace and ``key_averages()`` attribute the device time under.
- :class:`StepTimer`: wall time per step, images/s, smoothed by an EMA.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Record a profiler trace of the block and write it into ``logdir``;
    yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """A named range, visible in profiler timelines."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step timing: step seconds, their EMA and images/s."""

    def __init__(self, batch_size: int, ema_decay: float = 0.9):
        self.batch_size = batch_size
        self.ema_decay = ema_decay
        self._last: Optional[float] = None
        self._ema: Optional[float] = None

    def tick(self) -> dict:
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return {}
        dt = now - self._last
        self._last = now
        self._ema = dt if self._ema is None else (
            self._ema * self.ema_decay + dt * (1 - self.ema_decay))
        return {"step_time_s": dt, "step_time_ema_s": self._ema,
                "images_per_sec": self.batch_size / self._ema}
