"""Graceful preemption for training loops (``deco_tpu/utils/preemption.py``).

Cluster schedulers deliver SIGTERM with a grace window. Python's default
disposition kills the process without unwinding, so the fit loop's
on-exception checkpoint never runs. ``PreemptionGuard`` turns the first
SIGTERM into a stop flag the fit loop checks once per step: the loop
breaks, the end-of-fit save writes a resumable checkpoint, and the process
exits cleanly. A second SIGTERM restores the default disposition
(immediate termination) so a hung save cannot block the scheduler.
"""

from __future__ import annotations

import signal
import sys


class PreemptionGuard:
    """Context manager: first SIGTERM -> ``requested`` flag; second -> die.

    Installs its handler only in the main thread (a requirement of the
    signal module); elsewhere it is a no-op guard whose ``requested`` stays
    False.
    """

    def __init__(self):
        self.requested = False
        self._prev = None
        self._installed = False

    def _handler(self, signum, frame):
        if self.requested:  # second signal: give up immediately
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)
        self.requested = True
        print("PreemptionGuard: SIGTERM received; finishing the current step, checkpointing "
              "and exiting (send again to force-kill)", file=sys.stderr, flush=True)

    def __enter__(self):
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        except ValueError:  # not the main thread
            pass
        return self

    def __exit__(self, *exc):
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
        return False
