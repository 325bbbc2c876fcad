"""Straggler mitigation — the port of ``StragglerWatchdog`` from
``repro/train/elastic.py``.

A step-time watchdog flags steps slower than ``threshold`` times the
rolling median: on a fleet the signal that swaps in hot spares, in one
process a log field.  The reference's ``reshard_tree`` and
``simulate_failure_and_resume`` place a restored tree onto a JAX ``Mesh``;
they wait for the port's distribution (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Optional

import numpy as np

__all__ = ["StragglerWatchdog"]


class StragglerWatchdog:
    """Flags steps slower than ``threshold x`` the rolling median.

    The window is small so the detector adapts to phase changes; the
    caller excludes the first step and checkpoint steps (``exclude=True``).
    A step is timed on the host's clock from :meth:`start` to :meth:`stop`,
    with no device synchronisation, as the reference times its dispatch.
    """

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.times: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.flagged = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, exclude: bool = False) -> bool:
        """Returns True if this step is a straggler."""
        if self._t0 is None:
            return False
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if exclude or len(self.times) < 5:
            if not exclude:
                self.times.append(dt)
            return False
        med = float(np.median(self.times))
        self.times.append(dt)
        if dt > self.threshold * med:
            self.flagged += 1
            return True
        return False
