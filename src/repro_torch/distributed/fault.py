"""Fault-tolerance runtime policies: preemption handling and straggler
watch (the port's copy of `repro.distributed.fault`).

  * SIGTERM/SIGINT (a preemption notice): finish the in-flight step, write
    a blocking checkpoint and exit cleanly (`PreemptionGuard`).
  * Straggler detection: an EWMA of each step's wall-clock time; a step
    slower than ``threshold`` x the EWMA is recorded with its step, so a
    launcher can re-balance or evict the slow host (`StragglerWatch`).
    The data pipeline is deterministic per (step, shard), which makes
    re-assigning a shard safe.
"""
from __future__ import annotations

import signal
import time


class PreemptionGuard:
    """Context manager: converts SIGTERM/SIGINT into a `should_stop` flag
    checked at step boundaries, guaranteeing a final checkpoint."""

    def __init__(self):
        self.should_stop = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.should_stop = True

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


class StragglerWatch:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma = None
        self.flagged: list[tuple[int, float]] = []
        self._t0 = None

    def step_begin(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> bool:
        dt = time.monotonic() - self._t0
        slow = False
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.flagged.append((step, dt))
            slow = True
        self.ewma = dt if self.ewma is None else ((1 - self.alpha) * self.ewma + self.alpha * dt)
        return slow
