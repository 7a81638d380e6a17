"""Clock abstraction so controllers are testable without real sleeps."""

from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class FakeClock(Clock):
    """Manually-stepped clock; sleep() advances time instead of blocking."""

    def __init__(self, start: float = 1000.0):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        self.step(max(0.0, seconds))

    def step(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds
