"""Batcher: windowed batching of provisioning triggers.

Mirrors pkg/controllers/provisioning/batcher.go:27-99 — the window opens on
the first trigger, extends while triggers keep arriving within the idle
duration (default 1s), and is capped at the max duration (default 10s). The
immediate-flush path keeps tests deterministic.

This is the same batching discipline the dense solver wants anyway: one
large solve per window beats many small dispatches (host<->device latency).
"""

from __future__ import annotations

from ...analysis import WITNESS, guarded_by
from ...config import Config


@guarded_by("_cond", "_triggered", "_immediate", "_trigger_time")
class Batcher:
    def __init__(self, config: Config, clock=None):
        from ...utils.clock import Clock

        self.config = config
        self.clock = clock or Clock()
        self._cond = WITNESS.condition("provisioning.batcher")
        self._triggered = False
        self._immediate = False
        self._trigger_time = 0.0

    def trigger(self) -> None:
        with self._cond:
            self._triggered = True
            self._trigger_time = self.clock.now()
            self._cond.notify_all()

    def trigger_immediate(self) -> None:
        """Flush the window now (test hook, batcher.go:56)."""
        with self._cond:
            self._triggered = True
            self._immediate = True
            self._cond.notify_all()

    def wait(self, poll_interval: float = 0.05, deadline=None) -> bool:
        """Block until a batch window completes; True if triggered. A
        `deadline` (clock instant) bounds the idle wait: when it passes with
        no trigger the call returns True anyway, so a caller holding parked
        work (the provisioner's insufficient-capacity backoff) re-enters its
        round without needing a fresh pod event to fire."""
        with self._cond:
            while not self._triggered:
                if deadline is not None and self.clock.now() >= deadline:
                    return True
                self._cond.wait(timeout=poll_interval)
        window_start = self.clock.now()
        last_trigger = window_start
        while True:
            with self._cond:
                if self._immediate:
                    self._immediate = False
                    self._triggered = False
                    return True
                if self._trigger_time > last_trigger:
                    last_trigger = self._trigger_time
            now = self.clock.now()
            if now - window_start >= self.config.batch_max_duration:
                break
            if now - last_trigger >= self.config.batch_idle_duration:
                break
            self.clock.sleep(min(poll_interval, self.config.batch_idle_duration))
        with self._cond:
            self._triggered = False
        return True
