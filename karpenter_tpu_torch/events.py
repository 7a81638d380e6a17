"""Event recording: typed recorder + dedupe decorator (pkg/events).

The port's copy of karpenter_tpu/events.py."""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Tuple

# retained events per recorder: a long-lived runtime records on every
# provisioning/termination/interruption action, so an unbounded list is a
# slow leak — the ring keeps the newest window, like the apiserver's event
# TTL keeps only recent history
DEFAULT_EVENT_CAPACITY = 1000


@dataclass
class Event:
    kind: str
    reason: str
    message: str
    object_name: str
    timestamp: float = field(default_factory=time.time)


class Recorder:
    """Typed event surface (pkg/events/recorder.go:24-41). Events live in a
    bounded ring: appending past capacity evicts the oldest."""

    def __init__(self, capacity: int = DEFAULT_EVENT_CAPACITY):
        self.capacity = capacity
        self.events: Deque[Event] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def _record(self, kind: str, reason: str, message: str, name: str) -> None:
        with self._lock:
            self.events.append(Event(kind, reason, message, name))

    def nominate_pod(self, pod, node) -> None:
        self._record("Pod", "NominatePod", f"Pod should schedule on {node.name}", pod.name)

    def evict_pod(self, pod) -> None:
        self._record("Pod", "EvictPod", "Evicted pod", pod.name)

    def pod_failed_to_schedule(self, pod, err) -> None:
        self._record("Pod", "FailedScheduling", f"Failed to schedule pod, {err}", pod.name)

    def node_failed_to_drain(self, node, err) -> None:
        self._record("Node", "FailedDraining", f"Failed to drain node, {err}", node.name)

    def terminating_node(self, node, reason: str) -> None:
        self._record("Node", "TerminatingNode", reason, node.name)

    def launching_node(self, node, reason: str) -> None:
        self._record("Node", "LaunchingNode", reason, node.name)

    def waiting_on_readiness(self, node) -> None:
        self._record("Node", "WaitingOnReadiness", "Waiting on readiness to continue consolidation", node.name)

    def eviction_blocked(self, pod, reason: str) -> None:
        """A queued eviction that cannot proceed (do-not-disrupt veto):
        surfaced instead of silently retrying forever; identical repeats
        dedupe through DedupeRecorder's TTL window."""
        self._record("Pod", "EvictionBlocked", f"Eviction blocked, {reason}", pod.name)

    # interruption-subsystem events (controllers/interruption); identical
    # notices dedupe through DedupeRecorder's TTL window
    def node_interrupted(self, node, kind: str, message: str) -> None:
        reasons = {
            "spot_interruption": "SpotInterrupted",
            "rebalance_recommendation": "RebalanceRecommended",
            "scheduled_maintenance": "MaintenanceScheduled",
            "instance_stopped": "InstanceStopped",
            "instance_terminated": "InstanceTerminated",
        }
        self._record("Node", reasons.get(kind, "Interrupted"), message, node.name)

    def interruption_replacement_launched(self, node, pod_count: int) -> None:
        self._record(
            "Node", "InterruptionReplacement",
            f"Launching replacement capacity for {pod_count} pod(s) ahead of the drain", node.name,
        )

    def of(self, reason: str) -> List[Event]:
        with self._lock:
            return [e for e in self.events if e.reason == reason]

    def reset(self) -> None:
        with self._lock:
            self.events.clear()


class DedupeRecorder(Recorder):
    """TTL-deduped decorator (pkg/events/dedupe.go:25-95): identical events
    within the window are suppressed."""

    def __init__(self, inner: Recorder, ttl_seconds: float = 120.0, clock=None, capacity: int = DEFAULT_EVENT_CAPACITY):
        super().__init__(capacity=capacity)
        from .utils.clock import Clock

        self.inner = inner
        self.ttl = ttl_seconds
        self.clock = clock or Clock()
        self._seen: dict = {}

    def _record(self, kind: str, reason: str, message: str, name: str) -> None:
        key: Tuple[str, str, str, str] = (kind, reason, message, name)
        now = self.clock.now()
        with self._lock:
            expiry = self._seen.get(key)
            if expiry is not None and expiry > now:
                return
            self._seen[key] = now + self.ttl
            # mirror into our own list so the Recorder read surface
            # (of()/events) works on the wrapper too
            self.events.append(Event(kind, reason, message, name))
        self.inner._record(kind, reason, message, name)
