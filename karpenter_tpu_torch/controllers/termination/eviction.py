"""EvictionQueue: async pod eviction with PDB-aware per-item retry.

Mirrors pkg/controllers/termination/eviction.go:36-117 — evictions are
queued, attempted through the Eviction API, and individually re-queued with
exponential backoff (base 100ms, max 10s — the ItemExponentialFailureRateLimiter
at eviction.go:37-38,52) when a PodDisruptionBudget rejects them (the 429
path). A blocked pod never stalls the rest of the queue: each item carries
its own next-attempt time, so a drain pass skips pods still backing off and
keeps evicting the others (the reference's workqueue delivers the same
property by re-adding failures via AddRateLimited while the Start loop keeps
consuming, eviction.go:71-90).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional, Set

from ...analysis import WITNESS, guarded_by
from ...api.objects import Pod
from ...events import Recorder
from ...kube.cluster import KubeCluster
from ...utils import pod as podutils


@guarded_by("_lock", "_queue", "_queued", "_failures", "_not_before")
class EvictionQueue:
    BASE_DELAY = 0.1  # evictionQueueBaseDelay (eviction.go:37)
    MAX_DELAY = 10.0  # evictionQueueMaxDelay (eviction.go:38)

    def __init__(self, kube: KubeCluster, recorder: Optional[Recorder] = None, clock=None):
        from ...utils.clock import Clock

        self.kube = kube
        self.recorder = recorder or Recorder()
        self.clock = clock or kube.clock or Clock()
        self._lock = WITNESS.lock("termination.eviction")
        self._queue: Deque[Pod] = deque()
        self._queued: Set[str] = set()
        self._failures: Dict[str, int] = {}
        self._not_before: Dict[str, float] = {}

    def add(self, *pods: Pod) -> None:
        with self._lock:
            for pod in pods:
                if pod.uid not in self._queued:
                    self._queued.add(pod.uid)
                    self._queue.append(pod)

    def _forget(self, pod: Pod) -> None:
        with self._lock:
            self._queued.discard(pod.uid)
            self._failures.pop(pod.uid, None)
            self._not_before.pop(pod.uid, None)

    def _requeue_failed(self, pod: Pod, now: float) -> None:
        with self._lock:
            n = self._failures.get(pod.uid, 0) + 1
            self._failures[pod.uid] = n
            self._not_before[pod.uid] = now + min(self.MAX_DELAY, self.BASE_DELAY * (2 ** (n - 1)))
            self._queue.append(pod)

    def drain_once(self, budget: int = 1000) -> int:
        """Attempt up to `budget` due evictions; PDB-blocked pods re-queue with
        per-item exponential backoff and do NOT block later items. Returns the
        number evicted."""
        evicted = 0
        attempts = 0
        now = self.clock.now()
        with self._lock:
            passes = len(self._queue)
        for _ in range(passes):
            if attempts >= budget:
                break
            with self._lock:
                if not self._queue:
                    break
                pod = self._queue.popleft()
                if self._not_before.get(pod.uid, 0.0) > now:
                    # still backing off: rotate to the tail, keep draining others
                    self._queue.append(pod)
                    continue
            attempts += 1
            current = self.kube.get("Pod", pod.name, pod.namespace)
            if current is None:
                self._forget(pod)  # 404: already gone counts as evicted (eviction.go:100-102)
                continue
            if podutils.has_do_not_disrupt(current) and not podutils.is_terminal(current):
                # the disruption veto (karpenter.sh/do-not-disrupt, legacy
                # do-not-evict): surfaced as a blocked-eviction reason — an
                # involuntary drain must not retry it silently forever
                self.recorder.eviction_blocked(current, "pod has karpenter.sh/do-not-disrupt")
                self._requeue_failed(pod, now)
                continue
            if self.kube.evict_pod(pod):
                self.recorder.evict_pod(pod)
                self._forget(pod)
                evicted += 1
            else:
                # PDB rejected (429): individual backoff, siblings continue
                self._requeue_failed(pod, now)
        return evicted

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)
