"""Scheduling queue: first-fit-decreasing order + progress detection.

Mirrors pkg/controllers/provisioning/scheduling/queue.go — pods sorted by CPU
descending, then memory descending, then creation time/UID for determinism;
the `attempts` budget terminates the relaxation loop once no pod schedules or
relaxes in a full pass.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

from ..api.objects import Pod
from ..utils import resources


def ffd_sort_key(pod: Pod) -> Tuple:
    requests = resources.pod_requests(pod)
    return (
        -requests.get(resources.CPU, 0.0),
        -requests.get(resources.MEMORY, 0.0),
        pod.metadata.creation_timestamp,
        pod.metadata.uid,
    )


class Queue:
    def __init__(self, pods: List[Pod]):
        self._pods = deque(sorted(pods, key=ffd_sort_key))
        self._last_popped: Optional[Pod] = None
        self._attempts = len(self._pods)

    def pop(self) -> Optional[Pod]:
        if not self._pods or self._attempts == 0:
            return None
        self._last_popped = self._pods.popleft()
        return self._last_popped

    def push(self, pod: Pod, relaxed: bool) -> None:
        """Re-queue a pod that failed to schedule. The attempts budget resets
        on relaxation (progress) and decrements when the same pod bounces
        straight back."""
        self._pods.append(pod)
        if relaxed or self._last_popped is not pod:
            self._attempts = len(self._pods)
        else:
            self._attempts -= 1

    def note_progress(self) -> None:
        """Reset the attempts budget after a pod successfully schedules.

        The reference's stated contract is 'keep trying as long as we are
        making progress' (queue.go:25-27); a successful placement is progress
        (it may unblock pods with affinity to the placed pod, or rebalance a
        skew), so the remaining pods deserve a fresh pass. Terminates: at most
        one reset per successful placement, so O(P^2) pops worst case."""
        self._attempts = len(self._pods)

    def remaining(self) -> List[Pod]:
        return list(self._pods)
