"""Disruption-cost model (pkg/controllers/consolidation/helpers.go:30-69).

Per-pod cost from the pod deletion-cost annotation and priority, clamped to
[-10, 10], summed per node, scaled by the node's remaining lifetime fraction
(nodes close to expiry are cheap to disrupt).

The port's copy of karpenter_tpu/controllers/consolidation/helpers.py.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ...api.objects import Pod

POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"


def _clamp(value: float, low: float, high: float) -> float:
    return max(low, min(high, value))


def pod_cost(pod: Pod) -> float:
    cost = 1.0
    annotation = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if annotation is not None:
        try:
            cost += _clamp(float(annotation) / 100.0, -10.0, 10.0)
        except ValueError:
            pass
    if pod.spec.priority is not None:
        cost += _clamp(pod.spec.priority / 1_000_000.0, -10.0, 10.0)
    return _clamp(cost, -10.0, 10.0)


def disruption_cost(pods: Iterable[Pod], lifetime_remaining: float = 1.0) -> float:
    return sum(pod_cost(p) for p in pods) * lifetime_remaining


def lifetime_remaining(clock, node, ttl_seconds_until_expired: Optional[float]) -> float:
    """Fraction of provisioned lifetime left (1.0 when no expiry TTL)."""
    if not ttl_seconds_until_expired:
        return 1.0
    age = clock.now() - node.metadata.creation_timestamp
    return max(0.0, 1.0 - age / ttl_seconds_until_expired)
