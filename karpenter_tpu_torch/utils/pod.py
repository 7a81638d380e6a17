"""Pod predicates (pkg/utils/pod/scheduling.go)."""

from __future__ import annotations

from ..api import labels as lbl
from ..api.objects import Pod


def is_provisionable(pod: Pod) -> bool:
    """Pending, not bound, marked unschedulable by kube-scheduler, and not
    actively preempting (pod/scheduling.go:24-31)."""
    return (
        not is_scheduled(pod)
        and not is_preempting(pod)
        and failed_to_schedule(pod)
        and not is_terminal(pod)
        and not is_terminating(pod)
    )


def is_scheduled(pod: Pod) -> bool:
    return bool(pod.spec.node_name)


def is_preempting(pod: Pod) -> bool:
    return bool(pod.status.nominated_node_name)


def failed_to_schedule(pod: Pod) -> bool:
    for condition in pod.status.conditions:
        if condition.type == "PodScheduled" and condition.status == "False" and condition.reason == "Unschedulable":
            return True
    return False


def is_terminal(pod: Pod) -> bool:
    return pod.status.phase in ("Succeeded", "Failed")


def is_terminating(pod: Pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_owned_by_daemonset(pod: Pod) -> bool:
    return _owned_by(pod, "DaemonSet")


def is_owned_by_node(pod: Pod) -> bool:
    return _owned_by(pod, "Node")


def is_owned(pod: Pod) -> bool:
    return bool(pod.metadata.owner_references)


def _owned_by(pod: Pod, kind: str) -> bool:
    return any(ref.kind == kind for ref in pod.metadata.owner_references)


def is_reschedulable(pod: Pod) -> bool:
    """Counts toward node emptiness / needs rescheduling on disruption.
    Daemonset pods, static (node-owned) mirror pods, and terminal pods do
    not (emptiness.go:105-110)."""
    return not is_owned_by_daemonset(pod) and not is_owned_by_node(pod) and not is_terminal(pod)


def is_node_empty(pods) -> bool:
    """The shared emptiness predicate used by the emptiness TTL and the
    consolidation empty-node fast path — one definition so they agree."""
    return not any(is_reschedulable(p) for p in pods)


def has_do_not_evict(pod: Pod) -> bool:
    return pod.metadata.annotations.get(lbl.DO_NOT_EVICT_ANNOTATION) == "true"


def has_do_not_disrupt(pod: Pod) -> bool:
    """The disruption veto, honoring both the karpenter.sh/do-not-disrupt
    spelling and the legacy karpenter.sh/do-not-evict one — a pod carrying
    either makes its node ineligible for voluntary disruption and surfaces
    as a blocked-eviction reason on involuntary drains."""
    return pod.metadata.annotations.get(lbl.DO_NOT_DISRUPT_ANNOTATION) == "true" or has_do_not_evict(pod)


def has_required_pod_affinity(pod: Pod) -> bool:
    return bool(
        pod.spec.affinity
        and pod.spec.affinity.pod_affinity
        and pod.spec.affinity.pod_affinity.required
    )


def has_pod_affinity(pod: Pod) -> bool:
    a = pod.spec.affinity
    return bool(a and a.pod_affinity and (a.pod_affinity.required or a.pod_affinity.preferred))


def has_pod_anti_affinity(pod: Pod) -> bool:
    a = pod.spec.affinity
    return bool(a and a.pod_anti_affinity and (a.pod_anti_affinity.required or a.pod_anti_affinity.preferred))


def has_required_pod_anti_affinity(pod: Pod) -> bool:
    a = pod.spec.affinity
    return bool(a and a.pod_anti_affinity and a.pod_anti_affinity.required)
