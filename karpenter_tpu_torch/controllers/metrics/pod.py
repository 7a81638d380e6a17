"""Pod metrics: per-pod state gauge with the reference's full label
dimensionality — name, namespace, owner, node, provisioner, zone, arch,
capacity_type, instance_type, phase — plus the pending→running startup-time
summary.

Mirrors pkg/controllers/metrics/pod/controller.go:41-152: one gauge series
of value 1 per pod; the owner label is the synthesized selflink of the first
owner reference (controller.go:165-173); node-derived labels read the
scheduled node's own labels and degrade to "N/A" when the pod is unscheduled
or its node is gone, with the provisioner falling back to the pod's
nodeSelector (controller.go:179-190). Startup time is observed once per pod
when it first leaves Pending for Running (the pendingPods set semantics;
this scrape-driven port measures against the clock rather than the Ready
condition's transition time, which the simulation does not carry).

A scrape reads the pods and their nodes from the kube client's informer
cache (`cached_pods`, `cached_node`), as Karpenter's controller reads
controller-runtime's cached client: over HTTP a scrape sends no request.
"""

from __future__ import annotations

from ...api import labels as lbl
from ...kube.cluster import KubeCluster
from ...metrics import REGISTRY, Registry

NOT_APPLICABLE = "N/A"

LABEL_NAMES = (
    "name",
    "namespace",
    "owner",
    "node",
    "provisioner",
    "zone",
    "arch",
    "capacity_type",
    "instance_type",
    "phase",
)


def owner_selflink(pod) -> str:
    """Synthesized selflink of the first owner reference
    (controller.go:165-173); empty for ownerless pods."""
    if not pod.metadata.owner_references:
        return ""
    ref = pod.metadata.owner_references[0]
    return f"/apis/{ref.api_version}/namespaces/{pod.namespace}/{ref.kind.lower()}s/{ref.name}"


class PodMetricsController:
    def __init__(self, kube: KubeCluster, registry: Registry = REGISTRY):
        self.kube = kube
        self.gauge = registry.gauge(
            "karpenter_pods_state",
            "Pod state is the current state of pods. This metric can be used several ways "
            "as it is labeled by the pod name, namespace, owner, node, provisioner name, "
            "zone, architecture, capacity type, instance type and pod phase.",
            label_names=LABEL_NAMES,
        )
        self.startup_summary = registry.summary(
            "karpenter_pods_startup_time_seconds",
            "The time from pod creation until the pod is running.",
        )
        self._pending: set = set()

    def _labels(self, pod) -> dict:
        values = {
            "name": pod.metadata.name,
            "namespace": pod.namespace,
            "owner": owner_selflink(pod),
            "node": pod.spec.node_name or "",
            "phase": pod.status.phase,
        }
        node = self.kube.cached_node(pod.spec.node_name) if pod.spec.node_name else None
        if node is None:
            values["zone"] = NOT_APPLICABLE
            values["arch"] = NOT_APPLICABLE
            values["capacity_type"] = NOT_APPLICABLE
            values["instance_type"] = NOT_APPLICABLE
            # an unscheduled pod still attributes to a provisioner when its
            # selector names one (controller.go:184-188)
            values["provisioner"] = pod.spec.node_selector.get(lbl.PROVISIONER_NAME_LABEL, NOT_APPLICABLE)
        else:
            node_labels = node.metadata.labels
            values["zone"] = node_labels.get(lbl.LABEL_TOPOLOGY_ZONE, "")
            values["arch"] = node_labels.get(lbl.LABEL_ARCH, "")
            values["capacity_type"] = node_labels.get(lbl.LABEL_CAPACITY_TYPE, "")
            values["instance_type"] = node_labels.get(lbl.LABEL_INSTANCE_TYPE, "")
            values["provisioner"] = node_labels.get(lbl.PROVISIONER_NAME_LABEL, NOT_APPLICABLE)
        return values

    def scrape(self) -> None:
        self.gauge.clear()
        live: set = set()
        for pod in self.kube.cached_pods():
            live.add(pod.uid)
            self.gauge.set(1, **self._labels(pod))
            # pendingPods semantics (controller.go:145-152): observe startup
            # only for pods THIS controller saw Pending first — a restart
            # must not record day-old Running pods as fresh startups
            if pod.status.phase == "Pending":
                self._pending.add(pod.uid)
            elif pod.status.phase == "Running" and pod.uid in self._pending:
                self._pending.discard(pod.uid)
                startup = max(0.0, self.kube.clock.now() - pod.metadata.creation_timestamp)
                self.startup_summary.observe(startup)
        # pods deleted while still Pending would otherwise pin their uid here
        # forever (a slow leak on churning unschedulable workloads)
        self._pending &= live
