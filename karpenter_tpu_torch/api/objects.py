"""Minimal Kubernetes object model.

The framework is a control plane over pods and nodes; this module defines the
slice of the Kubernetes API surface the scheduler and controllers consume,
as plain dataclasses. Field names follow Kubernetes spelling (snake_cased) so
the mapping to the real API is mechanical. Resource lists are canonical-unit
float dicts (see utils.resources).
"""

from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.quantity import parse_quantity

_sequence = itertools.count(1)


def _next_uid() -> str:
    return f"uid-{next(_sequence):08d}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = field(default_factory=_next_uid)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    finalizers: List[str] = field(default_factory=list)
    owner_references: List["OwnerReference"] = field(default_factory=list)
    resource_version: int = 0

    def __post_init__(self):
        if not self.name:
            self.name = f"object-{uuid.uuid4().hex[:12]}"


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    api_version: str = ""
    controller: bool = False
    block_owner_deletion: bool = False


# ---------------------------------------------------------------------------
# Selectors / requirements
# ---------------------------------------------------------------------------

# NodeSelectorOperator values
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str
    values: List[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        for key, value in self.match_labels.items():
            if labels.get(key) != value:
                return False
        for expr in self.match_expressions:
            value = labels.get(expr.key)
            if expr.operator == OP_IN:
                if value is None or value not in expr.values:
                    return False
            elif expr.operator == OP_NOT_IN:
                if value is not None and value in expr.values:
                    return False
            elif expr.operator == OP_EXISTS:
                if value is None:
                    return False
            elif expr.operator == OP_DOES_NOT_EXIST:
                if value is not None:
                    return False
            else:
                raise ValueError(f"invalid label selector operator {expr.operator}")
        return True


# ---------------------------------------------------------------------------
# Affinity / topology
# ---------------------------------------------------------------------------


@dataclass
class NodeAffinity:
    required: List[NodeSelectorTerm] = field(default_factory=list)  # OR terms
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    namespace_selector: Optional[LabelSelector] = None


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str = DO_NOT_SCHEDULE
    label_selector: Optional[LabelSelector] = None


# ---------------------------------------------------------------------------
# Taints / tolerations
# ---------------------------------------------------------------------------

NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return not self.key or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


# ---------------------------------------------------------------------------
# Pods
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    host_ip: str = ""
    protocol: str = "TCP"


@dataclass
class ResourceRequirements:
    requests: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)


@dataclass
class Container:
    name: str = "container"
    image: str = "image"
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: List[ContainerPort] = field(default_factory=list)


@dataclass
class PersistentVolumeClaimVolumeSource:
    claim_name: str = ""


@dataclass
class Volume:
    name: str = ""
    persistent_volume_claim: Optional[PersistentVolumeClaimVolumeSource] = None


@dataclass
class PodCondition:
    type: str
    status: str = "True"
    reason: str = ""


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    node_name: str = ""
    priority: Optional[int] = None
    priority_class_name: str = ""
    preemption_policy: str = "PreemptLowerPriority"
    scheduler_name: str = "default-scheduler"
    volumes: List[Volume] = field(default_factory=list)
    overhead: Dict[str, float] = field(default_factory=dict)
    termination_grace_period_seconds: Optional[int] = None


@dataclass
class PodStatus:
    phase: str = "Pending"
    conditions: List[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""
    # stamped by the bind verb with the store's clock (the PodStatus.startTime
    # analog): the one authoritative bind instant, so every observer of the
    # creation->bind interval (SLO accountant, lifecycle journal) reads the
    # SAME number instead of measuring watch-dispatch time independently
    start_time: Optional[float] = None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind = "Pod"

    # per-pod memo attributes (Requirements.from_pod, the dense encoder)
    # keyed on resource_version. deepcopy MUST NOT carry them: copies exist
    # to be mutated (relaxation, volume-topology injection) and a stale memo
    # on a mutated copy silently reverts the mutation for every consumer.
    _COPY_EXCLUDED = ("_reqs_cache", "_encode_cache", "_podreq_cache")

    def __deepcopy__(self, memo):
        import copy as _copy

        clone = self.__class__.__new__(self.__class__)
        memo[id(self)] = clone
        for key, value in self.__dict__.items():
            if key in self._COPY_EXCLUDED:
                continue
            setattr(clone, key, _copy.deepcopy(value, memo))
        return clone

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def __hash__(self):
        return hash(self.metadata.uid)

    def __eq__(self, other):
        return isinstance(other, Pod) and other.metadata.uid == self.metadata.uid


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    provider_id: str = ""


@dataclass
class NodeCondition:
    type: str
    status: str = "True"


@dataclass
class NodeStatus:
    capacity: Dict[str, float] = field(default_factory=dict)
    allocatable: Dict[str, float] = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)
    phase: str = ""


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    kind = "Node"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def ready(self) -> bool:
        return any(c.type == "Ready" and c.status == "True" for c in self.status.conditions)

    def __hash__(self):
        return hash(self.metadata.uid)

    def __eq__(self, other):
        return isinstance(other, Node) and other.metadata.uid == self.metadata.uid


# ---------------------------------------------------------------------------
# Storage objects (volume topology / volume limits)
# ---------------------------------------------------------------------------


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: Optional[str] = None
    volume_name: str = ""

    kind = "PersistentVolumeClaim"


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    csi_driver: str = ""
    zones: List[str] = field(default_factory=list)  # from nodeAffinity zone terms

    kind = "PersistentVolume"


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    zones: List[str] = field(default_factory=list)  # allowedTopologies zones

    kind = "StorageClass"


@dataclass
class CSINodeDriver:
    name: str
    allocatable_count: Optional[int] = None


@dataclass
class CSINode:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: List[CSINodeDriver] = field(default_factory=list)

    kind = "CSINode"


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    min_available: Optional[object] = None  # int or percentage string
    max_unavailable: Optional[object] = None
    disruptions_allowed: int = 0

    kind = "PodDisruptionBudget"


@dataclass
class Namespace:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    kind = "Namespace"


@dataclass
class ConfigMap:
    """Key/value configuration object (the karpenter-global-settings
    carrier, pkg/config/config.go)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)

    kind = "ConfigMap"


@dataclass
class DaemonSet:
    """A daemonset: its pod template contributes per-node overhead during
    scheduling (provisioner.go:339-360)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec_template: Optional["Pod"] = None  # the pod template

    kind = "DaemonSet"

    def pod_template(self) -> "Pod":
        if self.spec_template is None:
            return Pod()
        return self.spec_template


@dataclass
class LeaseSpec:
    """coordination.k8s.io/v1 LeaseSpec — the leader-election carrier
    (the reference elects via resourcelock.LeaseLock, controllers.go:104-106)."""

    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: Optional[float] = None
    renew_time: Optional[float] = None
    lease_transitions: int = 0


@dataclass
class Lease:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)

    kind = "Lease"


@dataclass
class MutatingWebhookConfiguration:
    """admissionregistration.k8s.io/v1 — the defaulting registration. The
    webhooks array stays wire-shaped (raw dicts): the apiserver consumes
    clientConfig/rules directly and the webhook process patches
    caBundle/url into it at startup (cmd/webhook.py)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    webhooks: List[dict] = field(default_factory=list)

    kind = "MutatingWebhookConfiguration"


@dataclass
class ValidatingWebhookConfiguration:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    webhooks: List[dict] = field(default_factory=list)

    kind = "ValidatingWebhookConfiguration"


def resource_list(**kwargs) -> Dict[str, float]:
    """Convenience builder: resource_list(cpu='100m', memory='1Gi') -> floats.

    Python identifiers can't contain '.', so extended resources pass through a
    dict: resource_list(**{'nvidia.com/gpu': 1}).
    """
    return {key.replace("_", "-") if key in ("ephemeral_storage",) else key: parse_quantity(value) for key, value in kwargs.items()}
