"""Provisioner: the user-facing provisioning policy object.

Equivalent of the reference's v1alpha5 Provisioner CRD
(pkg/apis/provisioning/v1alpha5/provisioner.go:31-160): constraints (labels,
taints, startup taints, requirements, kubelet config, provider config),
lifecycle TTLs, resource limits, weight, and consolidation policy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import labels as lbl
from .objects import NodeSelectorRequirement, ObjectMeta, Taint


@dataclass
class KubeletConfiguration:
    cluster_dns: List[str] = field(default_factory=list)
    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    system_reserved: Dict[str, float] = field(default_factory=dict)
    kube_reserved: Dict[str, float] = field(default_factory=dict)


@dataclass
class Consolidation:
    enabled: bool = False


@dataclass
class Budget:
    """One disruption-rate budget: at most `nodes` (an int count like "5" or
    a percentage like "10%") of the provisioner's nodes may be voluntarily
    disrupted at once. With `schedule` (5-field cron, UTC) + `duration`
    (seconds) the budget only applies inside the recurring window; without
    them it applies always."""

    nodes: str = "10%"
    schedule: Optional[str] = None
    duration: Optional[float] = None


@dataclass
class Disruption:
    """spec.disruption: the provisioner's voluntary-disruption policy,
    enforced atomically across every method (emptiness, expiration, drift,
    consolidation) by the disruption orchestrator. The effective limit at
    any instant is the MINIMUM across active budgets; no budgets means
    unlimited."""

    budgets: List[Budget] = field(default_factory=list)


@dataclass
class Limits:
    resources: Dict[str, float] = field(default_factory=dict)

    def exceeded_by(self, usage: Dict[str, float]) -> Optional[str]:
        """Returns a reason string if usage exceeds any limit, else None."""
        for name, limit in self.resources.items():
            if usage.get(name, 0.0) > limit + 1e-9:
                return f"{name} resource usage of {usage.get(name, 0.0)} exceeds limit of {limit}"
        return None


@dataclass
class ProvisionerSpec:
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    requirements: List[NodeSelectorRequirement] = field(default_factory=list)
    kubelet_configuration: Optional[KubeletConfiguration] = None
    provider: Optional[dict] = None
    provider_ref: Optional[str] = None
    ttl_seconds_after_empty: Optional[float] = None
    ttl_seconds_until_expired: Optional[float] = None
    limits: Optional[Limits] = None
    weight: Optional[int] = None
    consolidation: Optional[Consolidation] = None
    disruption: Optional[Disruption] = None


@dataclass
class ProvisionerStatus:
    resources: Dict[str, float] = field(default_factory=dict)
    last_scale_time: Optional[float] = None
    conditions: List[str] = field(default_factory=list)


@dataclass
class Provisioner:
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(name="default", namespace=""))
    spec: ProvisionerSpec = field(default_factory=ProvisionerSpec)
    status: ProvisionerStatus = field(default_factory=ProvisionerStatus)

    kind = "Provisioner"

    @property
    def name(self) -> str:
        return self.metadata.name

    def __hash__(self):
        return hash(self.metadata.uid)

    def __eq__(self, other):
        return isinstance(other, Provisioner) and other.metadata.uid == self.metadata.uid


def order_by_weight(provisioners: List[Provisioner]) -> List[Provisioner]:
    """Sort descending by spec.weight (None == 0), mirrors provisioner.go:151."""
    return sorted(provisioners, key=lambda p: -(p.spec.weight or 0))


VALID_TAINT_EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")


def parse_budget_nodes(value: str):
    """Parse a Budget.nodes value into ("percent", p) or ("count", n).
    Raises ValueError with a human-readable message on malformed input."""
    text = str(value).strip()
    if text.endswith("%"):
        body = text[:-1]
        if not body.isdigit():
            raise ValueError(f"budget nodes {value!r} is not a valid percentage; use e.g. \"10%\"")
        pct = int(body)
        if pct > 100:
            raise ValueError(f"budget nodes {value!r} exceeds 100%")
        return ("percent", pct)
    if not text.isdigit():
        raise ValueError(f"budget nodes {value!r} must be a non-negative integer (\"5\") or a percentage (\"10%\")")
    return ("count", int(text))


def validate_disruption(disruption: "Disruption") -> List[str]:
    """spec.disruption rule set: nodes syntax, schedule/duration pairing,
    cron syntax, and zero-node windows. A permanently-zero budget (nodes
    "0" with no schedule) is rejected — it silently blocks every voluntary
    method forever; per-pod karpenter.sh/do-not-disrupt or a scheduled
    maintenance window is the intended spelling."""
    from ..utils import cron

    errs: List[str] = []
    for i, budget in enumerate(disruption.budgets):
        prefix = f"disruption.budgets[{i}]"
        kind = number = None
        try:
            kind, number = parse_budget_nodes(budget.nodes)
        except ValueError as e:
            errs.append(f"{prefix}: {e}")
        if (budget.schedule is None) != (budget.duration is None):
            errs.append(f"{prefix}: schedule and duration must be set together (a window needs both)")
        if budget.schedule is not None:
            errs.extend(f"{prefix}: {e}" for e in cron.cron_errors(budget.schedule))
        if budget.duration is not None and budget.duration <= 0:
            errs.append(f"{prefix}: duration must be positive, got {budget.duration} (a zero-length window never applies)")
        if kind is not None and number == 0 and budget.schedule is None:
            errs.append(
                f"{prefix}: nodes {budget.nodes!r} with no schedule blocks all voluntary disruption permanently; "
                "scope it with a schedule + duration window, or use the karpenter.sh/do-not-disrupt pod annotation"
            )
    return errs


def validate_requirement(req: NodeSelectorRequirement) -> List[str]:
    """Single-requirement rule set (ValidateRequirement,
    provisioner_validation.go:177-209): normalization first, then operator
    support, restricted-label, key/value syntax, and per-operator arity."""
    from .objects import OP_DOES_NOT_EXIST, OP_EXISTS, OP_GT, OP_IN, OP_LT, OP_NOT_IN

    errs: List[str] = []
    key = lbl.normalize_label(req.key)
    if req.operator not in (OP_IN, OP_NOT_IN, OP_EXISTS, OP_DOES_NOT_EXIST, OP_GT, OP_LT):
        errs.append(f"key {key} has an unsupported operator {req.operator!r}")
    if lbl.is_restricted_label(key):
        errs.append(f"label {key} is restricted")
    for e in lbl.qualified_name_errors(key):
        errs.append(f"key {key} is not a qualified name, {e}")
    for value in req.values:
        for e in lbl.label_value_errors(value):
            errs.append(f"invalid value {value!r} for key {key}, {e}")
    if req.operator == OP_IN and not req.values:
        errs.append(f"key {key} with operator {req.operator} must have a value defined")
    if req.operator in (OP_EXISTS, OP_DOES_NOT_EXIST) and req.values:
        errs.append(f"key {key} with operator {req.operator} must not have values")
    if req.operator in (OP_GT, OP_LT):
        ok = len(req.values) == 1 and req.values[0].isdigit()
        if not ok:
            errs.append(f"key {key} with operator {req.operator} must have a single positive integer value")
    return errs


def _validate_taints_field(taints: List[Taint], existing: set, field_name: str) -> List[str]:
    errs: List[str] = []
    for i, taint in enumerate(taints):
        if not taint.key:
            errs.append(f"{field_name}[{i}]: taint key is required")
        else:
            for e in lbl.qualified_name_errors(taint.key):
                errs.append(f"{field_name}[{i}]: {e}")
        if taint.value:
            for e in lbl.label_value_errors(taint.value):
                errs.append(f"{field_name}[{i}]: invalid value, {e}")
        if taint.effect not in VALID_TAINT_EFFECTS + ("",):
            errs.append(f"{field_name}[{i}]: invalid taint effect {taint.effect!r}")
        pair = (taint.key, taint.effect)
        if pair in existing:
            errs.append(f"{field_name}[{i}]: duplicate taint Key/Effect pair {taint.key}={taint.effect}")
        existing.add(pair)
    return errs


def validate_provisioner(provisioner: Provisioner) -> List[str]:
    """Admission-style validation — the full rule set of
    provisioner_validation.go (metadata, labels, taints incl. duplicate
    key/effect pairs across taints+startupTaints, requirements, TTLs,
    provider exclusivity). Returns human-readable violations (empty ==
    valid)."""
    errs: List[str] = []
    spec = provisioner.spec

    errs.extend(f"metadata: {e}" for e in lbl.dns1123_name_errors(provisioner.metadata.name))
    # the name is minted into the karpenter.sh/provisioner-name node LABEL,
    # whose value caps at 63 characters — a longer name would launch nodes
    # the apiserver rejects
    if len(provisioner.metadata.name) > 63:
        errs.append(f"metadata: name {provisioner.metadata.name!r} must be at most 63 characters")

    # labels (validateLabels): restricted keys incl. the provisioner-name
    # label itself, plus key/value syntax
    for key, value in spec.labels.items():
        if key == lbl.PROVISIONER_NAME_LABEL:
            errs.append(f"label {key} is restricted")
        errs.extend(f"labels: {e}" for e in lbl.qualified_name_errors(key))
        errs.extend(f"labels[{key}]: {e}" for e in lbl.label_value_errors(value))
        if key != lbl.PROVISIONER_NAME_LABEL and lbl.is_restricted_label(key):
            errs.append(f"label {key} is restricted")

    # taints + startupTaints share the duplicate-pair namespace
    seen: set = set()
    errs.extend(_validate_taints_field(spec.taints, seen, "taints"))
    errs.extend(_validate_taints_field(spec.startup_taints, seen, "startupTaints"))

    # requirements (validateRequirements)
    for i, req in enumerate(spec.requirements):
        if lbl.normalize_label(req.key) == lbl.PROVISIONER_NAME_LABEL:
            errs.append(f"requirements[{i}]: {req.key} is restricted")
        errs.extend(f"requirements[{i}]: {e}" for e in validate_requirement(req))

    if spec.ttl_seconds_until_expired is not None and spec.ttl_seconds_until_expired < 0:
        errs.append("ttlSecondsUntilExpired cannot be negative")
    if spec.ttl_seconds_after_empty is not None and spec.ttl_seconds_after_empty < 0:
        errs.append("ttlSecondsAfterEmpty cannot be negative")
    if spec.ttl_seconds_after_empty is not None and spec.consolidation and spec.consolidation.enabled:
        errs.append("ttlSecondsAfterEmpty is mutually exclusive with consolidation.enabled")
    if spec.provider is not None and spec.provider_ref is not None:
        errs.append("provider and providerRef are mutually exclusive")
    if spec.weight is not None and not (0 <= spec.weight <= 100):
        errs.append("weight must be within [0, 100]")
    if spec.limits is not None:
        for name, value in spec.limits.resources.items():
            if value < 0:
                errs.append(f"limits.resources[{name}] cannot be negative")
    if spec.disruption is not None:
        errs.extend(validate_disruption(spec.disruption))
    return errs
