"""Seeded workload and catalog builders for the port.

The port's counterparts of the JAX package's test fixtures (tests/helpers.py
make_pod / make_provisioner) and of bench.py's workload builders
(build_workload, build_selectors_taints_workload, build_spot_od_types). They
draw from numpy with the same seeds in the same order, so both packages
build the same pods and catalogs: the tests and chip_smoke.py build the
port's side from here.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np

from .api.labels import LABEL_HOSTNAME, LABEL_TOPOLOGY_ZONE
from .api.objects import (
    Affinity,
    Container,
    ContainerPort,
    LabelSelector,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodCondition,
    PodSpec,
    PodStatus,
    PreferredSchedulingTerm,
    ResourceRequirements,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
    Volume,
    PersistentVolumeClaimVolumeSource,
)
from .api.provisioner import Budget, Consolidation, Disruption, Limits, Provisioner, ProvisionerSpec
from .cloudprovider.fake import Offering, instance_type
from .utils.quantity import parse_quantity

_counter = itertools.count(1)


def _parse_resources(resources: Optional[Dict[str, object]]) -> Dict[str, float]:
    return {k: parse_quantity(v) for k, v in (resources or {}).items()}


def make_pod(
    name: str = "",
    namespace: str = "default",
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    requests: Optional[Dict[str, object]] = None,
    limits: Optional[Dict[str, object]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    node_requirements: Optional[List[NodeSelectorRequirement]] = None,
    node_preferences: Optional[List[PreferredSchedulingTerm]] = None,
    required_node_terms: Optional[List[NodeSelectorTerm]] = None,
    pod_requirements: Optional[List[PodAffinityTerm]] = None,
    pod_preferences: Optional[List[WeightedPodAffinityTerm]] = None,
    pod_anti_requirements: Optional[List[PodAffinityTerm]] = None,
    pod_anti_preferences: Optional[List[WeightedPodAffinityTerm]] = None,
    topology_spread_constraints: Optional[List[TopologySpreadConstraint]] = None,
    tolerations: Optional[List[Toleration]] = None,
    host_ports: Optional[List[ContainerPort]] = None,
    pvcs: Optional[List[str]] = None,
    node_name: str = "",
    phase: str = "Pending",
    creation_timestamp: float = 0.0,
    priority: Optional[int] = None,
    unschedulable: bool = True,
) -> Pod:
    """Build a pod; by default a pending pod marked unschedulable (the
    provisionable state, equivalent of test.UnschedulablePod)."""
    if not name:
        name = f"pod-{next(_counter):05d}"
    affinity = None
    if node_requirements or node_preferences or required_node_terms or pod_requirements or pod_preferences or pod_anti_requirements or pod_anti_preferences:
        node_affinity = None
        if node_requirements or node_preferences or required_node_terms:
            required = required_node_terms or []
            if node_requirements:
                required = [NodeSelectorTerm(match_expressions=list(node_requirements))] + list(required)
            node_affinity = NodeAffinity(required=required, preferred=list(node_preferences or []))
        pod_affinity = None
        if pod_requirements or pod_preferences:
            pod_affinity = PodAffinity(required=list(pod_requirements or []), preferred=list(pod_preferences or []))
        anti_affinity = None
        if pod_anti_requirements or pod_anti_preferences:
            anti_affinity = PodAntiAffinity(required=list(pod_anti_requirements or []), preferred=list(pod_anti_preferences or []))
        affinity = Affinity(node_affinity=node_affinity, pod_affinity=pod_affinity, pod_anti_affinity=anti_affinity)

    container = Container(
        resources=ResourceRequirements(requests=_parse_resources(requests), limits=_parse_resources(limits)),
        ports=list(host_ports or []),
    )
    volumes = [Volume(name=f"vol-{i}", persistent_volume_claim=PersistentVolumeClaimVolumeSource(claim_name=c)) for i, c in enumerate(pvcs or [])]
    conditions = []
    if unschedulable and not node_name:
        conditions.append(PodCondition(type="PodScheduled", status="False", reason="Unschedulable"))
    return Pod(
        metadata=ObjectMeta(
            name=name,
            namespace=namespace,
            labels=dict(labels or {}),
            annotations=dict(annotations or {}),
            creation_timestamp=creation_timestamp,
        ),
        spec=PodSpec(
            containers=[container],
            node_selector=dict(node_selector or {}),
            affinity=affinity,
            tolerations=list(tolerations or []),
            topology_spread_constraints=list(topology_spread_constraints or []),
            node_name=node_name,
            volumes=volumes,
            priority=priority,
        ),
        status=PodStatus(phase=phase, conditions=conditions),
    )


def make_provisioner(
    name: str = "default",
    labels: Optional[Dict[str, str]] = None,
    taints=None,
    startup_taints=None,
    requirements: Optional[List[NodeSelectorRequirement]] = None,
    limits: Optional[Dict[str, object]] = None,
    weight: Optional[int] = None,
    ttl_seconds_after_empty: Optional[float] = None,
    ttl_seconds_until_expired: Optional[float] = None,
    consolidation_enabled: Optional[bool] = None,
    provider: Optional[dict] = None,
    kubelet_configuration=None,
    budgets: Optional[List[Budget]] = None,
) -> Provisioner:
    spec = ProvisionerSpec(
        labels=dict(labels or {}),
        taints=list(taints or []),
        startup_taints=list(startup_taints or []),
        requirements=list(requirements or []),
        limits=Limits(resources=_parse_resources(limits)) if limits is not None else None,
        weight=weight,
        ttl_seconds_after_empty=ttl_seconds_after_empty,
        ttl_seconds_until_expired=ttl_seconds_until_expired,
        consolidation=Consolidation(enabled=consolidation_enabled) if consolidation_enabled is not None else None,
        provider=provider,
        kubelet_configuration=kubelet_configuration,
        disruption=Disruption(budgets=list(budgets)) if budgets is not None else None,
    )
    return Provisioner(metadata=ObjectMeta(name=name, namespace=""), spec=spec)


def build_workload(count: int, seed: int = 42):
    """The reference benchmark's mixed workload (scheduling_benchmark_test.go:
    180-194): ~4/7 generic + zonal spread + zonal self-affinity + hostname
    anti-affinity cohorts, with self-consistent selectors."""
    rng = np.random.default_rng(seed)
    cpus = [0.1, 0.25, 0.5, 1.0, 1.5]
    mems = ["100Mi", "256Mi", "512Mi", "1Gi", "2Gi", "4Gi"]
    values = "abcdefg"

    def size():
        return {"cpu": cpus[rng.integers(len(cpus))], "memory": mems[rng.integers(len(mems))]}

    pods = []
    seventh = count // 7
    for i in range(seventh):  # zonal spread, 7 label cohorts
        label = {"spread": values[rng.integers(7)]}
        pods.append(
            make_pod(
                labels=label,
                requests=size(),
                topology_spread_constraints=[
                    TopologySpreadConstraint(max_skew=1, topology_key=LABEL_TOPOLOGY_ZONE, label_selector=LabelSelector(match_labels=label))
                ],
            )
        )
    for i in range(seventh):  # zonal self-affinity cohorts
        label = {"affinity": values[rng.integers(7)]}
        pods.append(
            make_pod(
                labels=label,
                requests=size(),
                pod_requirements=[PodAffinityTerm(topology_key=LABEL_TOPOLOGY_ZONE, label_selector=LabelSelector(match_labels=label))],
            )
        )
    for i in range(seventh):  # hostname anti-affinity cohorts
        label = {"anti": values[rng.integers(7)]}
        pods.append(
            make_pod(
                labels=label,
                requests=size(),
                pod_anti_requirements=[PodAffinityTerm(topology_key=LABEL_HOSTNAME, label_selector=LabelSelector(match_labels=label))],
            )
        )
    while len(pods) < count:
        pods.append(make_pod(labels={"app": values[rng.integers(7)]}, requests=size()))
    return pods


def build_selectors_taints_workload(count: int, seed: int = 7):
    """BASELINE config 2: nodeSelector cohorts over zones, all pods tolerating
    the provisioner's dedicated taint."""
    rng = np.random.default_rng(seed)
    cpus = [0.25, 0.5, 1.0]
    mems = ["256Mi", "512Mi", "1Gi", "2Gi"]
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    tol = [Toleration(key="dedicated", operator="Equal", value="batch", effect="NoSchedule")]

    pods = []
    for i in range(count):
        kwargs = dict(
            requests={"cpu": cpus[rng.integers(3)], "memory": mems[rng.integers(4)]},
            tolerations=tol,
        )
        if i % 2 == 0:  # half the pods pin a zone via nodeSelector
            kwargs["node_selector"] = {LABEL_TOPOLOGY_ZONE: zones[rng.integers(3)]}
        pods.append(make_pod(**kwargs))
    return pods


def build_spot_od_types(total: int):
    """BASELINE config 5: total/2 shapes, each offered spot (cheap) and
    on-demand (pricey) as distinct types — mixed-pricing universe."""
    types = []
    zones = ["test-zone-1", "test-zone-2", "test-zone-3"]
    for i in range(total // 2):
        cpu = (i % 32) + 1
        mem = f"{cpu * 2}Gi"
        pods = cpu * 10
        offers = [Offering(capacity_type="on-demand", zone=z) for z in zones]
        types.append(instance_type(f"od-{i}", cpu=cpu, memory=mem, pods=pods, offerings=offers, price=0.12 * cpu))
        offers = [Offering(capacity_type="spot", zone=z) for z in zones]
        types.append(instance_type(f"spot-{i}", cpu=cpu, memory=mem, pods=pods, offerings=offers, price=0.04 * cpu))
    return types
