"""Seeded workload and catalog builders for the port.

The port's counterparts of the JAX package's test fixtures (tests/helpers.py
make_pod / make_provisioner / make_node / make_state_node), of bench.py's
builders (build_workload, build_selectors_taints_workload,
build_spot_od_types, build_repack_state), of the randomized warm-cluster
generators of its differential tests (tests/test_differential_campaign.py,
tests/test_warm_fill_vectorized.py), of its seeded cluster churn
(tests/test_incremental_parity.py's _Churn, bench.py's
run_incremental_churn) and of its controller test environments
(tests/env.py's Environment, tests/test_deprovisioning.py's DeprovEnv and
owned_pod, tests/test_disruption.py's DisruptionEnv, and the Runtime over
the simulated cloud of tests/test_simulated_provider.py,
tests/test_interruption_catalog.py's InterruptionEnv and tests/test_gc.py's
GCEnv). They draw from numpy
with the same seeds in the same order, so both packages build the same
pods, catalogs and clusters: the tests and chip_smoke.py build the port's
side from here.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np

from . import webhooks
from .api.labels import (
    LABEL_CAPACITY_TYPE,
    LABEL_HOSTNAME,
    LABEL_INSTANCE_TYPE,
    LABEL_NODE_INITIALIZED,
    LABEL_TOPOLOGY_ZONE,
    PROVISIONER_NAME_LABEL,
    TERMINATION_FINALIZER,
)
from .api.objects import (
    OP_IN,
    Affinity,
    Container,
    ContainerPort,
    LabelSelector,
    Node,
    NodeAffinity,
    NodeCondition,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodCondition,
    PodSpec,
    PodStatus,
    PreferredSchedulingTerm,
    ResourceRequirements,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
    Volume,
    PersistentVolumeClaimVolumeSource,
)
from .api.provisioner import Budget, Consolidation, Disruption, Limits, Provisioner, ProvisionerSpec
from .cloudprovider.fake import FakeCloudProvider, Offering, instance_type
from .cloudprovider.simulated.backend import CloudBackend, FleetInstanceSpec, FleetRequest
from .cloudprovider.simulated.provider import SimulatedCloudProvider
from .config import Config
from .controllers.consolidation import ConsolidationController
from .controllers.counter import CounterController
from .controllers.disruption import DisruptionController
from .controllers.gc import GarbageCollectionController
from .controllers.interruption import InterruptionController
from .controllers.node import NodeController
from .controllers.provisioning import ProvisionerController, ProvisioningReconciler
from .controllers.state.cluster import Cluster
from .controllers.termination import TerminationController
from .events import DEFAULT_EVENT_CAPACITY, DedupeRecorder, Recorder
from .kube.cluster import KubeCluster
from .scheduling.hostports import HostPortUsage
from .scheduling.volumelimits import VolumeCount, VolumeLimits
from .utils.clock import FakeClock
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


def make_node(
    name: str = "",
    labels: Optional[Dict[str, str]] = None,
    taints=None,
    allocatable: Optional[Dict[str, object]] = None,
    capacity: Optional[Dict[str, object]] = None,
    ready: bool = True,
) -> Node:
    if not name:
        name = f"node-{next(_counter):05d}"
    alloc = _parse_resources(allocatable)
    cap = _parse_resources(capacity) or dict(alloc)
    return Node(
        metadata=ObjectMeta(name=name, namespace="", labels=dict(labels or {})),
        spec=NodeSpec(taints=list(taints or [])),
        status=NodeStatus(
            capacity=cap,
            allocatable=alloc or dict(cap),
            conditions=[NodeCondition(type="Ready", status="True" if ready else "False")],
        ),
    )


class StateNode:
    """The minimal cluster-state node surface ExistingNodeView consumes."""

    def __init__(self, node: Node, available: Dict[str, float], daemonset_requested: Dict[str, float]):
        self.node = node
        self.available = available
        self.daemonset_requested = daemonset_requested
        self.host_port_usage = HostPortUsage()
        self.volume_usage = VolumeLimits()
        self.volume_limits = VolumeCount()


def make_state_node(
    node: Optional[Node] = None,
    provisioner: str = "default",
    available: Optional[Dict[str, object]] = None,
    daemonset_requested: Optional[Dict[str, object]] = None,
    **node_kwargs,
) -> StateNode:
    """An existing (warm) node for the scheduler: `state_nodes=[...]`."""
    if node is None:
        labels = dict(node_kwargs.pop("labels", {}) or {})
        if provisioner is not None:
            labels.setdefault(PROVISIONER_NAME_LABEL, provisioner)
        node = make_node(labels=labels, **node_kwargs)
    return StateNode(
        node,
        _parse_resources(available) if available is not None else dict(node.status.allocatable),
        _parse_resources(daemonset_requested),
    )


ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")


def build_repack_state(node_count: int) -> List[StateNode]:
    """BASELINE config 4: a warm cluster of 16-CPU / 32Gi on-demand nodes,
    round-robin over three zones, to repack onto."""
    nodes = []
    for i in range(node_count):
        labels = {
            PROVISIONER_NAME_LABEL: "default",
            LABEL_INSTANCE_TYPE: "fake-it-15",
            LABEL_TOPOLOGY_ZONE: ZONES[i % 3],
            LABEL_CAPACITY_TYPE: "on-demand",
        }
        nodes.append(make_state_node(labels=labels, allocatable={"cpu": 16, "memory": "32Gi", "pods": 110}))
    return nodes


def rename(pods, tag):
    """Deterministic pod names (make_pod's come from a process-global
    counter), so two builds of one batch compare by name."""
    for i, pod in enumerate(pods):
        pod.metadata.name = f"dp-{tag}-{i:04d}"
    return pods


def random_workload(rng: np.random.Generator, count: int):
    """A random mix of plain cohorts, zonal spread, zonal self-affinity,
    hostname anti-affinity, zone selectors, host ports, tolerations of the
    dedicated pool's taint and preferred zone affinity."""
    cpus = [0.25, 0.5, 1.0, 2.0]
    mems = ["128Mi", "512Mi", "1Gi", "2Gi"]
    pods = []
    for i in range(count):
        kind = rng.integers(0, 12)
        size = {"cpu": cpus[rng.integers(len(cpus))], "memory": mems[rng.integers(len(mems))]}
        cohort = f"c{rng.integers(4)}"
        if kind < 4:  # plain
            pods.append(make_pod(labels={"app": cohort}, requests=size))
        elif kind == 10:  # tolerates the dedicated provisioner's taint
            pods.append(
                make_pod(
                    labels={"app": cohort},
                    requests=size,
                    tolerations=[Toleration(key="dedicated", operator="Equal", value="batch", effect="NoSchedule")],
                )
            )
        elif kind == 11:  # preferred zone affinity: exercises relaxation
            zone = ZONES[rng.integers(3)]
            pods.append(
                make_pod(
                    labels={"app": cohort},
                    requests=size,
                    node_preferences=[
                        PreferredSchedulingTerm(
                            weight=int(rng.integers(1, 100)),
                            preference=NodeSelectorTerm(
                                match_expressions=[NodeSelectorRequirement(LABEL_TOPOLOGY_ZONE, OP_IN, [zone])]
                            ),
                        )
                    ],
                )
            )
        elif kind < 6:  # zonal spread
            pods.append(
                make_pod(
                    labels={"spread": cohort},
                    requests=size,
                    topology_spread_constraints=[
                        TopologySpreadConstraint(
                            max_skew=int(rng.integers(1, 3)),
                            topology_key=LABEL_TOPOLOGY_ZONE,
                            label_selector=LabelSelector(match_labels={"spread": cohort}),
                        )
                    ],
                )
            )
        elif kind < 7:  # zonal self-affinity
            pods.append(
                make_pod(
                    labels={"aff": cohort},
                    requests=size,
                    pod_requirements=[
                        PodAffinityTerm(topology_key=LABEL_TOPOLOGY_ZONE, label_selector=LabelSelector(match_labels={"aff": cohort}))
                    ],
                )
            )
        elif kind < 8:  # hostname anti-affinity
            pods.append(
                make_pod(
                    labels={"anti": cohort},
                    requests=size,
                    pod_anti_requirements=[
                        PodAffinityTerm(topology_key=LABEL_HOSTNAME, label_selector=LabelSelector(match_labels={"anti": cohort}))
                    ],
                )
            )
        elif kind < 9:  # zone selector
            pods.append(make_pod(requests=size, node_selector={LABEL_TOPOLOGY_ZONE: ZONES[rng.integers(3)]}))
        else:  # host port (few port numbers, so some conflict)
            pods.append(make_pod(requests=size, host_ports=[ContainerPort(host_port=int(8000 + rng.integers(4)))]))
    return pods


def random_states(rng: np.random.Generator) -> List[StateNode]:
    """0-7 small warm nodes in random zones."""
    states = []
    for i in range(int(rng.integers(0, 8))):
        states.append(
            make_state_node(
                labels={
                    PROVISIONER_NAME_LABEL: "default",
                    LABEL_INSTANCE_TYPE: "fake-it-3",
                    LABEL_CAPACITY_TYPE: "on-demand",
                    LABEL_TOPOLOGY_ZONE: ZONES[int(rng.integers(3))],
                },
                allocatable={"cpu": int(rng.integers(4, 17)), "memory": "32Gi", "pods": 110},
            )
        )
    return states


def warm_states(rng: np.random.Generator) -> List[StateNode]:
    """The warm-heavy variant of random_states: enough existing capacity
    that the fill decides most placements."""
    states = random_states(rng)
    for i in range(int(rng.integers(6, 18))):
        states.append(
            make_state_node(
                labels={
                    PROVISIONER_NAME_LABEL: "default",
                    LABEL_INSTANCE_TYPE: "fake-it-3",
                    LABEL_CAPACITY_TYPE: "on-demand",
                    LABEL_TOPOLOGY_ZONE: ZONES[int(rng.integers(3))],
                },
                allocatable={"cpu": int(rng.integers(8, 33)), "memory": "64Gi", "pods": 110},
            )
        )
    return states


def campaign_provisioners() -> List[Provisioner]:
    """Weight order: the untainted default first, then a dedicated pool whose
    NoSchedule taint only tolerating pods may land on."""
    return [
        make_provisioner(name="default", weight=10),
        make_provisioner(name="dedicated", weight=1, taints=[Taint(key="dedicated", value="batch", effect="NoSchedule")]),
    ]


# --- kernel inputs --------------------------------------------------------


def bucket_cost_problem(rng: np.random.Generator, B: int, T: int, R: int, kind: str = "random"):
    """Seeded inputs of the bucket -> instance-type cost kernel: (stats
    [2, B, R], caps [T, R], prices [T], allowed [B, T]), numpy f32 / bool.

    "random" is tests/test_pallas.py's generator. "ties" keeps its buckets
    and draws a catalog of a few type families, each row scaled by a power
    of two and priced in proportion to it: frac * price is equal within a
    family, and repeated rows tie on the whole key, so the argmin rests on
    its first-index rule. "infeasible" leaves about half of the buckets no
    feasible type (nothing allowed, a pod larger than every type, or a
    resource no type has), so their keys are all inf and t* must be 0.
    "unrequested" is the headline solve's resource pattern: past the first
    three resources (cpu, memory, pods) no bucket asks for anything and no
    type offers it, so most sums are zero."""
    sum_req = (rng.random((B, R)) * 20).astype(np.float32)
    max_req = (sum_req * rng.random((B, R))).astype(np.float32)
    caps = (rng.random((T, R)) * 16).astype(np.float32)
    caps[rng.random((T, R)) < 0.1] = 0.0  # types lacking a resource entirely
    prices = (rng.random((T,)) * 4 + 0.1).astype(np.float32)
    allowed = rng.random((B, T)) > 0.3
    if kind == "ties":
        family = rng.integers(0, max(1, T // 16), size=T)
        scale = np.float32(2.0) ** rng.integers(0, 4, size=T).astype(np.float32)
        caps = caps[family] * scale[:, None]
        prices = prices[family] * scale
    elif kind == "infeasible":
        dead = rng.random(B) < 0.5
        how = rng.integers(0, 3, size=B)
        allowed[dead & (how == 0)] = False
        max_req[dead & (how == 1), 0] = caps[:, 0].max() * 2 + 1
        caps[:, -1] = 0.0  # no type has the last resource ...
        needs = dead & (how == 2)
        sum_req[~needs, -1] = 0.0  # ... and only these buckets ask for it
        max_req[~needs, -1] = 0.0
        sum_req[needs, -1] += 1.0
    elif kind == "unrequested":
        sum_req[:, 3:] = 0.0
        max_req[:, 3:] = 0.0
        caps[:, 3:] = 0.0
    elif kind != "random":
        raise ValueError(f"unknown problem kind {kind!r}")
    return np.stack([sum_req, max_req]), caps, prices, allowed


def warm_fill_surface(rng: np.random.Generator, S: int, V: int, R: int):
    """Seeded inputs of the warm-fill admission kernel (f64 sizes [S, R] and
    head [V, R]): tests/test_warm_fill_vectorized.py's _random_surface."""
    sizes = (rng.random((S, R)) * 4).astype(np.float64)
    sizes[rng.random((S, R)) < 0.2] = 0.0  # size classes not requesting an axis
    head = (rng.random((V, R)) * 32).astype(np.float64)
    head[rng.random((V,)) < 0.1] = -1.0  # over-committed views
    return sizes, head


# --- seeded cluster churn, through the kube store -> watch -> Cluster feed ---


def churn_node(name: str, rng: np.random.Generator) -> Node:
    """tests/test_incremental_parity.py's _warm_node: a small fake-it-3 node
    in a random zone."""
    return make_node(
        name=name,
        labels={
            PROVISIONER_NAME_LABEL: "default",
            LABEL_INSTANCE_TYPE: "fake-it-3",
            LABEL_CAPACITY_TYPE: "on-demand",
            LABEL_TOPOLOGY_ZONE: ZONES[int(rng.integers(3))],
        },
        allocatable={"cpu": int(rng.integers(8, 33)), "memory": "64Gi", "pods": 110},
    )


class Churn:
    """Randomized cluster churn through the real watch seam (the JAX
    package's tests/test_incremental_parity.py:_Churn): every mutation goes
    kube -> watch event -> Cluster handler -> delta journal, the feed the
    incremental engine consumes. Binds, unbinds, node launches and node
    terminations, drawn from one seed."""

    def __init__(self, kube, seed: int, tag: str, min_nodes: int = 6):
        self.kube = kube
        self.rng = np.random.default_rng(seed)
        self.tag = tag
        self.min_nodes = min_nodes
        self._n = 0
        self._p = 0
        self.bound: List[Pod] = []

    def add_node(self) -> str:
        name = f"{self.tag}-n{self._n:03d}"
        self._n += 1
        self.kube.create(churn_node(name, self.rng))
        return name

    def seed_nodes(self, count: int) -> None:
        for _ in range(count):
            self.add_node()

    def drop_node(self) -> None:
        nodes = self.kube.list_nodes()
        if len(nodes) <= self.min_nodes:
            return
        self.kube.delete(nodes[int(self.rng.integers(len(nodes)))], grace=False)

    def bind(self) -> None:
        nodes = self.kube.list_nodes()
        if not nodes:
            return
        node = nodes[int(self.rng.integers(len(nodes)))]
        pod = make_pod(
            name=f"{self.tag}-bp{self._p:04d}",
            labels={"app": "warm"},
            requests={"cpu": 0.25, "memory": "256Mi"},
            node_name=node.name,
            phase="Running",
            unschedulable=False,
        )
        self._p += 1
        self.kube.create(pod)
        self.bound.append(pod)

    def unbind(self) -> None:
        if not self.bound:
            return
        pod = self.bound.pop(int(self.rng.integers(len(self.bound))))
        self.kube.delete(pod, grace=False)

    def step(self) -> None:
        r = self.rng
        for _ in range(int(r.integers(0, 3))):
            self.bind()
        if r.random() < 0.4:
            self.add_node()
        if r.random() < 0.3:
            self.drop_node()
        if r.random() < 0.3:
            self.unbind()


def standing_cluster(kube, node_count: int) -> None:
    """bench.py's run_incremental_churn cluster: node_count 16-CPU / 32Gi
    fake-it-15 on-demand nodes, round-robin over three zones (the node
    shape of build_repack_state), created through the kube store."""
    for i in range(node_count):
        kube.create(
            make_node(
                name=f"churn-n{i:04d}",
                labels={
                    PROVISIONER_NAME_LABEL: "default",
                    LABEL_INSTANCE_TYPE: "fake-it-15",
                    LABEL_TOPOLOGY_ZONE: ZONES[i % 3],
                    LABEL_CAPACITY_TYPE: "on-demand",
                },
                allocatable={"cpu": 16, "memory": "32Gi", "pods": 110},
            )
        )


def consolidation_cluster(kube, provisioner, prefix: str, node_count: int, type_name: str, allocatable, pods_per_node: int, requests) -> None:
    """`node_count` nodes of `provisioner` labelled as the fake provider labels
    its launches of `type_name` (on-demand, round-robin over three zones),
    Ready and already initialized (the initialized label, the termination
    finalizer and the provisioner owner reference the node controller would
    add), each running `pods_per_node` ReplicaSet-owned pods of `requests`
    bound to it, created through the kube store."""
    for i in range(node_count):
        name = f"{prefix}-n{i:04d}"
        node = make_node(
            name=name,
            labels={
                PROVISIONER_NAME_LABEL: provisioner.name,
                LABEL_INSTANCE_TYPE: type_name,
                LABEL_TOPOLOGY_ZONE: ZONES[i % 3],
                LABEL_CAPACITY_TYPE: "on-demand",
                LABEL_HOSTNAME: name,
                LABEL_NODE_INITIALIZED: "true",
            },
            allocatable=allocatable,
        )
        node.metadata.finalizers.append(TERMINATION_FINALIZER)
        node.metadata.owner_references.append(OwnerReference(kind="Provisioner", name=provisioner.name, uid=provisioner.metadata.uid))
        kube.create(node)
        for j in range(pods_per_node):
            kube.create(owned_pod(name=f"{prefix}-p{i:04d}-{j:03d}", requests=requests, node_name=name, phase="Running", unschedulable=False))


def standing_churn(kube, step: int, node_count: int) -> None:
    """bench.py's per-pass churn: three pod binds and one node-status
    refresh, at most 4 dirty node names per pass."""
    for i in range(3):
        node = f"churn-n{(step * 3 + i) % node_count:04d}"
        kube.create(
            make_pod(
                name=f"churn-bp{step:03d}-{i}",
                labels={"app": "standing"},
                requests={"cpu": 0.25, "memory": "256Mi"},
                node_name=node,
                phase="Running",
                unschedulable=False,
            )
        )
    refreshed = kube.get_node(f"churn-n{(step * 7) % node_count:04d}")
    if refreshed is not None:
        kube.update(refreshed)


def churn_batch(step: int, count: int) -> List[Pod]:
    """bench.py's per-pass batch: `count` pending 0.5-CPU / 512Mi pods."""
    return [
        make_pod(name=f"churn-p{step:03d}-{i:03d}", labels={"app": "delta"}, requests={"cpu": 0.5, "memory": "512Mi"})
        for i in range(count)
    ]


class Environment:
    """The port's counterpart of the JAX package's tests/env.py: the
    in-memory kube API, cluster state, fake cloud provider and provisioning
    controllers, with deterministic drive helpers. The constructor and the
    helpers are the reference's; rounds run synchronously, on a FakeClock
    unless another clock is given."""

    def __init__(self, instance_types=None, dense_solver=None, clock=None):
        self.clock = clock or FakeClock()
        self.kube = KubeCluster(clock=self.clock)
        self.provider = FakeCloudProvider(instance_types)
        self.recorder = Recorder()
        self._wire(dense_solver)

    def _wire(self, dense_solver=None) -> None:
        """Cluster state and the provisioning controllers over this
        environment's store, provider and recorder."""
        self.cluster = Cluster(self.kube, self.provider, clock=self.clock)
        self.config = Config()
        self.provisioner_controller = ProvisionerController(
            self.kube,
            self.cluster,
            self.provider,
            config=self.config,
            recorder=self.recorder,
            dense_solver=dense_solver,
            wait_for_cluster_sync=False,  # synchronous rounds are always synced
            clock=self.clock,
        )
        self.reconciler = ProvisioningReconciler(self.kube, self.provisioner_controller)

    def provision(self):
        """Run one deterministic provisioning round."""
        return self.provisioner_controller.trigger_and_wait()

    def bind_nominated(self) -> int:
        """Simulate the cluster scheduler: bind each pod that was nominated
        onto a launched node to that node. Returns the number of bindings."""
        if self.provisioner_controller.last_results is None:
            return 0
        bound = 0
        launched_nodes = {n.name: n for n in self.kube.list_nodes()}
        pods = {}
        for pod in self.kube.list_pods():
            pods.setdefault(pod.name, pod)  # the first of a name, as a scan finds it
        for event in self.recorder.of("NominatePod"):
            node_name = event.message.split()[-1]
            pod = pods.get(event.object_name)
            if pod is None or pod.spec.node_name:
                continue
            if node_name in launched_nodes:
                self.kube.bind_pod(pod, node_name)
                bound += 1
        return bound

    def node_for(self, pod_name: str):
        pod = next((p for p in self.kube.list_pods() if p.name == pod_name), None)
        if pod is None or not pod.spec.node_name:
            return None
        return self.kube.get_node(pod.spec.node_name)

    def mark_initialized(self, node) -> None:
        node.metadata.labels[LABEL_NODE_INITIALIZED] = "true"
        self.kube.update(node)


def owned_pod(**kwargs) -> Pod:
    """make_pod, owned by a ReplicaSet (something would recreate it), so a
    voluntary disruption may evict it."""
    pod = make_pod(**kwargs)
    pod.metadata.owner_references.append(OwnerReference(kind="ReplicaSet", name="rs"))
    return pod


class _LifecycleEnv(Environment):
    """The Environment with its provisioners created, and the reference
    rigs' drive helper. Its subclasses add the controllers."""

    def __init__(self, provisioners=None, instance_types_list=None):
        super().__init__(instance_types=instance_types_list)
        for prov in provisioners or [make_provisioner()]:
            self.kube.create(prov)

    def launch_node_with_pods(self, *pods):
        """Create the pods, provision, bind the nominations, initialize the
        nodes, then let the nomination TTLs lapse (consolidation skips
        nominated nodes). Returns the store's nodes."""
        for pod in pods:
            self.kube.create(pod)
        self.provision()
        self.bind_nominated()
        self.node_controller.reconcile_all()
        self.clock.step(self.cluster.nomination_ttl + 1)
        return self.kube.list_nodes()


class DeprovEnv(_LifecycleEnv):
    """The counterpart of tests/test_deprovisioning.py's DeprovEnv: the node,
    termination, counter and (standalone) consolidation controllers."""

    def __init__(self, provisioners=None, instance_types_list=None):
        super().__init__(provisioners, instance_types_list)
        self.node_controller = NodeController(self.kube, self.cluster, self.provider, clock=self.clock)
        self.termination_controller = TerminationController(self.kube, self.provider, self.recorder, clock=self.clock)
        self.counter_controller = CounterController(self.kube, self.cluster)
        self.consolidation = ConsolidationController(
            self.kube, self.cluster, self.provider, self.provisioner_controller, self.recorder, clock=self.clock
        )


class DisruptionEnv(_LifecycleEnv):
    """The counterpart of tests/test_disruption.py's DisruptionEnv: the node
    controller delegates disruption (it stamps emptiness but never deletes),
    and every voluntary disruption flows through the DisruptionController,
    with consolidation as one of its sources and the termination controller
    draining what it deletes."""

    def __init__(self, provisioners=None, instance_types_list=None):
        super().__init__(provisioners, instance_types_list)
        self.node_controller = NodeController(
            self.kube, self.cluster, self.provider, clock=self.clock, delegate_disruption=True
        )
        self.termination_controller = TerminationController(self.kube, self.provider, self.recorder, clock=self.clock)
        self.consolidation = ConsolidationController(
            self.kube, self.cluster, self.provider, self.provisioner_controller, self.recorder, clock=self.clock
        )
        self.disruption = DisruptionController(
            self.kube, self.cluster, self.provider, self.provisioner_controller,
            consolidation=self.consolidation, termination=self.termination_controller,
            recorder=self.recorder, clock=self.clock,
        )

    def tick(self):
        """One deterministic runtime tick: lifecycle -> disruption -> drain."""
        self.node_controller.reconcile_all()
        self.disruption.reconcile()
        self.termination_controller.reconcile_all()


def spot_provisioner() -> Provisioner:
    """The default provisioner restricted to spot capacity: the cost-driven
    fleet a spot reclaim wave hits."""
    return make_provisioner(
        requirements=[NodeSelectorRequirement(key=LABEL_CAPACITY_TYPE, operator=OP_IN, values=["spot"])]
    )


def reclaim_wave_workload(count: int, seed: int = 42) -> List[Pod]:
    """ReplicaSet-owned pods with build_workload's request mix (cpu
    0.1-1.5, memory 100Mi-4Gi, drawn the same way from the same seed): the
    first seventh in build_workload's zonal-spread cohorts, the rest generic.
    No affinity or anti-affinity cohorts: placed anti-affinity pods would
    send every re-solve to the host loop."""
    rng = np.random.default_rng(seed)
    cpus = [0.1, 0.25, 0.5, 1.0, 1.5]
    mems = ["100Mi", "256Mi", "512Mi", "1Gi", "2Gi", "4Gi"]
    values = "abcdefg"

    def size():
        return {"cpu": cpus[rng.integers(len(cpus))], "memory": mems[rng.integers(len(mems))]}

    pods = []
    for _ in range(count // 7):
        label = {"spread": values[rng.integers(7)]}
        pods.append(
            owned_pod(
                labels=label,
                requests=size(),
                topology_spread_constraints=[
                    TopologySpreadConstraint(max_skew=1, topology_key=LABEL_TOPOLOGY_ZONE, label_selector=LabelSelector(match_labels=label))
                ],
            )
        )
    while len(pods) < count:
        pods.append(owned_pod(labels={"app": values[rng.integers(7)]}, requests=size()))
    return pods


def spot_and_on_demand_provisioner() -> Provisioner:
    """The default provisioner allowing both capacity types, as the
    reference's interruption and gc rigs create it."""
    return make_provisioner(
        requirements=[NodeSelectorRequirement(key=LABEL_CAPACITY_TYPE, operator=OP_IN, values=["spot", "on-demand"])]
    )


class SimulatedEnv(Environment):
    """The controllers a Runtime wires (karpenter_tpu/runtime.py:146-256)
    over the simulated cloud, without the Runtime: CloudBackend and
    SimulatedCloudProvider on a FakeClock, a DedupeRecorder, the admission
    chain (webhooks.register), cluster state, the provisioning, node
    (delegating disruption), termination, counter and garbage-collection
    controllers, and the interruption controller on the provider's
    notification source with the provider's offering-health hook. The
    reference's rigs build a Runtime with the dense solver off; here the
    caller routes the solve (env.provisioner_controller.dense_solver)."""

    def __init__(self, event_capacity: int = DEFAULT_EVENT_CAPACITY):
        self.clock = FakeClock()
        self.kube = KubeCluster(clock=self.clock)
        self.backend = CloudBackend(clock=self.clock)
        self.provider = SimulatedCloudProvider(backend=self.backend, kube=self.kube, clock=self.clock)
        self.recorder = DedupeRecorder(Recorder(capacity=event_capacity), clock=self.clock, capacity=event_capacity)
        webhooks.register(self.kube, self.provider)
        self._wire()
        self.node_controller = NodeController(
            self.kube, self.cluster, self.provider, clock=self.clock, delegate_disruption=True
        )
        self.termination_controller = TerminationController(self.kube, self.provider, self.recorder, clock=self.clock)
        self.counter_controller = CounterController(self.kube, self.cluster)
        self.gc = GarbageCollectionController(
            self.kube, self.cluster, self.provider, termination=self.termination_controller, clock=self.clock
        )
        self.interruption = InterruptionController(
            self.kube, self.cluster, self.provisioner_controller, self.provider.notification_source(),
            termination=self.termination_controller, recorder=self.recorder, clock=self.clock,
            cloud_provider=self.provider,
        )

    def instance_id(self, node) -> str:
        return node.spec.provider_id.split("///", 1)[1]


class InterruptionEnv(SimulatedEnv):
    """The counterpart of tests/test_interruption_catalog.py's
    InterruptionEnv (in-process transport): the simulated cloud, the
    interruption controller polling its queue, and a provisioner allowing
    spot and on-demand capacity."""

    def __init__(self):
        super().__init__()
        self.kube.create(spot_and_on_demand_provisioner())

    def launch_node_with_pods(self, pod_count: int = 3):
        pods = []
        for _ in range(pod_count):
            pod = owned_pod(requests={"cpu": "1", "memory": "1Gi"})
            pods.append(pod)
            self.kube.create(pod)
        self.provision()
        node = self.kube.list_nodes()[0]
        node.status.conditions = [NodeCondition(type="Ready", status="True")]
        self.kube.update(node)
        for pod in pods:
            self.kube.bind_pod(pod, node.name)
        self.node_controller.reconcile_all()
        return node, pods

    def converge(self, rounds: int = 4) -> None:
        """Drain the at-least-once echo chain (interruption -> termination
        -> instance_terminated notification -> no-op delete) to quiescence."""
        for _ in range(rounds):
            self.interruption.poll_once()
            self.termination_controller.reconcile_all()


class GCEnv(SimulatedEnv):
    """The counterpart of tests/test_gc.py's GCEnv: the simulated cloud (the
    sweep's default 30 s registration grace, the reference rig's value) and
    a provisioner allowing spot and on-demand capacity."""

    def __init__(self):
        super().__init__()
        self.kube.create(spot_and_on_demand_provisioner())

    def launch_node(self, pod_count: int = 0):
        pods = []
        for _ in range(pod_count):
            pod = owned_pod(requests={"cpu": "1", "memory": "1Gi"})
            pods.append(pod)
            self.kube.create(pod)
        if not pods:
            # provision needs at least one pending pod; use a throwaway
            pod = owned_pod(requests={"cpu": "1", "memory": "1Gi"})
            self.kube.create(pod)
        self.provision()
        node = self.kube.list_nodes()[-1]
        node.status.conditions = [NodeCondition(type="Ready", status="True")]
        self.kube.update(node)
        for pod in pods:
            self.kube.bind_pod(pod, node.name)
        if not pods:
            self.kube.delete(pod, grace=False)  # the throwaway: node ends up empty
        return node, pods

    def leak_instance(self) -> str:
        """An instance with no node: the crash-between-launch-and-bind shape."""
        template = self.backend.ensure_launch_template("gc-leak", "img", [], "")
        instance = self.backend.create_fleet(
            FleetRequest(
                specs=[
                    FleetInstanceSpec(
                        instance_type=self.backend.catalog[0].name,
                        zone="zone-a",
                        capacity_type="on-demand",
                        launch_template_id=template.template_id,
                    )
                ],
                capacity_type="on-demand",
            )
        )
        return instance.instance.instance_id
