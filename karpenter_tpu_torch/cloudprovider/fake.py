"""Fake cloud provider + instance-type generators for tests and benchmarks.

Equivalent of pkg/cloudprovider/fake/ — an in-memory provider that records
Create calls and synthesizes Node objects deterministically from the first
instance-type option and a requirement-compatible offering, plus the two
instance-type corpus generators the reference's scheduler suites and benchmark
use (fake/instancetype.go:96-148).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..api import labels as lbl
from ..api.objects import OP_DOES_NOT_EXIST, OP_IN, Node, NodeCondition, NodeSpec, NodeStatus, ObjectMeta
from ..api.provisioner import Provisioner
from ..scheduling.requirement import Requirement
from ..scheduling.requirements import Requirements
from ..utils import resources as res
from ..utils.quantity import parse_quantity
from .errors import InsufficientCapacityError
from .types import CloudProvider, InstanceType, NodeRequest, Offering

LABEL_INSTANCE_SIZE = "size"
EXOTIC_INSTANCE_LABEL = "special"
INTEGER_INSTANCE_LABEL = "integer"

# The fake provider's labels are well-known, same as the reference's fake
# (fake/instancetype.go:41-47).
lbl.WELL_KNOWN_LABELS.update({LABEL_INSTANCE_SIZE, EXOTIC_INSTANCE_LABEL, INTEGER_INSTANCE_LABEL})

DEFAULT_OFFERINGS = (
    Offering(capacity_type="spot", zone="test-zone-1"),
    Offering(capacity_type="spot", zone="test-zone-2"),
    Offering(capacity_type="on-demand", zone="test-zone-1"),
    Offering(capacity_type="on-demand", zone="test-zone-2"),
    Offering(capacity_type="on-demand", zone="test-zone-3"),
)


@dataclass
class FakeInstanceType(InstanceType):
    _name: str
    _resources: Dict[str, float] = field(default_factory=dict)
    _overhead: Dict[str, float] = field(default_factory=lambda: {"cpu": 0.1, "memory": 10 * 2**20})
    _offerings: Sequence[Offering] = DEFAULT_OFFERINGS
    architecture: str = "amd64"
    operating_systems: tuple = ("linux", "windows", "darwin")
    _price: float = 0.0

    def __post_init__(self):
        self._resources.setdefault("cpu", 4.0)
        self._resources.setdefault("memory", 4 * 2**30)
        self._resources.setdefault("pods", 5.0)

    def name(self) -> str:
        return self._name

    def resources(self) -> Dict[str, float]:
        return self._resources

    def overhead(self) -> Dict[str, float]:
        return self._overhead

    def offerings(self) -> Sequence[Offering]:
        return self._offerings

    def price(self) -> float:
        """Price defaults to a resource-derived synthetic price
        (fake/instancetype.go:168-185): 0.1/cpu + 0.1/GB + 1.0/gpu."""
        if self._price:
            return self._price
        price = 0.0
        for name, value in self._resources.items():
            if name == "cpu":
                price += 0.1 * value
            elif name == "memory":
                price += 0.1 * value / 1e9
            elif name in (res.NVIDIA_GPU, res.AMD_GPU):
                price += 1.0
        return price

    def requirements(self) -> Requirements:
        # memoized: the scheduler probes requirements once per (group, type)
        # and rebuilding the set algebra dominates encode time otherwise.
        # Keyed on the contributing fields so tests that mutate a fake type
        # (e.g. dropping an offering to simulate capacity loss) see fresh
        # requirements.
        key = (
            self._name,
            self.architecture,
            tuple(self.operating_systems),
            tuple(self._offerings),
            self._resources.get("cpu"),
            self._resources.get("memory"),
        )
        cached = getattr(self, "_requirements_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        requirements = self._build_requirements()
        object.__setattr__(self, "_requirements_cache", (key, requirements))
        return requirements

    def _build_requirements(self) -> Requirements:
        requirements = Requirements(
            Requirement(lbl.LABEL_INSTANCE_TYPE, OP_IN, self._name),
            Requirement(lbl.LABEL_ARCH, OP_IN, self.architecture),
            Requirement(lbl.LABEL_OS, OP_IN, *self.operating_systems),
            Requirement(lbl.LABEL_TOPOLOGY_ZONE, OP_IN, *[o.zone for o in self._offerings]),
            Requirement(lbl.LABEL_CAPACITY_TYPE, OP_IN, *[o.capacity_type for o in self._offerings]),
            Requirement(LABEL_INSTANCE_SIZE, OP_DOES_NOT_EXIST),
            Requirement(EXOTIC_INSTANCE_LABEL, OP_DOES_NOT_EXIST),
            Requirement(INTEGER_INSTANCE_LABEL, OP_IN, str(int(self._resources.get("cpu", 0)))),
        )
        if self._resources.get("cpu", 0) > 4 and self._resources.get("memory", 0) > 8 * 2**30:
            requirements.get(LABEL_INSTANCE_SIZE).insert("large")
            requirements.get(EXOTIC_INSTANCE_LABEL).insert("optional")
        else:
            requirements.get(LABEL_INSTANCE_SIZE).insert("small")
        return requirements


def instance_type(
    name: str,
    cpu: object = None,
    memory: object = None,
    pods: object = None,
    resources: Optional[Dict[str, object]] = None,
    offerings: Optional[Sequence[Offering]] = None,
    architecture: str = "amd64",
    operating_systems: Sequence[str] = ("linux", "windows", "darwin"),
    overhead: Optional[Dict[str, object]] = None,
    price: float = 0.0,
) -> FakeInstanceType:
    parsed: Dict[str, float] = {k: parse_quantity(v) for k, v in (resources or {}).items()}
    if cpu is not None:
        parsed["cpu"] = parse_quantity(cpu)
    if memory is not None:
        parsed["memory"] = parse_quantity(memory)
    if pods is not None:
        parsed["pods"] = parse_quantity(pods)
    kwargs = {}
    if overhead is not None:
        kwargs["_overhead"] = {k: parse_quantity(v) for k, v in overhead.items()}
    return FakeInstanceType(
        _name=name,
        _resources=parsed,
        _offerings=tuple(offerings) if offerings else DEFAULT_OFFERINGS,
        architecture=architecture,
        operating_systems=tuple(operating_systems),
        _price=price,
        **kwargs,
    )


def instance_types(total: int) -> List[FakeInstanceType]:
    """Incrementing corpus: (i+1) vCPU, 2(i+1)Gi memory, 10(i+1) pods —
    the benchmark universe (fake/instancetype.go:135-148)."""
    return [
        instance_type(f"fake-it-{i}", cpu=i + 1, memory=f"{(i + 1) * 2}Gi", pods=(i + 1) * 10)
        for i in range(total)
    ]


def instance_types_assorted() -> List[FakeInstanceType]:
    """Full cartesian corpus over cpu x mem x zone x capacity-type x os x arch
    (fake/instancetype.go:96-127)."""
    out = []
    for cpu in (1, 2, 4, 8, 16, 32, 64):
        for mem in (1, 2, 4, 8, 16, 32, 64, 128):
            for zone in ("test-zone-1", "test-zone-2", "test-zone-3"):
                for ct in ("spot", "on-demand"):
                    for os_ in ("linux", "windows"):
                        for arch in ("amd64", "arm64"):
                            out.append(
                                instance_type(
                                    f"{cpu}-cpu-{mem}-mem-{arch}-{os_}-{zone}-{ct}",
                                    cpu=cpu,
                                    memory=f"{mem}Gi",
                                    architecture=arch,
                                    operating_systems=(os_,),
                                    offerings=[Offering(capacity_type=ct, zone=zone)],
                                )
                            )
    return out


def default_instance_types() -> List[FakeInstanceType]:
    """The default menagerie (fake/cloudprovider.go:84-138): a spread of
    shapes incl. GPU, arm, single-pod, and windows-only types."""
    return [
        instance_type("default-instance-type", cpu=16, memory="128Gi", pods=110),
        instance_type("small-instance-type", cpu=2, memory="2Gi", pods=10),
        instance_type("nvidia-gpu-instance-type", cpu=16, memory="128Gi", pods=10,
                      resources={res.NVIDIA_GPU: 2}),
        instance_type("amd-gpu-instance-type", cpu=16, memory="128Gi", pods=10,
                      resources={res.AMD_GPU: 2}),
        instance_type("arm-instance-type", cpu=16, memory="128Gi", pods=110, architecture="arm64"),
        instance_type("single-pod-instance-type", cpu=2, memory="4Gi", pods=1),
        instance_type("windows-instance-type", cpu=4, memory="8Gi", pods=50,
                      operating_systems=("windows",)),
    ]


class FakeCloudProvider(CloudProvider):
    """In-memory provider: deterministic node synthesis + call recording,
    with injectable failures (fake/cloudprovider.go:37-147)."""

    def __init__(self, instance_types: Optional[List[InstanceType]] = None):
        self.instance_types_list: List[InstanceType] = (
            list(instance_types) if instance_types is not None else default_instance_types()
        )
        self.create_calls: List[NodeRequest] = []
        self.delete_calls: List[Node] = []
        self.next_create_error: Optional[Exception] = None
        self.allow_insufficient_capacity: bool = False
        self.insufficient_capacity_pools: set = set()  # {(instance_type, zone, capacity_type)}
        self._lock = threading.Lock()
        self._counter = itertools.count(1)
        self.live_instances: set = set()  # node names with a live fake instance

    def reset(self) -> None:
        self.create_calls = []
        self.delete_calls = []
        self.next_create_error = None
        self.insufficient_capacity_pools = set()
        self.live_instances = set()

    def create(self, node_request: NodeRequest) -> Node:
        with self._lock:
            if self.next_create_error is not None:
                err, self.next_create_error = self.next_create_error, None
                raise err
            self.create_calls.append(node_request)
            n = next(self._counter)
            ice_pools = set(self.insufficient_capacity_pools)
            allow_ice = self.allow_insufficient_capacity

        requirements = node_request.template.requirements
        skipped = []
        for it in node_request.instance_type_options:
            for offering in it.offerings():
                if not requirements.get(lbl.LABEL_TOPOLOGY_ZONE).has(offering.zone) or not requirements.get(
                    lbl.LABEL_CAPACITY_TYPE
                ).has(offering.capacity_type):
                    continue
                pool = (it.name(), offering.zone, offering.capacity_type)
                if pool in ice_pools or not offering.available:
                    # same discipline as CloudBackend.create_fleet: an
                    # exhausted pool is skipped, the launch falls through to
                    # the next-cheapest offering, and the skipped pool rides
                    # the typed error if nothing remains. With
                    # allow_insufficient_capacity=False (the default), the
                    # FIRST exhausted pool fails the whole request — the
                    # strict mode suites use to prove a caller would have
                    # retried into the wall without the negative cache.
                    skipped.append(pool)
                    if not allow_ice:
                        raise InsufficientCapacityError([pool])
                    continue
                return self._to_node(node_request, it, offering, n)
        if not skipped:
            # no offering matched the REQUIREMENTS at all: a template/
            # scheduler bug, not a capacity failure — keep it untyped so the
            # provisioner classifies it reason="other" and the per-pool ICE
            # counter never records pools that were never exhausted
            raise RuntimeError("insufficient capacity: no available offering matched the request")
        raise InsufficientCapacityError(skipped)

    def _to_node(self, node_request: NodeRequest, it: InstanceType, offering: Offering, n: int) -> Node:
        name = f"fake-node-{n:05d}"
        with self._lock:
            self.live_instances.add(name)
        labels = dict(node_request.template.labels)
        labels.update(node_request.template.requirements.labels())
        # provider-injected well-known labels
        labels[lbl.LABEL_INSTANCE_TYPE] = it.name()
        labels[lbl.LABEL_TOPOLOGY_ZONE] = offering.zone
        labels[lbl.LABEL_CAPACITY_TYPE] = offering.capacity_type
        labels[lbl.LABEL_HOSTNAME] = name
        labels[lbl.PROVISIONER_NAME_LABEL] = node_request.template.provisioner_name
        for requirement in it.requirements():
            # only single-valued requirements are definite enough to become
            # labels; multi-valued ones (os, zone sets) would contradict the
            # template's own constraints if picked arbitrarily
            if requirement.operator() == OP_IN and len(requirement.values) == 1 and requirement.key not in labels:
                labels[requirement.key] = requirement.any_value()
        capacity = dict(it.resources())
        allocatable = res.subtract(capacity, it.overhead())
        return Node(
            metadata=ObjectMeta(name=name, namespace="", labels=labels,
                                # the drift seam: record what this node was
                                # launched from so config changes are detectable
                                annotations={lbl.PROVISIONER_HASH_ANNOTATION: node_request.template.spec_hash()},
                                finalizers=[lbl.TERMINATION_FINALIZER]),
            spec=NodeSpec(
                taints=list(node_request.template.taints) + list(node_request.template.startup_taints),
                provider_id=f"fake:///{name}",
            ),
            status=NodeStatus(
                capacity=capacity,
                allocatable=res.clamp_negative_to_zero(allocatable),
                conditions=[NodeCondition(type="Ready", status="True")],
            ),
        )

    def delete(self, node: Node) -> None:
        self.delete_calls.append(node)
        with self._lock:
            self.live_instances.discard(node.metadata.name)

    def instance_exists(self, node: Node):
        # only nodes this provider launched are knowable; anything else
        # (fixture-made nodes) is reported gone, which preserves the
        # age-based consolidation escape for synthetic test nodes
        with self._lock:
            return node.metadata.name in self.live_instances

    def get_instance_types(self, provisioner: Provisioner) -> List[InstanceType]:
        return list(self.instance_types_list)

    def name(self) -> str:
        return "fake"
