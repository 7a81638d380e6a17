"""CloudProvider: the pluggable provider boundary.

Equivalent of the reference's pkg/cloudprovider/types.go:41-88 — the interface
every cloud backend implements (Create/Delete/GetInstanceTypes/Name), the
InstanceType surface the scheduler consumes (requirements, offerings,
resources, overhead, price), and the Offering (capacity type x zone)
availability record.

The TPU solver sits *behind* this boundary: it consumes the same InstanceType
universe, densified into matrices (ir/encode.py), so any provider — fake, AWS,
or otherwise — automatically gets the TPU packing path.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..api.objects import Node
from ..api.provisioner import Provisioner
from ..scheduling.nodetemplate import NodeTemplate
from ..scheduling.requirements import Requirements


@dataclass(frozen=True)
class Offering:
    capacity_type: str
    zone: str
    price: Optional[float] = None  # per-offering price override (spot markets)
    # offering-health flag fed by the unavailable-offerings cache: an
    # unavailable offering stays IN the universe (stable topology domains,
    # visible to pricing and metrics) but is never selected — the host
    # loop's type_has_offering and the dense encoder's availability cube
    # both skip it (the reference's Offering.Available)
    available: bool = True


@dataclass
class NodeRequest:
    template: NodeTemplate
    instance_type_options: List["InstanceType"] = field(default_factory=list)


class InstanceType(abc.ABC):
    """One purchasable machine shape."""

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def requirements(self) -> Requirements:
        """Node labels this type would carry, as a requirement set."""

    @abc.abstractmethod
    def offerings(self) -> Sequence[Offering]: ...

    @abc.abstractmethod
    def resources(self) -> Dict[str, float]:
        """Total allocatable-before-overhead capacity."""

    @abc.abstractmethod
    def overhead(self) -> Dict[str, float]:
        """System/kube-reserved overhead subtracted from resources."""

    @abc.abstractmethod
    def price(self) -> float: ...

    def __repr__(self) -> str:
        return f"<InstanceType {self.name()}>"


def lookup_instance_type(cloud_provider: "CloudProvider", node: Node, provisioners: Sequence[Provisioner]) -> Optional["InstanceType"]:
    """Resolve a node's instance type from its labels — the one shared
    implementation used by cluster-state capacity fallback, initialization's
    extended-resource wait, and consolidation pricing."""
    from ..api import labels as lbl

    type_name = node.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE)
    if not type_name or cloud_provider is None:
        return None
    provisioner_name = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
    ordered = sorted(provisioners, key=lambda p: p.name != provisioner_name)  # matching provisioner first
    for provisioner in ordered:
        for it in cloud_provider.get_instance_types(provisioner):
            if it.name() == type_name:
                return it
    return None


class CloudProvider(abc.ABC):
    """The provider plugin boundary (types.go:41-56)."""

    @abc.abstractmethod
    def create(self, node_request: NodeRequest) -> Node:
        """Launch capacity satisfying the request; returns the created Node.

        MUST be thread-safe: the provisioner fans a batch out over a thread
        pool (up to Provisioner.LAUNCH_WORKERS concurrent calls), matching
        the reference's one-goroutine-per-node launch (provisioner.go:176).
        """

    @abc.abstractmethod
    def delete(self, node: Node) -> None: ...

    def instance_exists(self, node: Node) -> Optional[bool]:
        """Liveness of the backing instance: True if it still exists at the
        cloud, False if it is gone, None if the provider cannot tell.

        Consolidation uses this to distinguish "large slice legitimately
        booting longer than the replace window" (alive, keep blocking the
        pass) from "launch that died and will never become capacity" (gone,
        stop blocking). Optional: the default None keeps the age-based
        fallback."""
        return None

    @abc.abstractmethod
    def get_instance_types(self, provisioner: Provisioner) -> List[InstanceType]: ...

    @abc.abstractmethod
    def name(self) -> str: ...
