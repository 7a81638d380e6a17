"""SimulatedCloudProvider: the full 'real-style' provider implementation.

The AWS-provider-equivalent (pkg/cloudprovider/aws/cloudprovider.go +
instance.go) wired over the CloudBackend: catalog + pricing + launch-template
providers, NodeClass provider config (the AWSNodeTemplate CRD analog),
create() through the fleet batcher with the 20-cheapest-types cap,
insufficient-capacity handling feeding the negative offering cache, and
instance→Node conversion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ...api import labels as lbl
from ...api.objects import Node, NodeCondition, NodeSpec, NodeStatus, ObjectMeta
from ...api.provisioner import Provisioner
from ...utils import resources as res
from ..offerings import count_insufficient_capacity
from ..types import CloudProvider, InstanceType, NodeRequest
from .backend import CloudBackend, FleetInstanceSpec, FleetRequest, InsufficientCapacityError, LaunchTemplateNotFoundError
from .catalog import InstanceTypeCatalog, PricingProvider, SimulatedInstanceType, UnavailableOfferingsCache
from .fleet import CreateFleetBatcher
from .launchtemplate import FAMILIES, KubeletArgs, LaunchTemplateProvider
from .network import SecurityGroupProvider, SubnetProvider

# EC2 CreateFleet accepts at most ~20 type overrides; same discipline here
# (aws/cloudprovider.go:62-63)
MAX_INSTANCE_TYPES = 20


@dataclass
class NodeClass:
    """Out-of-CRD provider configuration (the AWSNodeTemplate analog):
    image family, subnet/security-group discovery selectors, explicit image
    and userdata for the custom family, tags. Cluster-scoped, like
    Provisioner (namespace='')."""

    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(namespace=""))
    image_family: str = "standard"
    image_id: str = ""  # required for (and only valid with) the custom family
    user_data: str = ""  # only valid with the custom family (passed through)
    subnet_selector: Dict[str, str] = field(default_factory=dict)
    security_group_selector: Dict[str, str] = field(default_factory=dict)
    security_group_ids: List[str] = field(default_factory=list)
    tags: Dict[str, str] = field(default_factory=dict)
    include_previous_generation: bool = False

    kind = "NodeClass"

    _FIELD_TYPES = {
        "image_family": str,
        "image_id": str,
        "user_data": str,
        "subnet_selector": dict,
        "security_group_selector": dict,
        "security_group_ids": list,
        "tags": dict,
        "include_previous_generation": bool,
    }

    @classmethod
    def config_type_errors(cls, cfg: dict) -> List[str]:
        return [
            f"provider config key {k!r} must be {t.__name__}, got {type(cfg[k]).__name__}"
            for k, t in cls._FIELD_TYPES.items()
            if k in cfg and not isinstance(cfg[k], t)
        ]

    @classmethod
    def from_provider_config(cls, cfg: dict) -> "NodeClass":
        """Deserialize inline spec.provider config (the v1alpha1 AWS
        serialization analog); unknown keys and field types are rejected by
        validation (config_type_errors runs first in the admission hook)."""
        return cls(
            image_family=cfg.get("image_family", "standard"),
            image_id=cfg.get("image_id", ""),
            user_data=cfg.get("user_data", ""),
            subnet_selector=dict(cfg.get("subnet_selector", {})),
            security_group_selector=dict(cfg.get("security_group_selector", {})),
            security_group_ids=list(cfg.get("security_group_ids", [])),
            tags=dict(cfg.get("tags", {})),
            include_previous_generation=bool(cfg.get("include_previous_generation", False)),
        )


_PROVIDER_CONFIG_KEYS = {
    "image_family",
    "image_id",
    "user_data",
    "subnet_selector",
    "security_group_selector",
    "security_group_ids",
    "tags",
    "include_previous_generation",
}


def validate_node_class(node_class: NodeClass) -> List[str]:
    """The provider-config validation analog (aws/apis/v1alpha1
    validation, 255 LoC): family enum, custom-family contract, selector
    exclusivity."""
    errs: List[str] = []
    if node_class.image_family not in FAMILIES:
        errs.append(
            f"invalid image family {node_class.image_family!r}; supported: {sorted(FAMILIES)}"
        )
    if node_class.image_family == "custom":
        if not node_class.image_id:
            errs.append("custom image family requires image_id")
    else:
        if node_class.image_id:
            errs.append("image_id is only valid with the custom image family")
        if node_class.user_data:
            errs.append("user_data is only valid with the custom image family")
    if node_class.security_group_ids and node_class.security_group_selector:
        errs.append("security_group_ids and security_group_selector are mutually exclusive")
    return errs


class SimulatedCloudProvider(CloudProvider):
    def __init__(self, backend: Optional[CloudBackend] = None, kube=None, cluster_name: str = "cluster", clock=None):
        from ...utils.clock import Clock

        # the family label becomes selectable once this provider is in play
        # (registered here, not at import, so merely importing the module
        # doesn't change label semantics process-wide)
        lbl.WELL_KNOWN_LABELS.add("karpenter-tpu/instance-family")
        self.backend = backend or CloudBackend()
        self.kube = kube  # for NodeClass provider_ref resolution
        self.clock = clock or self.backend.clock or Clock()
        self.pricing = PricingProvider(self.backend)
        self.unavailable = UnavailableOfferingsCache(self.clock)
        self.catalog = InstanceTypeCatalog(self.backend, self.pricing, self.unavailable, self.clock)
        self.launch_templates = LaunchTemplateProvider(self.backend, cluster_name, clock=self.clock)
        self.subnets = SubnetProvider(self.backend, self.clock)
        self.security_groups = SecurityGroupProvider(self.backend, self.clock)
        # every exhausted pool an item reports — typed ICEs AND the pools a
        # successful launch skipped on its way to a pricier one — lands in
        # the negative cache, so the NEXT solve routes around the crunch
        # before ever retrying into it
        self.fleet_batcher = CreateFleetBatcher(self.backend, window=0.0, on_unavailable=self._observe_unavailable_pools)
        self._node_counter = 0

    def _observe_unavailable_pools(self, pools) -> None:
        """Negative-cache feed shared by the launch paths: quarantine each
        (type, zone, capacity-type) pool and count the ICE observation."""
        count_insufficient_capacity(pools)
        self.unavailable.mark_pools(pools)

    def mark_offering_unavailable(self, type_name: str, zone: str, capacity_type: str, ttl=None) -> None:
        """Out-of-band offering-health feed (no ICE counted): the
        interruption controller quarantines a just-reclaimed spot pool here —
        the pool the cloud is actively draining is the worst candidate for
        the replacement launch."""
        self.unavailable.mark_unavailable(type_name, zone, capacity_type, ttl=ttl)

    # -- admission hooks (the DefaultHook/ValidateHook seam the webhook
    # chain invokes, reference aws/cloudprovider.go:119-120) ---------------

    def default_provisioner(self, provisioner: Provisioner) -> None:
        """Add the provider's default requirements when the user left the
        axis open: on-demand capacity and amd64 (the AWS defaulting
        behavior for karpenter.sh/capacity-type and kubernetes.io/arch)."""
        from ...api.objects import OP_IN, NodeSelectorRequirement

        keys = {lbl.normalize_label(r.key) for r in provisioner.spec.requirements}
        if lbl.LABEL_CAPACITY_TYPE not in keys:
            provisioner.spec.requirements.append(
                NodeSelectorRequirement(key=lbl.LABEL_CAPACITY_TYPE, operator=OP_IN, values=[lbl.CAPACITY_TYPE_ON_DEMAND])
            )
        if lbl.LABEL_ARCH not in keys:
            provisioner.spec.requirements.append(
                NodeSelectorRequirement(key=lbl.LABEL_ARCH, operator=OP_IN, values=[lbl.ARCHITECTURE_AMD64])
            )

    def validate_provisioner(self, provisioner: Provisioner) -> List[str]:
        """Validate the inline provider config (ValidateHook analog)."""
        cfg = provisioner.spec.provider
        if not cfg:
            return []
        errs = [f"unknown provider config key {k!r}" for k in cfg if k not in _PROVIDER_CONFIG_KEYS]
        errs.extend(NodeClass.config_type_errors(cfg))
        if not errs:  # types are sound: the deserialized form can be checked
            errs.extend(validate_node_class(NodeClass.from_provider_config(cfg)))
        return errs

    def validate_object(self, obj) -> List[str]:
        """Admission for provider-owned CRs: NodeClass writes get the same
        validation as inline provider config (the AWSNodeTemplate webhook
        analog) — a custom-family NodeClass without image_id must be
        rejected at the API boundary, not crash a provisioning round."""
        if isinstance(obj, NodeClass):
            return validate_node_class(obj)
        return []

    def name(self) -> str:
        return "simulated"

    def notification_source(self):
        """The interruption feed for this cloud: the backend's in-process
        NotificationQueue, or the CloudAPIClient itself on the HTTP
        transport (it duck-types receive_messages/delete_message/
        dead_letter_depth over /v1/queue)."""
        return getattr(self.backend, "notifications", self.backend)

    def refresh_pricing(self) -> bool:
        """One pricing-refresh tick (the synchronous core of the reference's
        async OD/spot updaters, pricing.go:76-393): re-pull the price books
        and, when they changed, invalidate the catalog so the next
        GetInstanceTypes prices offerings from the new books. Called by the
        runtime's leader-only refresh loop (runtime.py)."""
        changed = self.pricing.refresh()
        if changed:
            self.catalog.invalidate()
        return changed

    # -- provider config -------------------------------------------------------

    def _node_class(self, provisioner: Optional[Provisioner]) -> NodeClass:
        if provisioner is None:
            return NodeClass()
        if provisioner.spec.provider_ref and self.kube is not None:
            node_class = self.kube.get("NodeClass", provisioner.spec.provider_ref, namespace="")
            if node_class is not None:
                return node_class
        if provisioner.spec.provider:
            return NodeClass.from_provider_config(provisioner.spec.provider)
        return NodeClass()

    # -- instance types ----------------------------------------------------------

    def get_instance_types(self, provisioner: Provisioner) -> List[InstanceType]:
        node_class = self._node_class(provisioner)
        return list(
            self.catalog.get(
                include_previous_generation=node_class.include_previous_generation,
                subnet_selector=node_class.subnet_selector or None,
            )
        )

    # -- create / delete ----------------------------------------------------------

    def create(self, node_request: NodeRequest) -> Node:
        try:
            return self._create(node_request)
        except LaunchTemplateNotFoundError:
            # the launch-template cache went out of sync with an external
            # deletion: drop it and rebuild once — the retry re-ensures every
            # template against the cloud (launchtemplate_test.go:138-160)
            self.launch_templates.clear_cache()
            return self._create(node_request)

    def _create(self, node_request: NodeRequest) -> Node:
        template = node_request.template
        requirements = template.requirements
        options = sorted(node_request.instance_type_options, key=lambda it: it.price())[:MAX_INSTANCE_TYPES]
        provisioner = self.kube.get("Provisioner", template.provisioner_name, namespace="") if self.kube else None
        node_class = self._node_class(provisioner)
        security_group_ids = self.security_groups.resolve(
            node_class.security_group_selector or None, node_class.security_group_ids
        )
        # zone -> chosen subnet (most available IPs), hoisted out of the
        # offering loop (depends only on zone x selector)
        zone_subnet: Dict[str, Optional[str]] = {}
        kubelet = None
        if template.kubelet_configuration is not None:
            kc = template.kubelet_configuration
            kubelet = KubeletArgs(
                cluster_dns=list(kc.cluster_dns),
                max_pods=kc.max_pods,
                system_reserved=dict(kc.system_reserved),
                kube_reserved=dict(kc.kube_reserved),
            )

        specs: List[FleetInstanceSpec] = []
        capacity_types = set()
        for it in options:
            launch_template = self.launch_templates.resolve(
                node_class.image_family,
                next(iter(it.requirements().get(lbl.LABEL_ARCH).values), lbl.ARCHITECTURE_AMD64),
                security_group_ids,
                template.labels,
                list(template.taints) + list(template.startup_taints),
                kubelet=kubelet,
                image_id=node_class.image_id or None,
                custom_user_data=node_class.user_data or None,
            )
            for offering in it.offerings():
                if not offering.available:
                    # quarantined pool (unavailable-offerings cache): a spec
                    # for it would let the backend's lowest-price pick launch
                    # straight back into the exhausted/reclaimed pool
                    continue
                if not requirements.get(lbl.LABEL_TOPOLOGY_ZONE).has(offering.zone):
                    continue
                if not requirements.get(lbl.LABEL_CAPACITY_TYPE).has(offering.capacity_type):
                    continue
                # the zone must have a discoverable subnet; launch targets
                # the one with the most available IPs (instance.go:239-279)
                if offering.zone not in zone_subnet:
                    best = self.subnets.best_for_zone(offering.zone, node_class.subnet_selector or None)
                    zone_subnet[offering.zone] = best.subnet_id if best is not None else None
                subnet_id = zone_subnet[offering.zone]
                if subnet_id is None:
                    continue
                capacity_types.add(offering.capacity_type)
                specs.append(
                    FleetInstanceSpec(
                        instance_type=it.name(),
                        zone=offering.zone,
                        capacity_type=offering.capacity_type,
                        launch_template_id=launch_template.template_id,
                        subnet_id=subnet_id,
                    )
                )
        if not specs:
            raise RuntimeError("no offering satisfies the node requirements")
        # prefer spot when allowed (lowest-price strategy picks it anyway)
        capacity_type = lbl.CAPACITY_TYPE_SPOT if lbl.CAPACITY_TYPE_SPOT in capacity_types else lbl.CAPACITY_TYPE_ON_DEMAND

        import uuid

        # one client token per LOGICAL launch: the batcher derives its
        # per-waiter tokens from it and replays them on lost responses, so a
        # transport failure mid-CreateFleet can never double-launch. An
        # InsufficientCapacityError propagates typed to the provisioner's
        # fallback re-solve; the batcher's on_unavailable callback has
        # already quarantined the exhausted pools (including pools a
        # SUCCESSFUL launch skipped) by the time either outcome lands here.
        instance = self.fleet_batcher.create_fleet(
            FleetRequest(specs=specs, capacity_type=capacity_type, client_token=uuid.uuid4().hex)
        )
        return self._instance_to_node(instance, node_request)

    def _instance_to_node(self, instance, node_request: NodeRequest) -> Node:
        it = next((t for t in node_request.instance_type_options if t.name() == instance.instance_type), None)
        labels = dict(node_request.template.labels)
        labels.update(node_request.template.requirements.labels())
        labels[lbl.PROVISIONER_NAME_LABEL] = node_request.template.provisioner_name
        labels[lbl.LABEL_INSTANCE_TYPE] = instance.instance_type
        labels[lbl.LABEL_TOPOLOGY_ZONE] = instance.zone
        labels[lbl.LABEL_CAPACITY_TYPE] = instance.capacity_type
        name = instance.instance_id
        labels[lbl.LABEL_HOSTNAME] = name
        # duck-typed: scheduler-side wrappers (kubelet maxPods cap) are not
        # SimulatedInstanceType instances but forward .info to the adapter
        info = getattr(it, "info", None)
        if info is not None:
            labels[lbl.LABEL_ARCH] = info.architecture
            labels[lbl.LABEL_OS] = lbl.OS_LINUX
        capacity = dict(it.resources()) if it is not None else {}
        allocatable = res.clamp_negative_to_zero(res.subtract(capacity, it.overhead())) if it is not None else {}
        return Node(
            metadata=ObjectMeta(
                name=name, namespace="", labels=labels,
                # launch-template seam for drift detection: the spec-hash of
                # the template this instance was actually launched from
                annotations={lbl.PROVISIONER_HASH_ANNOTATION: node_request.template.spec_hash()},
                finalizers=[lbl.TERMINATION_FINALIZER],
            ),
            spec=NodeSpec(
                taints=list(node_request.template.taints) + list(node_request.template.startup_taints),
                provider_id=f"sim:///{instance.instance_id}",
            ),
            # real nodes join NotReady; the kubelet flips Ready later (the
            # node-lifecycle controller waits for it)
            status=NodeStatus(capacity=capacity, allocatable=allocatable, conditions=[]),
        )

    def delete(self, node: Node) -> None:
        if node.spec.provider_id.startswith("sim:///"):
            self.backend.terminate_instance(node.spec.provider_id.split("///", 1)[1])

    def instance_exists(self, node: Node):
        if not node.spec.provider_id.startswith("sim:///"):
            return None  # not ours to answer for
        return self.backend.instance_exists(node.spec.provider_id.split("///", 1)[1])

    def list_instances(self):
        """Every live cloud instance (id, launch time) — the GC sweep's
        source of truth for the orphan direction. Works on both transports:
        CloudBackend and CloudAPIClient each expose list_instances()."""
        return self.backend.list_instances()

    def terminate_instance(self, instance_id: str) -> None:
        """Terminate by raw instance id (the GC sweep holds no Node object
        for an orphan — that is what makes it an orphan)."""
        self.backend.terminate_instance(instance_id)
