"""NodeTemplate: a provisioner rendered into a launchable-node template.

Mirrors pkg/scheduling/nodetemplate.go:29-67 — the provisioner's labels,
taints, startup taints, requirements, and kubelet config rolled into the
object the scheduler opens new virtual nodes from, plus `to_node()` which
emits the cluster Node object carrying the termination finalizer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..api import labels as lbl
from ..api.objects import Node, NodeSpec, NodeStatus, ObjectMeta, OP_IN
from ..api.provisioner import KubeletConfiguration, Provisioner
from .requirement import Requirement
from .requirements import Requirements
from .taints import Taints


@dataclass
class NodeTemplate:
    provisioner_name: str
    provider: Optional[dict] = None
    provider_ref: Optional[str] = None
    labels: Dict[str, str] = field(default_factory=dict)
    taints: Taints = field(default_factory=Taints)
    startup_taints: Taints = field(default_factory=Taints)
    requirements: Requirements = field(default_factory=Requirements)
    kubelet_configuration: Optional[KubeletConfiguration] = None
    # the base provisioner template's digest, pinned at from_provisioner()
    # time: the scheduler tightens per-node COPIES of the requirements, so
    # hashing the launch-time template would make every node look drifted
    stamped_hash: Optional[str] = None

    @classmethod
    def from_provisioner(cls, provisioner: Provisioner) -> "NodeTemplate":
        requirements = Requirements()
        requirements.add(*Requirements.from_node_selector_requirements(provisioner.spec.requirements).values())
        requirements.add(*Requirements.from_labels(provisioner.spec.labels).values())
        requirements.add(Requirement(lbl.PROVISIONER_NAME_LABEL, OP_IN, provisioner.name))
        template = cls(
            provisioner_name=provisioner.name,
            provider=provisioner.spec.provider,
            provider_ref=provisioner.spec.provider_ref,
            labels=dict(provisioner.spec.labels),
            taints=Taints(provisioner.spec.taints),
            startup_taints=Taints(provisioner.spec.startup_taints),
            requirements=requirements,
            kubelet_configuration=provisioner.spec.kubelet_configuration,
        )
        template.stamped_hash = template.spec_hash()
        return template

    def spec_hash(self) -> str:
        """Deterministic digest of everything that shapes a launched node:
        labels, taints, requirements, kubelet config, and provider config.
        Providers stamp it onto nodes at launch (the
        karpenter.sh/provisioner-hash annotation); the disruption
        controller's drift method compares it against the CURRENT
        provisioner's template — a mismatch flags the node drifted.

        Returns the digest pinned by from_provisioner() when present (the
        base template, surviving per-node requirement tightening)."""
        if self.stamped_hash is not None:
            return self.stamped_hash
        import hashlib
        import json

        def _taints(taints) -> list:
            return sorted((t.key, t.value, t.effect) for t in taints)

        requirements = sorted(
            (r.key, r.operator(), sorted(str(v) for v in r.values), r.greater_than, r.less_than)
            for r in self.requirements
        )
        kubelet = None
        if self.kubelet_configuration is not None:
            kc = self.kubelet_configuration
            kubelet = [
                list(kc.cluster_dns), kc.max_pods, kc.pods_per_core,
                sorted(kc.system_reserved.items()), sorted(kc.kube_reserved.items()),
            ]
        payload = {
            "labels": sorted(self.labels.items()),
            "taints": _taints(self.taints),
            "startup_taints": _taints(self.startup_taints),
            "requirements": requirements,
            "kubelet": kubelet,
            "provider": self.provider,
            "provider_ref": self.provider_ref,
        }
        return hashlib.sha256(json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()[:16]

    def copy(self) -> "NodeTemplate":
        return NodeTemplate(
            provisioner_name=self.provisioner_name,
            provider=self.provider,
            provider_ref=self.provider_ref,
            labels=dict(self.labels),
            taints=Taints(self.taints),
            startup_taints=Taints(self.startup_taints),
            requirements=self.requirements.copy(),
            kubelet_configuration=self.kubelet_configuration,
            stamped_hash=self.stamped_hash,
        )

    def to_node(self) -> Node:
        """Emit the Node object for launch (nodetemplate.go:57-67)."""
        labels = dict(self.labels)
        labels.update(self.requirements.labels())
        labels[lbl.PROVISIONER_NAME_LABEL] = self.provisioner_name
        return Node(
            metadata=ObjectMeta(
                name="",
                namespace="",
                labels=labels,
                annotations={lbl.PROVISIONER_HASH_ANNOTATION: self.spec_hash()},
                finalizers=[lbl.TERMINATION_FINALIZER],
            ),
            spec=NodeSpec(taints=list(self.taints) + list(self.startup_taints)),
            status=NodeStatus(),
        )
