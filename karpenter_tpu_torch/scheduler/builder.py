"""Scheduler construction: templates, instance-type universe, topology domains.

The equivalent of the wiring in the reference's
pkg/controllers/provisioning/provisioner.go:217-277 — node templates ordered
by provisioner weight, per-provisioner instance types, the topology domain
universe derived from instance-type requirements + provisioner requirements,
daemonset overhead, and topology construction.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set

from ..api.objects import OP_IN, Pod
from ..api.provisioner import Provisioner, order_by_weight
from ..cloudprovider.types import CloudProvider, InstanceType
from ..scheduling.nodetemplate import NodeTemplate
from ..utils import resources as res
from ..utils import pod as podutils
from .scheduler import Scheduler, SchedulerOptions
from .topology import Topology


def compute_domains(provisioners: Sequence[Provisioner], instance_types: Dict[str, List[InstanceType]]) -> Dict[str, Set[str]]:
    """The universe of topology domains per label key."""
    domains: Dict[str, Set[str]] = {}
    for provisioner in provisioners:
        for it in instance_types.get(provisioner.name, []):
            for requirement in it.requirements():
                if not requirement.complement:
                    domains.setdefault(requirement.key, set()).update(requirement.values)
        for req in provisioner.spec.requirements:
            if req.operator == OP_IN:
                domains.setdefault(req.key, set()).update(req.values)
        for key, value in provisioner.spec.labels.items():
            domains.setdefault(key, set()).add(value)
    return domains


def daemonset_overhead(daemonset_pods: Iterable[Pod], template: NodeTemplate) -> Dict[str, float]:
    """Total requests of daemonset pods that would schedule to nodes from this
    template (provisioner.go:339-360): tolerate the taints and be requirement
    compatible."""
    total: Dict[str, float] = {}
    for pod in daemonset_pods:
        if template.taints.tolerates(pod) is not None:
            continue
        from ..scheduling.requirements import Requirements

        if template.requirements.compatible(Requirements.from_pod(pod)) is not None:
            continue
        total = res.merge(total, res.pod_requests(pod))
    return total


class _MaxPodsInstanceType(InstanceType):
    """A provisioner's kubeletConfiguration.maxPods caps pods-per-node below
    the machine's native density (the reference applies this inside the AWS
    provider's instance-type adapter, instancetypes.go pods()); applied here
    so EVERY provider honors it and the dense encode sees the capped value."""

    def __init__(self, inner: InstanceType, max_pods: int):
        self._inner = inner
        self._max_pods = float(max_pods)

    def name(self) -> str:
        return self._inner.name()

    def requirements(self):
        return self._inner.requirements()

    def offerings(self):
        return self._inner.offerings()

    def resources(self) -> Dict[str, float]:
        out = dict(self._inner.resources())
        out[res.PODS] = min(out.get(res.PODS, self._max_pods), self._max_pods)
        return out

    def overhead(self) -> Dict[str, float]:
        return self._inner.overhead()

    def price(self) -> float:
        return self._inner.price()

    def __getattr__(self, name):
        # provider-specific adapters expose extra attributes (e.g. the
        # simulated provider reads .info for arch/os labels); forward so
        # wrapping never hides the underlying adapter's surface. Private
        # names never forward: pickle probes them before __init__ has set
        # _inner, which would recurse here
        if name.startswith("_"):
            raise AttributeError(name)
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)


# wrapper lists memoized on the wrapped instance-type OBJECTS (providers
# return a fresh list copy per call but TTL-cache the items), so the dense
# catalog cache and the vectorized filter cache — keyed the same way — stay
# warm across solves; the entry pins the originals against id reuse
_MAX_PODS_MEMO: Dict[tuple, tuple] = {}


def apply_kubelet_max_pods(provisioner: Provisioner, types: List[InstanceType]) -> List[InstanceType]:
    kc = provisioner.spec.kubelet_configuration
    if kc is None or kc.max_pods is None:
        return types
    # idempotent: the remote-solver fallback re-enters build_scheduler with
    # an already-capped snapshot; re-wrapping would mint fresh ids and defeat
    # the warmed catalog/filter caches
    if types and all(isinstance(it, _MaxPodsInstanceType) and it._max_pods == kc.max_pods for it in types):
        return types
    key = (tuple(id(it) for it in types), kc.max_pods)
    entry = _MAX_PODS_MEMO.get(key)
    if entry is None:
        if len(_MAX_PODS_MEMO) >= 64:
            _MAX_PODS_MEMO.clear()
        entry = (tuple(types), [_MaxPodsInstanceType(it, kc.max_pods) for it in types])
        _MAX_PODS_MEMO[key] = entry
    return entry[1]


def build_scheduler(
    provisioners: Sequence[Provisioner],
    cloud_provider: CloudProvider,
    pods: Sequence[Pod],
    kube=None,
    cluster=None,
    state_nodes: Sequence[object] = (),
    daemonset_pods: Sequence[Pod] = (),
    opts: Optional[SchedulerOptions] = None,
    recorder=None,
    dense_solver=None,
    nominated: Sequence[tuple] = (),
) -> Scheduler:
    provisioners = order_by_weight(list(provisioners))
    node_templates = [NodeTemplate.from_provisioner(p) for p in provisioners]
    instance_types = {
        p.name: apply_kubelet_max_pods(p, cloud_provider.get_instance_types(p)) for p in provisioners
    }
    domains = compute_domains(provisioners, instance_types)
    topology = Topology(kube=kube, cluster=cluster, domains=domains, pods=list(pods), nominated=nominated)
    overhead = {t.provisioner_name: daemonset_overhead(daemonset_pods, t) for t in node_templates}
    return Scheduler(
        node_templates=node_templates,
        provisioners=provisioners,
        topology=topology,
        instance_types=instance_types,
        daemon_overhead=overhead,
        state_nodes=state_nodes,
        opts=opts,
        recorder=recorder,
        cluster=cluster,
        dense_solver=dense_solver,
    )
