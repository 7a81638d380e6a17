"""VirtualNode: an in-flight node being designed during scheduling.

Mirrors scheduling/node.go — a constraint set plus the surviving
instance-type options and committed pods. `add(pod)` runs the full check
chain (taints → host ports → requirement compatibility → topology tightening
→ instance-type filtering) and commits mutations only on success.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

try:  # the host loop works without numpy; only the vectorized cache needs it
    import numpy as np
except ImportError:  # pragma: no cover
    np = None

from ..api import labels as lbl
from ..api.objects import OP_IN, Pod
from ..cloudprovider.types import InstanceType
from ..scheduling.hostports import HostPortUsage
from ..scheduling.nodetemplate import NodeTemplate
from ..scheduling.requirement import Requirement
from ..scheduling.requirements import Requirements
from ..utils import resources as res
from .errors import IncompatibleError
from .topology import Topology

_hostname_counter = itertools.count(1)


class CatalogFilterCache:
    """Vectorized survivor filtering over one shared instance-type catalog.

    The host loop and the dense commit path both re-run
    filter_instance_types on every add — O(T) Python predicate calls per
    pod, the reference's hot loop (node.go:139-161). This cache keeps the
    outcome bit-identical (it delegates to the same three predicates on
    every cache miss) while making the steady state cheap:

    - resource fit: [T, R] total/overhead matrices evaluated in the same
      operand order as res.fits ((requests + overhead) <= total + tol) so
      float64 verdicts cannot drift from the exact predicate;
    - requirement compatibility + offering: the verdict depends only on the
      node requirements restricted to keys any catalog type carries (plus
      zone/capacity-type), so masks memoize by that signature — cohorts of
      identically-constrained pods hit the same entry across every bin.

    Scoped per (scheduler, provisioner): instance-type objects are shared
    by reference across nodes, so id() indexes survivor subsets back into
    the catalog arrays.
    """

    def __init__(self, types: Sequence[InstanceType]):
        self.types = list(types)
        self.index = {id(it): i for i, it in enumerate(self.types)}
        res_keys: set = set()
        rel_keys: set = set()
        for it in self.types:
            res_keys |= set(it.resources()) | set(it.overhead())
            rel_keys |= set(it.requirements().keys())
        rel_keys.add(lbl.LABEL_TOPOLOGY_ZONE)
        rel_keys.add(lbl.LABEL_CAPACITY_TYPE)
        self.rel_keys = tuple(sorted(rel_keys))
        self.kpos = {k: j for j, k in enumerate(sorted(res_keys))}
        T, R = len(self.types), len(self.kpos)
        total = np.zeros((T, R))
        over = np.zeros((T, R))
        tol = np.zeros((T, R))
        static_ok = np.ones((T,), dtype=bool)
        for i, it in enumerate(self.types):
            r, o = it.resources(), it.overhead()
            for k, j in self.kpos.items():
                total[i, j] = r.get(k, 0.0)
                over[i, j] = o.get(k, 0.0)
                tol[i, j] = res.tolerance(total[i, j])
                # overhead alone must fit even for unrequested resources
                if over[i, j] > total[i, j] + tol[i, j]:
                    static_ok[i] = False
        self._total = total
        self._over = over
        self._tol = tol
        self._cap = total - over  # could_fit() headroom only, never fit verdicts
        self._static_ok = static_ok
        self._compat_masks: Dict[tuple, "object"] = {}

    def _requirements_signature(self, requirements: Requirements):
        sig = []
        for k in self.rel_keys:
            if requirements.has(k):
                r = requirements.get(k)
                sig.append((k, r.complement, frozenset(r.values), r.greater_than, r.less_than))
        return tuple(sig)

    def _compat_offering_mask(self, requirements: Requirements):
        sig = self._requirements_signature(requirements)
        mask = self._compat_masks.get(sig)
        if mask is None:
            mask = np.fromiter(
                (type_is_compatible(it, requirements) and type_has_offering(it, requirements) for it in self.types),
                dtype=bool,
                count=len(self.types),
            )
            self._compat_masks[sig] = mask
        return mask

    def _fit_mask(self, requests: Dict[str, float]):
        cols, vals, missing = [], [], False
        for k, v in requests.items():
            j = self.kpos.get(k)
            if j is None:
                # no catalog type carries this resource: only a ~zero
                # request can fit (fits() vs an absent key)
                if v > res.tolerance(0.0):
                    missing = True
                    break
            else:
                cols.append(j)
                vals.append(v)
        if missing:
            return np.zeros((len(self.types),), dtype=bool)
        mask = self._static_ok
        if cols:
            # same operand order as res.fits: (request + overhead) <= total + tol
            v = np.asarray(vals)
            mask = mask & ((v[None, :] + self._over[:, cols]) <= self._total[:, cols] + self._tol[:, cols]).all(axis=1)
        return mask

    def filter(
        self,
        options: Sequence[InstanceType],
        requirements: Requirements,
        requests: Dict[str, float],
    ) -> List[InstanceType]:
        cmask = self._compat_offering_mask(requirements)
        fmask = self._fit_mask(requests)
        index = self.index
        out: List[InstanceType] = []
        for it in options:
            i = index.get(id(it))
            if i is None:
                # unknown object (not from this catalog): exact predicates
                if type_is_compatible(it, requirements) and type_fits(it, requests) and type_has_offering(it, requirements):
                    out.append(it)
            elif cmask[i] and fmask[i]:
                out.append(it)
        return out

    def max_free(self, options: Sequence[InstanceType]) -> Dict[str, float]:
        """Elementwise max of (resources - overhead) over `options` — the
        could_fit() headroom vector, computed from the capacity matrix."""
        rows = [self.index[id(it)] for it in options if id(it) in self.index]
        if len(rows) != len(options):
            return _max_free_python(options)
        free = self._cap[rows].max(axis=0)
        return {k: float(free[j]) for k, j in self.kpos.items() if free[j] > 0.0}


_FILTER_CACHE_MEMO: Dict[tuple, CatalogFilterCache] = {}


def catalog_filter_cache(types: Sequence[InstanceType]) -> Optional[CatalogFilterCache]:
    """Memoized per instance-type OBJECT identity (the same discipline as
    ir/encode.py's catalog_key): providers hand out a fresh list copy per
    get_instance_types call while TTL-caching the items, so keying on the
    items is what makes repeated solves reuse the matrices and warmed compat
    masks instead of rebuilding per Scheduler. The entry pins the objects,
    so a live key's ids can never be recycled. Returns None (callers use the
    pure-Python path) when numpy is unavailable."""
    if np is None or not types:
        return None
    key = tuple(id(it) for it in types)
    entry = _FILTER_CACHE_MEMO.get(key)
    if entry is None:
        if len(_FILTER_CACHE_MEMO) >= 64:
            _FILTER_CACHE_MEMO.clear()
        # pin the keyed objects: if one were GC'd, a recycled id could alias
        # a different catalog onto a stale entry forever
        entry = (tuple(types), CatalogFilterCache(types))
        _FILTER_CACHE_MEMO[key] = entry
    return entry[1]


def _max_free_python(options: Sequence[InstanceType]) -> Dict[str, float]:
    free: Dict[str, float] = {}
    for it in options:
        caps = it.resources()
        over = it.overhead()
        for name, value in caps.items():
            avail = value - over.get(name, 0.0)
            if avail > free.get(name, 0.0):
                free[name] = avail
    return free


class VirtualNode:
    def __init__(
        self,
        template: NodeTemplate,
        topology: Topology,
        daemon_resources: Dict[str, float],
        instance_types: Sequence[InstanceType],
        filter_cache: Optional[CatalogFilterCache] = None,
    ):
        # copy template and pin a placeholder hostname so hostname-keyed
        # topologies see this node as a domain (node.go:46-53); stripped at
        # finalize_scheduling.
        hostname = f"hostname-placeholder-{next(_hostname_counter):04d}"
        topology.register(lbl.LABEL_HOSTNAME, hostname)
        self._hostname = hostname
        self.template = template.copy()
        self.template.requirements.add(Requirement(lbl.LABEL_HOSTNAME, OP_IN, hostname))
        self.topology = topology
        self.instance_type_options: List[InstanceType] = list(instance_types)
        self.pods: List[Pod] = []
        self.requests: Dict[str, float] = dict(daemon_resources or {})
        self.host_port_usage = HostPortUsage()
        self._max_free = None
        self._filter_cache = filter_cache

    @classmethod
    def open_prepared(
        cls,
        template: NodeTemplate,
        requirements: Requirements,
        topology: Topology,
        daemon_resources: Dict[str, float],
        instance_types: Sequence[InstanceType],
        register: bool = True,
        filter_cache: Optional[CatalogFilterCache] = None,
    ) -> "VirtualNode":
        """Fast constructor for the dense commit path (solver/dense.py):
        the caller supplies an already-validated Requirements set, so the
        template is rebuilt around it instead of deep-copied. Immutable
        template fields (labels, taints, kubelet config) are shared by
        reference — nothing mutates them after construction; `add` replaces
        `template.requirements` wholesale rather than editing in place.

        With register=False the placeholder hostname is NOT made visible to
        topology — the caller is building the node speculatively (under the
        device round trip) and must call register_hostname() before the node
        joins the schedule."""
        node = cls.__new__(cls)
        hostname = f"hostname-placeholder-{next(_hostname_counter):04d}"
        if register:
            topology.register(lbl.LABEL_HOSTNAME, hostname)
        node._hostname = hostname
        node.template = NodeTemplate(
            provisioner_name=template.provisioner_name,
            provider=template.provider,
            provider_ref=template.provider_ref,
            labels=template.labels,
            taints=template.taints,
            startup_taints=template.startup_taints,
            requirements=requirements,
            kubelet_configuration=template.kubelet_configuration,
            stamped_hash=template.stamped_hash,
        )
        requirements.add(Requirement(lbl.LABEL_HOSTNAME, OP_IN, hostname))
        node.topology = topology
        node.instance_type_options = list(instance_types)
        node.pods = []
        node.requests = dict(daemon_resources or {})
        node.host_port_usage = HostPortUsage()
        node._max_free = None
        node._filter_cache = filter_cache
        return node

    @property
    def requirements(self) -> Requirements:
        return self.template.requirements

    @property
    def provisioner_name(self) -> str:
        return self.template.provisioner_name

    def could_fit(self, pod_requests: Dict[str, float]) -> bool:
        """Conservative O(R) capacity prescreen for the scheduler's
        open-node scan: False means every surviving instance type would fail
        the resources check inside add(), so the expensive exact protocol
        (requirement algebra + exception) can be skipped. True guarantees
        nothing — add() remains the authority. The headroom vector is the
        elementwise max over surviving options and is invalidated by every
        successful add (options shrink, requests grow)."""
        free = self._max_free
        if free is None:
            if self._filter_cache is not None:
                free = self._filter_cache.max_free(self.instance_type_options)
            else:
                free = _max_free_python(self.instance_type_options)
            self._max_free = free
        for name, value in pod_requests.items():
            headroom = free.get(name, 0.0) - self.requests.get(name, 0.0)
            if value > headroom + max(1e-9, 1e-6 * abs(headroom)):
                return False
        return True

    def add(self, pod: Pod) -> None:
        """Try to place the pod; raises IncompatibleError without mutating on
        failure (node.go:64-109)."""
        err = self.template.taints.tolerates(pod)
        if err is not None:
            raise IncompatibleError(err)
        err = self.host_port_usage.validate(pod)
        if err is not None:
            raise IncompatibleError(err)

        node_requirements = Requirements(*self.requirements.values())
        pod_requirements = Requirements.from_pod(pod)

        err = node_requirements.compatible(pod_requirements)
        if err is not None:
            raise IncompatibleError(f"incompatible requirements, {err}")
        node_requirements.add(*pod_requirements.values())

        topology_requirements = self.topology.add_requirements(pod_requirements, node_requirements, pod)
        err = node_requirements.compatible(topology_requirements)
        if err is not None:
            raise IncompatibleError(err)
        node_requirements.add(*topology_requirements.values())

        requests = res.merge(self.requests, res.pod_requests(pod))
        if self._filter_cache is not None:
            instance_types = self._filter_cache.filter(self.instance_type_options, node_requirements, requests)
        else:
            instance_types = filter_instance_types(self.instance_type_options, node_requirements, requests)
        if not instance_types:
            raise IncompatibleError(
                f"no instance type satisfied resources {res.to_string(res.pod_requests(pod))} "
                f"and requirements {node_requirements!r}"
            )

        # commit
        self.pods.append(pod)
        self.instance_type_options = instance_types
        self.requests = requests
        self._max_free = None  # options shrank / requests grew: recompute lazily
        self.template.requirements = node_requirements
        self.topology.record(pod, node_requirements)
        self.host_port_usage.add(pod)

    def register_hostname(self) -> None:
        """Make the placeholder hostname visible to topology groups — the
        deferred half of open_prepared(register=False)."""
        self.topology.register(lbl.LABEL_HOSTNAME, self._hostname)

    def finalize_scheduling(self) -> None:
        """Strip the placeholder hostname before launch (node.go:113-117)."""
        self.template.requirements.delete(lbl.LABEL_HOSTNAME)

    def release(self) -> None:
        """Discard a probe node that never placed a pod: retract its
        placeholder hostname so topology domains don't accumulate phantoms
        across failed open-a-node attempts."""
        assert not self.pods, "release() is only valid for empty probe nodes"
        self.topology.unregister(lbl.LABEL_HOSTNAME, self._hostname)

    def __repr__(self) -> str:
        names = ", ".join(it.name() for it in self.instance_type_options[:5])
        return f"<VirtualNode {len(self.pods)} pods requesting {res.to_string(self.requests)} from types {names}>"


def filter_instance_types(
    instance_types: Sequence[InstanceType],
    requirements: Requirements,
    requests: Dict[str, float],
) -> List[InstanceType]:
    """Survivor filter: requirement-compatible ∧ resource-fit ∧ offering
    available in the allowed zone x capacity-type (node.go:139-161). This is
    the per-pod O(T) hot loop that the dense solver computes as one [P, T]
    feasibility mask on device (ops/feasibility.py)."""
    return [
        it
        for it in instance_types
        if type_is_compatible(it, requirements) and type_fits(it, requests) and type_has_offering(it, requirements)
    ]


# The three predicates are public: the dense encoder (ir/encode.py) applies
# them factored apart (compat per group, fit per bin) — one definition serves
# both the host loop and the dense path so their semantics cannot drift.


def type_is_compatible(it: InstanceType, requirements: Requirements) -> bool:
    return it.requirements().intersects(requirements) is None


def type_fits(it: InstanceType, requests: Dict[str, float]) -> bool:
    return res.fits(res.merge(requests, it.overhead()), it.resources())


def type_has_offering(it: InstanceType, requirements: Requirements) -> bool:
    for offering in it.offerings():
        if not offering.available:
            continue  # quarantined pool (unavailable-offerings cache): never selectable
        if (not requirements.has(lbl.LABEL_TOPOLOGY_ZONE) or requirements.get(lbl.LABEL_TOPOLOGY_ZONE).has(offering.zone)) and (
            not requirements.has(lbl.LABEL_CAPACITY_TYPE) or requirements.get(lbl.LABEL_CAPACITY_TYPE).has(offering.capacity_type)
        ):
            return True
    return False
