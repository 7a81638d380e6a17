"""Dense problem IR: the pods x instance-types constraint matrices.

This is the bridge between the host object model and the TPU solver. The key
architectural split (vs. the reference's per-pod sequential filtering in
scheduling/node.go:139-161):

- **Label/taint/offering algebra runs on host, but only G times, not P times.**
  Pods are deduplicated by *constraint signature* (node selector, affinity
  terms, tolerations, spread constraints, labels); real batches collapse from
  10k pods to a handful of groups. Each group's instance-type compatibility
  row is computed with the *exact same host algebra* the FFD oracle uses —
  zero semantic drift between the dense path and the host path.

- **Everything P-scale ships to the device as dense matrices**: requests
  [P, R], capacities [T, R], prices [T], compat [G, T], offering masks
  [T, Z] / [T, C]. Resource fit, domain assignment, packing, and
  verification reductions are tensor programs (ops/, solver/).

Groups whose constraints the dense path can't express (multi-term affinity,
volume limits, host ports, inverse anti-affinity interference, ...) are
classified HOST and fall back to the exact sequential loop.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..api import labels as lbl
from ..api.objects import DO_NOT_SCHEDULE, OP_IN, Pod
from ..cloudprovider.types import InstanceType
from ..scheduling.nodetemplate import NodeTemplate
from ..scheduling.requirements import Requirements
from ..utils import resources as res

# Fixed resource axis. Extended resources beyond these fall back to host
# (rare); the axis is padded so compiled shapes stay stable.
RESOURCE_AXIS: Tuple[str, ...] = (
    res.CPU,
    res.MEMORY,
    res.PODS,
    res.EPHEMERAL_STORAGE,
    res.NVIDIA_GPU,
    res.AMD_GPU,
    res.AWS_NEURON,
    res.AWS_POD_ENI,
)
R = len(RESOURCE_AXIS)
_RESOURCE_INDEX = {name: i for i, name in enumerate(RESOURCE_AXIS)}

# A huge capacity stands in for "resource not limited by this type" when the
# type doesn't define the resource but also can't satisfy it — fit handles it
# by treating missing capacity as zero, same as resources.fits().


class GroupKind(enum.Enum):
    PLAIN = "plain"  # resource + label constraints only
    SPREAD = "spread"  # one DoNotSchedule spread over zone/hostname/capacity-type
    AFFINITY = "affinity"  # one required self-affinity over zone/hostname
    ANTI_HOST = "anti-host"  # hostname anti-affinity: dedicated nodes
    HOST = "host"  # not dense-expressible: exact host loop


SPREAD_KEYS = (lbl.LABEL_TOPOLOGY_ZONE, lbl.LABEL_HOSTNAME, lbl.LABEL_CAPACITY_TYPE)


@dataclass
class GroupInfo:
    kind: GroupKind
    pods: List[Pod] = field(default_factory=list)
    requirements: Optional[Requirements] = None  # pod-derived requirements
    template_index: int = -1
    # spread/affinity descriptor
    topology_key: str = ""
    max_skew: int = 1
    selector_signature: tuple = ()
    # dense row indices
    index: int = -1
    # subkey of constraint_signature that determines the compat row: node
    # selector + node-affinity terms + tolerations (what Requirements.from_pod
    # and Taints.tolerates read) — pod labels/namespace/spread terms group
    # pods but cannot change template/type compatibility
    compat_sig: tuple = ()


def resource_vector(rl: Dict[str, float]) -> Optional[np.ndarray]:
    """Project a resource list onto the fixed axis; None if it names a
    resource outside the axis (host fallback)."""
    vec = np.zeros((R,), dtype=np.float64)
    for name, value in (rl or {}).items():
        idx = _RESOURCE_INDEX.get(name)
        if idx is None:
            if value > 0:
                return None
            continue
        vec[idx] = value
    return vec


def _toleration_signature(pod: Pod) -> tuple:
    return tuple(sorted((t.key, t.operator, t.value, t.effect) for t in pod.spec.tolerations))


def _selector_signature(selector) -> tuple:
    if selector is None:
        return ()
    return (
        tuple(sorted(selector.match_labels.items())),
        tuple(sorted((e.key, e.operator, tuple(sorted(e.values))) for e in selector.match_expressions)),
    )


def constraint_signature(pod: Pod) -> tuple:
    """Everything that affects where a pod may go (and how it groups)."""
    spec = pod.spec
    # fast path: unconstrained pods (the common deployment shape) — avoid
    # walking container ports when no constraint machinery is present
    if (
        spec.affinity is None
        and not spec.topology_spread_constraints
        and not spec.node_selector
        and not spec.tolerations
        and not spec.volumes
        and not spec.init_containers
        and all(not p.host_port for c in spec.containers for p in c.ports)
    ):
        return (pod.namespace, tuple(sorted(pod.metadata.labels.items())), (), (), (), (), (), False)
    affinity_sig: tuple = ()
    if spec.affinity is not None:
        a = spec.affinity
        node_sig = ()
        if a.node_affinity is not None:
            node_sig = (
                tuple(
                    tuple(sorted((r.key, r.operator, tuple(sorted(r.values))) for r in term.match_expressions))
                    for term in a.node_affinity.required
                ),
                tuple(
                    (t.weight, tuple(sorted((r.key, r.operator, tuple(sorted(r.values))) for r in t.preference.match_expressions)))
                    for t in a.node_affinity.preferred
                ),
            )
        pod_aff_sig = ()
        if a.pod_affinity is not None:
            pod_aff_sig = (
                tuple((t.topology_key, _selector_signature(t.label_selector), tuple(sorted(t.namespaces))) for t in a.pod_affinity.required),
                tuple((wt.weight, wt.pod_affinity_term.topology_key, _selector_signature(wt.pod_affinity_term.label_selector)) for wt in a.pod_affinity.preferred),
            )
        anti_sig = ()
        if a.pod_anti_affinity is not None:
            anti_sig = (
                tuple((t.topology_key, _selector_signature(t.label_selector), tuple(sorted(t.namespaces))) for t in a.pod_anti_affinity.required),
                tuple((wt.weight, wt.pod_affinity_term.topology_key, _selector_signature(wt.pod_affinity_term.label_selector)) for wt in a.pod_anti_affinity.preferred),
            )
        affinity_sig = (node_sig, pod_aff_sig, anti_sig)
    spread_sig = tuple(
        (c.max_skew, c.topology_key, c.when_unsatisfiable, _selector_signature(c.label_selector))
        for c in spec.topology_spread_constraints
    )
    ports_sig = tuple(
        sorted(
            (p.host_ip, p.host_port, p.protocol)
            for c in list(spec.containers) + list(spec.init_containers)
            for p in c.ports
            if p.host_port
        )
    )
    return (
        pod.namespace,
        tuple(sorted(pod.metadata.labels.items())),
        tuple(sorted(spec.node_selector.items())),
        affinity_sig,
        spread_sig,
        _toleration_signature(pod),
        ports_sig,
        bool(spec.volumes),
    )


def classify_group(pod: Pod) -> Tuple[GroupKind, str, int, tuple]:
    """Decide whether this constraint shape is dense-expressible.

    Returns (kind, topology_key, max_skew, selector_signature).
    """
    spec = pod.spec
    # volumes and host ports need per-node stateful checks -> host
    if spec.volumes:
        return (GroupKind.HOST, "", 0, ())
    if any(p.host_port for c in list(spec.containers) + list(spec.init_containers) for p in c.ports):
        return (GroupKind.HOST, "", 0, ())

    spreads = spec.topology_spread_constraints
    a = spec.affinity
    has_node_pref = bool(a and a.node_affinity and a.node_affinity.preferred)
    multi_required_terms = bool(a and a.node_affinity and len(a.node_affinity.required) > 1)
    if has_node_pref or multi_required_terms:
        # relaxation ladder territory -> host
        return (GroupKind.HOST, "", 0, ())
    pod_aff = a.pod_affinity if a else None
    pod_anti = a.pod_anti_affinity if a else None
    n_constraints = (
        len(spreads)
        + (len(pod_aff.required) + len(pod_aff.preferred) if pod_aff else 0)
        + (len(pod_anti.required) + len(pod_anti.preferred) if pod_anti else 0)
    )
    if n_constraints == 0:
        return (GroupKind.PLAIN, "", 0, ())
    if n_constraints > 1:
        return (GroupKind.HOST, "", 0, ())

    if len(spreads) == 1:
        c = spreads[0]
        if c.when_unsatisfiable != DO_NOT_SCHEDULE:
            return (GroupKind.HOST, "", 0, ())  # ScheduleAnyway enters relaxation
        if c.topology_key not in SPREAD_KEYS:
            return (GroupKind.HOST, "", 0, ())
        # dense spread requires the constraint to select the pod itself
        # (the usual deployment shape); otherwise counting is cross-group
        if c.label_selector is None or not c.label_selector.matches(pod.metadata.labels):
            return (GroupKind.HOST, "", 0, ())
        return (GroupKind.SPREAD, c.topology_key, c.max_skew, _selector_signature(c.label_selector))

    if pod_aff and len(pod_aff.required) == 1 and not pod_aff.preferred and not pod_anti:
        term = pod_aff.required[0]
        if term.topology_key not in (lbl.LABEL_TOPOLOGY_ZONE, lbl.LABEL_HOSTNAME):
            return (GroupKind.HOST, "", 0, ())
        if term.namespace_selector is not None or term.namespaces:
            return (GroupKind.HOST, "", 0, ())
        # dense affinity requires self-selection (the pod is in its own
        # affinity cluster) so components close over the group
        if term.label_selector is None or not term.label_selector.matches(pod.metadata.labels):
            return (GroupKind.HOST, "", 0, ())
        return (GroupKind.AFFINITY, term.topology_key, 0, _selector_signature(term.label_selector))

    if pod_anti and len(pod_anti.required) == 1 and not pod_anti.preferred and not pod_aff:
        term = pod_anti.required[0]
        if term.topology_key != lbl.LABEL_HOSTNAME:
            # zonal anti-affinity blocks whole zones; keep exact host semantics
            return (GroupKind.HOST, "", 0, ())
        if term.namespace_selector is not None or term.namespaces:
            return (GroupKind.HOST, "", 0, ())
        if term.label_selector is None or not term.label_selector.matches(pod.metadata.labels):
            return (GroupKind.HOST, "", 0, ())
        return (GroupKind.ANTI_HOST, lbl.LABEL_HOSTNAME, 0, _selector_signature(term.label_selector))

    return (GroupKind.HOST, "", 0, ())


@dataclass
class DenseProblem:
    """The full dense encoding of one provisioning batch."""

    # axes
    resource_names: Tuple[str, ...]
    zones: List[str]
    capacity_types: List[str]
    # pods (dense-eligible, original order)
    pods: List[Pod]
    requests: np.ndarray  # [P, R] float64 (host math is exact; device casts to f32)
    group_ids: np.ndarray  # [P] int32
    groups: List[GroupInfo]  # G entries
    # instance types: the concatenation of each template's (weight-ordered)
    # provisioner universe — a type column belongs to exactly one template
    templates: List[NodeTemplate]
    instance_types: List[InstanceType]
    type_template: np.ndarray  # [T] int32: owning template index per column
    caps: np.ndarray  # [T, R] float64 (resources - system overhead, missing -> 0)
    prices: np.ndarray  # [T] float64
    avail: np.ndarray  # [T, Z, C] bool: available-offering cube (see CatalogEncoding.avail)
    compat: np.ndarray  # [G, T] bool (nonzero only inside the group's template segment)
    group_zone_allowed: np.ndarray  # [G, Z] bool
    group_ct_allowed: np.ndarray  # [G, C] bool
    daemon_overhead: np.ndarray  # [T, R] float64: daemonset overhead of each column's template
    # quarantined offerings in this catalog (CatalogEncoding.masked_offerings)
    masked_offerings: int = 0
    # pods that must take the exact host path
    host_pods: List[Pod] = field(default_factory=list)

    @property
    def P(self) -> int:
        return len(self.pods)

    @property
    def T(self) -> int:
        return len(self.instance_types)

    @property
    def G(self) -> int:
        return len(self.groups)

    def template_of_group(self, group: "GroupInfo") -> NodeTemplate:
        return self.templates[group.template_index]

    def shape_signature(self) -> Dict[str, int]:
        """The axis cardinalities that key the solver's compiled-shape
        universe — what the flight recorder (flight.py) attributes a
        recompile to when one of them changes between solves. Bucket and
        padded-dispatch dimensions are appended by the solver (they only
        exist after domain assignment / dispatch padding)."""
        return {
            "pods": self.P,
            "groups": self.G,
            "types": self.T,
            "zones": len(self.zones),
            "capacity_types": len(self.capacity_types),
            "resources": len(self.resource_names),
        }


@dataclass
class CatalogEncoding:
    """Per-catalog dense matrices, cacheable across solves.

    Everything here is a function of (templates, instance-type universe,
    topology domains) only — independent of the pod batch — so a long-lived
    solver reuses it for every solve against the same catalog (the
    incremental device-state idea from SURVEY.md §7 applied to the host-side
    encode). Contract: instance-type lists are immutable snapshots (the
    reference's GetInstanceTypes returns cached objects the same way); a
    provider that changes its universe must return a new list object.
    `compat_cache` memoizes per-constraint-shape compat rows keyed by
    GroupInfo.compat_sig; entries are (row [T] bool, template_index,
    zone_allowed [Z] bool, ct_allowed [C] bool), with template_index == -1
    marking shapes no template can host."""

    key: tuple
    # strong refs to the keyed instance-type lists: the cache key uses their
    # id()s, which must not be recycled while this entry is alive
    source_lists: tuple
    type_list: List[InstanceType]
    type_template_ids: List[int]
    segment_bounds: List[Tuple[int, int]]
    zone_list: List[str]
    ct_list: List[str]
    zone_index: Dict[str, int]
    ct_index: Dict[str, int]
    caps: np.ndarray  # [T, R]
    prices: np.ndarray  # [T]
    # the availability CUBE: avail[t, z, c] == an AVAILABLE offering of type
    # t exists in (zone z, capacity-type c). Strictly finer than a
    # per-axis type-zone x type-ct product (which would let a bucket pinned
    # to (zone, ct) pick a type offering that pair only across two
    # DIFFERENT offerings), and the carrier of offering-health: a pool
    # quarantined by the unavailable-offerings cache is simply a zero here,
    # so the device mask routes around it with no host loop (see
    # dense._device_solve).
    avail: np.ndarray  # [T, Z, C] bool
    # offerings present in the universe but flagged available=False (the
    # unavailable-offerings cache quarantine) — distinct from structural
    # zeros (a type simply not offered in a pool); nonzero means offering
    # health is actively constraining this catalog
    masked_offerings: int
    empty_fit: np.ndarray  # [T] bool: overhead alone fits the type
    compat_cache: Dict[tuple, tuple] = field(default_factory=dict)


@dataclass
class WarmViewEncoding:
    """Dense arrays over the existing-node views of one solve — the
    [views x resources] half of the vectorized warm fill (solver/warmfill.py).

    All capacity math is f64 and uses the exact expressions of the certified
    cohort fast paths (existingnode.py): avail_tol = available +
    resources.tolerance(available) per axis entry, so `avail_tol - requests`
    IS the `limit + tolerance(limit) - base` headroom of the closed-form
    count and `requests + size <= avail_tol` IS resources.fits on the
    merged request list. Views whose available/requests name a resource
    outside the fixed axis are marked unusable (same rule as the host
    fill's `usable` screen)."""

    usable: np.ndarray  # [V] bool
    avail_tol: np.ndarray  # [V, R] f64
    requests0: np.ndarray  # [V, R] f64
    head0: np.ndarray  # [V, R] f64 (avail_tol - requests0; -1 rows when unusable)
    zone: List[Optional[str]]  # per-view zone label (None when absent)
    ct: List[Optional[str]]  # per-view capacity-type label
    hostname: List[str]
    taint_sig: List[tuple]  # content signature of the view's scheduling taints
    # the incremental engine's resident [Vp, R] f32 headroom on the solver's
    # device and its row pad Vp (solver/incremental.py), where it produced
    # this encoding; rows [:V] equal f32(head0). Not part of the value.
    head_dev: Optional[object] = field(default=None, compare=False, repr=False)  # torch.Tensor
    head_vp: int = field(default=0, compare=False, repr=False)


def encode_warm_views(views: Sequence) -> WarmViewEncoding:
    """Encode existing-node views into the dense warm-fill arrays."""
    V = len(views)
    usable = np.zeros((V,), dtype=bool)
    avail = np.zeros((V, R), dtype=np.float64)
    requests0 = np.zeros((V, R), dtype=np.float64)
    zone: List[Optional[str]] = []
    ct: List[Optional[str]] = []
    hostname: List[str] = []
    taint_sig: List[tuple] = []
    for vi, view in enumerate(views):
        a = resource_vector(view.available)
        u = resource_vector(view.requests)
        if a is not None and u is not None:
            avail[vi] = a
            requests0[vi] = u
            usable[vi] = True
        labels = view.node.metadata.labels
        zone.append(labels.get(lbl.LABEL_TOPOLOGY_ZONE))
        ct.append(labels.get(lbl.LABEL_CAPACITY_TYPE))
        hostname.append(labels.get(lbl.LABEL_HOSTNAME) or view.node.name)
        taint_sig.append(tuple(sorted((t.key, t.value, t.effect) for t in view.taints)))
    # elementwise: limit + tolerance(limit), limit = 0.0 for axis resources
    # the view does not define (dict .get default) — one [V, R] pass, same
    # f64 expressions as the per-row loop (tolerance is elementwise)
    avail_tol = np.where(usable[:, None], avail + res.tolerance(avail), 0.0)
    requests0 = np.where(usable[:, None], requests0, 0.0)
    head0 = np.where(usable[:, None], avail_tol - requests0, -1.0)
    return WarmViewEncoding(
        usable=usable,
        avail_tol=avail_tol,
        requests0=requests0,
        head0=head0,
        zone=zone,
        ct=ct,
        hostname=hostname,
        taint_sig=taint_sig,
    )


def template_signature(template: NodeTemplate) -> tuple:
    """Content signature of the compat-relevant template fields (templates
    are rebuilt from provisioners every solve; identity is useless)."""
    reqs = tuple(
        sorted(
            (r.key, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than)
            for r in template.requirements.values()
        )
    )
    taints = tuple(sorted((t.key, t.value, t.effect) for t in template.taints))
    return (template.provisioner_name, taints, reqs)


def catalog_key(
    templates: Sequence[NodeTemplate],
    instance_types: Dict[str, Sequence[InstanceType]],
    zones: Optional[Sequence[str]] = None,
    capacity_types: Optional[Sequence[str]] = None,
) -> tuple:
    # keyed by the identity of the instance-type OBJECTS, not the list:
    # providers hand out a fresh list copy per get_instance_types call while
    # TTL-caching the items, so item identity is what's stable across solves.
    # Cache holders must pin the items (see catalog_pin) so a live entry's
    # ids can never be recycled onto different objects.
    return (
        tuple(template_signature(t) for t in templates),
        tuple(tuple(id(it) for it in instance_types.get(t.provisioner_name) or ()) for t in templates),
        tuple(sorted(zones or ())),
        tuple(sorted(capacity_types or ())),
    )


def catalog_pin(
    templates: Sequence[NodeTemplate], instance_types: Dict[str, Sequence[InstanceType]]
) -> tuple:
    """The object references a catalog_key's ids point at — stored alongside
    the cached encoding to keep them alive (id-reuse safety)."""
    return tuple(tuple(instance_types.get(t.provisioner_name) or ()) for t in templates)


def encode_catalog(
    templates: Sequence[NodeTemplate],
    instance_types: Dict[str, Sequence[InstanceType]],
    zones: Optional[Sequence[str]] = None,
    capacity_types: Optional[Sequence[str]] = None,
) -> CatalogEncoding:
    """Build the batch-independent half of the encoding (type matrices,
    offering masks, axes)."""
    templates = list(templates)
    type_list: List[InstanceType] = []
    type_template_ids: List[int] = []
    segment_bounds: List[Tuple[int, int]] = []  # [ti] -> (start, end) on the type axis
    for ti, template in enumerate(templates):
        segment_types = list(instance_types.get(template.provisioner_name, ()))
        start = len(type_list)
        type_list.extend(segment_types)
        type_template_ids.extend([ti] * len(segment_types))
        segment_bounds.append((start, len(type_list)))

    zone_set: Set[str] = set(zones or ())
    ct_set: Set[str] = set(capacity_types or ())
    for it in type_list:
        for offering in it.offerings():
            zone_set.add(offering.zone)
            ct_set.add(offering.capacity_type)
    zone_list = sorted(zone_set)
    ct_list = sorted(ct_set)
    zone_index = {z: i for i, z in enumerate(zone_list)}
    ct_index = {c: i for i, c in enumerate(ct_list)}

    T = len(type_list)
    caps = np.zeros((T, R), dtype=np.float64)
    prices = np.zeros((T,), dtype=np.float64)
    avail = np.zeros((T, len(zone_list), len(ct_list)), dtype=bool)
    masked_offerings = 0
    for t, it in enumerate(type_list):
        cap_vec = resource_vector(it.resources())
        over_vec = resource_vector(it.overhead())
        if cap_vec is None or over_vec is None:
            cap_vec = cap_vec if cap_vec is not None else np.zeros((R,), np.float64)
            over_vec = over_vec if over_vec is not None else np.zeros((R,), np.float64)
        caps[t] = np.maximum(cap_vec - over_vec, 0.0)
        prices[t] = it.price()
        for offering in it.offerings():
            # quarantined offerings (unavailable-offerings cache) stay in
            # the zone/ct axes (domains stable) but are zeros in the cube —
            # never a selectable (type, zone, ct) cell
            if getattr(offering, "available", True):
                avail[t, zone_index[offering.zone], ct_index[offering.capacity_type]] = True
            else:
                masked_offerings += 1
    empty_fit = np.array([res.fits(it.overhead(), it.resources()) for it in type_list], dtype=bool)
    return CatalogEncoding(
        key=catalog_key(templates, instance_types, zones, capacity_types),
        source_lists=tuple(instance_types.get(t.provisioner_name) for t in templates),
        type_list=type_list,
        type_template_ids=type_template_ids,
        segment_bounds=segment_bounds,
        zone_list=zone_list,
        ct_list=ct_list,
        zone_index=zone_index,
        ct_index=ct_index,
        caps=caps,
        prices=prices,
        avail=avail,
        masked_offerings=masked_offerings,
        empty_fit=empty_fit,
    )


def encode_problem(
    pods: Sequence[Pod],
    templates: Sequence[NodeTemplate],
    instance_types: Dict[str, Sequence[InstanceType]],
    daemon_overhead: Optional[Dict[str, Dict[str, float]]] = None,
    zones: Optional[Sequence[str]] = None,
    capacity_types: Optional[Sequence[str]] = None,
    catalog: Optional[CatalogEncoding] = None,
    catalog_key_hint: Optional[tuple] = None,
    cohort_label_keys: Optional[frozenset] = None,
) -> DenseProblem:
    """Encode a batch against the weight-ordered node templates.

    Each group binds to the FIRST template (weight order) it is compatible
    with and that offers at least one compatible instance type — the same
    first-workable-template rule the host loop applies when opening a fresh
    node (reference scheduler.go:207-232). The type axis is the concatenation
    of every template's instance-type universe; a group's compat row is zero
    outside its chosen template's segment, so the device argmin can never
    pick a cross-template type.

    `cohort_label_keys` (when given) is the set of label KEYS that any
    selector in play — batch pods' spread/affinity/anti selectors plus the
    scheduler topology's existing cohort selectors — could match. Pod labels
    outside this set cannot influence placement (no selector counts them),
    so they are dropped from the GROUPING key: identically-constrained
    cohorts that differ only in unmatched labels collapse into one group and
    pack as one FFD stream, the same cross-cohort node sharing the host
    loop's single global queue produces. The per-pod signature cache is
    unaffected (filtering happens on the cached value).
    """
    templates = list(templates)
    if catalog is None:
        catalog = encode_catalog(templates, instance_types, zones, capacity_types)
    else:
        # a stale catalog would silently bind groups to the wrong template's
        # type segment — fail loud instead. A caller that just looked the
        # catalog up under its key passes it as catalog_key_hint to avoid
        # recomputing template signatures on the hot path.
        expected = catalog_key_hint if catalog_key_hint is not None else catalog_key(templates, instance_types, zones, capacity_types)
        if catalog.key != expected:
            raise ValueError("CatalogEncoding does not match the supplied templates/instance_types/domains")
    type_list = catalog.type_list
    type_template_ids = catalog.type_template_ids
    segment_bounds = catalog.segment_bounds
    zone_list = catalog.zone_list
    ct_list = catalog.ct_list
    T = len(type_list)
    caps = catalog.caps
    prices = catalog.prices

    # daemonset overhead per type column = its template's overhead
    overhead_by_template: List[np.ndarray] = []
    for template in templates:
        vec = resource_vector((daemon_overhead or {}).get(template.provisioner_name, {}) or {})
        overhead_by_template.append(vec if vec is not None else np.zeros((R,), np.float64))
    overhead_t = (
        np.stack(overhead_by_template)[np.asarray(type_template_ids, dtype=np.int64)]
        if type_list
        else np.zeros((0, R), np.float64)
    )

    # -- group pods by constraint signature ---------------------------------
    groups: List[GroupInfo] = []
    group_by_sig: Dict[tuple, GroupInfo] = {}
    host_pods: List[Pod] = []
    dense_pods: List[Pod] = []
    dense_group_of_pod: List[int] = []
    request_rows: List[np.ndarray] = []

    for pod in pods:
        # per-pod encode cache: pods are immutable during scheduling
        # (relaxation returns fresh copies — preferences.py), so the signature
        # and request vector can live on the object across solves. This is
        # the incremental device-state idea from SURVEY.md §7: pending pods
        # that survive a batch re-encode for free on the next solve. The
        # cache is keyed on metadata.resource_version: live pods DO mutate
        # between solves (kube update events, e.g. a resized pod feeding a
        # consolidation simulation), and a stale request vector here would
        # silently mis-place the pod.
        version = pod.metadata.resource_version
        cached = getattr(pod, "_encode_cache", None)
        if cached is not None and cached[0] == version:
            _, sig, req_vec = cached
        else:
            req_vec = resource_vector(res.pod_requests(pod))
            sig = constraint_signature(pod) if req_vec is not None else None
            try:
                pod._encode_cache = (version, sig, req_vec)
            except AttributeError:
                pass  # slotted/frozen pod objects simply skip the cache
        if req_vec is None:
            host_pods.append(pod)
            continue
        if cohort_label_keys is not None and sig[1]:
            filtered = tuple(kv for kv in sig[1] if kv[0] in cohort_label_keys)
            if filtered != sig[1]:
                sig = (sig[0], filtered) + sig[2:]
        group = group_by_sig.get(sig)
        if group is None:
            kind, key, max_skew, sel_sig = classify_group(pod)
            group = GroupInfo(kind=kind, topology_key=key, max_skew=max_skew, selector_signature=sel_sig)
            if kind != GroupKind.HOST:
                group.requirements = Requirements.from_pod(pod)
                group.index = len(groups)
                # node_selector + node-affinity + tolerations slots of the
                # constraint signature (see GroupInfo.compat_sig)
                group.compat_sig = (sig[2], sig[3][0] if sig[3] else (), sig[5])
                groups.append(group)
            group_by_sig[sig] = group
        if group.kind == GroupKind.HOST:
            host_pods.append(pod)
            continue
        group.pods.append(pod)
        dense_pods.append(pod)
        dense_group_of_pod.append(group.index)
        request_rows.append(req_vec)

    G = len(groups)
    compat = np.zeros((G, T), dtype=bool)
    group_zone_allowed = np.ones((G, len(zone_list)), dtype=bool)
    group_ct_allowed = np.ones((G, len(ct_list)), dtype=bool)

    # -- per-group compatibility via the exact host algebra ------------------
    from ..scheduler.node import type_is_compatible, type_has_offering

    # overhead-fits-resources holds independently of the group (requests are
    # checked per bin later); precomputed once per catalog
    empty_fit = catalog.empty_fit
    if len(catalog.compat_cache) > 4096:  # unbounded user labels can't leak
        catalog.compat_cache.clear()
    for group in groups:
        cached_row = catalog.compat_cache.get(group.compat_sig)
        if cached_row is not None:
            row, ti, z_allow, c_allow = cached_row
            if ti < 0:
                group.kind = GroupKind.HOST
            else:
                compat[group.index] = row
                group.template_index = ti
                group_zone_allowed[group.index] = z_allow
                group_ct_allowed[group.index] = c_allow
            continue
        pod = group.pods[0]
        # first workable template in weight order (scheduler.go:207-232):
        # taints tolerated, requirements compatible, >=1 compatible type
        chosen = -1
        for ti, template in enumerate(templates):
            if template.taints.tolerates(pod) is not None:
                continue
            node_requirements = Requirements(*template.requirements.values())
            if node_requirements.compatible(group.requirements) is not None:
                continue
            node_requirements.add(*group.requirements.values())
            start, end = segment_bounds[ti]
            any_type = False
            for t in range(start, end):
                it = type_list[t]
                if empty_fit[t] and type_is_compatible(it, node_requirements) and type_has_offering(it, node_requirements):
                    compat[group.index, t] = True
                    any_type = True
            if not any_type:
                continue
            chosen = ti
            group.template_index = ti
            zone_req = node_requirements.get(lbl.LABEL_TOPOLOGY_ZONE)
            group_zone_allowed[group.index] = [zone_req.has(z) for z in zone_list]
            ct_req = node_requirements.get(lbl.LABEL_CAPACITY_TYPE)
            group_ct_allowed[group.index] = [ct_req.has(c) for c in ct_list]
            break
        if chosen < 0:
            # no template can open a node for this shape (compat row is
            # all-False): exact host loop owns the (identical) failure message
            group.kind = GroupKind.HOST
            catalog.compat_cache[group.compat_sig] = (None, -1, None, None)
        else:
            catalog.compat_cache[group.compat_sig] = (
                compat[group.index].copy(),
                chosen,
                group_zone_allowed[group.index].copy(),
                group_ct_allowed[group.index].copy(),
            )

    # groups demoted to HOST during compat: move their pods to host_pods
    if any(g.kind == GroupKind.HOST for g in groups):
        keep = [g for g in groups if g.kind != GroupKind.HOST]
        old_to_new = {}
        for new_index, g in enumerate(keep):
            old_to_new[g.index] = new_index
        new_dense_pods, new_group_ids, new_rows = [], [], []
        for pod, gid, row in zip(dense_pods, dense_group_of_pod, request_rows):
            if gid in old_to_new:
                new_dense_pods.append(pod)
                new_group_ids.append(old_to_new[gid])
                new_rows.append(row)
            else:
                host_pods.append(pod)
        compat = compat[[g.index for g in keep]] if keep else np.zeros((0, T), dtype=bool)
        group_zone_allowed = group_zone_allowed[[g.index for g in keep]] if keep else np.ones((0, len(zone_list)), bool)
        group_ct_allowed = group_ct_allowed[[g.index for g in keep]] if keep else np.ones((0, len(ct_list)), bool)
        for g in keep:
            g.index = old_to_new[g.index]
        groups = keep
        dense_pods, dense_group_of_pod, request_rows = new_dense_pods, new_group_ids, new_rows

    requests = np.stack(request_rows) if request_rows else np.zeros((0, R), np.float64)
    group_ids = np.asarray(dense_group_of_pod, dtype=np.int32)

    return DenseProblem(
        resource_names=RESOURCE_AXIS,
        zones=zone_list,
        capacity_types=ct_list,
        pods=dense_pods,
        requests=requests,
        group_ids=group_ids,
        groups=groups,
        templates=templates,
        instance_types=type_list,
        type_template=np.asarray(type_template_ids, dtype=np.int32),
        caps=caps,
        prices=prices,
        avail=catalog.avail,
        masked_offerings=catalog.masked_offerings,
        compat=compat,
        group_zone_allowed=group_zone_allowed,
        group_ct_allowed=group_ct_allowed,
        daemon_overhead=overhead_t,
        host_pods=host_pods,
    )
