"""Resource-list arithmetic.

Mirrors the semantics of the reference's pkg/utils/resources/resources.go
(Merge/Subtract/Fits/MaxResources/Cmp and pod request aggregation) over plain
``dict[str, float]`` resource lists in canonical units.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

ResourceList = Dict[str, float]

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
NVIDIA_GPU = "nvidia.com/gpu"
AMD_GPU = "amd.com/gpu"
AWS_NEURON = "aws.amazon.com/neuron"
AWS_POD_ENI = "vpc.amazonaws.com/pod-eni"


def merge(*resource_lists: Mapping[str, float]) -> ResourceList:
    """Element-wise sum over any number of resource lists."""
    out: ResourceList = {}
    for rl in resource_lists:
        if not rl:
            continue
        for name, value in rl.items():
            out[name] = out.get(name, 0.0) + value
    return out


def subtract(lhs: Mapping[str, float], rhs: Mapping[str, float]) -> ResourceList:
    """lhs - rhs over the union of keys (missing keys treated as zero)."""
    out: ResourceList = dict(lhs or {})
    for name, value in (rhs or {}).items():
        out[name] = out.get(name, 0.0) - value
    return out


def max_resources(*resource_lists: Mapping[str, float]) -> ResourceList:
    """Element-wise max over resource lists (used for pessimistic limit math)."""
    out: ResourceList = {}
    for rl in resource_lists:
        for name, value in (rl or {}).items():
            if name not in out or value > out[name]:
                out[name] = value
    return out


def tolerance(total):
    """Comparison tolerance for resource arithmetic: absolute for cpu-scale
    values plus relative for byte-scale values; effectively zero when the
    capacity itself is zero (a nonzero request for an absent resource never
    fits). Elementwise-safe: accepts floats or numpy arrays. Shared by
    fits(), the dense packer (pack_counts.py), and the commit audit
    (solver/dense.py) so their verdicts can never disagree."""
    if isinstance(total, (int, float)):
        return 1e-6 + 1e-9 * abs(total) if total > 0 else 1e-12
    import numpy as np

    return np.where(np.asarray(total) > 0, 1e-6 + 1e-9 * np.abs(total), 1e-12)


def fits(candidate: Mapping[str, float], total: Mapping[str, float]) -> bool:
    """True if candidate <= total for every resource named in candidate.

    Matches reference semantics (pkg/utils/resources/resources.go:Fits): a
    resource requested but absent from `total` only fits if the request is 0.
    """
    for name, value in (candidate or {}).items():
        limit = (total or {}).get(name, 0.0)
        if value > limit + tolerance(limit):
            return False
    return True


def cmp(lhs: float, rhs: float) -> int:
    if lhs < rhs:
        return -1
    if lhs > rhs:
        return 1
    return 0


def any_exceeds(lhs: Mapping[str, float], rhs: Mapping[str, float]) -> bool:
    """True if lhs[k] > rhs[k] for any key present in both (limit checks)."""
    for name, value in (lhs or {}).items():
        if name in (rhs or {}) and value > rhs[name] + 1e-9:
            return True
    return False


def is_zero(rl: Mapping[str, float]) -> bool:
    return all(abs(v) < 1e-12 for v in (rl or {}).values())


def clamp_negative_to_zero(rl: Mapping[str, float]) -> ResourceList:
    return {k: (0.0 if v < 0 else v) for k, v in (rl or {}).items()}


def requests_for_pods(*pods) -> ResourceList:
    """Aggregate effective requests over pods.

    Per-pod effective request = max(sum of container requests, max over init
    container requests) + 1 'pods' resource, following the reference's
    resources.RequestsForPods / Ceiling semantics.
    """
    out: ResourceList = {}
    for pod in pods:
        out = merge(out, pod_requests(pod))
    return out


def _effective_requests(container) -> ResourceList:
    """Per-resource, a missing request defaults to the limit — the apiserver's
    admission defaulting, which the scheduler must mirror for objects that
    never crossed a real apiserver (provisioning suite :326)."""
    return {**container.resources.limits, **container.resources.requests}


def pod_requests(pod) -> ResourceList:
    """Effective scheduling requests of a pod (containers + init peak +
    overhead + the implicit 1 pod). Memoized per (pod, resource_version) —
    the scheduler and the dense fill call this many times per pod per solve
    — so the returned mapping is SHARED and must be treated as immutable
    (every consumer merges/subtracts into fresh dicts)."""
    version = pod.metadata.resource_version
    cached = getattr(pod, "_podreq_cache", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    running: ResourceList = {}
    for container in pod.spec.containers:
        running = merge(running, _effective_requests(container))
    init_peak: ResourceList = {}
    for container in pod.spec.init_containers:
        init_peak = max_resources(init_peak, _effective_requests(container))
    out = max_resources(running, init_peak)
    out[PODS] = out.get(PODS, 0.0) + 1.0
    if pod.spec.overhead:
        out = merge(out, pod.spec.overhead)
    try:
        pod._podreq_cache = (version, out)
    except AttributeError:
        pass  # slotted/frozen pod objects skip the memo
    return out


def pod_limits(pod) -> ResourceList:
    running: ResourceList = {}
    for container in pod.spec.containers:
        running = merge(running, container.resources.limits)
    init_peak: ResourceList = {}
    for container in pod.spec.init_containers:
        init_peak = max_resources(init_peak, container.resources.limits)
    return max_resources(running, init_peak)


def to_string(rl: Mapping[str, float]) -> str:
    from .quantity import format_quantity

    return ", ".join(f"{k}: {format_quantity(v)}" for k, v in sorted((rl or {}).items()))
