"""Kubernetes wire codec: api.objects dataclasses <-> camelCase JSON.

The object model (api/objects.py) keeps Kubernetes field spelling in
snake_case, so the wire mapping is mechanical: snake_case <-> camelCase,
nested dataclasses recursed via type hints, `kind`/`apiVersion` stamped from
the registry. Timestamps travel as RFC3339 (fractional seconds preserved,
so fake-clock epochs round-trip); metadata.resourceVersion travels as a
string, as the real API server serves it.

This is the seam the reference gets from client-go's generated deepcopy/
codec stack (the ~3k generated LoC SURVEY.md §2.8 notes we compress): one
generic reflective codec instead of per-type generated marshallers.

The port's copy of karpenter_tpu/kube/codec.py. Its type hints resolve
against the port's own api modules, so every object decodes into the
port's classes.
"""

from __future__ import annotations

import dataclasses
import datetime
import typing
from typing import Any, Dict, Optional, Type

from ..api import objects as obj
from ..api.provisioner import Provisioner

# kind -> (apiVersion, plural, namespaced)
API_REGISTRY: Dict[str, tuple] = {
    "Pod": ("v1", "pods", True),
    "Node": ("v1", "nodes", False),
    "Namespace": ("v1", "namespaces", False),
    "ConfigMap": ("v1", "configmaps", True),
    "PersistentVolumeClaim": ("v1", "persistentvolumeclaims", True),
    "PersistentVolume": ("v1", "persistentvolumes", False),
    "PodDisruptionBudget": ("policy/v1", "poddisruptionbudgets", True),
    "StorageClass": ("storage.k8s.io/v1", "storageclasses", False),
    "CSINode": ("storage.k8s.io/v1", "csinodes", False),
    "DaemonSet": ("apps/v1", "daemonsets", True),
    "Lease": ("coordination.k8s.io/v1", "leases", True),
    "Provisioner": ("karpenter.sh/v1alpha5", "provisioners", False),
    "MutatingWebhookConfiguration": ("admissionregistration.k8s.io/v1", "mutatingwebhookconfigurations", False),
    "ValidatingWebhookConfiguration": ("admissionregistration.k8s.io/v1", "validatingwebhookconfigurations", False),
}

KIND_CLASSES: Dict[str, type] = {
    "Pod": obj.Pod,
    "Node": obj.Node,
    "Namespace": obj.Namespace,
    "ConfigMap": obj.ConfigMap,
    "PersistentVolumeClaim": obj.PersistentVolumeClaim,
    "PersistentVolume": obj.PersistentVolume,
    "PodDisruptionBudget": obj.PodDisruptionBudget,
    "StorageClass": obj.StorageClass,
    "CSINode": obj.CSINode,
    "DaemonSet": obj.DaemonSet,
    "Lease": obj.Lease,
    "Provisioner": Provisioner,
    "MutatingWebhookConfiguration": obj.MutatingWebhookConfiguration,
    "ValidatingWebhookConfiguration": obj.ValidatingWebhookConfiguration,
}


def snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part.title() for part in rest)


def camel_to_snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


_EPOCH = datetime.timezone.utc


def ts_to_wire(seconds: Optional[float]) -> Optional[str]:
    if seconds is None:
        return None
    return datetime.datetime.fromtimestamp(seconds, tz=_EPOCH).isoformat().replace("+00:00", "Z")


def ts_from_wire(value) -> Optional[float]:
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    return datetime.datetime.fromisoformat(value.replace("Z", "+00:00")).timestamp()


def _encode_value(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return _encode_dataclass(value)
    if isinstance(value, dict):
        return {k: _encode_value(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode_value(v) for v in value]
    return value


def _encode_dataclass(value: Any) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(value):
        v = getattr(value, f.name)
        if v is None:
            continue
        out[snake_to_camel(f.name)] = _encode_value(v)
    return out


def _meta_to_wire(meta: obj.ObjectMeta) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "name": meta.name,
        "namespace": meta.namespace,
        "uid": meta.uid,
        "resourceVersion": str(meta.resource_version),
        "creationTimestamp": ts_to_wire(meta.creation_timestamp),
    }
    if meta.labels:
        out["labels"] = dict(meta.labels)
    if meta.annotations:
        out["annotations"] = dict(meta.annotations)
    if meta.deletion_timestamp is not None:
        out["deletionTimestamp"] = ts_to_wire(meta.deletion_timestamp)
    if meta.finalizers:
        out["finalizers"] = list(meta.finalizers)
    if meta.owner_references:
        out["ownerReferences"] = [_encode_dataclass(r) for r in meta.owner_references]
    return out


def to_wire(o: Any) -> Dict[str, Any]:
    kind = o.kind
    api_version, _, _ = API_REGISTRY[kind]
    out: Dict[str, Any] = {"apiVersion": api_version, "kind": kind}
    for f in dataclasses.fields(o):
        v = getattr(o, f.name)
        if f.name == "metadata":
            out["metadata"] = _meta_to_wire(v)
        elif v is None:
            continue
        else:
            out[snake_to_camel(f.name)] = _encode_value(v)
    return out


_HINT_CACHE: Dict[type, Dict[str, Any]] = {}


def _type_hints(cls: type) -> Dict[str, Any]:
    hints = _HINT_CACHE.get(cls)
    if hints is None:
        from ..api import objects as objects_mod
        from ..api import provisioner as provisioner_mod

        ns = {**vars(objects_mod), **vars(provisioner_mod)}
        hints = typing.get_type_hints(cls, globalns=ns)
        _HINT_CACHE[cls] = hints
    return hints


def _decode_value(hint: Any, value: Any) -> Any:
    origin = typing.get_origin(hint)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if value is None:
            return None
        return _decode_value(args[0], value) if args else value
    if origin in (list, typing.List):
        (item_hint,) = typing.get_args(hint) or (Any,)
        return [_decode_value(item_hint, v) for v in (value or [])]
    if origin in (dict, typing.Dict):
        return dict(value or {})
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        return _decode_dataclass(hint, value or {})
    return value


def _decode_dataclass(cls: type, data: Dict[str, Any]) -> Any:
    hints = _type_hints(cls)
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        wire_key = snake_to_camel(f.name)
        if wire_key not in data:
            continue
        kwargs[f.name] = _decode_value(hints.get(f.name, Any), data[wire_key])
    return cls(**kwargs)


def _meta_from_wire(data: Dict[str, Any]) -> obj.ObjectMeta:
    return obj.ObjectMeta(
        name=data.get("name", ""),
        namespace=data.get("namespace", ""),
        labels=dict(data.get("labels") or {}),
        annotations=dict(data.get("annotations") or {}),
        uid=data.get("uid") or obj._next_uid(),
        creation_timestamp=ts_from_wire(data.get("creationTimestamp")) or 0.0,
        deletion_timestamp=ts_from_wire(data.get("deletionTimestamp")),
        finalizers=list(data.get("finalizers") or []),
        owner_references=[_decode_dataclass(obj.OwnerReference, r) for r in data.get("ownerReferences") or []],
        resource_version=int(data.get("resourceVersion") or 0),
    )


def from_wire(data: Dict[str, Any], kind: Optional[str] = None) -> Any:
    kind = kind or data.get("kind")
    cls: Type = KIND_CLASSES[kind]
    hints = _type_hints(cls)
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name == "metadata":
            kwargs["metadata"] = _meta_from_wire(data.get("metadata") or {})
            continue
        wire_key = snake_to_camel(f.name)
        if wire_key not in data:
            continue
        kwargs[f.name] = _decode_value(hints.get(f.name, Any), data[wire_key])
    return cls(**kwargs)


def rest_path(kind: str, namespace: str = "", name: str = "") -> str:
    """Canonical REST path for a kind: /api/v1/... for the core group,
    /apis/<group>/<version>/... otherwise (the client-go RESTMapper rule)."""
    api_version, plural, namespaced = API_REGISTRY[kind]
    root = f"/api/{api_version}" if "/" not in api_version else f"/apis/{api_version}"
    path = f"{root}/namespaces/{namespace}/{plural}" if namespaced and namespace else f"{root}/{plural}"
    if name:
        path += f"/{name}"
    return path
