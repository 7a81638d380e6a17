"""Launch-template resolution with caching + image families.

The LaunchTemplateProvider/amifamily analog (pkg/cloudprovider/aws/
launchtemplate.go + amifamily/ + amifamily/bootstrap/): per-(image family x
security groups x userdata) templates resolved lazily against the backend,
with image-family resolvers owning image discovery and the node bootstrap
payload. Families mirror the reference's resolver split
(amifamily/resolver.go:97-135 — AL2/Bottlerocket/Ubuntu/Custom):

- ``standard``  — shell bootstrap script with kubelet flags (the AL2/EKS
  bootstrap.sh shape, amifamily/bootstrap/eksbootstrap.go);
- ``minimal``   — declarative TOML settings payload (the Bottlerocket
  shape, amifamily/bootstrap/bottlerocket.go);
- ``gpu``       — standard plus device-plugin enablement, selected for
  accelerator-bearing templates;
- ``custom``    — user supplies the image id and a userdata template; the
  framework passes userdata through untouched (amifamily Custom semantics:
  no merging, the user owns the whole payload).
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .backend import CloudBackend, LaunchTemplate

DEFAULT_KUBE_VERSION = "1.29"


@dataclass
class KubeletArgs:
    """The slice of kubelet configuration the bootstrap payload carries
    (provisioner spec.kubeletConfiguration -> node registration args)."""

    cluster_dns: Sequence[str] = ()
    max_pods: Optional[int] = None
    system_reserved: Dict[str, float] = field(default_factory=dict)
    kube_reserved: Dict[str, float] = field(default_factory=dict)

    def flags(self) -> List[str]:
        out: List[str] = []
        if self.cluster_dns:
            out.append(f"--cluster-dns={','.join(self.cluster_dns)}")
        if self.max_pods is not None:
            out.append(f"--max-pods={self.max_pods}")
        if self.system_reserved:
            out.append("--system-reserved=" + ",".join(f"{k}={v}" for k, v in sorted(self.system_reserved.items())))
        if self.kube_reserved:
            out.append("--kube-reserved=" + ",".join(f"{k}={v}" for k, v in sorted(self.kube_reserved.items())))
        return out


def _taint_args(taints: Sequence[object]) -> str:
    return ",".join(f"{t.key}={t.value}:{t.effect}" for t in taints)


def _label_args(labels: Dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


@dataclass
class ImageFamily:
    """An image family resolves (kube version, architecture) -> image id and
    renders the bootstrap userdata."""

    name: str

    def image_id(self, architecture: str, kube_version: str = DEFAULT_KUBE_VERSION) -> str:
        # versioned image discovery: the SSM-parameter lookup analog
        # (amifamily ssm discovery) — deterministic per (family, arch, version)
        digest = hashlib.sha1(f"{self.name}/{architecture}/{kube_version}".encode()).hexdigest()[:12]
        return f"img-{self.name}-{digest}"

    def user_data(
        self,
        cluster_name: str,
        labels: Dict[str, str],
        taints: Sequence[object],
        kubelet: Optional["KubeletArgs"] = None,
        custom_user_data: Optional[str] = None,
    ) -> str:
        kubelet = kubelet or KubeletArgs()
        flags = " ".join(kubelet.flags())
        return (
            f"#!/bin/sh\nbootstrap --cluster {cluster_name!r} "
            f"--labels {_label_args(labels)!r} --taints {_taint_args(taints)!r} "
            f"--family {self.name}"
            + (f" {flags}" if flags else "")
            + "\n"
        )


@dataclass
class MinimalFamily(ImageFamily):
    """Declarative settings payload — the Bottlerocket shape: no shell, a
    TOML document the init system consumes."""

    def user_data(self, cluster_name, labels, taints, kubelet=None, custom_user_data=None) -> str:
        kubelet = kubelet or KubeletArgs()
        lines = ["[settings.kubernetes]", f'cluster-name = "{cluster_name}"']
        if kubelet.max_pods is not None:
            lines.append(f"max-pods = {kubelet.max_pods}")
        if kubelet.cluster_dns:
            lines.append(f'cluster-dns-ip = "{kubelet.cluster_dns[0]}"')
        if kubelet.system_reserved:
            lines.append("[settings.kubernetes.system-reserved]")
            lines.extend(f'"{k}" = "{v}"' for k, v in sorted(kubelet.system_reserved.items()))
        if kubelet.kube_reserved:
            lines.append("[settings.kubernetes.kube-reserved]")
            lines.extend(f'"{k}" = "{v}"' for k, v in sorted(kubelet.kube_reserved.items()))
        lines.append("[settings.kubernetes.node-labels]")
        lines.extend(f'"{k}" = "{v}"' for k, v in sorted(labels.items()))
        if taints:
            lines.append("[settings.kubernetes.node-taints]")
            lines.extend(f'"{t.key}" = "{t.value}:{t.effect}"' for t in taints)
        return "\n".join(lines) + "\n"


@dataclass
class GpuFamily(ImageFamily):
    """Standard bootstrap plus accelerator device-plugin enablement."""

    def user_data(self, cluster_name, labels, taints, kubelet=None, custom_user_data=None) -> str:
        base = ImageFamily.user_data(self, cluster_name, labels, taints, kubelet)
        return base + "enable-device-plugin --accelerators all\n"


@dataclass
class CustomFamily(ImageFamily):
    """User-owned image + userdata: passed through untouched (the Custom
    amifamily contract — no merging, no implicit bootstrap)."""

    def image_id(self, architecture: str, kube_version: str = DEFAULT_KUBE_VERSION) -> str:
        raise ValueError("custom image family requires an explicit imageId in the NodeClass")

    def user_data(self, cluster_name, labels, taints, kubelet=None, custom_user_data=None) -> str:
        return custom_user_data or ""


FAMILIES: Dict[str, ImageFamily] = {
    "standard": ImageFamily("standard"),
    "minimal": MinimalFamily("minimal"),
    "gpu": GpuFamily("gpu"),
    "custom": CustomFamily("custom"),
}


def get_image_family(name: Optional[str]) -> ImageFamily:
    return FAMILIES.get(name or "standard", FAMILIES["standard"])


class LaunchTemplateProvider:
    # cached entries re-ensure against the cloud after this long, healing a
    # PARTIALLY out-of-sync cache (one arch's template deleted externally)
    # the way the reference's TTL'd describe + NotFound-recreate does
    # (launchtemplate.go cache TTL); the all-stale case recovers immediately
    # through the fleet error path (provider.py create)
    CACHE_TTL_SECONDS = 600.0

    def __init__(self, backend: CloudBackend, cluster_name: str = "cluster", clock=None):
        from ...utils.clock import Clock

        self.backend = backend
        self.cluster_name = cluster_name
        self.clock = clock or getattr(backend, "clock", None) or Clock()
        self._lock = threading.Lock()
        self._cache: Dict[str, Tuple[LaunchTemplate, float]] = {}  # name -> (template, cached_at)

    def resolve(
        self,
        image_family: Optional[str],
        architecture: str,
        security_group_ids: Sequence[str],
        labels: Dict[str, str],
        taints: Sequence[object],
        kubelet: Optional[KubeletArgs] = None,
        image_id: Optional[str] = None,
        custom_user_data: Optional[str] = None,
    ) -> LaunchTemplate:
        family = get_image_family(image_family)
        image = image_id or family.image_id(architecture)
        user_data = family.user_data(self.cluster_name, labels, taints, kubelet, custom_user_data)
        key_digest = hashlib.sha1(
            "|".join([image, ",".join(sorted(security_group_ids)), user_data]).encode()
        ).hexdigest()[:16]
        name = f"karpenter-tpu-{key_digest}"
        now = self.clock.now()
        with self._lock:
            cached = self._cache.get(name)
            if cached is not None and now - cached[1] < self.CACHE_TTL_SECONDS:
                return cached[0]
        template = self.backend.ensure_launch_template(name, image, security_group_ids, user_data)
        with self._lock:
            self._cache[name] = (template, now)
        return template

    def invalidate(self, name: str) -> None:
        with self._lock:
            self._cache.pop(name, None)
        self.backend.delete_launch_template(name)

    def clear_cache(self) -> None:
        """Drop every cached entry so the next resolve re-ensures against the
        cloud — the recovery step when the cache went out of sync with an
        external deletion (launchtemplate_test.go:138-160)."""
        with self._lock:
            self._cache.clear()
