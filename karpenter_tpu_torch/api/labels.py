"""Label taxonomy: well-known, restricted, and normalized labels.

Mirrors the reference's pkg/apis/provisioning/v1alpha5/labels.go:25-122 label
rules: a small set of well-known node labels the scheduler understands natively
(open-world if undefined), restricted domains users may not set, and
normalization of deprecated beta labels onto their stable equivalents.
"""

from __future__ import annotations

from typing import List

# Kubernetes stable labels
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_TOPOLOGY_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_ARCH = "kubernetes.io/arch"
LABEL_OS = "kubernetes.io/os"

# Framework-specific domain and labels (karpenter.sh analog)
GROUP = "karpenter.sh"
PROVISIONER_NAME_LABEL = GROUP + "/provisioner-name"
LABEL_CAPACITY_TYPE = GROUP + "/capacity-type"
LABEL_NODE_INITIALIZED = GROUP + "/initialized"
DO_NOT_EVICT_ANNOTATION = GROUP + "/do-not-evict"
# the modern spelling of the eviction veto; the legacy do-not-evict spelling
# stays honored everywhere the new one is (utils/pod.py has_do_not_disrupt)
DO_NOT_DISRUPT_ANNOTATION = GROUP + "/do-not-disrupt"
DO_NOT_CONSOLIDATE_ANNOTATION = GROUP + "/do-not-consolidate"
EMPTINESS_TIMESTAMP_ANNOTATION = GROUP + "/emptiness-timestamp"
# spec-hash of the launch template the node was created from (stamped by the
# provider at launch); mismatch against the current Provisioner flags drift
PROVISIONER_HASH_ANNOTATION = GROUP + "/provisioner-hash"
# set by the disruption controller's drift method when the recorded hash no
# longer matches the Provisioner + launch template
DRIFTED_ANNOTATION = GROUP + "/drifted"
# durable crash-consistency markers (the disruption ledger is in-memory, so
# a restarted controller reconstructs it from these):
#  - disrupting: stamped (value = the disruption method) on a candidate the
#    moment its budget charge lands, cleared when the command unwinds; a node
#    carrying it WITH a deletion timestamp is mid-voluntary-drain and must be
#    re-charged on restart, WITHOUT one it was stranded pre-drain by a crash
#    and must be released (uncordoned + cleared)
#  - replacement-for: stamped on replacement nodes at launch (value = the
#    comma-joined candidate names); on restart an uninitialized replacement
#    whose candidates still exist is reaped (its command died with the old
#    process), one whose candidates are gone is adopted
DISRUPTING_ANNOTATION = GROUP + "/disrupting"
REPLACEMENT_FOR_ANNOTATION = GROUP + "/replacement-for"
TERMINATION_FINALIZER = GROUP + "/termination"

# Node lifecycle taints (mirrors k8s well-known taints)
TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"
# applied by the interruption controller on an interruption notice; paired
# with spec.unschedulable so drains and the scheduler both see the cordon
TAINT_INTERRUPTION = GROUP + "/interruption"

ARCHITECTURE_AMD64 = "amd64"
ARCHITECTURE_ARM64 = "arm64"
OS_LINUX = "linux"

CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

RESTRICTED_LABEL_DOMAINS = {"kubernetes.io", "k8s.io", GROUP}
LABEL_DOMAIN_EXCEPTIONS = {"kops.k8s.io", "node.kubernetes.io"}

# WellKnownLabels is deliberately mutable: providers register their own
# well-known labels (the fake provider registers size/special/integer the same
# way the reference's fake does in pkg/cloudprovider/fake/instancetype.go:41).
WELL_KNOWN_LABELS = {
    PROVISIONER_NAME_LABEL,
    LABEL_TOPOLOGY_ZONE,
    LABEL_TOPOLOGY_REGION,
    LABEL_INSTANCE_TYPE,
    LABEL_ARCH,
    LABEL_OS,
    LABEL_CAPACITY_TYPE,
}

RESTRICTED_LABELS = {EMPTINESS_TIMESTAMP_ANNOTATION, LABEL_HOSTNAME}

NORMALIZED_LABELS = {
    "failure-domain.beta.kubernetes.io/zone": LABEL_TOPOLOGY_ZONE,
    "failure-domain.beta.kubernetes.io/region": LABEL_TOPOLOGY_REGION,
    "beta.kubernetes.io/arch": LABEL_ARCH,
    "beta.kubernetes.io/os": LABEL_OS,
    "beta.kubernetes.io/instance-type": LABEL_INSTANCE_TYPE,
}


def normalize_label(key: str) -> str:
    return NORMALIZED_LABELS.get(key, key)


def label_domain(key: str) -> str:
    if "/" in key:
        return key.split("/", 1)[0]
    return ""


def is_restricted_node_label(key: str) -> bool:
    """True if the framework must not inject this label onto nodes."""
    if key in WELL_KNOWN_LABELS:
        return True
    domain = label_domain(key)
    if domain in LABEL_DOMAIN_EXCEPTIONS:
        return False
    for restricted in RESTRICTED_LABEL_DOMAINS:
        if domain == restricted or domain.endswith("." + restricted):
            return True
    return key in RESTRICTED_LABELS


def is_restricted_label(key: str) -> bool:
    """True if users may not set this label on provisioners/pods."""
    if key in WELL_KNOWN_LABELS:
        return False
    return is_restricted_node_label(key)


# -- label syntax validation (k8s.io/apimachinery util/validation) -----------

import re as _re

_NAME_RE = _re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")
_DNS1123_SUBDOMAIN_RE = _re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$")


def qualified_name_errors(key: str) -> List[str]:
    """validation.IsQualifiedName: optional DNS-subdomain prefix + '/' + name
    of <=63 alphanumeric/-_. characters."""
    errs: List[str] = []
    if not key:
        return ["name part must be non-empty"]
    parts = key.split("/")
    if len(parts) > 2:
        return [f"a qualified name must have at most one '/': {key!r}"]
    if len(parts) == 2:
        prefix, name = parts
        if not prefix:
            errs.append(f"prefix part of {key!r} must be non-empty")
        elif len(prefix) > 253 or not _DNS1123_SUBDOMAIN_RE.match(prefix):
            errs.append(f"prefix part of {key!r} must be a valid DNS subdomain")
    else:
        name = parts[0]
    if not name:
        errs.append(f"name part of {key!r} must be non-empty")
    elif len(name) > 63:
        errs.append(f"name part of {key!r} must be 63 characters or less")
    elif not _NAME_RE.match(name):
        errs.append(
            f"name part of {key!r} must consist of alphanumeric characters, '-', '_' or '.', "
            "starting and ending alphanumeric"
        )
    return errs


def label_value_errors(value: str) -> List[str]:
    """validation.IsValidLabelValue: empty OK, else <=63 chars of the
    qualified-name character class."""
    if not value:
        return []
    if len(value) > 63:
        return [f"label value {value!r} must be 63 characters or less"]
    if not _NAME_RE.match(value):
        return [
            f"label value {value!r} must consist of alphanumeric characters, '-', '_' or '.', "
            "starting and ending alphanumeric"
        ]
    return []


def dns1123_name_errors(name: str) -> List[str]:
    """Object-name validation (apis.ValidateObjectMetadata analog)."""
    if not name:
        return ["name is required"]
    if len(name) > 253 or not _DNS1123_SUBDOMAIN_RE.match(name):
        return [f"name {name!r} must be a lowercase DNS subdomain"]
    return []
