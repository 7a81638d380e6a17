"""Admission: defaulting + validation for Provisioner writes.

Equivalent of pkg/webhooks — in the in-memory API the admission chain runs
synchronously inside create/update instead of over an HTTPS webhook, with the
same two phases: defaulting first, then validation (rejection raises).
"""

from __future__ import annotations

from .api.provisioner import Provisioner, validate_provisioner
from .kube.cluster import KubeCluster


class AdmissionError(RuntimeError):
    pass


def default_provisioner(provisioner: Provisioner, cloud_provider=None) -> None:
    """Defaulting webhook: fill canonical defaults in place, then give the
    cloud provider its hook (the DefaultHook seam the reference's AWS
    provider registers, cloudprovider.go:119-120)."""
    spec = provisioner.spec
    if spec.weight is None:
        spec.weight = 0
    for taint in list(spec.taints) + list(spec.startup_taints):
        if not taint.effect:
            taint.effect = "NoSchedule"
    hook = getattr(cloud_provider, "default_provisioner", None)
    if hook is not None:
        hook(provisioner)


def validate_or_raise(provisioner: Provisioner, cloud_provider=None) -> None:
    errs = list(validate_provisioner(provisioner))
    hook = getattr(cloud_provider, "validate_provisioner", None)
    if hook is not None:
        errs.extend(hook(provisioner) or ())
    if errs:
        raise AdmissionError("; ".join(errs))


def register(kube: KubeCluster, cloud_provider=None) -> None:
    """Install the admission chain: Provisioner writes get defaulting then
    validation (core rule set + provider hooks); every other kind is offered
    to the provider's validate_object hook (how provider-owned CRs like the
    simulated NodeClass — the AWSNodeTemplate analog — get admission, same
    seam as the reference's AWSNodeTemplate webhook).

    Idempotent per cluster: a second register (a restarted Runtime over the
    same KubeCluster) swaps the provider in place instead of stacking
    another wrapper around the already-wrapped verbs."""
    if getattr(kube, "_admission_registered", False):
        kube._admission_provider = cloud_provider
        return
    kube._admission_registered = True
    kube._admission_provider = cloud_provider
    original_create, original_update = kube.create, kube.update

    def _admit(obj):
        provider = kube._admission_provider
        if isinstance(obj, Provisioner):
            default_provisioner(obj, provider)
            validate_or_raise(obj, provider)
            return
        hook = getattr(provider, "validate_object", None)
        if hook is not None:
            errs = hook(obj) or ()
            if errs:
                raise AdmissionError("; ".join(errs))

    def admitted_create(obj):
        _admit(obj)
        return original_create(obj)

    def admitted_update(obj):
        _admit(obj)
        return original_update(obj)

    kube.create = admitted_create  # type: ignore[method-assign]
    kube.update = admitted_update  # type: ignore[method-assign]
