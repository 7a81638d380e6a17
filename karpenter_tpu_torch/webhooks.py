"""Admission: defaulting + validation for Provisioner writes.

Equivalent of pkg/webhooks — in the in-memory API the admission chain runs
synchronously inside create/update instead of over an HTTPS webhook, with the
same two phases: defaulting first, then validation (rejection raises).

The port's copy of karpenter_tpu/webhooks.py. The chain also admits the
writes of the port's retry_on_conflict: its edit is admitted on each attempt
before the write. A write to the status subresource
(`retry_on_conflict(..., status_only=True)`) is not admitted: it lands
no spec, and an apiserver's webhook rule for a resource does not match its
status. So the counter controller's status write leaves a Provisioner that
another client wrote with no admission as it was written, where the
reference's full update defaults it (and drifts every node launched from
it before).
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
    original_retry_on_conflict = kube.retry_on_conflict

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

    def admitted_retry_on_conflict(kind, name, namespace, mutate, **kwargs):
        if kwargs.get("status_only"):
            return original_retry_on_conflict(kind, name, namespace, mutate, **kwargs)

        def admitted(obj) -> bool:
            if not mutate(obj):
                return False
            _admit(obj)
            return True

        return original_retry_on_conflict(kind, name, namespace, admitted, **kwargs)

    kube.retry_on_conflict = admitted_retry_on_conflict  # type: ignore[method-assign]
