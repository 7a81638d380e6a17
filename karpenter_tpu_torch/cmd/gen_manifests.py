"""Deployment manifest generator: the Helm-chart analog.

The reference ships charts/karpenter (Deployment, RBAC, webhooks, CRDs,
settings ConfigMaps, PDB, Service/ServiceMonitor). This framework's
deployment surface is generated from the SAME sources of truth the runtime
uses — `utils/options.py` for flags/ports, `config.py` for the
global-settings ConfigMap, the webhook server's port for admission wiring —
so the manifests cannot drift from the binaries.

    python -m karpenter_tpu_torch.cmd.gen_manifests > OUT/karpenter-tpu.yaml
    python -m karpenter_tpu_torch.cmd.gen_manifests --solver-sidecar --tpu-resource nvidia.com/gpu=1
    python -m karpenter_tpu_torch.cmd.gen_manifests --check DIR   # staleness gate

Renders plain YAML (kubectl-appliable); parameterization covers what the
chart's values.yaml exposes where it applies to this runtime.

The port's copy of karpenter_tpu/cmd/gen_manifests.py. Its containers run
the port's modules (karpenter_tpu_torch.cmd.webhook, .solver_service; the
controller container runs the image's entrypoint, as in the reference), the
controller container asks for one card (CONTROLLER_DEVICE: its solver and
the crossover it measures at boot run on cuda), the sidecar render asks for
the card's device resource (nvidia.com/gpu), and
`--check` takes the directory to compare with and has no default, so the
port's render is never held against, or written over, the JAX package's
deploy/ files.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

from ..config import CONFIGMAP_NAME, DEFAULT_CONFIGMAP_DATA
from ..utils.options import Options
from .webhook import ADMISSION_RULE, DEFAULT_WEBHOOK_PORT, MUTATING_NAME, VALIDATING_NAME

APP_LABELS = {"app.kubernetes.io/name": "karpenter-tpu", "app.kubernetes.io/instance": "karpenter-tpu"}
WEBHOOK_LABELS = {"app.kubernetes.io/name": "karpenter-tpu-webhook", "app.kubernetes.io/instance": "karpenter-tpu"}
SOLVER_SIDECAR_ADDR = "127.0.0.1:8433"
# the controller's solver, and the crossover it measures at boot, run on
# the card, so its container asks for one
CONTROLLER_DEVICE = ("nvidia.com/gpu", "1")


def _meta(name: str, namespace: Optional[str], labels: Dict[str, str]) -> Dict:
    meta = {"name": name, "labels": dict(labels)}
    if namespace is not None:
        meta["namespace"] = namespace
    return meta


def crd_provisioner() -> Dict:
    """karpenter.sh/v1alpha5 Provisioner — structural schema; the deep rule
    set (api/provisioner.py validate()) runs in the validating webhook, the
    same split the reference uses."""
    requirement = {
        "type": "object",
        "required": ["key", "operator"],
        "properties": {
            "key": {"type": "string"},
            "operator": {"type": "string", "enum": ["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"]},
            "values": {"type": "array", "items": {"type": "string"}},
        },
    }
    taint = {
        "type": "object",
        "required": ["key", "effect"],
        "properties": {
            "key": {"type": "string"},
            "value": {"type": "string"},
            "effect": {"type": "string", "enum": ["NoSchedule", "PreferNoSchedule", "NoExecute"]},
        },
    }
    spec_props = {
        "labels": {"type": "object", "additionalProperties": {"type": "string"}},
        "annotations": {"type": "object", "additionalProperties": {"type": "string"}},
        "taints": {"type": "array", "items": taint},
        "startupTaints": {"type": "array", "items": taint},
        "requirements": {"type": "array", "items": requirement},
        "kubeletConfiguration": {
            "type": "object",
            "properties": {
                "clusterDNS": {"type": "array", "items": {"type": "string"}},
                "maxPods": {"type": "integer", "minimum": 1},
                "podsPerCore": {"type": "integer", "minimum": 1},
                "systemReserved": {"type": "object", "additionalProperties": True},
                "kubeReserved": {"type": "object", "additionalProperties": True},
            },
        },
        "limits": {
            "type": "object",
            "properties": {"resources": {"type": "object", "additionalProperties": True}},
        },
        "provider": {"type": "object", "x-kubernetes-preserve-unknown-fields": True},
        "providerRef": {"type": "string"},
        "ttlSecondsAfterEmpty": {"type": "integer", "minimum": 0},
        "ttlSecondsUntilExpired": {"type": "integer", "minimum": 0},
        # [0, 100], matching the webhook's validate() (api/provisioner.py)
        "weight": {"type": "integer", "minimum": 0, "maximum": 100},
        "consolidation": {"type": "object", "properties": {"enabled": {"type": "boolean"}}},
        # voluntary-disruption budgets enforced by the disruption
        # orchestrator (controllers/disruption); the deep rule set — percent
        # syntax, schedule/duration pairing, zero-node windows — runs in the
        # validating webhook (api/provisioner.py validate_disruption)
        "disruption": {
            "type": "object",
            "properties": {
                "budgets": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["nodes"],
                        "properties": {
                            "nodes": {"type": "string"},
                            "schedule": {"type": "string"},
                            "duration": {"type": "number", "exclusiveMinimum": 0},
                        },
                    },
                },
            },
        },
    }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "provisioners.karpenter.sh"},
        "spec": {
            "group": "karpenter.sh",
            "names": {"kind": "Provisioner", "listKind": "ProvisionerList", "plural": "provisioners", "singular": "provisioner"},
            "scope": "Cluster",
            "versions": [
                {
                    "name": "v1alpha5",
                    "served": True,
                    "storage": True,
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "spec": {"type": "object", "properties": spec_props},
                                "status": {"type": "object", "x-kubernetes-preserve-unknown-fields": True},
                            },
                        }
                    },
                    "subresources": {"status": {}},
                }
            ],
        },
    }


def crd_nodeclass() -> Dict:
    """NodeClass — the provider-owned template CR (the AWSNodeTemplate
    analog; cloudprovider/simulated/provider.py NodeClass)."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "nodeclasses.karpenter.sh"},
        "spec": {
            "group": "karpenter.sh",
            "names": {"kind": "NodeClass", "listKind": "NodeClassList", "plural": "nodeclasses", "singular": "nodeclass"},
            "scope": "Cluster",
            "versions": [
                {
                    "name": "v1alpha1",
                    "served": True,
                    "storage": True,
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "spec": {
                                    "type": "object",
                                    "properties": {
                                        "imageFamily": {"type": "string"},
                                        "imageId": {"type": "string"},
                                        "userData": {"type": "string"},
                                        "subnetSelector": {"type": "object", "additionalProperties": {"type": "string"}},
                                        "securityGroupSelector": {"type": "object", "additionalProperties": {"type": "string"}},
                                        "securityGroupIds": {"type": "array", "items": {"type": "string"}},
                                        "tags": {"type": "object", "additionalProperties": {"type": "string"}},
                                        "includePreviousGeneration": {"type": "boolean"},
                                    },
                                }
                            },
                        }
                    },
                }
            ],
        },
    }


def rbac(namespace: str) -> List[Dict]:
    """Exactly what the runtime touches: watches + writes in kube/client.py
    and the controllers — no more."""
    cluster_rules = [
        # read: the watch set the state cache and scheduler consume
        {"apiGroups": ["karpenter.sh"], "resources": ["provisioners", "provisioners/status", "nodeclasses"], "verbs": ["get", "list", "watch"]},
        {"apiGroups": [""], "resources": ["pods", "nodes", "persistentvolumes", "persistentvolumeclaims"], "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["storage.k8s.io"], "resources": ["storageclasses", "csinodes"], "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["apps"], "resources": ["daemonsets"], "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["policy"], "resources": ["poddisruptionbudgets"], "verbs": ["get", "list", "watch"]},
        # write: node lifecycle + eviction + status
        {"apiGroups": ["karpenter.sh"], "resources": ["provisioners/status"], "verbs": ["create", "delete", "patch"]},
        {"apiGroups": [""], "resources": ["nodes"], "verbs": ["create", "patch", "update", "delete"]},
        {"apiGroups": [""], "resources": ["pods/eviction"], "verbs": ["create"]},
        {"apiGroups": [""], "resources": ["events"], "verbs": ["create", "patch"]},
        # the webhook patches its serving CA bundle into its own
        # registrations at startup (cmd/webhook.py register_configurations)
        {
            "apiGroups": ["admissionregistration.k8s.io"],
            "resources": ["mutatingwebhookconfigurations", "validatingwebhookconfigurations"],
            "verbs": ["get", "list", "watch", "create"],
        },
        {
            "apiGroups": ["admissionregistration.k8s.io"],
            "resources": ["mutatingwebhookconfigurations"],
            "verbs": ["update"],
            "resourceNames": [MUTATING_NAME],
        },
        {
            "apiGroups": ["admissionregistration.k8s.io"],
            "resources": ["validatingwebhookconfigurations"],
            "verbs": ["update"],
            "resourceNames": [VALIDATING_NAME],
        },
    ]
    namespace_rules = [
        # the karpenter-global-settings / logging ConfigMap watches (config.py)
        {"apiGroups": [""], "resources": ["configmaps"], "verbs": ["get", "list", "watch"]},
        # Lease leader election (kube/leaderelection.py)
        {"apiGroups": ["coordination.k8s.io"], "resources": ["leases"], "verbs": ["get", "list", "watch", "create", "update", "patch"]},
    ]
    return [
        {"apiVersion": "v1", "kind": "ServiceAccount", "metadata": _meta("karpenter-tpu", namespace, APP_LABELS)},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole", "metadata": _meta("karpenter-tpu", None, APP_LABELS), "rules": cluster_rules},
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": _meta("karpenter-tpu", None, APP_LABELS),
            "roleRef": {"apiGroup": "rbac.authorization.k8s.io", "kind": "ClusterRole", "name": "karpenter-tpu"},
            "subjects": [{"kind": "ServiceAccount", "name": "karpenter-tpu", "namespace": namespace}],
        },
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role", "metadata": _meta("karpenter-tpu", namespace, APP_LABELS), "rules": namespace_rules},
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": _meta("karpenter-tpu", namespace, APP_LABELS),
            "roleRef": {"apiGroup": "rbac.authorization.k8s.io", "kind": "Role", "name": "karpenter-tpu"},
            "subjects": [{"kind": "ServiceAccount", "name": "karpenter-tpu", "namespace": namespace}],
        },
    ]


def configmaps(namespace: str, interruption_queue: str = "") -> List[Dict]:
    data = dict(DEFAULT_CONFIGMAP_DATA)
    if interruption_queue:
        # settings parity with the reference's aws.interruptionQueueName:
        # recorded in the global-settings ConfigMap so operators see the
        # deployed queue name; the boot flag stays authoritative
        data["interruptionQueueName"] = interruption_queue
    return [
        {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": _meta(CONFIGMAP_NAME, namespace, APP_LABELS),
            "data": data,
        }
    ]


def controller_deployment(args) -> Dict:
    defaults = Options()
    container_args = [
        "--cluster-name", args.cluster_name,
        "--metrics-port", str(defaults.metrics_port),
        "--health-probe-port", str(defaults.health_probe_port),
    ]
    if args.solver_sidecar:
        container_args += ["--solver-service-address", SOLVER_SIDECAR_ADDR]
    # getattr: embedded callers build bare namespaces without the flag
    if getattr(args, "interruption_queue", ""):
        container_args += ["--interruption-queue", args.interruption_queue]
    containers = [
        {
            "name": "controller",
            "image": args.image,
            "args": container_args,
            "env": [
                {"name": "SYSTEM_NAMESPACE", "valueFrom": {"fieldRef": {"fieldPath": "metadata.namespace"}}},
            ],
            "ports": [
                {"name": "http-metrics", "containerPort": defaults.metrics_port, "protocol": "TCP"},
                {"name": "http", "containerPort": defaults.health_probe_port, "protocol": "TCP"},
            ],
            "livenessProbe": {"httpGet": {"path": "/healthz", "port": "http"}, "initialDelaySeconds": 30, "timeoutSeconds": 30},
            "readinessProbe": {"httpGet": {"path": "/readyz", "port": "http"}, "timeoutSeconds": 30},
            "resources": {
                "requests": {"cpu": "1", "memory": "1Gi", CONTROLLER_DEVICE[0]: CONTROLLER_DEVICE[1]},
                "limits": {"cpu": "1", "memory": "1Gi", CONTROLLER_DEVICE[0]: CONTROLLER_DEVICE[1]},
            },
        }
    ]
    if args.solver_sidecar:
        sidecar = {
            "name": "solver",
            "image": args.image,
            "command": ["python", "-m", "karpenter_tpu_torch.cmd.solver_service"],
            "args": ["--address", SOLVER_SIDECAR_ADDR],
            "resources": {"requests": {}, "limits": {}},
        }
        if args.tpu_resource:
            name, _, qty = args.tpu_resource.partition("=")
            sidecar["resources"]["requests"][name] = qty or "1"
            sidecar["resources"]["limits"][name] = qty or "1"
        containers.append(sidecar)
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": _meta("karpenter-tpu", args.namespace, APP_LABELS),
        "spec": {
            "replicas": args.replicas,
            "revisionHistoryLimit": 10,
            "strategy": {"rollingUpdate": {"maxUnavailable": 1}},
            "selector": {"matchLabels": dict(APP_LABELS)},
            "template": {
                "metadata": {"labels": dict(APP_LABELS)},
                "spec": {
                    "serviceAccountName": "karpenter-tpu",
                    "priorityClassName": "system-cluster-critical",
                    "dnsPolicy": "Default",
                    "containers": containers,
                    # never schedule onto capacity we manage (chart affinity)
                    "affinity": {
                        "nodeAffinity": {
                            "requiredDuringSchedulingIgnoredDuringExecution": {
                                "nodeSelectorTerms": [
                                    {"matchExpressions": [{"key": "karpenter.sh/provisioner-name", "operator": "DoesNotExist"}]}
                                ]
                            }
                        }
                    },
                    "tolerations": [{"key": "CriticalAddonsOnly", "operator": "Exists"}],
                },
            },
        },
    }


def webhook_bundle(args) -> List[Dict]:
    """Separate admission process (cmd/webhook.py) with self-managed serving
    certs (kube/certs.py): the Deployment, its Service, and the admission
    registrations. caBundle is patched at startup by the webhook process the
    same way knative's cert rotation does it."""
    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": _meta("karpenter-tpu-webhook", args.namespace, WEBHOOK_LABELS),
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": dict(WEBHOOK_LABELS)},
            "template": {
                "metadata": {"labels": dict(WEBHOOK_LABELS)},
                "spec": {
                    "serviceAccountName": "karpenter-tpu",
                    "containers": [
                        {
                            "name": "webhook",
                            "image": args.image,
                            "command": ["python", "-m", "karpenter_tpu_torch.cmd.webhook"],
                            "args": ["--host", "0.0.0.0", "--port", str(DEFAULT_WEBHOOK_PORT)],
                            "env": [
                                # the serving cert needs the Service DNS SANs
                                {"name": "SYSTEM_NAMESPACE", "valueFrom": {"fieldRef": {"fieldPath": "metadata.namespace"}}},
                            ],
                            "ports": [{"name": "https-webhook", "containerPort": DEFAULT_WEBHOOK_PORT, "protocol": "TCP"}],
                            "resources": {"requests": {"cpu": "200m", "memory": "256Mi"}},
                        }
                    ],
                },
            },
        },
    }
    service = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": _meta("karpenter-tpu-webhook", args.namespace, WEBHOOK_LABELS),
        "spec": {
            "type": "ClusterIP",
            "selector": dict(WEBHOOK_LABELS),
            "ports": [{"name": "https-webhook", "port": 443, "targetPort": "https-webhook", "protocol": "TCP"}],
        },
    }
    client_config = {"service": {"name": "karpenter-tpu-webhook", "namespace": args.namespace, "port": 443}}
    crd_rule = dict(ADMISSION_RULE)  # one rule definition, shared with the webhook's self-registration
    mutating = {
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": "MutatingWebhookConfiguration",
        "metadata": _meta(MUTATING_NAME, None, WEBHOOK_LABELS),
        "webhooks": [
            {
                "name": MUTATING_NAME,
                "admissionReviewVersions": ["v1"],
                "clientConfig": client_config,
                "rules": [crd_rule],
                "sideEffects": "None",
                "failurePolicy": "Fail",
            }
        ],
    }
    validating = {
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": "ValidatingWebhookConfiguration",
        "metadata": _meta(VALIDATING_NAME, None, WEBHOOK_LABELS),
        "webhooks": [
            {
                "name": VALIDATING_NAME,
                "admissionReviewVersions": ["v1"],
                "clientConfig": client_config,
                "rules": [crd_rule],
                "sideEffects": "None",
                "failurePolicy": "Fail",
            }
        ],
    }
    return [deployment, service, mutating, validating]


def stability(namespace: str, service_monitor: bool) -> List[Dict]:
    defaults = Options()
    out = [
        {
            "apiVersion": "policy/v1",
            "kind": "PodDisruptionBudget",
            "metadata": _meta("karpenter-tpu", namespace, APP_LABELS),
            "spec": {"maxUnavailable": 1, "selector": {"matchLabels": dict(APP_LABELS)}},
        },
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": _meta("karpenter-tpu", namespace, APP_LABELS),
            "spec": {
                "type": "ClusterIP",
                "selector": dict(APP_LABELS),
                "ports": [{"name": "http-metrics", "port": defaults.metrics_port, "targetPort": "http-metrics", "protocol": "TCP"}],
            },
        },
    ]
    if service_monitor:
        out.append(
            {
                "apiVersion": "monitoring.coreos.com/v1",
                "kind": "ServiceMonitor",
                "metadata": _meta("karpenter-tpu", namespace, APP_LABELS),
                "spec": {
                    "selector": {"matchLabels": dict(APP_LABELS)},
                    "endpoints": [{"port": "http-metrics"}],
                },
            }
        )
    return out


def render(args) -> List[Dict]:
    docs: List[Dict] = [
        {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": args.namespace, "labels": dict(APP_LABELS)}},
        crd_provisioner(),
        crd_nodeclass(),
    ]
    docs += rbac(args.namespace)
    docs += configmaps(args.namespace, interruption_queue=getattr(args, "interruption_queue", ""))
    docs.append(controller_deployment(args))
    docs += webhook_bundle(args)
    docs += stability(args.namespace, args.service_monitor)
    return docs


# the renders and the argv each is generated with — the source of truth
# for `--check`
CHECK_TARGETS = (
    ("karpenter-tpu.yaml", ()),
    ("karpenter-tpu-sidecar.yaml", ("--solver-sidecar", "--tpu-resource", "nvidia.com/gpu=1", "--service-monitor")),
)


def check(directory: str) -> int:
    """Exit-code staleness gate, symmetrical to gen_docs --check: re-render
    every manifest in `directory` and diff; 0 when current, 1 (with the stale
    paths and the regenerate command on stderr) when the generators moved —
    e.g. a CRD schema key like disruption.budgets was added without
    re-rendering."""
    import io
    import os
    from contextlib import redirect_stdout

    rc = 0
    for filename, argv in CHECK_TARGETS:
        path = os.path.join(directory, filename)
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(list(argv))
        if not os.path.exists(path):
            print(f"gen_manifests --check: {path} does not exist; regenerate it:", file=sys.stderr)
            rc = 1
        elif open(path, encoding="utf-8").read() != buf.getvalue():
            print(f"gen_manifests --check: {path} is stale against the generators; regenerate it:", file=sys.stderr)
            rc = 1
        else:
            continue
        print(f"  python -m karpenter_tpu_torch.cmd.gen_manifests {' '.join(argv)} > {path}", file=sys.stderr)
    return rc


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--check":
        if len(argv) < 2:
            print("gen_manifests --check: name the directory that holds the renders", file=sys.stderr)
            return 2
        return check(argv[1])
    parser = argparse.ArgumentParser(prog="karpenter-tpu-gen-manifests", description=__doc__)
    parser.add_argument("--namespace", default="karpenter")
    parser.add_argument("--image", default="karpenter-tpu:latest")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--cluster-name", default="cluster")
    parser.add_argument("--solver-sidecar", action="store_true", help="add the gRPC solver sidecar container")
    parser.add_argument("--tpu-resource", default="", help="device resource for the sidecar, e.g. nvidia.com/gpu=1")
    parser.add_argument("--service-monitor", action="store_true", help="emit a prometheus-operator ServiceMonitor")
    parser.add_argument(
        "--interruption-queue", dest="interruption_queue", default="",
        help="cloud interruption queue name: wires --interruption-queue into the controller args and the settings ConfigMap",
    )
    args = parser.parse_args(argv)

    import yaml

    sys.stdout.write(yaml.safe_dump_all(render(args), sort_keys=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
