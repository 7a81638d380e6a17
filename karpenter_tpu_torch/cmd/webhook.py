"""Admission webhook entry point (cmd/webhook/main.go analog).

    python -m karpenter_tpu_torch.cmd.webhook --port 8443 [--apiserver-url URL]

Serves the AdmissionReview protocol over HTTPS with self-managed serving
certs (the knative cert-rotation analog, kube/certs.py). With
--apiserver-url (or $KUBERNETES_APISERVER_URL), it upserts its own
Mutating/Validating WebhookConfiguration objects at startup — patching the
serving CA bundle (and, when no service ref resolves, its direct URL) into
the registrations the way knative's cert controller does. kubectl-applied
configurations from deploy/ are completed in place; absent ones are created.

The port's copy of karpenter_tpu/cmd/webhook.py. It does no device work.
"""

from __future__ import annotations

import argparse
import base64
import os
import signal
import sys
import threading

DEFAULT_WEBHOOK_PORT = 8443
WEBHOOK_SERVICE_NAME = "karpenter-tpu-webhook"
MUTATING_NAME = "defaulting.webhook.karpenter-tpu.sh"
VALIDATING_NAME = "validation.webhook.karpenter-tpu.sh"


def service_dns_sans(namespace: str) -> list:
    """The names a real apiserver dials for a service-ref registration."""
    return [
        WEBHOOK_SERVICE_NAME,
        f"{WEBHOOK_SERVICE_NAME}.{namespace}",
        f"{WEBHOOK_SERVICE_NAME}.{namespace}.svc",
        f"{WEBHOOK_SERVICE_NAME}.{namespace}.svc.cluster.local",
    ]
ADMISSION_RULE = {
    "apiGroups": ["karpenter.sh"],
    "apiVersions": ["v1alpha5", "v1alpha1"],
    "operations": ["CREATE", "UPDATE"],
    "resources": ["provisioners", "nodeclasses"],
}


def register_configurations(client, server_url: str, ca_pem: bytes, advertise_url: str = "", namespace: str = "") -> None:
    """Upsert the admission registrations with this server's CA bundle.

    A configuration that carries a service ref keeps it (in-cluster routing)
    and only gains the caBundle; one without gets the direct URL. When
    CREATING absent configurations in-cluster (namespace known), the service
    ref is minted — never the bind address, which an apiserver can't dial."""
    from ..api.objects import MutatingWebhookConfiguration, ObjectMeta, ValidatingWebhookConfiguration
    from ..kube.client import ApiStatusError, Conflict

    bundle = base64.b64encode(ca_pem).decode()
    url = advertise_url or server_url

    for cls, name, path in (
        (MutatingWebhookConfiguration, MUTATING_NAME, "/mutate"),
        (ValidatingWebhookConfiguration, VALIDATING_NAME, "/validate"),
    ):
        current = client.get(cls.kind, name, namespace="")
        if current is None:
            if namespace:
                client_config = {
                    "service": {"name": WEBHOOK_SERVICE_NAME, "namespace": namespace, "port": 443},
                    "caBundle": bundle,
                }
            else:
                client_config = {"url": url + path, "caBundle": bundle}
            cfg = cls(
                metadata=ObjectMeta(name=name, namespace=""),
                webhooks=[
                    {
                        "name": name,
                        "admissionReviewVersions": ["v1"],
                        "clientConfig": client_config,
                        "rules": [dict(ADMISSION_RULE)],
                        "sideEffects": "None",
                        "failurePolicy": "Fail",
                    }
                ],
            )
            try:
                client.create(cfg)
                continue
            except Conflict:
                pass  # lost the create race: fall through to the update path
            except ApiStatusError as err:
                if err.code != 409:
                    raise  # a real failure must not be reported as success
            current = client.get(cls.kind, name, namespace="")
            if current is None:
                raise RuntimeError(f"webhook configuration {name} vanished during registration")
        for hook in current.webhooks:
            cc = hook.setdefault("clientConfig", {})
            cc["caBundle"] = bundle
            if not cc.get("service"):
                cc["url"] = url + path
        client.update(current)


def main(argv=None) -> int:
    from ..cloudprovider.fake import FakeCloudProvider
    from ..kube.webhookserver import AdmissionWebhookServer
    from ..logsetup import configure

    parser = argparse.ArgumentParser(prog="karpenter-tpu-webhook")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=DEFAULT_WEBHOOK_PORT)
    parser.add_argument("--log-level", default="info")
    parser.add_argument(
        "--apiserver-url",
        default=os.environ.get("KUBERNETES_APISERVER_URL", ""),
        help="upsert the WebhookConfiguration objects (caBundle + url) against this apiserver",
    )
    parser.add_argument(
        "--advertise-url", default="", help="external URL the apiserver should dial (default: the serving address)"
    )
    args = parser.parse_args(argv)
    configure(args.log_level)

    # in-cluster, the apiserver dials the Service DNS name: the serving cert
    # must carry those SANs ($SYSTEM_NAMESPACE is injected by the generated
    # Deployment)
    namespace = os.environ.get("SYSTEM_NAMESPACE", "")
    server = AdmissionWebhookServer(
        host=args.host,
        port=args.port,
        cloud_provider=FakeCloudProvider(),
        extra_sans=service_dns_sans(namespace) if namespace else None,
    )
    server.start()
    # the same backend selection as the controller: explicit URL, else the
    # in-cluster serviceaccount credential set
    from ..utils.options import Options
    from .controller import build_kube_backend

    client, url = build_kube_backend(Options(apiserver_url=args.apiserver_url))
    if url:
        register_configurations(client, server.url, server.cert.ca_pem, args.advertise_url, namespace=namespace)
        print(f"karpenter-tpu webhook registered configurations at {url}", file=sys.stderr)
    print(f"karpenter-tpu webhook serving AdmissionReview at {server.url} (CA bundle on stdout below)", file=sys.stderr)
    print(server.cert.ca_pem.decode(), flush=True)  # parents read this via a block-buffered pipe

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
