"""Admission webhook process: the AdmissionReview protocol over HTTPS.

The reference runs admission as a SEPARATE deployment (cmd/webhook/main.go)
serving knative's defaulting + validation endpoints with rotated certs.
This is that shape for this framework: an HTTPS server speaking
admission.k8s.io/v1 AdmissionReview —

  POST /mutate    — defaulting: runs webhooks.default_provisioner (and the
                    provider's DefaultHook seam) and answers with an
                    RFC 6902 JSONPatch of what changed
  POST /validate  — validation: runs webhooks.validate_or_raise; a failure
                    answers allowed=false with the reason in status.message

The apiserver emulator (kube/apiserver.py) dispatches matching writes here
exactly like a real apiserver honoring a MutatingWebhookConfiguration /
ValidatingWebhookConfiguration pair, verifying the serving cert against the
CA bundle registered with the configuration (kube/certs.py).
"""

from __future__ import annotations

import base64
import json
import ssl
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ..logsetup import get_logger
from .certs import ServingCert, generate_serving_cert
from .codec import from_wire, to_wire

log = get_logger("webhook")


def json_patch(before: dict, after: dict, path: str = "") -> list:
    """Minimal RFC 6902 diff: add/replace/remove over nested dicts (list
    values replaced wholesale — admission patches don't need list surgery)."""
    ops = []
    if not isinstance(before, dict) or not isinstance(after, dict):
        if before != after:
            ops.append({"op": "replace", "path": path or "/", "value": after})
        return ops
    for key in before:
        escaped = key.replace("~", "~0").replace("/", "~1")
        if key not in after:
            ops.append({"op": "remove", "path": f"{path}/{escaped}"})
        elif isinstance(before[key], dict) and isinstance(after[key], dict):
            ops.extend(json_patch(before[key], after[key], f"{path}/{escaped}"))
        elif before[key] != after[key]:
            ops.append({"op": "replace", "path": f"{path}/{escaped}", "value": after[key]})
    for key in after:
        if key not in before:
            escaped = key.replace("~", "~0").replace("/", "~1")
            ops.append({"op": "add", "path": f"{path}/{escaped}", "value": after[key]})
    return ops


def apply_json_patch(doc: dict, ops: list) -> dict:
    out = json.loads(json.dumps(doc))
    for op in ops:
        parts = [p.replace("~1", "/").replace("~0", "~") for p in op["path"].split("/")[1:]]
        target = out
        for part in parts[:-1]:
            target = target.setdefault(part, {})
        leaf = parts[-1]
        if op["op"] == "remove":
            target.pop(leaf, None)
        else:
            target[leaf] = op["value"]
    return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "karpenter-tpu-webhook"

    def log_message(self, *args):
        pass

    def do_POST(self):
        length = int(self.headers.get("Content-Length") or 0)
        review = json.loads(self.rfile.read(length) or b"{}")
        request = review.get("request") or {}
        uid = request.get("uid", "")
        wire = request.get("object") or {}
        response = {"uid": uid, "allowed": True}
        try:
            obj = from_wire(wire)
            cloud_provider = self.server.cloud_provider  # type: ignore[attr-defined]
            if self.path == "/mutate":
                from .. import webhooks

                if wire.get("kind") == "Provisioner":
                    webhooks.default_provisioner(obj, cloud_provider)
                mutated = to_wire(obj)
                ops = json_patch(wire, mutated)
                if ops:
                    response["patchType"] = "JSONPatch"
                    response["patch"] = base64.b64encode(json.dumps(ops).encode()).decode()
            else:  # /validate
                from .. import webhooks

                if wire.get("kind") == "Provisioner":
                    webhooks.validate_or_raise(obj, cloud_provider)
                else:
                    hook = getattr(cloud_provider, "validate_object", None)
                    if hook is not None:
                        errs = hook(obj) or ()
                        if errs:
                            raise webhooks.AdmissionError("; ".join(errs))
        except Exception as exc:  # noqa: BLE001 - admission rejection path
            response = {"uid": uid, "allowed": False, "status": {"message": str(exc), "code": 400}}
        body = json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview", "response": response}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class AdmissionWebhookServer:
    """The webhook deployment: HTTPS AdmissionReview endpoint with
    self-managed serving certs (the knative cert-rotation analog)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        cloud_provider=None,
        cert: Optional[ServingCert] = None,
        extra_sans: Optional[List[str]] = None,
    ):
        # extra_sans carries the in-cluster Service DNS names — the names a
        # real apiserver dials for service-ref registrations — so the
        # self-managed cert verifies there too (cmd/webhook.py)
        self.cert = cert or generate_serving_cert(sans=[host, "localhost", *(extra_sans or [])])
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.cloud_provider = cloud_provider  # type: ignore[attr-defined]
        # serving TLS from the generated cert (ssl needs file paths)
        self._certfile = tempfile.NamedTemporaryFile(suffix=".pem", delete=False)
        self._certfile.write(self.cert.cert_pem + self.cert.key_pem)
        self._certfile.flush()
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self._certfile.name)
        self._httpd.socket = ctx.wrap_socket(self._httpd.socket, server_side=True)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"https://{host}:{port}"

    def start(self) -> "AdmissionWebhookServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1}, name="webhook-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        import os

        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        try:
            os.unlink(self._certfile.name)
        except OSError:
            pass
