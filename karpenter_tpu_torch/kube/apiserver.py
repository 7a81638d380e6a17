"""An in-process Kubernetes API server speaking the real wire protocol.

The reference develops against envtest — a real kube-apiserver with no
kubelets (SURVEY.md §4). This module is that tier for environments with no
apiserver binary: a threaded HTTP server implementing the protocol surface
the framework's client (kube/client.py) and any kubectl-shaped tooling
need, over plain JSON dicts:

  - group/version REST layout (/api/v1, /apis/<group>/<version>), namespaced
    and cluster-scoped collections, single-object GET/PUT/DELETE, POST create
  - optimistic concurrency: metadata.resourceVersion is a monotonically
    increasing global counter; a PUT carrying a stale non-zero version gets
    409 Conflict
  - finalizer semantics: DELETE stamps deletionTimestamp while finalizers
    remain (unless gracePeriodSeconds=0), an update clearing the last
    finalizer of a terminating object removes it
  - watches: GET ?watch=true[&resourceVersion=N] streams chunked JSON events
    (ADDED/MODIFIED/DELETED) from a bounded journal; a too-old version gets
    410 Gone so clients relist (the informer contract)
  - subresources: pods/{name}/eviction (PDB-aware, 429 on violation, the
    eviction.go:100-107 status-code contract), pods/{name}/binding (the
    kube-scheduler's bind verb) and {plural}/{name}/status (a PUT that lands
    the status only)

State is wire-format dicts end to end; the server never imports the object
model, so it exercises the codec + client exactly as a remote apiserver
would.

The port's copy of karpenter_tpu/kube/apiserver.py. One change of cost only:
the handler sets TCP_NODELAY on its connections. One addition: the status
subresource, as the repo's CRD declares it for provisioners
(deploy/karpenter-tpu.yaml, `subresources: status`). A PUT to
{plural}/{name}/status keeps the stored object but its status, and no
webhook sees it, since a registered rule names the resource, not its
status.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .chaos import FAULT_COMPACT, FAULT_CONFLICT, FAULT_STALE_READ, FAULT_WATCH_DROP, KUBE_CHAOS
from .codec import API_REGISTRY, ts_to_wire

_JOURNAL_CAP = 50_000


def _plural_map() -> Dict[Tuple[str, str], Tuple[str, bool]]:
    """(apiVersion, plural) -> (kind, namespaced)."""
    out = {}
    for kind, (api_version, plural, namespaced) in API_REGISTRY.items():
        out[(api_version, plural)] = (kind, namespaced)
    return out


_PLURALS = _plural_map()


class _Status:
    """Build metav1.Status error bodies."""

    @staticmethod
    def error(code: int, reason: str, message: str) -> dict:
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "message": message,
            "reason": reason,
            "code": code,
        }


class _Unreachable:
    """A stored webhook registration with failurePolicy Fail and no dialable
    endpoint: matching writes must fail closed, like a real apiserver."""

    def __init__(self, name: str):
        self.name = name


class APIServerState:
    """The object store + watch hub, shared across handler threads."""

    def __init__(self, clock=None):
        self._lock = threading.RLock()
        self._objects: Dict[Tuple[str, str, str], dict] = {}  # (kind, ns, name) -> wire
        self._rv = 0
        self._journal: List[Tuple[int, str, str, dict]] = []  # (rv, kind, type, wire)
        self._watchers: List[Tuple[str, "queue.Queue"]] = []
        self._watch_blocked = False  # chaos blackout: subscribes refused 503
        self._clock = clock
        # admission webhook registrations: in-process registrations (the
        # test convenience) plus _dynamic_webhooks derived from stored
        # WebhookConfiguration objects; writes to matching kinds dispatch
        # over HTTPS with the registered CA bundle verifying the webhook's
        # serving cert
        self._webhooks: List[tuple] = []
        self._dynamic_webhooks: List[tuple] = []

    WEBHOOK_CONFIG_KINDS = ("MutatingWebhookConfiguration", "ValidatingWebhookConfiguration")

    def register_webhooks(self, kinds, mutate_url: Optional[str], validate_url: Optional[str], ca_pem: bytes) -> None:
        import ssl

        # the CA bundle is immutable per registration: build its TLS context
        # once instead of re-parsing the PEM on every admitted write
        ctx = ssl.create_default_context(cadata=ca_pem.decode())
        self._webhooks.append((set(kinds), None, mutate_url, validate_url, ctx))

    def _rebuild_dynamic_webhooks(self) -> None:
        """Derive admission dispatch from STORED Mutating/Validating
        WebhookConfiguration objects — the real registration path: kubectl
        applies the configurations, the webhook process patches in its
        caBundle + url, and writes start dispatching. Entries without a
        resolvable url or caBundle are skipped exactly like an apiserver
        that cannot reach the service."""
        import base64
        import ssl

        # (group, plural) -> kind, the rule-scoping a real apiserver applies
        group_plural_to_kind = {
            (api_version.rsplit("/", 1)[0] if "/" in api_version else "", plural): kind
            for kind, (api_version, plural, _) in API_REGISTRY.items()
        }
        dynamic: List[tuple] = []
        for (kind, _, _), wire in list(self._objects.items()):
            if kind not in self.WEBHOOK_CONFIG_KINDS:
                continue
            for hook in wire.get("webhooks") or []:
                kinds = set()
                operations = set()
                for rule in hook.get("rules") or []:
                    groups = rule.get("apiGroups") or ["*"]
                    for res in rule.get("resources") or []:
                        for group in groups:
                            if group == "*":
                                kinds.update(k for (g, p), k in group_plural_to_kind.items() if p == res)
                            else:
                                mapped = group_plural_to_kind.get((group, res))
                                if mapped:
                                    kinds.add(mapped)
                    operations.update(rule.get("operations") or ["*"])
                if not kinds:
                    continue
                client = hook.get("clientConfig") or {}
                url = client.get("url")
                bundle = client.get("caBundle")
                ctx = None
                if url and bundle:
                    try:
                        ctx = ssl.create_default_context(cadata=base64.b64decode(bundle).decode())
                    except Exception:
                        ctx = None  # malformed bundle: unreachable
                if ctx is None:
                    # fail CLOSED like a real apiserver that cannot call the
                    # webhook — unless the registration opts into Ignore
                    if (hook.get("failurePolicy") or "Fail") == "Fail":
                        dynamic.append((kinds, operations, None, None, _Unreachable(hook.get("name", "webhook"))))
                    continue
                if kind == "MutatingWebhookConfiguration":
                    dynamic.append((kinds, operations, url, None, ctx))
                else:
                    dynamic.append((kinds, operations, None, url, ctx))
        # defaulting before validation across entries (webhooks.go:41-96)
        dynamic.sort(key=lambda entry: entry[2] is None)
        self._dynamic_webhooks = dynamic

    def _call_webhook(self, url: str, ctx, wire: dict, operation: str) -> dict:
        import urllib.request

        review = {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {"uid": f"rev-{self._rv}", "object": wire, "operation": operation},
        }
        req = urllib.request.Request(url, data=json.dumps(review).encode(), headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
                return json.loads(resp.read())
        except ApiError:
            raise
        except Exception as exc:  # TLS/transport failure -> the real
            # apiserver's "failed calling webhook" InternalError
            raise ApiError(500, "InternalError", f"failed calling webhook {url}: {exc}") from exc

    def _admit(self, kind: str, wire: dict, operation: str) -> dict:
        """Run registered webhooks: defaulting (apply JSONPatch) then
        validation (webhooks.go:41-96 ordering); a disallow maps to 422."""
        if kind in self.WEBHOOK_CONFIG_KINDS:
            return wire  # registrations themselves are not webhook-admitted
        for kinds, operations, mutate_url, validate_url, ctx in list(self._webhooks) + list(self._dynamic_webhooks):
            if kind not in kinds:
                continue
            if operations is not None and "*" not in operations and operation not in operations:
                continue  # the rule's operations scope a real apiserver honors
            if isinstance(ctx, _Unreachable):
                raise ApiError(500, "InternalError", f"failed calling webhook {ctx.name}: no reachable endpoint registered")
            if mutate_url:
                out = self._call_webhook(mutate_url, ctx, wire, operation).get("response") or {}
                if not out.get("allowed", False):
                    raise ApiError(422, "Invalid", (out.get("status") or {}).get("message", "admission denied"))
                if out.get("patch"):
                    try:
                        import base64

                        from .webhookserver import apply_json_patch

                        ops = json.loads(base64.b64decode(out["patch"]))
                        wire = apply_json_patch(wire, ops)
                    except Exception as exc:  # malformed/unsupported patch
                        raise ApiError(500, "InternalError", f"failed applying webhook patch from {mutate_url}: {exc}") from exc
            if validate_url:
                out = self._call_webhook(validate_url, ctx, wire, operation).get("response") or {}
                if not out.get("allowed", False):
                    raise ApiError(422, "Invalid", (out.get("status") or {}).get("message", "admission denied"))
        return wire

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else time.time()

    def _bump(self, wire: dict) -> int:
        self._rv += 1
        wire.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
        return self._rv

    def _emit(self, kind: str, event_type: str, wire: dict) -> None:
        record = (self._rv, kind, event_type, json.loads(json.dumps(wire)))
        self._journal.append(record)
        if len(self._journal) > _JOURNAL_CAP:
            del self._journal[: _JOURNAL_CAP // 10]
        for want_kind, q in list(self._watchers):
            if want_kind == kind:
                q.put(record)
        if kind in self.WEBHOOK_CONFIG_KINDS:
            self._rebuild_dynamic_webhooks()

    # -- chaos seam (kube/chaos.py) ------------------------------------------

    def _chaos(self, verb: str, kind: str):
        """Consult the control-plane fault plan at one verb boundary (one
        attribute read when no plan is installed). An injected conflict is
        the same 409 wire status an organic stale write gets — the CLIENT's
        RetryOnConflict/relist machinery is what the storm exercises."""
        fault = KUBE_CHAOS.check(verb, kind)
        if fault == FAULT_CONFLICT:
            raise ApiError(409, "Conflict", f"{kind}: injected conflict storm at verb {verb!r}")
        return fault

    def chaos_kill_watches(self) -> None:
        """Drop every live watch stream (connection closed mid-stream): each
        informer must reconnect from its last seen resourceVersion."""
        with self._lock:
            for _, q in list(self._watchers):
                q.put(None)
        KUBE_CHAOS.record_action("watch-kill", transport="http")

    def chaos_watch_gap_begin(self) -> None:
        """Open a watch blackout: live streams are killed and re-subscribes
        are refused (503) until the gap ends — the window where informers
        spin on the full-jitter reconnect backoff while writes keep landing
        in the journal."""
        with self._lock:
            self._watch_blocked = True
        KUBE_CHAOS.record_action("watch-gap-begin", transport="http")
        self.chaos_kill_watches()

    def chaos_watch_gap_end(self) -> None:
        with self._lock:
            self._watch_blocked = False
        KUBE_CHAOS.record_action("watch-gap-end", transport="http")

    def chaos_compact(self) -> None:
        """Forced journal compaction: everything but the newest record is
        dropped, so a watch resuming from an older resourceVersion gets 410
        Gone and must relist — the informer contract's hard path."""
        with self._lock:
            if len(self._journal) > 1:
                del self._journal[:-1]
        KUBE_CHAOS.record_action("compact", transport="http")

    # -- verbs (wire dicts in, wire dicts out; raise (code, reason, msg)) ----

    def create(self, kind: str, namespace: str, wire: dict) -> dict:
        self._chaos("create", kind)
        wire = self._admit(kind, wire, "CREATE")
        with self._lock:
            meta = wire.setdefault("metadata", {})
            meta.setdefault("namespace", namespace)
            name = meta.get("name", "")
            key = (kind, meta.get("namespace", ""), name)
            if key in self._objects:
                raise ApiError(409, "AlreadyExists", f"{kind} {name!r} already exists")
            if not meta.get("uid"):
                meta["uid"] = f"uid-srv-{self._rv + 1:08d}"
            if not meta.get("creationTimestamp"):
                meta["creationTimestamp"] = ts_to_wire(self._now())
            self._bump(wire)
            self._objects[key] = wire
            self._emit(kind, "ADDED", wire)
            return wire

    def update(self, kind: str, namespace: str, name: str, wire: dict) -> dict:
        self._chaos("update", kind)
        wire = self._admit(kind, wire, "UPDATE")
        with self._lock:
            key = (kind, namespace, name)
            current = self._objects.get(key)
            if current is None:
                raise ApiError(404, "NotFound", f"{kind} {name!r} not found")
            _check_version(kind, name, current, wire)
            meta = wire.setdefault("metadata", {})
            # immutable server-owned fields
            meta["uid"] = current["metadata"].get("uid")
            meta["creationTimestamp"] = current["metadata"].get("creationTimestamp")
            if current["metadata"].get("deletionTimestamp") and not meta.get("deletionTimestamp"):
                meta["deletionTimestamp"] = current["metadata"]["deletionTimestamp"]
            # clearing the last finalizer of a terminating object deletes it
            if meta.get("deletionTimestamp") and not meta.get("finalizers"):
                del self._objects[key]
                self._bump(wire)
                self._emit(kind, "DELETED", wire)
                return wire
            self._bump(wire)
            self._objects[key] = wire
            self._emit(kind, "MODIFIED", wire)
            return wire

    def update_status(self, kind: str, namespace: str, name: str, wire: dict) -> dict:
        """PUT {plural}/{name}/status: the stored object with the incoming
        status, under the same resourceVersion check as update(); no
        admission runs."""
        self._chaos("update", kind)
        with self._lock:
            key = (kind, namespace, name)
            current = self._objects.get(key)
            if current is None:
                raise ApiError(404, "NotFound", f"{kind} {name!r} not found")
            _check_version(kind, name, current, wire)
            stored = json.loads(json.dumps(current))
            stored["status"] = wire.get("status", {})
            self._bump(stored)
            self._objects[key] = stored
            self._emit(kind, "MODIFIED", stored)
            return stored

    def delete(self, kind: str, namespace: str, name: str, force: bool = False) -> dict:
        self._chaos("delete", kind)
        with self._lock:
            key = (kind, namespace, name)
            current = self._objects.get(key)
            if current is None:
                raise ApiError(404, "NotFound", f"{kind} {name!r} not found")
            meta = current["metadata"]
            if not force and meta.get("finalizers"):
                if not meta.get("deletionTimestamp"):
                    meta["deletionTimestamp"] = ts_to_wire(self._now())
                    self._bump(current)
                    self._emit(kind, "MODIFIED", current)
                return current
            del self._objects[key]
            self._bump(current)
            self._emit(kind, "DELETED", current)
            return current

    def get(self, kind: str, namespace: str, name: str) -> dict:
        with self._lock:
            current = self._objects.get((kind, namespace, name))
            if current is None:
                raise ApiError(404, "NotFound", f"{kind} {name!r} not found")
        if self._chaos("get", kind) == FAULT_STALE_READ:
            # serve the read one write behind: the resourceVersion handed
            # back no longer matches the store, so the caller's next
            # conditional PUT loses its CAS — a lagging replica's answer
            stale = json.loads(json.dumps(current))
            meta = stale.setdefault("metadata", {})
            meta["resourceVersion"] = str(max(0, int(meta.get("resourceVersion") or 0) - 1))
            return stale
        return current

    def list(self, kind: str, namespace: Optional[str]) -> Tuple[List[dict], int]:
        with self._lock:
            items = [
                w
                for (k, ns, _), w in sorted(self._objects.items())
                if k == kind and (namespace is None or ns == namespace)
            ]
            return json.loads(json.dumps(items)), self._rv

    def subscribe(self, kind: str, since_rv: int) -> Tuple["queue.Queue", List[tuple]]:
        fault = self._chaos("watch", kind)
        if fault == FAULT_COMPACT:
            self.chaos_compact()
        with self._lock:
            if fault == FAULT_WATCH_DROP or self._watch_blocked:
                raise ApiError(503, "ServiceUnavailable", "watch stream refused (chaos blackout)")
            if self._journal and since_rv and since_rv < self._journal[0][0] - 1:
                raise ApiError(410, "Expired", f"resourceVersion {since_rv} is too old")
            backlog = [r for r in self._journal if r[0] > since_rv and r[1] == kind]
            q: "queue.Queue" = queue.Queue()
            self._watchers.append((kind, q))
            return q, backlog

    def unsubscribe(self, q: "queue.Queue") -> None:
        with self._lock:
            self._watchers = [(k, w) for (k, w) in self._watchers if w is not q]

    # -- subresources --------------------------------------------------------

    def evict(self, namespace: str, name: str) -> None:
        """The Eviction API: 404 if gone, 429 if a PDB disallows, else delete
        (eviction.go:100-107 status-code contract)."""
        with self._lock:
            pod = self._objects.get(("Pod", namespace, name))
            if pod is None:
                raise ApiError(404, "NotFound", f"pod {name!r} not found")
            labels = pod["metadata"].get("labels") or {}
            guards = []
            for (k, ns, _), w in self._objects.items():
                if k == "PodDisruptionBudget" and ns == namespace and _selector_matches(w.get("selector"), labels):
                    guards.append(w)
            for pdb in guards:
                if int(pdb.get("disruptionsAllowed", 0)) <= 0:
                    raise ApiError(429, "TooManyRequests", "eviction would violate a PodDisruptionBudget")
            for pdb in guards:
                pdb["disruptionsAllowed"] = int(pdb.get("disruptionsAllowed", 0)) - 1
            self.delete("Pod", namespace, name, force=True)

    def bind(self, namespace: str, name: str, node_name: str) -> None:
        """The kube-scheduler's bind verb (pods/{name}/binding)."""
        with self._lock:
            pod = self._objects.get(("Pod", namespace, name))
            if pod is None:
                raise ApiError(404, "NotFound", f"pod {name!r} not found")
            pod.setdefault("spec", {})["nodeName"] = node_name
            status = pod.setdefault("status", {})
            status["phase"] = "Running"
            # the authoritative bind instant (PodStatus.startTime): watchers
            # measure creation->bind off this stamp, not their dispatch time
            status["startTime"] = self._now()
            status["conditions"] = [c for c in status.get("conditions", []) if c.get("type") != "PodScheduled"]
            self._bump(pod)
            self._emit("Pod", "MODIFIED", pod)


def _check_version(kind: str, name: str, current: dict, wire: dict) -> None:
    """Optimistic concurrency: a PUT carrying a non-zero resourceVersion
    other than the stored one gets 409 Conflict."""
    incoming_rv = wire.get("metadata", {}).get("resourceVersion") or "0"
    current_rv = current.get("metadata", {}).get("resourceVersion")
    if incoming_rv not in ("0", "", None) and incoming_rv != current_rv:
        raise ApiError(409, "Conflict", f"{kind} {name!r}: stale resourceVersion {incoming_rv} (current {current_rv})")


def _selector_matches(selector: Optional[dict], labels: Dict[str, str]) -> bool:
    if not selector:
        return False
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        value = labels.get(expr.get("key"))
        op = expr.get("operator")
        values = expr.get("values") or []
        if op == "In" and (value is None or value not in values):
            return False
        if op == "NotIn" and value is not None and value in values:
            return False
        if op == "Exists" and value is None:
            return False
        if op == "DoesNotExist" and value is not None:
            return False
    return True


class ApiError(Exception):
    def __init__(self, code: int, reason: str, message: str):
        super().__init__(message)
        self.code = code
        self.reason = reason
        self.message = message


def _parse_path(path: str):
    """Resolve a REST path to (kind, namespaced, namespace, name, subresource).

    Layouts:  /api/v1/<plural>[/...]                        core, cluster/all-ns
              /api/v1/namespaces/<ns>/<plural>[/<name>[/<sub>]]
              /apis/<group>/<version>/...                   same shapes
    """
    parts = [p for p in path.split("/") if p]
    if not parts:
        raise ApiError(404, "NotFound", "no path")
    if parts[0] == "api":
        api_version = parts[1]
        rest = parts[2:]
    elif parts[0] == "apis":
        api_version = f"{parts[1]}/{parts[2]}"
        rest = parts[3:]
    else:
        raise ApiError(404, "NotFound", f"unknown API root {parts[0]!r}")
    namespace = ""
    # /namespaces/<ns>/<plural>/... is a namespaced path; a bare
    # /namespaces[/<name>] (length <= 2) is the Namespace collection itself
    if len(rest) > 2 and rest[0] == "namespaces":
        namespace, rest = rest[1], rest[2:]
    entry = _PLURALS.get((api_version, rest[0] if rest else ""))
    if entry is None:
        raise ApiError(404, "NotFound", f"unknown resource {path!r}")
    kind, namespaced = entry
    name = rest[1] if len(rest) > 1 else ""
    sub = rest[2] if len(rest) > 2 else ""
    return kind, namespaced, namespace, name, sub


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "karpenter-tpu-apiserver"
    # a response goes out in two writes (headers, then body): with Nagle's
    # algorithm on, the body waits for the client's delayed ACK of the
    # headers, ~40 ms a request on Linux
    disable_nagle_algorithm = True

    def log_message(self, *args):  # quiet
        pass

    @property
    def state(self) -> APIServerState:
        return self.server.state  # type: ignore[attr-defined]

    def _send_json(self, code: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_error(self, err: ApiError) -> None:
        self._send_json(err.code, _Status.error(err.code, err.reason, err.message))

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return {}
        return json.loads(self.rfile.read(length) or b"{}")

    def do_GET(self):
        url = urlparse(self.path)
        params = parse_qs(url.query)
        try:
            kind, namespaced, namespace, name, _ = _parse_path(url.path)
            if name:
                wire = self.state.get(kind, namespace, name)
                self._send_json(200, wire)
                return
            if params.get("watch", ["false"])[0] in ("true", "1"):
                self._serve_watch(kind, int(params.get("resourceVersion", ["0"])[0] or 0))
                return
            items, rv = self.state.list(kind, namespace or None if namespaced else None)
            self._send_json(
                200,
                {
                    "kind": f"{kind}List",
                    "apiVersion": API_REGISTRY[kind][0],
                    "metadata": {"resourceVersion": str(rv)},
                    "items": items,
                },
            )
        except ApiError as err:
            self._send_error(err)

    def _serve_watch(self, kind: str, since_rv: int) -> None:
        q, backlog = self.state.subscribe(kind, since_rv)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_chunk(payload: dict) -> None:
                data = (json.dumps(payload) + "\n").encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            for rv, _, event_type, wire in backlog:
                send_chunk({"type": event_type, "object": wire})
            while not getattr(self.server, "_shutting_down", False):
                try:
                    record = q.get(timeout=0.25)
                except queue.Empty:
                    continue
                if record is None:
                    # chaos kill sentinel: close the SOCKET, not just the
                    # handler — under HTTP/1.1 keep-alive a bare return
                    # leaves the client blocked on readline() forever
                    self.close_connection = True
                    return
                rv, _, event_type, wire = record
                send_chunk({"type": event_type, "object": wire})
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            self.state.unsubscribe(q)

    def do_POST(self):
        url = urlparse(self.path)
        try:
            kind, namespaced, namespace, name, sub = _parse_path(url.path)
            body = self._read_body()
            if kind == "Pod" and name and sub == "eviction":
                self.state.evict(namespace, name)
                self._send_json(201, {"kind": "Status", "status": "Success", "code": 201})
                return
            if kind == "Pod" and name and sub == "binding":
                self.state.bind(namespace, name, (body.get("target") or {}).get("name", ""))
                self._send_json(201, {"kind": "Status", "status": "Success", "code": 201})
                return
            wire = self.state.create(kind, namespace, body)
            self._send_json(201, wire)
        except ApiError as err:
            self._send_error(err)

    def do_PUT(self):
        url = urlparse(self.path)
        try:
            kind, namespaced, namespace, name, sub = _parse_path(url.path)
            if sub == "status":
                wire = self.state.update_status(kind, namespace, name, self._read_body())
            else:
                wire = self.state.update(kind, namespace, name, self._read_body())
            self._send_json(200, wire)
        except ApiError as err:
            self._send_error(err)

    def do_DELETE(self):
        url = urlparse(self.path)
        params = parse_qs(url.query)
        try:
            kind, namespaced, namespace, name, _ = _parse_path(url.path)
            force = params.get("gracePeriodSeconds", [""])[0] == "0"
            wire = self.state.delete(kind, namespace, name, force=force)
            self._send_json(200, wire)
        except ApiError as err:
            self._send_error(err)


class APIServer:
    """Lifecycle wrapper: serve_forever on a daemon thread, bound port
    discoverable for clients."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, clock=None):
        self.state = APIServerState(clock=clock)
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.state = self.state  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "APIServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1}, name="kube-apiserver", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd._shutting_down = True  # type: ignore[attr-defined]
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
