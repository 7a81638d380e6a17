"""CloudAPIClient: the provider's remote-transport cloud client.

Duck-types `CloudBackend`, so `SimulatedCloudProvider(backend=client)` runs
the whole provider stack — catalog, pricing, launch templates, fleet
batching, ICE negative caching — with every cloud interaction crossing a
socket. This is the client half of the production seam (api.py documents
the protocol), mirroring the reference's remote-API client obligations
(pkg/cloudprovider/aws/cloudprovider.go:86-101, instance.go:133-208,335-345):

  - bearer-token auth and a connectivity dry-run (`verify()`, the session
    GetCallerIdentity analog) so a misconfigured endpoint fails at startup,
    not mid-provisioning;
  - retry with exponential backoff + FULL jitter (the aws-sdk recipe:
    sleep ~ uniform(0, min(cap, base * 2^attempt))) on 429 (honoring a
    throttle's Retry-After as the floor), 5xx, and transport errors, bounded
    by max_attempts AND a per-request deadline so one logical call can never
    stall its controller loop longer than the budget;
  - observability: karpenter_cloudapi_retries_total{code} counts every
    retried attempt by the failure class that caused it;
  - pagination for the instance-type catalog;
  - a typed error taxonomy: structured error bodies map back to
    InsufficientCapacityError (with per-pool extraction) and
    LaunchTemplateNotFoundError (with template ids) — the same exceptions
    the in-process backend raises, so provider error handling is
    transport-agnostic;
  - idempotent CreateFleet: every logical launch carries a client token;
    a retry after a lost response replays the SAME token and the service
    returns the original instance — a mid-call timeout can never
    double-launch (EC2 ClientToken semantics).
"""

from __future__ import annotations

import http.client
import json
import random
import uuid
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import quote, urlparse

from ...logsetup import get_logger
from ...metrics import REGISTRY
from ...utils.clock import Clock
from .backend import (
    FleetInstance,
    FleetRequest,
    FleetResult,
    InstanceTypeInfo,
    InsufficientCapacityError,
    LaunchTemplate,
    LaunchTemplateNotFoundError,
    SecurityGroup,
    Subnet,
)

log = get_logger("cloudapi")

MAX_ATTEMPTS = 6
BACKOFF_BASE = 0.05
BACKOFF_CAP = 2.0
PAGE_SIZE = 50
# total time budget for ONE logical call (all attempts + backoffs, judged on
# the client's clock): a degraded cloud must surface as a typed error within
# the budget, not stall a controller loop across minutes of backoff
REQUEST_DEADLINE = 30.0


class CloudAPIError(RuntimeError):
    """Transport or service failure that exhausted the retry budget."""

    def __init__(self, message: str, status: Optional[int] = None, code: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.code = code


class AuthError(CloudAPIError):
    """401: bad or missing bearer token — never retried."""


class CloudAPIClient:
    def __init__(
        self,
        base_url: str,
        token: str = "sim-cloud-token",
        clock=None,
        max_attempts: int = MAX_ATTEMPTS,
        backoff_base: float = BACKOFF_BASE,
        timeout: float = 10.0,
        request_deadline: float = REQUEST_DEADLINE,
        sleep=None,
    ):
        parsed = urlparse(base_url)
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or 80
        self._token = token
        self.clock = clock or Clock()
        self.max_attempts = max_attempts
        self.backoff_base = backoff_base
        self.timeout = timeout
        self.request_deadline = request_deadline
        # backoff sleeps through the clock (FakeClock advances virtually) so
        # fake-clocked suites never burn real wall time on retries; an
        # explicit `sleep` hook wins (tests capture the schedule)
        self._sleep = sleep if sleep is not None else self.clock.sleep
        self._rng = random.Random(0x5EED)
        self.retries = 0  # observable: total retried attempts
        self.retries_total = REGISTRY.counter(
            "karpenter_cloudapi_retries_total",
            "Cloud API attempts retried, by the failure class that caused the retry",
            ("code",),
        )

    # -- transport -----------------------------------------------------------

    def _once(self, method: str, path: str, body: Optional[dict]) -> Tuple[int, dict, Dict[str, str]]:
        conn = http.client.HTTPConnection(self._host, self._port, timeout=self.timeout)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            headers = {"Authorization": f"Bearer {self._token}", "Content-Type": "application/json"}
            conn.request(method, path, body=payload, headers=headers)
            response = conn.getresponse()
            raw = response.read()
            parsed = json.loads(raw) if raw else {}
            return response.status, parsed, dict(response.getheaders())
        finally:
            conn.close()

    def _call(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        """One logical API call: retries transport errors, 429 (honoring
        Retry-After), and 5xx with exponential backoff + full jitter, bounded
        by max_attempts AND the per-request deadline; maps structured errors
        to the typed taxonomy."""
        started = self.clock.now()
        last_error: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            if attempt:
                self.retries += 1
            if attempt and self.clock.now() - started >= self.request_deadline:
                raise CloudAPIError(
                    f"{method} {path} exceeded the {self.request_deadline:.1f}s request deadline: {last_error}",
                    status=getattr(last_error, "status", None),
                    code="deadline_exceeded",
                )
            try:
                status, parsed, headers = self._once(method, path, body)
            except OSError as err:  # connection refused/reset, timeout
                last_error = err
                self._backoff(attempt, None, started, code="transport")
                continue
            if status == 429:
                last_error = CloudAPIError("throttled", status=429, code="throttled")
                self._backoff(attempt, headers.get("Retry-After"), started, code="throttled")
                continue
            if status >= 500:
                message = (parsed.get("error") or {}).get("message", "internal error")
                last_error = CloudAPIError(message, status=status, code="internal")
                self._backoff(attempt, None, started, code="internal")
                continue
            if status == 401:
                raise AuthError("unauthorized: check the cloud API bearer token", status=401, code="unauthorized")
            error = parsed.get("error")
            if error is not None:
                code = error.get("code")
                if code == "insufficient_capacity":
                    raise InsufficientCapacityError([tuple(p) for p in error.get("pools", [])])
                if code == "launch_template_not_found":
                    raise LaunchTemplateNotFoundError(error.get("template_ids", []))
                if code == "not_found":
                    raise _RemoteNotFound(error.get("message", path))
                raise CloudAPIError(error.get("message", code or "error"), status=status, code=code)
            return parsed
        raise CloudAPIError(
            f"{method} {path} failed after {self.max_attempts} attempts: {last_error}",
            status=getattr(last_error, "status", None),
            code=getattr(last_error, "code", None) or "exhausted",
        )

    def _backoff(self, attempt: int, retry_after: Optional[str], started: float, code: str = "transport") -> None:
        """Sleep before the retry the caller is about to make: exponential
        cap with FULL jitter (uniform over [0, cap] — the aws-sdk
        FullJitter recipe that decorrelates a thundering herd better than
        any fixed fraction), a throttle's Retry-After as the floor, and the
        whole thing clamped to the remaining request deadline."""
        self.retries_total.inc(code=code)
        cap = min(BACKOFF_CAP, self.backoff_base * (2**attempt))
        delay = self._rng.uniform(0.0, cap)
        if retry_after is not None:
            try:
                hint = float(retry_after)
            except ValueError:
                hint = 0.0
            delay = max(hint, delay)
        remaining = self.request_deadline - (self.clock.now() - started)
        self._sleep(max(0.0, min(delay, remaining)))

    # -- connectivity dry-run -----------------------------------------------

    def verify(self) -> None:
        """Startup connectivity + auth dry-run (cloudprovider.go:86-101):
        one cheap authenticated call; raises AuthError / CloudAPIError."""
        self._call("GET", "/v1/subnets")

    # -- CloudBackend surface -----------------------------------------------

    def describe_instance_types(self) -> List[InstanceTypeInfo]:
        items: List[dict] = []
        token: Optional[int] = 0
        while token is not None:
            page = self._call("GET", f"/v1/instance-types?max-results={PAGE_SIZE}&page-token={token}")
            items.extend(page.get("items", []))
            token = page.get("next_token")
        return [InstanceTypeInfo(**item) for item in items]

    def _selector_query(self, tag_selector: Optional[Dict[str, str]]) -> str:
        if not tag_selector:
            return ""
        return "?" + "&".join(f"tag.{quote(k)}={quote(v)}" for k, v in sorted(tag_selector.items()))

    def describe_subnets(self, tag_selector: Optional[Dict[str, str]] = None) -> List[Subnet]:
        page = self._call("GET", "/v1/subnets" + self._selector_query(tag_selector))
        return [Subnet(**item) for item in page.get("items", [])]

    def describe_security_groups(self, tag_selector: Optional[Dict[str, str]] = None) -> List[SecurityGroup]:
        page = self._call("GET", "/v1/security-groups" + self._selector_query(tag_selector))
        return [SecurityGroup(**item) for item in page.get("items", [])]

    def describe_prices(self) -> Tuple[Dict[str, float], Dict[Tuple[str, str], float]]:
        page = self._call("GET", "/v1/prices")
        od = dict(page.get("on_demand", {}))
        spot = {(q["type"], q["zone"]): q["price"] for q in page.get("spot", [])}
        return od, spot

    def get_on_demand_price(self, type_name: str) -> Optional[float]:
        od, _ = self.describe_prices()
        return od.get(type_name)

    def get_spot_price(self, type_name: str, zone: str) -> Optional[float]:
        _, spot = self.describe_prices()
        return spot.get((type_name, zone))

    def ensure_launch_template(self, name: str, image_id: str, security_group_ids: Sequence[str], user_data: str) -> LaunchTemplate:
        body = {
            "name": name,
            "image_id": image_id,
            "security_group_ids": list(security_group_ids),
            "user_data": user_data,
        }
        data = self._call("POST", "/v1/launch-templates", body)
        data["security_group_ids"] = tuple(data.get("security_group_ids", ()))
        return LaunchTemplate(**data)

    def delete_launch_template(self, name: str) -> None:
        self._call("DELETE", f"/v1/launch-templates/{quote(name)}")

    def create_fleet(self, request: FleetRequest) -> FleetResult:
        # the request's own client token wins (callers like the fleet
        # batcher coin one per LOGICAL launch, so an application-level retry
        # dedupes too); a token-less request still gets a per-call token so
        # the transport retry inside _call can never double-launch
        body = {
            "idempotency_token": request.client_token or uuid.uuid4().hex,
            "capacity_type": request.capacity_type,
            "count": max(1, int(request.count)),
            "specs": [
                {
                    "instance_type": s.instance_type,
                    "zone": s.zone,
                    "capacity_type": s.capacity_type,
                    "launch_template_id": s.launch_template_id,
                    "subnet_id": s.subnet_id,
                }
                for s in request.specs
            ],
        }
        data = self._call("POST", "/v1/fleet", body)
        # per-item result shape (api.py /v1/fleet): typed shortfall entries
        # map back to the same exceptions the in-process backend raises, so
        # provider/batcher error handling is transport-agnostic
        return FleetResult(
            instances=[FleetInstance(**item) for item in data.get("instances", [])],
            errors=[
                InsufficientCapacityError([tuple(p) for p in err.get("pools", [])])
                for err in data.get("errors", [])
            ],
            unavailable_pools=[tuple(p) for p in data.get("unavailable_pools", [])],
        )

    def terminate_instance(self, instance_id: str) -> None:
        try:
            self._call("DELETE", f"/v1/instances/{quote(instance_id)}")
        except _RemoteNotFound:
            pass  # already gone: terminate is idempotent, like the backend

    def instance_exists(self, instance_id: str) -> bool:
        try:
            self._call("GET", f"/v1/instances/{quote(instance_id)}")
            return True
        except _RemoteNotFound:
            return False

    def list_instances(self) -> List[FleetInstance]:
        page = self._call("GET", "/v1/instances")
        return [FleetInstance(**item) for item in page.get("items", [])]

    # -- notification queue (notifications.py over the wire) -----------------

    def receive_messages(self, max_messages: int = 10, wait_seconds: float = 0.0, visibility_timeout=None):
        """ReceiveMessage long-poll. Duck-types NotificationQueue so the
        interruption controller is transport-agnostic. The service caps the
        server-side wait at 5s (below the transport timeout); longer waits
        are the caller's loop."""
        from .notifications import ReceivedMessage

        body = {"max_messages": max_messages, "wait_seconds": wait_seconds}
        if visibility_timeout is not None:
            body["visibility_timeout"] = visibility_timeout
        page = self._call("POST", "/v1/queue/receive", body)
        return [
            ReceivedMessage(
                message_id=m["message_id"],
                receipt_handle=m["receipt_handle"],
                receive_count=int(m.get("receive_count", 1)),
                body=dict(m.get("body", {})),
            )
            for m in page.get("messages", [])
        ]

    def delete_message(self, receipt_handle: str) -> bool:
        page = self._call("DELETE", f"/v1/queue/messages/{quote(receipt_handle)}")
        return bool(page.get("deleted"))

    def queue_attributes(self) -> dict:
        return self._call("GET", "/v1/queue/attributes")

    def dead_letter_depth(self) -> int:
        return int(self.queue_attributes().get("dead_letter_depth", 0))


class _RemoteNotFound(RuntimeError):
    pass
