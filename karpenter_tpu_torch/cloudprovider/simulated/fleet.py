"""CreateFleetBatcher: coalesce identical concurrent fleet calls.

Mirrors pkg/cloudprovider/aws/createfleetbatcher.go:40-197 — concurrent
create() calls for the same launch configuration collapse into one backend
call whose results fan out to the waiters, cutting API pressure during
launch storms.

Each waiter's OWN client token rides its launch (a waiter with no token
gets one coined at join), and the waiter receives exactly the instance
launched under its token — so an application-level retry of any one
logical launch, even one that joined a batch as a follower, replays its
token and dedupes at the backend. A call whose RESPONSE is lost
(ResponseLostError / a dead transport mid-call) is retried with the same
token for the same reason: a lost response never double-launches and never
loses the instance it paid for.

Fulfillment is PER-ITEM under a capacity crunch: a waiter whose own fleet
item hit insufficient capacity gets the typed `InsufficientCapacityError`
for ITS pools — never the leader's unrelated exception and never a silent
None — while sibling waiters whose items launched still receive their
instances (createfleetbatcher_test.go:250, and the partial-fulfillment
contract of the reference's per-item CreateFleet error extraction). The
exhausted pools every item reports (including pools a SUCCESSFUL launch
skipped on its way to a pricier one) stream to `on_unavailable`, the
negative-offering-cache feed.

The port's copy of karpenter_tpu/cloudprovider/simulated/fleet.py; its
lock is a plain threading.Lock (the reference's lock-order witness and
guarded-by annotation are left out).
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple

from ..errors import InsufficientCapacityError, TransientCloudError
from .backend import CloudBackend, FleetInstance, FleetRequest

BATCH_WINDOW_SECONDS = 0.05
# attempts per backend call when the response is lost; each retry replays
# the same client token, so the worst case is one launch + N-1 replays
LOST_RESPONSE_ATTEMPTS = 3


class _Batch:
    def __init__(self):
        self.tokens: List[str] = []  # one per waiter, index == waiter slot
        self.done = threading.Event()
        self.results: Dict[int, FleetInstance] = {}  # waiter slot -> its instance
        self.item_errors: Dict[int, Exception] = {}  # waiter slot -> ITS typed failure
        self.error: Optional[Exception] = None  # batch-level failure (transport etc.)


def _request_key(request: FleetRequest) -> Tuple:
    return (
        request.capacity_type,
        tuple(sorted((s.instance_type, s.zone, s.capacity_type, s.launch_template_id) for s in request.specs)),
    )


class CreateFleetBatcher:
    def __init__(self, backend: CloudBackend, window: float = BATCH_WINDOW_SECONDS, on_unavailable: Optional[Callable] = None):
        self.backend = backend
        self.window = window
        # exhausted-pool observations ((type, zone, capacity_type) lists)
        # from every item — typed ICEs AND the pools successful launches
        # skipped; the provider wires this into its UnavailableOfferings
        self.on_unavailable = on_unavailable
        self._lock = threading.Lock()
        self._pending: Dict[Tuple, _Batch] = {}

    def _report_unavailable(self, pools) -> None:
        if self.on_unavailable is not None and pools:
            self.on_unavailable(list(pools))

    def _create_one(self, request: FleetRequest, token: str) -> FleetInstance:
        """One instance launch, idempotent under retry: the waiter's token
        rides the call and is replayed verbatim when the response is lost."""
        tokened = replace(request, client_token=token, count=1)
        last: Optional[Exception] = None
        for _ in range(LOST_RESPONSE_ATTEMPTS):
            try:
                result = self.backend.create_fleet(tokened)
            except TransientCloudError as err:
                last = err  # outcome unknown: replay the same token
                continue
            self._report_unavailable(getattr(result, "unavailable_pools", ()))
            return result.instance
        raise last

    def create_fleet(self, request: FleetRequest) -> FleetInstance:
        key = _request_key(request)
        token = request.client_token or uuid.uuid4().hex
        with self._lock:
            batch = self._pending.get(key)
            leader = batch is None
            if leader:
                batch = _Batch()
                self._pending[key] = batch
            slot = len(batch.tokens)
            batch.tokens.append(token)
        if leader:
            # the leader waits out the window for followers to pile on, then
            # issues one backend call per waiter — each under THAT waiter's
            # token — in a single burst
            threading.Event().wait(self.window)
            with self._lock:
                del self._pending[key]
                tokens = list(batch.tokens)
            for i, waiter_token in enumerate(tokens):
                try:
                    batch.results[i] = self._create_one(request, waiter_token)
                except InsufficientCapacityError as e:
                    # THIS item's capacity failure: deliver it to its waiter
                    # and keep serving the rest of the burst — instances
                    # already launched (and any that still can) go to their
                    # waiters; only the unfulfilled items error
                    batch.item_errors[i] = e
                    self._report_unavailable(e.pools)
                except Exception as e:  # noqa: BLE001
                    # batch-level failure (transport death, injected error):
                    # the shortfall shares it
                    batch.error = e
                    break
            batch.done.set()
        else:
            batch.done.wait()
        instance = batch.results.get(slot)
        if instance is not None:
            return instance
        item_error = batch.item_errors.get(slot)
        if item_error is not None:
            raise item_error
        if batch.error is not None:
            raise batch.error
        raise RuntimeError("fleet batch returned no instance")
