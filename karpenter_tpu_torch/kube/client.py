"""HttpKubeClient: the real-protocol Kubernetes client.

Drop-in replacement for the in-memory KubeCluster (kube/cluster.py) that
speaks HTTP to an apiserver — the in-process emulator (kube/apiserver.py)
or any endpoint serving the same protocol subset. Mirrors the client stack
the reference builds on (controllers.go:86-165):

  - rate-limited REST client: a token bucket at 200 QPS / 300 burst, the
    reference's defaults (utils/options/options.go:65-66)
  - ListAndWatch informers: watch() lists (replay) then streams chunked
    watch events on a daemon thread, reconnecting from the last seen
    resourceVersion and relisting on 410 Gone
  - optimistic-concurrency handling: update() retries stale-resourceVersion
    409s by refreshing the version and resending (client-go's
    RetryOnConflict idiom), preserving KubeCluster's last-write-wins surface
  - the Eviction (429 on PDB violation) and Binding subresources

Every verb serializes through kube/codec.py, so state observed by
controllers is always a decoded wire copy — reference semantics, where
mutating a local object never changes the cluster until written back. A
watch event's object and a cached read's are the informer's own, shared by
every handler and reader of the kind, which must not edit them; a handler
whose objects its callers later edit (the state Cluster's Node handler,
whose nodes retry_on_conflict and delete write back into) asks watch() for
its own copy of each.

The port's copy of karpenter_tpu/kube/client.py, with two additions:

  - `retry_on_conflict`, client-go's RetryOnConflict, which re-reads the
    object and re-applies the caller's edit after a 409 instead of
    resending a stale object (update() keeps the reference's
    refresh-and-resend); with `status_only` it PUTs to the
    object's /status, which lands the status only;
  - one shared informer per kind, client-go's SharedIndexInformer: the
    first watch() of a kind starts its one ListAndWatch stream, and every
    later watch() of that kind joins it, so an event is decoded once for
    all handlers. Each handler has a queue and a thread of its own
    (client-go's processorListener), so the store never waits on a slow
    handler. The informer's store, indexed by namespace and name, is
    what `cached_pods` and `cached_node` read, with no request, once its
    first LIST is in (client-go's HasSynced). The reference opens a stream
    per watch() and sends a LIST for every list.
"""

from __future__ import annotations

import copy
import http.client
import json
import queue
import random
import threading
from typing import Callable, Dict, List, Optional
from urllib.parse import urlparse

from ..api.objects import CSINode, Namespace, Node, PersistentVolume, PersistentVolumeClaim, Pod, StorageClass
from ..api.provisioner import Provisioner
from ..logsetup import get_logger
from .chaos import KUBE_CONFLICTS
from .cluster import (
    ADDED,
    DELETED,
    MODIFIED,
    RETRY_ON_CONFLICT_ATTEMPTS,
    Conflict,
    ConflictExhausted,
    NotFound,
    WatchEvent,
    conflict_exhausted,
    rebind,
)
from .codec import API_REGISTRY, from_wire, rest_path, to_wire

log = get_logger("kubeclient")

DEFAULT_QPS = 200.0  # options.go:65
DEFAULT_BURST = 300  # options.go:66

# watch-reconnect backoff: exponential cap with FULL jitter (the apiclient
# retry idiom) through the clock seam — a restarted apiserver must not be
# thundering-herded by every informer reconnecting on the same tick
WATCH_BACKOFF_BASE = 0.05
WATCH_BACKOFF_CAP = 2.0

# how long a cached read waits for its informer's first LIST (client-go's
# WaitForCacheSync) before it raises CacheNotSynced
CACHE_SYNC_TIMEOUT = 30.0
CACHE_SYNC_POLL = 0.05  # how often the wait looks at the client's stop flag


class CacheNotSynced(TimeoutError):
    """A cached read's informer had no complete LIST in its store by the
    deadline, or the client was stopped first. The read sends no request in
    its place."""


class _Listener:
    """One handler of a shared informer, with a queue and a thread of its
    own (client-go's processorListener): the stream puts each event in every
    listener's queue and reads on, so a slow handler delays only its own
    deliveries, never the store or the other handlers. With `own_copy` the
    handler gets a deep copy of each event's object, for a handler whose
    objects its callers later edit."""

    def __init__(self, kind: str, handler: Callable[[WatchEvent], None], replay: bool, own_copy: bool, index: int):
        self.kind = kind
        self.handler = handler
        self.replay = replay
        self.own_copy = own_copy
        self.queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self.stopped = False
        self.errors = 0
        self.thread = threading.Thread(target=self._run, daemon=True, name=f"watch-{kind.lower()}-handler-{index}")

    def stop(self) -> None:
        """Deliver nothing more; the thread ends at its next event."""
        self.stopped = True
        self.queue.put(None)

    def _run(self) -> None:
        while True:
            event = self.queue.get()
            if event is None or self.stopped:
                return
            if self.own_copy:
                event = WatchEvent(event.type, copy.deepcopy(event.obj))
            # a handler that raises misses only this event: the stream, the
            # store and every other handler go on as if it had returned
            try:
                self.handler(event)
            except Exception:  # noqa: BLE001 - one handler's fault must not relist for all
                self.errors += 1
                log.exception("watch %s: a handler raised on %s %s", self.kind, event.type, event.obj.metadata.name)


class _Informer:
    """One kind's shared informer (client-go's SharedIndexInformer): one
    ListAndWatch loop on a daemon thread, the store it keeps, and the
    handlers it feeds, each through a _Listener.

    The store maps (namespace, name) to the last object decoded, as
    client-go's store keys by namespace/name, with an index by namespace.
    `lock` guards the two and the listeners: an event goes into the store
    and into every listener's queue under it, and a late handler's replay
    of the store is queued under it, so every handler sees the store's
    objects and then each later event, in order, once; a read copies out
    what it needs under it. The store runs ahead of the handlers, never
    behind them."""

    def __init__(self, kind: str):
        self.kind = kind
        self.namespaced = API_REGISTRY[kind][2]
        self.lock = threading.Lock()
        self.store: Dict[tuple, object] = {}
        self.by_namespace: Dict[str, Dict[str, object]] = {}
        self.listeners: List[_Listener] = []
        self.synced = threading.Event()
        self._added = 0  # listeners ever added: their threads' names

    @property
    def handler_errors(self) -> int:
        return sum(listener.errors for listener in self.listeners)

    def _name_key(self, obj) -> tuple:
        return (obj.metadata.namespace if self.namespaced else "", obj.metadata.name)

    def _put(self, obj) -> None:
        self.store[self._name_key(obj)] = obj
        self.by_namespace.setdefault(obj.metadata.namespace, {})[obj.metadata.name] = obj

    def _drop(self, obj) -> None:
        # the delete of an object a recreate under its name has replaced
        # leaves the new one
        key = self._name_key(obj)
        held = self.store.get(key)
        if held is None or held.metadata.uid != obj.metadata.uid:
            return
        del self.store[key]
        members = self.by_namespace[held.metadata.namespace]
        del members[held.metadata.name]
        if not members:
            del self.by_namespace[held.metadata.namespace]

    def add(self, handler: Callable[[WatchEvent], None], replay: bool, own_copy: bool) -> None:
        """Register a handler; with `replay`, a synced store's objects reach
        it as ADDED first (an unsynced store's come with its first LIST)."""
        with self.lock:
            self._added += 1
            listener = _Listener(self.kind, handler, replay, own_copy, self._added)
            if replay and self.synced.is_set():
                for obj in self.store.values():
                    listener.queue.put(WatchEvent(ADDED, obj))
            self.listeners = self.listeners + [listener]
            listener.thread.start()

    def remove(self, handler: Callable[[WatchEvent], None]) -> None:
        """Stop and drop the handler's registrations, matched by identity,
        as the reference's unwatch does."""
        with self.lock:
            gone = [listener for listener in self.listeners if listener.handler is handler]
            self.listeners = [listener for listener in self.listeners if listener.handler is not handler]
        for listener in gone:
            listener.stop()

    def stop(self) -> None:
        with self.lock:
            listeners = self.listeners
        for listener in listeners:
            listener.stop()

    def resync(self, listed: List[object], first: bool) -> None:
        """Put a LIST in the store. The first goes to the handlers that
        asked for a replay, as ADDED; a relist (after a 410 gap) goes to
        every handler as the diff against the store by uid, as the
        reference's informer diffs: ADDED, MODIFIED, and DELETED for an
        object the gap hid the delete of."""
        with self.lock:
            previous = {obj.metadata.uid: obj for obj in self.store.values()}
            current = {obj.metadata.uid for obj in listed}
            self.store, self.by_namespace = {}, {}
            for obj in listed:
                self._put(obj)
            events = [WatchEvent(ADDED if first or obj.metadata.uid not in previous else MODIFIED, obj) for obj in listed]
            if not first:
                events += [WatchEvent(DELETED, obj) for uid, obj in previous.items() if uid not in current]
            for listener in self.listeners:
                if listener.replay or not first:
                    for event in events:
                        listener.queue.put(event)
            self.synced.set()

    def apply(self, event: WatchEvent) -> None:
        """One streamed event: into the store, then into every handler's
        queue."""
        with self.lock:
            if event.type == DELETED:
                self._drop(event.obj)
            else:
                self._put(event.obj)
            for listener in self.listeners:
                listener.queue.put(event)


class TokenBucket:
    """client-go flowcontrol.NewTokenBucketRateLimiter analog. Time flows
    through the Clock seam so a FakeClock suite can drive refill
    deterministically (the analyze clock rule's whole point)."""

    def __init__(self, qps: float, burst: int, clock=None):
        from ..utils.clock import Clock

        self.qps = qps
        self.burst = float(burst)
        self.clock = clock or Clock()
        self._tokens = float(burst)
        self._last = self.clock.now()
        self._lock = threading.Lock()

    def take(self) -> None:
        while True:
            with self._lock:
                now = self.clock.now()
                self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            self.clock.sleep(wait)


class ApiStatusError(RuntimeError):
    def __init__(self, code: int, body: dict):
        super().__init__(f"HTTP {code}: {body.get('message', '')}")
        self.code = code
        self.body = body


class HttpKubeClient:
    """KubeCluster-surface client over the Kubernetes REST protocol.

    https:// base URLs speak TLS; `ca_file` pins the server CA and
    `token_file` adds bearer-token auth — together the in-cluster
    serviceaccount credential set (client-go rest.InClusterConfig)."""

    def __init__(
        self,
        base_url: str,
        qps: float = DEFAULT_QPS,
        burst: int = DEFAULT_BURST,
        clock=None,
        ca_file: Optional[str] = None,
        token_file: Optional[str] = None,
    ):
        from ..utils.clock import Clock

        parsed = urlparse(base_url)
        self._host = parsed.hostname or "127.0.0.1"
        self._tls = parsed.scheme == "https"
        self._port = parsed.port or (443 if self._tls else 80)
        self._ssl_context = None
        if self._tls:
            import ssl

            self._ssl_context = ssl.create_default_context(cafile=ca_file)
        self._token_file = token_file
        # same default as KubeCluster: consumers dereference kube.clock.now()
        self.clock = clock or Clock()
        self._limiter = TokenBucket(qps, burst, clock=self.clock)
        self._watch_threads: List[threading.Thread] = []  # one per informer
        self._informers: Dict[str, _Informer] = {}
        self._informers_lock = threading.Lock()
        self._stop = threading.Event()
        self._local = threading.local()  # per-thread persistent connection
        # seeded per client: the jitter must differ BETWEEN informers of one
        # process (each watch loop draws from the shared stream) while tests
        # stay reproducible enough to bound the sleep range
        self._watch_rng = random.Random(0x5EED)

    # -- transport -----------------------------------------------------------

    def _new_connection(self, timeout: float) -> http.client.HTTPConnection:
        if self._tls:
            return http.client.HTTPSConnection(self._host, self._port, timeout=timeout, context=self._ssl_context)
        return http.client.HTTPConnection(self._host, self._port, timeout=timeout)

    def _auth_headers(self) -> Dict[str, str]:
        if self._token_file is None:
            return {}
        try:
            # re-read per request: kubelet rotates projected tokens in place
            with open(self._token_file) as fh:
                return {"Authorization": f"Bearer {fh.read().strip()}"}
        except OSError:
            return {}

    def _connection(self, fresh: bool = False) -> http.client.HTTPConnection:
        conn = None if fresh else getattr(self._local, "conn", None)
        if conn is None:
            conn = self._new_connection(timeout=30)
            self._local.conn = conn
        return conn

    def _request(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        self._limiter.take()
        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json", **self._auth_headers()}
        # keep-alive per thread; one transparent retry on a dead connection
        for attempt in range(2):
            conn = self._connection(fresh=attempt > 0)
            try:
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, ConnectionError, OSError):
                conn.close()
                self._local.conn = None
                if attempt == 0:
                    continue
                raise
            parsed = json.loads(data) if data else {}
            if resp.status >= 400:
                raise ApiStatusError(resp.status, parsed)
            return parsed
        raise RuntimeError("unreachable")

    # -- verbs (KubeCluster surface) ----------------------------------------

    def create(self, obj) -> object:
        wire = to_wire(obj)
        try:
            out = self._request("POST", rest_path(obj.kind, obj.metadata.namespace), wire)
        except ApiStatusError as err:
            if err.code == 409:
                KUBE_CONFLICTS.inc(kind=obj.kind, verb="create")
                raise Conflict(str(err)) from err
            raise
        stored = from_wire(out)
        obj.metadata.resource_version = stored.metadata.resource_version
        obj.metadata.uid = stored.metadata.uid
        obj.metadata.creation_timestamp = stored.metadata.creation_timestamp
        return obj

    RETRY_ON_CONFLICT_ATTEMPTS = RETRY_ON_CONFLICT_ATTEMPTS

    def update(self, obj) -> object:
        wire = to_wire(obj)
        path = rest_path(obj.kind, obj.metadata.namespace, obj.metadata.name)
        for attempt in range(self.RETRY_ON_CONFLICT_ATTEMPTS):
            try:
                out = self._request("PUT", path, wire)
                obj.metadata.resource_version = int(out.get("metadata", {}).get("resourceVersion") or 0)
                return obj
            except ApiStatusError as err:
                if err.code == 404:
                    raise NotFound(str(err)) from err
                if err.code != 409:
                    raise
                KUBE_CONFLICTS.inc(kind=obj.kind, verb="update")
                if attempt == self.RETRY_ON_CONFLICT_ATTEMPTS - 1:
                    # typed exhaustion, never a raw ApiStatusError: callers
                    # dispatch on "every refresh round lost" explicitly
                    raise ConflictExhausted(
                        f"{obj.kind} {obj.metadata.name!r}: conflict retries exhausted"
                        f" after {self.RETRY_ON_CONFLICT_ATTEMPTS} attempts"
                    ) from err
                # RetryOnConflict: refresh the version, resend our state
                try:
                    current = self._request("GET", path)
                except ApiStatusError as get_err:
                    if get_err.code == 404:
                        raise NotFound(str(get_err)) from get_err
                    raise
                wire["metadata"]["resourceVersion"] = current.get("metadata", {}).get("resourceVersion", "0")
        raise RuntimeError("unreachable")

    def update_no_retry(self, obj) -> object:
        """Conditional update: a stale resourceVersion surfaces as Conflict
        instead of being refreshed — the primitive compare-and-swap leader
        election is built on."""
        out = self._conditional_put(obj, "update_no_retry")
        obj.metadata.resource_version = int(out.get("metadata", {}).get("resourceVersion") or 0)
        return obj

    def _conditional_put(self, obj, verb: str, status_only: bool = False) -> dict:
        """PUT `obj` at the resourceVersion it carries (to its /status with
        `status_only`) and return the apiserver's answer; a 409 raises
        Conflict, counted under `verb`."""
        path = rest_path(obj.kind, obj.metadata.namespace, obj.metadata.name) + ("/status" if status_only else "")
        try:
            return self._request("PUT", path, to_wire(obj))
        except ApiStatusError as err:
            if err.code == 404:
                raise NotFound(str(err)) from err
            if err.code == 409:
                KUBE_CONFLICTS.inc(kind=obj.kind, verb=verb)
                raise Conflict(str(err)) from err
            raise

    def retry_on_conflict(
        self,
        kind: str,
        name: str,
        namespace: str,
        mutate: Callable[[object], bool],
        held=None,
        copy_of: Callable[[object], object] = copy.deepcopy,
        status_only: bool = False,
    ):
        """client-go's RetryOnConflict over the wire: apply `mutate` to a
        copy of the object and PUT it with the resourceVersion the copy
        carries (to the object's /status with `status_only`,
        where the apiserver lands the status only). The first attempt
        copies `held`, the caller's object, when there is one (`copy_of`, a
        deep copy unless the caller knows its edit touches less), so a
        write that meets no 409 costs one PUT;
        every other attempt GETs the object anew. On a 409 it tries again,
        up to RETRY_ON_CONFLICT_ATTEMPTS attempts, then raises
        ConflictExhausted. `mutate` returns False when the object needs no
        write. Unlike update(), a field another writer set in between
        survives. `held` gets the state the apiserver returned. Returns the
        written object, or None when `mutate` declined."""
        err: Optional[Conflict] = None
        current = held
        for _ in range(RETRY_ON_CONFLICT_ATTEMPTS):
            if current is None:
                current = candidate = self.get(kind, name, namespace)
                if current is None:
                    raise NotFound(f"{kind} {(namespace, name)} not found")
            else:
                candidate = copy_of(current)
            if not mutate(candidate):
                rebind(held, current)
                return None
            try:
                out = self._conditional_put(candidate, "update", status_only)
            except Conflict as conflict:
                err, current = conflict, None
                continue
            written = from_wire(out, kind)
            rebind(held, written)
            return written
        raise conflict_exhausted(kind, name, err)

    def apply(self, obj) -> object:
        try:
            return self.create(obj)
        except Conflict:
            return self.update(obj)

    def delete(self, obj, grace: bool = True) -> None:
        path = rest_path(obj.kind, obj.metadata.namespace, obj.metadata.name)
        if not grace:
            path += "?gracePeriodSeconds=0"
        try:
            out = self._request("DELETE", path)
        except ApiStatusError as err:
            if err.code == 404:
                return  # idempotent, like KubeCluster.delete
            if err.code == 409:
                # a conflicted delete (injected storms included) must speak
                # the same typed, counted surface the other verbs do
                KUBE_CONFLICTS.inc(kind=obj.kind, verb="delete")
                raise Conflict(str(err)) from err
            raise
        # surface the terminating timestamp on the caller's copy
        dt = out.get("metadata", {}).get("deletionTimestamp")
        if dt is not None:
            from .codec import ts_from_wire

            obj.metadata.deletion_timestamp = ts_from_wire(dt)

    def finalize(self, obj) -> None:
        current = self.get(obj.kind, obj.metadata.name, obj.metadata.namespace)
        if current is None:
            return
        current.metadata.finalizers = []
        try:
            self.update(current)
        except NotFound:
            pass

    def get(self, kind: str, name: str, namespace: str = "default"):
        try:
            return from_wire(self._request("GET", rest_path(kind, namespace, name)), kind)
        except ApiStatusError as err:
            if err.code == 404:
                return None
            raise

    def version(self) -> int:
        """The store's global resourceVersion, read off a LIST envelope —
        the KubeCluster.version() parity surface the coherence witness's
        moved-under-me guard compares before and after a deep compare."""
        out = self._request("GET", rest_path("Node"))
        return int(out.get("metadata", {}).get("resourceVersion") or 0)

    def list(self, kind: str, namespace: Optional[str] = None) -> List[object]:
        _, _, namespaced = API_REGISTRY[kind]
        path = rest_path(kind, namespace or "")
        out = self._request("GET", path)
        items = [from_wire(w, kind) for w in out.get("items", [])]
        if namespace is not None and namespaced:
            items = [o for o in items if o.metadata.namespace == namespace]
        return items

    # -- watches (one shared ListAndWatch informer per kind) ------------------

    def _informer(self, kind: str) -> _Informer:
        """The kind's informer, started by its first user; it runs until
        stop()."""
        with self._informers_lock:
            informer = self._informers.get(kind)
            if informer is None:
                informer = self._informers[kind] = _Informer(kind)
                thread = threading.Thread(target=self._watch_loop, args=(informer,), daemon=True, name=f"watch-{kind.lower()}")
                self._watch_threads.append(thread)
                thread.start()
        return informer

    def watch(self, kind: str, handler: Callable[[WatchEvent], None], replay: bool = True, own_copy: bool = False) -> None:
        """Join the kind's shared informer: `handler` gets each event on a
        thread of its own, after the store's objects as ADDED with `replay`.
        Event objects are the informer's, shared with every handler and
        cached read of the kind; with `own_copy` the handler gets a deep
        copy of each instead, for objects its callers later edit."""
        self._informer(kind).add(handler, replay, own_copy)

    def watcher_count(self) -> int:
        """Live (un-cancelled) watch registrations, not streams — the
        KubeCluster parity seam for the invariant monitor's leaked-watch
        witness."""
        with self._informers_lock:
            informers = list(self._informers.values())
        return sum(len(informer.listeners) for informer in informers)

    def unwatch(self, kind: str, handler: Callable[[WatchEvent], None]) -> None:
        """Cancel the watch registered for (kind, handler), matched by
        identity; the kind's informer and its store go on. The KubeCluster
        parity seam a stopped/crashed Runtime uses to detach its caches."""
        with self._informers_lock:
            informer = self._informers.get(kind)
        if informer is not None:
            informer.remove(handler)

    def _watch_loop(self, informer: _Informer) -> None:
        kind = informer.kind
        rv = 0
        first = True
        attempt = 0  # consecutive reconnect failures (resets on a healthy stream)
        while not self._stop.is_set():
            try:
                if rv == 0:
                    # list to (re)sync, then stream from the list version
                    out = self._request("GET", rest_path(kind))
                    rv = int(out.get("metadata", {}).get("resourceVersion") or 0)
                    informer.resync([from_wire(w, kind) for w in out.get("items", [])], first)
                    if not first:
                        from ..journal import JOURNAL

                        if JOURNAL.enabled:
                            JOURNAL.kube_event(f"watch-{kind.lower()}", "relist", transport="http")
                    first = False
                rv = self._stream(informer, rv)
                attempt = 0  # the stream served (or closed cleanly): healthy
            except Exception as exc:  # noqa: BLE001 - reconnect like an informer
                if self._stop.is_set():
                    return
                # full-jitter backoff (the apiclient retry idiom): every
                # informer of every replica reconnecting to a restarted
                # apiserver on the same 50 ms tick IS the thundering herd
                cap = min(WATCH_BACKOFF_CAP, WATCH_BACKOFF_BASE * (2**attempt))
                attempt += 1
                log.debug("watch %s: reconnecting after %s (attempt %d)", kind, exc, attempt)
                self.clock.sleep(self._watch_rng.uniform(0.0, cap))

    def _stream(self, informer: _Informer, rv: int) -> int:
        kind = informer.kind
        conn = self._new_connection(timeout=300)
        try:
            conn.request("GET", rest_path(kind) + f"?watch=true&resourceVersion={rv}", headers=self._auth_headers())
            resp = conn.getresponse()
            if resp.status == 410:
                return 0  # journal compacted: relist
            if resp.status >= 400:
                raise ApiStatusError(resp.status, {})
            while not self._stop.is_set():
                line = resp.readline()
                if not line:
                    return rv  # server closed: reconnect from rv
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                wire = event["object"]
                rv = int(wire.get("metadata", {}).get("resourceVersion") or rv)
                informer.apply(WatchEvent(event["type"], from_wire(wire, kind)))
            return rv
        finally:
            conn.close()

    # -- cached reads (the informer's store; no request) ----------------------

    def _synced(self, kind: str) -> _Informer:
        """The kind's informer once its first LIST is in the store,
        starting it if none runs. Waits up to CACHE_SYNC_TIMEOUT seconds,
        then raises CacheNotSynced; never sends a request in its place."""
        informer = self._informer(kind)
        waited = 0.0
        while not informer.synced.wait(CACHE_SYNC_POLL):
            waited += CACHE_SYNC_POLL
            if self._stop.is_set() or waited >= CACHE_SYNC_TIMEOUT:
                raise CacheNotSynced(f"{kind}: the informer's first LIST is not in its store after {waited:.2f} s")
        return informer

    def cached_pods(self, namespace: Optional[str] = None) -> List[Pod]:
        """The Pod informer's store, of one namespace or all: what
        list_pods() would return as of the last event decoded, read with
        no request. The objects are the informer's own: read, never edit."""
        informer = self._synced("Pod")
        with informer.lock:
            if namespace is None:
                return list(informer.store.values())
            return list(informer.by_namespace.get(namespace, {}).values())

    def cached_node(self, name: str) -> Optional[Node]:
        """The Node informer's object of that name, or None: get_node() as
        of the last event decoded, read with no request. None also for a
        node whose ADDED the stream has not decoded yet."""
        if not name:
            return None
        informer = self._synced("Node")
        with informer.lock:
            return informer.store.get(("", name))

    def stop(self) -> None:
        self._stop.set()
        with self._informers_lock:
            informers = list(self._informers.values())
        for informer in informers:
            informer.stop()

    # -- typed conveniences (KubeCluster parity) ------------------------------

    def list_pods(self, namespace: Optional[str] = None) -> List[Pod]:
        return self.list("Pod", namespace)

    def list_nodes(self) -> List[Node]:
        return self.list("Node")

    def list_provisioners(self) -> List[Provisioner]:
        return self.list("Provisioner")

    def list_namespaces(self) -> List[Namespace]:
        return self.list("Namespace")

    def get_node(self, name: str) -> Optional[Node]:
        if not name:
            return None
        return self.get("Node", name, namespace="")

    def pods_on_node(self, node_name: str) -> List[Pod]:
        return [p for p in self.list_pods() if p.spec.node_name == node_name]

    def pending_pods(self) -> List[Pod]:
        return [p for p in self.list_pods() if not p.spec.node_name]

    def bind_pod(self, pod: Pod, node_name: str) -> None:
        self._request(
            "POST",
            rest_path("Pod", pod.namespace, pod.name) + "/binding",
            {"apiVersion": "v1", "kind": "Binding", "target": {"kind": "Node", "name": node_name}},
        )
        pod.spec.node_name = node_name
        pod.status.phase = "Running"

    def evict_pod(self, pod: Pod) -> bool:
        try:
            self._request(
                "POST",
                rest_path("Pod", pod.namespace, pod.name) + "/eviction",
                {"apiVersion": "policy/v1", "kind": "Eviction", "metadata": {"name": pod.name, "namespace": pod.namespace}},
            )
            return True
        except ApiStatusError as err:
            if err.code == 429:
                return False
            if err.code == 404:
                return True  # already gone counts as evicted (eviction.go:100-102)
            raise

    # volume topology lookups (scheduling/volumelimits.py protocol)
    def get_persistent_volume_claim(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        return self.get("PersistentVolumeClaim", name, namespace)

    def get_persistent_volume(self, name: str) -> Optional[PersistentVolume]:
        return self.get("PersistentVolume", name, namespace="")

    def get_storage_class(self, name: str) -> Optional[StorageClass]:
        return self.get("StorageClass", name, namespace="")

    def get_csi_node(self, node_name: str) -> Optional[CSINode]:
        return self.get("CSINode", node_name, namespace="")
