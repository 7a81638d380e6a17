"""KubeCluster: the in-memory cluster API.

Stand-in for the kube-apiserver + client-go stack the reference builds on:
a keyed object store with synchronous watch dispatch, the field lookups the
controllers need (pods by node, persistent volumes, CSI nodes), and the small
write verbs (bind, evict, patch-like updates). The reference's envtest trick —
nodes are pure API objects, no kubelets, so multi-node behavior is simulated
entirely through the API — carries over directly (SURVEY.md section 4).

Watches dispatch synchronously on the mutating thread, which makes controller
tests deterministic (the reference needs TriggerAndWait plumbing for the same
reason).

The port's copy of karpenter_tpu/kube/cluster.py, with three edits:
`retry_on_conflict`, client-go's RetryOnConflict, mutates a copy and lands
it with a compare-and-swap, so an injected or organic 409 leaves the store
and the event stream as they were (with `status_only` it lands the
copy's status only, as a write to an object's /status does, and keeps the
stored spec); `bind_pod` consults the fault plan
before it edits the stored pod; and `cached_pods` / `cached_node`, the
informer-cache reads of HttpKubeClient, which here read the store (as
watch() takes and ignores HttpKubeClient's `own_copy`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

from ..api.objects import CSINode, Namespace, Node, PersistentVolume, PersistentVolumeClaim, Pod, PodDisruptionBudget, StorageClass
from ..api.provisioner import Provisioner
from .chaos import FAULT_CONFLICT, FAULT_STALE_READ, KUBE_CHAOS, KUBE_CONFLICTS

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass
class WatchEvent:
    type: str
    obj: object


class Conflict(RuntimeError):
    pass


class ConflictExhausted(Conflict):
    """The bounded RetryOnConflict budget ran out: every refresh-and-resend
    round lost to another writer. Typed (and counted through
    `karpenter_kube_conflicts_total`) so controllers can dispatch on
    exhaustion instead of treating it like a single routine 409."""


class NotFound(RuntimeError):
    pass


# attempts of one retry_on_conflict call: the budget the HTTP client's
# update() has had since the reference
RETRY_ON_CONFLICT_ATTEMPTS = 4


def conflict_exhausted(kind: str, name: str, err: Exception) -> ConflictExhausted:
    """The typed error both backends raise when every attempt lost."""
    exhausted = ConflictExhausted(f"{kind} {name!r}: conflict retries exhausted after {RETRY_ON_CONFLICT_ATTEMPTS} attempts")
    exhausted.__cause__ = err
    return exhausted


def rebind(held, current) -> None:
    """Give the caller's object the state of `current`, so a caller that
    goes on with the object it passed sees what the store holds."""
    if held is not None and held is not current:
        vars(held).update(vars(current))


def _unversioned(obj) -> tuple:
    """What the store changes in place without a new resourceVersion."""
    return obj.metadata.deletion_timestamp, tuple(obj.metadata.finalizers)


def _key(obj) -> tuple:
    return (obj.metadata.namespace, obj.metadata.name)


class KubeCluster:
    def __init__(self, clock=None):
        from ..analysis import WITNESS
        from ..utils.clock import Clock

        self.clock = clock or Clock()
        self._lock = WITNESS.rlock("kube.store")
        self._objects: Dict[str, Dict[tuple, object]] = {}
        self._watchers: Dict[str, List[Callable[[WatchEvent], None]]] = {}
        self._version = 0
        # watch-gap chaos state (kube/chaos.py): while a gap is open,
        # dispatch buffers instead of delivering — the synchronous-transport
        # analog of a killed watch stream whose events wait in the server
        # journal until the informer reconnects
        self._gap_open = False
        self._gap_dropped = False
        self._gap_buffer: List[tuple] = []
        self._gap_snapshot: Optional[Dict[str, dict]] = None

    def version(self) -> int:
        """The store's global resourceVersion (the coherence witness's
        moved-under-me guard; HttpKubeClient exposes the same surface)."""
        with self._lock:
            return self._version

    def _chaos(self, verb: str, kind: str):
        """Consult the control-plane fault plan at one verb boundary (a
        single attribute read when no plan is installed). An injected
        conflict is raised — and counted — exactly like an organic one."""
        fault = KUBE_CHAOS.check(verb, kind)
        if fault == FAULT_CONFLICT:
            KUBE_CONFLICTS.inc(kind=kind, verb=verb)
            raise Conflict(f"{kind}: injected conflict storm at verb {verb!r}")
        return fault

    # -- verbs ---------------------------------------------------------------

    def create(self, obj) -> object:
        self._chaos("create", obj.kind)
        with self._lock:
            store = self._objects.setdefault(obj.kind, {})
            key = _key(obj)
            if key in store:
                KUBE_CONFLICTS.inc(kind=obj.kind, verb="create")
                raise Conflict(f"{obj.kind} {key} already exists")
            self._version += 1
            obj.metadata.resource_version = self._version
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self.clock.now()
            store[key] = obj
        self._dispatch(obj.kind, WatchEvent(ADDED, obj))
        return obj

    def update(self, obj) -> object:
        self._chaos("update", obj.kind)
        return self._write(obj)

    def _write(self, obj) -> object:
        """The unconditional store write behind update()."""
        with self._lock:
            store = self._objects.setdefault(obj.kind, {})
            key = _key(obj)
            if key not in store:
                raise NotFound(f"{obj.kind} {key} not found")
            self._version += 1
            obj.metadata.resource_version = self._version
            store[key] = obj
        self._dispatch(obj.kind, WatchEvent(MODIFIED, obj))
        return obj

    def update_no_retry(self, obj) -> object:
        """Conditional update: the write only lands if obj carries the
        resourceVersion currently stored — the compare-and-swap primitive
        leader election requires. (Plain update() keeps last-write-wins.)"""
        return self._compare_and_swap(obj, "update_no_retry")

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
        """client-go's RetryOnConflict: apply `mutate` to a copy of the
        object (`copy_of`, a deep copy unless the caller knows its edit
        touches less) and write the copy only if the store still holds the
        version it was taken from. With `status_only` only the
        copy's status lands, onto the stored object, whose spec and
        metadata stay as stored: the write to the object's status
        subresource. The first attempt copies `held`, the caller's object,
        when there is one, so a write that meets no conflict reads nothing;
        every other attempt reads the object anew. On a conflict it tries again, up to RETRY_ON_CONFLICT_ATTEMPTS
        attempts, then raises ConflictExhausted. `mutate` returns False
        when the object needs no write.

        So a field another writer set in between survives, and a conflict
        (an injected one included) leaves the stored object and the event
        stream as they were. The write is a PUT on the wire, and the fault
        plan sees it at the verb "update", as the apiserver does. The stored
        object is updated in place, so whoever holds it sees the write;
        `held` gets the state the store ends with. Returns the stored
        object when a write landed, None when `mutate` declined."""
        err: Optional[Conflict] = None
        current = held
        for _ in range(RETRY_ON_CONFLICT_ATTEMPTS):
            if current is None:
                current = self.get(kind, name, namespace)
                if current is None:
                    raise NotFound(f"{kind} {(namespace, name)} not found")
            candidate = copy_of(current)
            seen = _unversioned(candidate)
            if not mutate(candidate):
                rebind(held, current)
                return None
            try:
                stored = self._compare_and_swap(candidate, "update", seen, status_only)
            except Conflict as conflict:
                err, current = conflict, None
                continue
            rebind(held, stored)
            return stored
        raise conflict_exhausted(kind, name, err)

    def _compare_and_swap(self, obj, verb: str, seen: Optional[tuple] = None, status_only: bool = False) -> object:
        """The conditional write behind update_no_retry and
        retry_on_conflict: `obj` lands only if the store still holds the
        resourceVersion it carries; else a counted Conflict. A stale read's
        copy (one version behind) loses here.

        update_no_retry's `obj` replaces the stored object, and a
        resourceVersion of 0 writes unconditionally. retry_on_conflict's
        lands onto the stored object in place, and passes `seen`, the
        deletion timestamp and finalizers of the copy it edited: delete()
        and finalize() change those in place without a new resourceVersion,
        so the write also loses when they moved, as it would against an
        apiserver, and cannot undo a deletion. With `status_only` only its
        status lands."""
        self._chaos(verb, obj.kind)
        with self._lock:
            store = self._objects.setdefault(obj.kind, {})
            key = _key(obj)
            current = store.get(key)
            if current is None:
                raise NotFound(f"{obj.kind} {key} not found")
            version = obj.metadata.resource_version
            if seen is None:
                moved = version not in (0, current.metadata.resource_version)
            else:
                moved = version != current.metadata.resource_version or _unversioned(current) != seen
            if moved:
                KUBE_CONFLICTS.inc(kind=obj.kind, verb=verb)
                raise Conflict(
                    f"{obj.kind} {key}: stale resourceVersion {version} "
                    f"(current {current.metadata.resource_version})"
                )
            self._version += 1
            obj.metadata.resource_version = self._version
            if seen is None:
                store[key] = obj
            else:
                if status_only:
                    current.status = obj.status
                    current.metadata.resource_version = self._version
                else:
                    vars(current).update(vars(obj))
                obj = current
        self._dispatch(obj.kind, WatchEvent(MODIFIED, obj))
        return obj

    def apply(self, obj) -> object:
        """create-or-update convenience (like server-side apply)."""
        with self._lock:
            store = self._objects.setdefault(obj.kind, {})
            exists = _key(obj) in store
        return self.update(obj) if exists else self.create(obj)

    def delete(self, obj, grace: bool = True) -> None:
        """Start (or finish) deletion. Objects with finalizers get a deletion
        timestamp and stay until finalizers clear, like the real API."""
        self._chaos("delete", obj.kind)
        with self._lock:
            store = self._objects.get(obj.kind, {})
            key = _key(obj)
            current = store.get(key)
            if current is None:
                return
            if grace and current.metadata.finalizers:
                if current.metadata.deletion_timestamp is None:
                    current.metadata.deletion_timestamp = self.clock.now()
                    event = WatchEvent(MODIFIED, current)
                else:
                    return  # already terminating
            else:
                del store[key]
                event = WatchEvent(DELETED, current)
        self._dispatch(obj.kind, event)

    def finalize(self, obj) -> None:
        """Remove all finalizers; if terminating, the object is removed."""
        with self._lock:
            store = self._objects.get(obj.kind, {})
            key = _key(obj)
            current = store.get(key)
            if current is None:
                return
            current.metadata.finalizers = []
            if current.metadata.deletion_timestamp is not None:
                del store[key]
                event = WatchEvent(DELETED, current)
            else:
                event = WatchEvent(MODIFIED, current)
        self._dispatch(obj.kind, event)

    def get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            current = self._objects.get(kind, {}).get((namespace, name))
        if current is not None and self._chaos("get", kind) == FAULT_STALE_READ:
            import copy

            # serve the read one write behind: a conditional update carrying
            # this copy's resourceVersion loses its CAS, exactly what a
            # lagging apiserver replica would have cost the caller
            stale = copy.deepcopy(current)
            stale.metadata.resource_version = max(0, int(stale.metadata.resource_version or 0) - 1)
            return stale
        return current

    def list(self, kind: str, namespace: Optional[str] = None) -> List[object]:
        with self._lock:
            objs = list(self._objects.get(kind, {}).values())
        if namespace is None:
            return objs
        return [o for o in objs if o.metadata.namespace == namespace]

    # -- watches -------------------------------------------------------------

    def watch(self, kind: str, handler: Callable[[WatchEvent], None], replay: bool = True, own_copy: bool = False) -> None:
        """Register a handler, called on the mutating thread. `own_copy`
        is HttpKubeClient's (a copy of each of its informer's shared
        objects); here every holder shares the store's objects by design,
        and it is ignored."""
        with self._lock:
            self._watchers.setdefault(kind, []).append(handler)
            existing = list(self._objects.get(kind, {}).values()) if replay else []
        for obj in existing:
            handler(WatchEvent(ADDED, obj))

    def watcher_count(self) -> int:
        """Live watch subscriptions across kinds — the invariant monitor's
        leaked-watch witness baselines this at arm time: crash/restart
        cycles are net-zero by contract (every successor attaches exactly
        what its predecessor detached), so growth is a leak."""
        with self._lock:
            return sum(len(handlers) for handlers in self._watchers.values())

    def unwatch(self, kind: str, handler: Callable[[WatchEvent], None]) -> None:
        """Deregister a watch handler. Dispatch is synchronous on the
        mutating thread, so a handler that outlives its owner (a stopped or
        crashed Runtime's state cache) would keep executing on every write
        forever — restartable components must detach what they attach."""
        with self._lock:
            handlers = self._watchers.get(kind)
            if handlers is not None:
                try:
                    handlers.remove(handler)
                except ValueError:
                    pass

    def _dispatch(self, kind: str, event: WatchEvent) -> None:
        with self._lock:
            if self._gap_open:
                # a killed stream's events wait in the server journal; the
                # buffered gap is the synchronous-transport equivalent. A
                # compacted gap drops them — the relist diff repays the debt
                if not self._gap_dropped:
                    self._gap_buffer.append((kind, event))
                return
        for handler in list(self._watchers.get(kind, [])):
            handler(event)

    # -- watch-gap chaos (kube/chaos.py imperative verbs) ----------------------

    def chaos_gap_open(self) -> bool:
        """True while an injected watch gap is suppressing dispatch — the
        coherence witness skips its rounds then: a cache behind a gapped
        store is EXPECTED incoherence, repaired at gap close, not a bug."""
        with self._lock:
            return self._gap_open

    def chaos_watch_gap_begin(self) -> None:
        """Open a watch gap: every dispatch buffers until the gap closes —
        the connection-drop -> reconnect-from-RV path, on the transport with
        no connection to drop. A snapshot of the store is kept so a
        compacted gap can synthesize the relist diff (deletions included)."""
        with self._lock:
            if self._gap_open:
                return
            self._gap_open = True
            self._gap_dropped = False
            self._gap_buffer = []
            self._gap_snapshot = {kind: dict(store) for kind, store in self._objects.items()}
        KUBE_CHAOS.record_action("watch-gap-begin", transport="inprocess")
        from ..journal import JOURNAL

        if JOURNAL.enabled:
            JOURNAL.kube_event("kube-store", "watch-gap", transport="inprocess")

    def chaos_compact(self) -> None:
        """Forced journal compaction inside an open gap: the buffered events
        are gone for good (410 Gone semantics) — closing the gap must relist
        instead of replaying."""
        with self._lock:
            if not self._gap_open:
                return
            self._gap_dropped = True
            self._gap_buffer = []
        KUBE_CHAOS.record_action("compact", transport="inprocess")

    def chaos_watch_gap_end(self) -> None:
        """Close the gap: flush the buffered events in order (the reconnect
        replay), or — after a compaction — deliver a synthesized relist diff
        (MODIFIED for every live object, DELETED for objects that vanished
        during the gap), which is exactly what an informer's relist-on-410
        resync delivers. The gap stays OPEN (writes keep buffering) until
        the replay fully drains: were the flag cleared first, a concurrent
        write could dispatch live and then be overwritten by the stale
        replay behind it — delivery order is the informer contract."""
        dropped = False
        relist_events = 0
        total = 0
        first = True
        while True:
            with self._lock:
                if not self._gap_open:
                    return
                if first and self._gap_dropped:
                    dropped = True
                    snapshot = self._gap_snapshot or {}
                    deliveries = []
                    kinds = set(snapshot) | set(self._objects)
                    for kind in sorted(kinds):
                        current = self._objects.get(kind, {})
                        for obj in current.values():
                            deliveries.append((kind, WatchEvent(MODIFIED, obj)))
                        for key, obj in snapshot.get(kind, {}).items():
                            if key not in current:
                                deliveries.append((kind, WatchEvent(DELETED, obj)))
                    relist_events = len(deliveries)
                    self._gap_dropped = False  # later rounds drain the buffer
                    self._gap_buffer = []
                else:
                    deliveries, self._gap_buffer = self._gap_buffer, []
                if not deliveries:
                    # nothing left to replay and nothing arrived while
                    # replaying: live dispatch may resume
                    self._gap_open = False
                    self._gap_snapshot = None
                    break
                first = False
            total += len(deliveries)
            for kind, event in deliveries:
                for handler in list(self._watchers.get(kind, [])):
                    handler(event)
        KUBE_CHAOS.record_action("watch-gap-end", transport="inprocess", relist=dropped, events=total)
        from ..journal import JOURNAL

        if JOURNAL.enabled and dropped:
            JOURNAL.kube_event("kube-store", "relist", transport="inprocess", events=relist_events)

    # -- typed conveniences ---------------------------------------------------

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

    # the informer-cache reads HttpKubeClient serves from its shared
    # informers' stores; here the store is the cache

    def cached_pods(self, namespace: Optional[str] = None) -> List[Pod]:
        return self.list_pods(namespace)

    def cached_node(self, name: str) -> Optional[Node]:
        return self.get_node(name)

    def bind_pod(self, pod: Pod, node_name: str) -> None:
        """Bind (schedule) a pod onto a node — the kube-scheduler's verb; the
        test environment uses it the way expectations.ExpectScheduled does.
        The fault plan is consulted before the pod is edited, so an injected
        conflict leaves the stored pod and the event stream as they were."""
        self._chaos("update", pod.kind)
        pod.spec.node_name = node_name
        pod.status.phase = "Running"
        # the authoritative bind instant (PodStatus.startTime): watchers
        # measure creation->bind off this stamp, not their dispatch time
        pod.status.start_time = self.clock.now()
        pod.status.conditions = [c for c in pod.status.conditions if c.type != "PodScheduled"]
        self._write(pod)

    def evict_pod(self, pod: Pod) -> bool:
        """Eviction API: respects PDBs; returns False (429 analog) if a
        matching PDB has no disruptions allowed."""
        for pdb in self.list("PodDisruptionBudget", pod.namespace):
            if pdb.selector is not None and pdb.selector.matches(pod.metadata.labels):
                if pdb.disruptions_allowed <= 0:
                    return False
                pdb.disruptions_allowed -= 1
        self.delete(pod, grace=False)
        return True

    # volume topology lookups (scheduling/volumelimits.py protocol)
    def get_persistent_volume_claim(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        return self.get("PersistentVolumeClaim", name, namespace)

    def get_persistent_volume(self, name: str) -> Optional[PersistentVolume]:
        return self.get("PersistentVolume", name, namespace="")

    def get_storage_class(self, name: str) -> Optional[StorageClass]:
        return self.get("StorageClass", name, namespace="")

    def get_csi_node(self, node_name: str) -> Optional[CSINode]:
        return self.get("CSINode", node_name, namespace="")
