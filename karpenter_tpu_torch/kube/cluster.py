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

The port's copy of karpenter_tpu/kube/cluster.py keeps the store, the watch,
the resync list and the watch-gap mechanics. The control-plane fault plan
(injected conflicts and stale reads) and its conflict counters are left out:
chaos injection and telemetry belong to later slices. The store lock is a
plain threading.RLock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

from ..api.objects import CSINode, Namespace, Node, PersistentVolume, PersistentVolumeClaim, Pod, PodDisruptionBudget, StorageClass
from ..api.provisioner import Provisioner

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
    round lost to another writer. Typed so controllers can dispatch on
    exhaustion instead of treating it like a single routine 409."""


class NotFound(RuntimeError):
    pass


def _key(obj) -> tuple:
    return (obj.metadata.namespace, obj.metadata.name)


class KubeCluster:
    def __init__(self, clock=None):
        from ..utils.clock import Clock

        self.clock = clock or Clock()
        self._lock = threading.RLock()
        self._objects: Dict[str, Dict[tuple, object]] = {}
        self._watchers: Dict[str, List[Callable[[WatchEvent], None]]] = {}
        self._version = 0
        # watch-gap state: while a gap is open,
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

    # -- verbs ---------------------------------------------------------------

    def create(self, obj) -> object:
        with self._lock:
            store = self._objects.setdefault(obj.kind, {})
            key = _key(obj)
            if key in store:
                raise Conflict(f"{obj.kind} {key} already exists")
            self._version += 1
            obj.metadata.resource_version = self._version
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self.clock.now()
            store[key] = obj
        self._dispatch(obj.kind, WatchEvent(ADDED, obj))
        return obj

    def update(self, obj) -> object:
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
        with self._lock:
            store = self._objects.setdefault(obj.kind, {})
            key = _key(obj)
            current = store.get(key)
            if current is None:
                raise NotFound(f"{obj.kind} {key} not found")
            if obj.metadata.resource_version not in (0, current.metadata.resource_version):
                raise Conflict(
                    f"{obj.kind} {key}: stale resourceVersion {obj.metadata.resource_version} "
                    f"(current {current.metadata.resource_version})"
                )
            self._version += 1
            obj.metadata.resource_version = self._version
            store[key] = obj
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
            return self._objects.get(kind, {}).get((namespace, name))

    def list(self, kind: str, namespace: Optional[str] = None) -> List[object]:
        with self._lock:
            objs = list(self._objects.get(kind, {}).values())
        if namespace is None:
            return objs
        return [o for o in objs if o.metadata.namespace == namespace]

    # -- watches -------------------------------------------------------------

    def watch(self, kind: str, handler: Callable[[WatchEvent], None], replay: bool = True) -> None:
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

    # -- watch gaps ------------------------------------------------------------

    def chaos_gap_open(self) -> bool:
        """True while a watch gap is suppressing dispatch: a cache behind a
        gapped store is EXPECTED to lag, and is repaired at gap close."""
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

    def chaos_compact(self) -> None:
        """Forced journal compaction inside an open gap: the buffered events
        are gone for good (410 Gone semantics) — closing the gap must relist
        instead of replaying."""
        with self._lock:
            if not self._gap_open:
                return
            self._gap_dropped = True
            self._gap_buffer = []

    def chaos_watch_gap_end(self) -> None:
        """Close the gap: flush the buffered events in order (the reconnect
        replay), or — after a compaction — deliver a synthesized relist diff
        (MODIFIED for every live object, DELETED for objects that vanished
        during the gap), which is exactly what an informer's relist-on-410
        resync delivers. The gap stays OPEN (writes keep buffering) until
        the replay fully drains: were the flag cleared first, a concurrent
        write could dispatch live and then be overwritten by the stale
        replay behind it — delivery order is the informer contract."""
        first = True
        while True:
            with self._lock:
                if not self._gap_open:
                    return
                if first and self._gap_dropped:
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
            for kind, event in deliveries:
                for handler in list(self._watchers.get(kind, [])):
                    handler(event)

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

    def bind_pod(self, pod: Pod, node_name: str) -> None:
        """Bind (schedule) a pod onto a node — the kube-scheduler's verb; the
        test environment uses it the way expectations.ExpectScheduled does."""
        pod.spec.node_name = node_name
        pod.status.phase = "Running"
        # the authoritative bind instant (PodStatus.startTime): watchers
        # measure creation->bind off this stamp, not their dispatch time
        pod.status.start_time = self.clock.now()
        pod.status.conditions = [c for c in pod.status.conditions if c.type != "PodScheduled"]
        self.update(pod)

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
