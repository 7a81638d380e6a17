"""Cluster state cache: the incremental mirror every solve reads.

Equivalent of pkg/controllers/state/cluster.go — nodes plus pod→node bindings
maintained from watch events, with per-node available resources, daemonset
accounting, host-port/volume usage, a nominated-node TTL cache (so freshly
scheduled pods aren't double-placed before their binding lands), an
anti-affinity pod index, a consolidation-state epoch, and the `synchronized`
guard that blocks provisioning until the cache has caught up with the API
server.

In the dense-solver world this cache is also the source of the ClusterState
matrices ([N, R] available, [N, K] labels) for existing-node fill and
whole-cluster repack, and its delta journal (ir/delta.py) is the feed of the
incremental solve engine (solver/incremental.py).

The port's copy of karpenter_tpu/controllers/state/cluster.py: the lock is a
plain threading.RLock; the lock-order witness and the guarded-by
annotations of the reference are left out. Counting a pod on a node is
StateNode.add_pod, so the provisioner can count the pods a round nominated
on a snapshot.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ...api import labels as lbl
from ...api.objects import Node, Pod
from ...cloudprovider.types import CloudProvider
from ...ir import delta as ir_delta
from ...kube.cluster import ADDED, DELETED, MODIFIED, KubeCluster, WatchEvent
from ...scheduling.hostports import HostPortUsage
from ...scheduling.volumelimits import VolumeCount, VolumeLimits, limits_from_csi_node
from ...utils import pod as podutils
from ...utils import resources as res


# distinguishes "no node prefetch was attempted" from "prefetched, missing"
_NOT_FETCHED = object()


class StateNode:
    def __init__(self, cluster: "Cluster", node: Node):
        self.cluster = cluster
        self.node = node
        self.capacity: Dict[str, float] = dict(node.status.capacity)
        self.allocatable: Dict[str, float] = dict(node.status.allocatable)
        self.available: Dict[str, float] = dict(self.allocatable)
        self.daemonset_requested: Dict[str, float] = {}
        self.daemonset_limits: Dict[str, float] = {}
        self.pod_requests: Dict[str, Dict[str, float]] = {}  # pod key -> requests
        self.pod_limits: Dict[str, Dict[str, float]] = {}
        self.host_port_usage = HostPortUsage()
        self.volume_usage = VolumeLimits(cluster.kube)
        self.volume_limits: VolumeCount = VolumeCount()
        self.marked_for_deletion = False

    @property
    def name(self) -> str:
        return self.node.name

    def owned(self) -> bool:
        return lbl.PROVISIONER_NAME_LABEL in self.node.metadata.labels

    def initialized(self) -> bool:
        return self.node.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) == "true"

    def pod_count(self) -> int:
        return len(self.pod_requests)

    def add_pod(self, pod: Pod) -> None:
        """Count the pod's requests, limits, host ports and volumes on this
        node; a pod already counted here is left as it is."""
        key = _pod_key(pod)
        if key in self.pod_requests:
            return
        requests = res.pod_requests(pod)
        limits = res.pod_limits(pod)
        self.pod_requests[key] = requests
        self.pod_limits[key] = limits
        self.available = res.subtract(self.available, requests)
        if podutils.is_owned_by_daemonset(pod):
            self.daemonset_requested = res.merge(self.daemonset_requested, requests)
            self.daemonset_limits = res.merge(self.daemonset_limits, limits)
        self.host_port_usage.add(pod)
        self.volume_usage.add(pod)

    def snapshot(self) -> "StateNode":
        """Deep-enough copy for a scheduling pass (provisioner.go:139-143):
        trackers the scheduler mutates are copied, the rest shared."""
        out = StateNode.__new__(StateNode)
        out.cluster = self.cluster
        out.node = self.node
        out.capacity = dict(self.capacity)
        out.allocatable = dict(self.allocatable)
        out.available = dict(self.available)
        out.daemonset_requested = dict(self.daemonset_requested)
        out.daemonset_limits = dict(self.daemonset_limits)
        out.pod_requests = {k: dict(v) for k, v in self.pod_requests.items()}
        out.pod_limits = {k: dict(v) for k, v in self.pod_limits.items()}
        out.host_port_usage = self.host_port_usage.copy()
        out.volume_usage = self.volume_usage.copy()
        out.volume_limits = VolumeCount(self.volume_limits)
        out.marked_for_deletion = self.marked_for_deletion
        return out


def _pod_key(pod: Pod) -> str:
    """Namespaced name, the reference's binding key (cluster.go:129,266).
    Keying by name (not uid) makes a same-name recreate displace the stale
    entry, so usage never leaks when the old pod's delete event was missed
    or consolidated away (state suite: 'track pods correctly if we miss
    events or they are consolidated')."""
    return f"{pod.metadata.namespace}/{pod.metadata.name}"


class Cluster:
    def __init__(self, kube: KubeCluster, cloud_provider: Optional[CloudProvider] = None, clock=None, nomination_ttl: float = 20.0):
        from ...utils.clock import Clock

        self.kube = kube
        self.cloud_provider = cloud_provider
        self.clock = clock or kube.clock or Clock()
        self.nomination_ttl = nomination_ttl
        # guards every attribute below; helpers that mutate them run under it
        self._lock = threading.RLock()
        self._nodes: Dict[str, StateNode] = {}
        self._bindings: Dict[str, str] = {}  # pod key -> node name
        self._pods: Dict[str, Pod] = {}  # pod key -> pod (bound pods)
        self._anti_affinity_pods: Dict[str, Pod] = {}
        self._nominated: Dict[str, float] = {}  # node name -> expiry
        self._consolidation_epoch = 0
        self._last_node_deletion = 0.0
        self._last_node_creation = 0.0
        self._node_deletion_seq = 0  # guards the lock-free node prefetch
        # per-node delta feed for the incremental solve engine
        # (solver/incremental.py): every mutation that can change a node's
        # schedulable surface records the node name here. The journal has
        # its own LEAF lock (ir/delta.py) — recording under self._lock is
        # the intended pattern, never the other order
        self.delta_journal = ir_delta.DeltaJournal()
        kube.watch("Node", self._on_node_event)
        kube.watch("Pod", self._on_pod_event)

    def detach(self) -> None:
        """Deregister this cache's watch handlers. Watches dispatch
        synchronously on the mutating thread, so a cache belonging to a
        stopped/crashed Runtime would otherwise keep mirroring (and paying
        for) every write for the life of the KubeCluster."""
        self.kube.unwatch("Node", self._on_node_event)
        self.kube.unwatch("Pod", self._on_pod_event)

    # -- event ingestion -----------------------------------------------------

    def _on_node_event(self, event: WatchEvent) -> None:
        node: Node = event.obj
        with self._lock:
            if event.type == DELETED:
                self._nodes.pop(node.name, None)
                self._last_node_deletion = self.clock.now()
                self._node_deletion_seq += 1
                self.delta_journal.record(node.name, ir_delta.NODE_REMOVED)
                self._bump_epoch()
                return
            self._update_node(node)

    def _update_node(self, node: Node) -> None:
        existing = self._nodes.get(node.name)
        state = StateNode(self, node)
        self._populate_capacity(state)
        self._populate_volume_limits(state)
        state.marked_for_deletion = node.metadata.deletion_timestamp is not None
        # re-apply pod bindings we know about
        for key, node_name in self._bindings.items():
            if node_name == node.name and key in self._pods:
                state.add_pod(self._pods[key])
        if existing is None:
            self._last_node_creation = self.clock.now()
        self._nodes[node.name] = state
        # a refresh dirties the row the same as a launch: labels/allocatable
        # may have changed under it (NODE_ADDED covers first-seen AND reseen)
        self.delta_journal.record(node.name, ir_delta.NODE_ADDED)
        self._bump_epoch()

    def _populate_capacity(self, state: StateNode) -> None:
        """Initialized nodes are trusted verbatim. Uninitialized ones fall
        back to instance-type data — including per-resource restoration of
        extended resources the kubelet zeroes out at startup (upstream #1459,
        cluster.go:203-245): a zero in BOTH capacity and allocatable for a
        resource the instance type advertises means "not registered yet",
        not "absent"."""
        node = state.node
        if state.initialized() or self.cloud_provider is None:
            if not state.available:
                state.available = dict(state.allocatable)
            return
        from ...cloudprovider.types import lookup_instance_type

        it = lookup_instance_type(self.cloud_provider, node, self.kube.list_provisioners())
        if it is None:
            if not state.available:
                state.available = dict(state.allocatable)
            return
        state.capacity = dict(it.resources())
        # restored values are allocatable-equivalent: capacity minus the
        # instance type's kube/system overhead, so the scheduler never packs
        # into the reserved slice the kubelet will claim
        effective = res.clamp_negative_to_zero(res.subtract(it.resources(), it.overhead()))
        allocatable = dict(node.status.allocatable)
        for name, value in effective.items():
            if value > 0 and not node.status.capacity.get(name) and not allocatable.get(name):
                allocatable[name] = value
        state.allocatable = allocatable
        state.available = dict(allocatable)

    def _populate_volume_limits(self, state: StateNode) -> None:
        csi = self.kube.get_csi_node(state.name)
        state.volume_limits = limits_from_csi_node(csi)

    def _on_pod_event(self, event: WatchEvent) -> None:
        pod: Pod = event.obj
        # a binding to a node we haven't seen needs a node fetch; on the HTTP
        # backend that's a network round trip, so do it BEFORE taking the lock
        # (holding it would serialize all state access on apiserver latency)
        prefetched = _NOT_FETCHED
        prefetch_seq = -1
        bound_to = pod.spec.node_name or None
        if bound_to is not None and event.type != DELETED and not podutils.is_terminal(pod):
            with self._lock:
                known = bound_to in self._nodes
                prefetch_seq = self._node_deletion_seq
            if not known:
                prefetched = self.kube.get_node(bound_to)
        with self._lock:
            if event.type == DELETED or podutils.is_terminal(pod):
                self._remove_pod(pod)
                return
            # a node DELETED event processed between the prefetch and now
            # could make the prefetched object resurrect a deleted node
            # (_update_node would re-insert it with no later event to remove
            # it — a ghost consolidation/scheduling could target forever);
            # discard the prefetch and let _update_pod re-fetch under
            # current state
            if prefetched is not _NOT_FETCHED and self._node_deletion_seq != prefetch_seq:
                prefetched = _NOT_FETCHED
            self._update_pod(pod, prefetched)

    def _update_pod(self, pod: Pod, prefetched_node=_NOT_FETCHED) -> None:
        key = _pod_key(pod)
        old_node = self._bindings.get(key)
        new_node = pod.spec.node_name or None
        stored = self._pods.get(key)
        if old_node and (old_node != new_node or (stored is not None and stored.uid != pod.uid)):
            # rebound, or recreated under the same name (uid changed — even on
            # the SAME node): release the old incarnation's accounting and
            # uid-keyed port/volume reservations before applying the new one
            self._remove_pod(pod)
        if new_node is None:
            if podutils.has_required_pod_anti_affinity(pod):
                # pending anti-affinity pods matter once bound; track pod only
                pass
            return
        self._bindings[key] = new_node
        self._pods[key] = pod
        if podutils.has_required_pod_anti_affinity(pod):
            self._anti_affinity_pods[key] = pod
        self.delta_journal.record(new_node, ir_delta.POD_BOUND)
        state = self._nodes.get(new_node)
        if state is None:
            # bound to a node we haven't seen: use the node fetched before the
            # lock — creating the state entry replays this binding too — rather
            # than waiting on a node event that may never come (cluster.go:448-464).
            # Only the rare race where the node entry vanished between the
            # prefetch check and now falls back to a blocking fetch.
            node = prefetched_node if prefetched_node is not _NOT_FETCHED else self.kube.get_node(new_node)
            if node is not None:
                self._update_node(node)
        elif key not in state.pod_requests:
            state.add_pod(pod)
        self._bump_epoch()

    def _remove_pod(self, pod: Pod) -> None:
        key = _pod_key(pod)
        node_name = self._bindings.pop(key, None)
        # release the STORED pod's usage: on a same-name recreate the caller's
        # pod is the new incarnation, but the accounting (and the uid the
        # port/volume trackers keyed on) belongs to the old one
        stored = self._pods.pop(key, pod)
        self._anti_affinity_pods.pop(key, None)
        if node_name is None:
            return
        state = self._nodes.get(node_name)
        if state is not None:
            requests = state.pod_requests.pop(key, None)
            limits = state.pod_limits.pop(key, None)
            if requests is not None:
                state.available = res.merge(state.available, requests)
                if podutils.is_owned_by_daemonset(stored):
                    state.daemonset_requested = res.subtract(state.daemonset_requested, requests)
                    state.daemonset_limits = res.subtract(state.daemonset_limits, limits or {})
            state.host_port_usage.delete_pod(stored.uid)
            state.volume_usage.delete_pod(stored.uid)
        self.delta_journal.record(node_name, ir_delta.POD_REMOVED)
        self._bump_epoch()

    # -- read interface --------------------------------------------------------

    def for_each_node(self, fn: Callable[[StateNode], bool]) -> None:
        with self._lock:
            nodes = sorted(self._nodes.values(), key=lambda s: s.name)
        for state in nodes:
            if not fn(state):
                return

    def nodes_snapshot(self) -> List[StateNode]:
        with self._lock:
            return [state.snapshot() for state in self._nodes.values()]

    def get_state_node(self, name: str) -> Optional[StateNode]:
        with self._lock:
            return self._nodes.get(name)

    def pods_on_node(self, name: str) -> List[Pod]:
        with self._lock:
            return [self._pods[uid] for uid, node in self._bindings.items() if node == name and uid in self._pods]

    def for_pods_with_anti_affinity(self, fn: Callable[[Pod, Optional[Node]], bool]) -> None:
        """Visits each bound pod carrying a required anti-affinity term. Pods
        whose node left the cache are skipped — the node-deletion event can
        arrive before the pod's (cluster.go:124-139)."""
        with self._lock:
            pods = list(self._anti_affinity_pods.values())
        for pod in pods:
            with self._lock:
                node_name = self._bindings.get(_pod_key(pod))
                state = self._nodes.get(node_name) if node_name else None
            if state is None:
                continue
            if not fn(pod, state.node):
                return

    # -- nominations ------------------------------------------------------------

    def nominate_node_for_pod(self, node_name: str) -> None:
        with self._lock:
            self._nominated[node_name] = self.clock.now() + self.nomination_ttl

    def is_node_nominated(self, node_name: str) -> bool:
        with self._lock:
            expiry = self._nominated.get(node_name)
            if expiry is None:
                return False
            if expiry < self.clock.now():
                del self._nominated[node_name]
                # expiry IS a consolidation-relevant state change: a node
                # that was protected is now a candidate. Without the bump,
                # a cluster that settles while its launches are still
                # nominated evaluates consolidation exactly once (against
                # the nomination wall), the epoch never moves again, and
                # post-ramp capacity strands forever — the 4.5x diurnal
                # cost-drift finding
                self._bump_epoch()
                return False
            return True

    # -- consolidation bookkeeping ----------------------------------------------

    def _bump_epoch(self) -> None:
        self._consolidation_epoch += 1

    def consolidation_epoch(self) -> int:
        with self._lock:
            return self._consolidation_epoch

    def last_node_deletion_time(self) -> float:
        with self._lock:
            return self._last_node_deletion

    def last_node_creation_time(self) -> float:
        with self._lock:
            return self._last_node_creation

    # -- restart reconstruction ---------------------------------------------------

    def resync(self) -> int:
        """Rebuild the mirror from a LIST of the API's current state — the
        informer re-list a restarted controller performs after its watches
        are established. Watch registration replays existing objects at
        construction time; this re-list closes the remaining gap (writes
        landing between that replay and the end of runtime assembly, and
        handlers registered replay=False) so a successor process starts
        from the API's truth, not a partial mirror. Idempotent: nodes/pods
        already mirrored are refreshed in place. Returns objects ingested."""
        # a re-list may fold in mutations the watch never delivered (that is
        # its whole point); no incremental reader can enumerate that delta,
        # so invalidate every outstanding checkpoint up front
        self.delta_journal.mark_gap()
        count = 0
        for node in self.kube.list_nodes():
            with self._lock:
                self._update_node(node)
            count += 1
        for pod in self.kube.list_pods():
            if podutils.is_terminal(pod):
                continue
            with self._lock:
                self._update_pod(pod)
            count += 1
        return count

    # -- consistency guard --------------------------------------------------------

    def coherence_view(self) -> Dict[str, dict]:
        """The coherence witness's comparison surface (the JAX package's
        kube/coherence.py; not ported yet):
        node name -> resourceVersion and pod key -> node binding, snapshot
        under one lock hold so the witness deep-compares a CONSISTENT view
        against the authoritative store."""
        with self._lock:
            return {
                "nodes": {
                    name: int(state.node.metadata.resource_version or 0)
                    for name, state in self._nodes.items()
                },
                "bindings": dict(self._bindings),
            }

    def synchronized(self) -> bool:
        """True when every node/bound pod in the API is reflected here —
        the over-provisioning guard (cluster.go:490-510)."""
        with self._lock:
            known_nodes = set(self._nodes)
            known_pods = set(self._bindings)
        for node in self.kube.list_nodes():
            if node.name not in known_nodes:
                return False
        for pod in self.kube.list_pods():
            if pod.spec.node_name and not podutils.is_terminal(pod) and _pod_key(pod) not in known_pods:
                return False
        return True
