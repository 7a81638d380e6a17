"""The port's cluster-state feed held against the JAX package's.

The same seeded kube operations (node create, update and delete, pod bind
and unbind, daemonset pods, a rebind, a resync that marks a journal gap) go
through each package's in-memory API server (kube/cluster.py) into its
cluster-state cache (controllers/state/cluster.py). Both must record the same
delta journal (epochs, node names, kinds) and hold the same nodes
(`nodes_snapshot()`: available and daemonset_requested), in the same order.
"""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_tpu.api.objects import OwnerReference as RefOwnerReference
from karpenter_tpu.controllers.state.cluster import Cluster as RefCluster
from karpenter_tpu.kube.cluster import KubeCluster as RefKubeCluster
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.api.objects import OwnerReference
from karpenter_tpu_torch.controllers.state.cluster import Cluster
from karpenter_tpu_torch.ir import delta
from karpenter_tpu_torch.kube.cluster import DELETED, MODIFIED, KubeCluster
from tests.helpers import make_node as ref_make_node
from tests.helpers import make_pod as ref_make_pod

ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")


class _Side:
    """One package's store and cache, driven by name."""

    def __init__(self, kube, cluster, make_node, make_pod, owner_reference):
        self.kube = kube
        self.cluster = cluster
        self.make_node = make_node
        self.make_pod = make_pod
        self.owner_reference = owner_reference
        self.pods = {}

    def create_node(self, name, zone, cpu):
        self.kube.create(
            self.make_node(
                name=name,
                labels={"karpenter.sh/provisioner-name": "default", "topology.kubernetes.io/zone": zone},
                allocatable={"cpu": cpu, "memory": "64Gi", "pods": 110},
            )
        )

    def update_node(self, name, cpu):
        node = self.kube.get_node(name)
        node.status.allocatable = dict(node.status.allocatable, cpu=float(cpu))
        self.kube.update(node)

    def delete_node(self, name):
        self.kube.delete(self.kube.get_node(name), grace=False)

    def bind(self, pod_name, node_name, cpu, daemon):
        pod = self.make_pod(
            name=pod_name,
            requests={"cpu": cpu, "memory": "256Mi"},
            node_name=node_name,
            phase="Running",
            unschedulable=False,
        )
        if daemon:
            pod.metadata.owner_references = [self.owner_reference(kind="DaemonSet", name="ds")]
        self.kube.create(pod)
        self.pods[pod_name] = pod

    def rebind(self, pod_name, node_name):
        self.kube.bind_pod(self.pods[pod_name], node_name)

    def unbind(self, pod_name):
        self.kube.delete(self.pods.pop(pod_name), grace=False)


def _sides():
    ref_kube, kube = RefKubeCluster(), KubeCluster()
    return (
        _Side(ref_kube, RefCluster(ref_kube, None), ref_make_node, ref_make_pod, RefOwnerReference),
        _Side(kube, Cluster(kube, None), testing.make_node, testing.make_pod, OwnerReference),
    )


def _ops(seed):
    """A seeded operation list, replayed verbatim on both sides."""
    rng = np.random.default_rng(seed)
    nodes, pods, ops = [], [], []
    for i in range(6):
        nodes.append(f"cs-n{i}")
        ops.append(("create_node", nodes[-1], ZONES[i % 3], int(rng.integers(4, 33))))
    for step in range(60):
        r = rng.random()
        if r < 0.35 and nodes:
            name = f"cs-p{step:03d}"
            pods.append(name)
            ops.append(("bind", name, nodes[int(rng.integers(len(nodes)))], float(rng.choice([0.25, 0.5, 1.0])), bool(rng.random() < 0.25)))
        elif r < 0.5 and pods:
            ops.append(("unbind", pods.pop(int(rng.integers(len(pods))))))
        elif r < 0.6 and pods and nodes:
            ops.append(("rebind", pods[int(rng.integers(len(pods)))], nodes[int(rng.integers(len(nodes)))]))
        elif r < 0.72:
            nodes.append(f"cs-n{6 + step}")
            ops.append(("create_node", nodes[-1], ZONES[int(rng.integers(3))], int(rng.integers(4, 33))))
        elif r < 0.82 and nodes:
            ops.append(("update_node", nodes[int(rng.integers(len(nodes)))], int(rng.integers(4, 33))))
        elif r < 0.9 and len(nodes) > 3:
            ops.append(("delete_node", nodes.pop(int(rng.integers(len(nodes))))))
        elif r < 0.93:
            ops.append(("resync",))
    return ops


def _journal(cluster):
    deltas = cluster.delta_journal.deltas_since(cluster.delta_journal._floor)
    return cluster.delta_journal.current_epoch(), [(d.epoch, d.node, d.kind) for d in deltas]


def _snapshot(cluster):
    return [(s.name, dict(s.available), dict(s.daemonset_requested), s.pod_count()) for s in cluster.nodes_snapshot()]


def _apply(side, op):
    if op[0] == "resync":
        side.cluster.resync()
    else:
        getattr(side, op[0])(*op[1:])


@pytest.mark.parametrize("seed", range(4))
def test_the_same_kube_operations_give_the_same_journal_and_nodes(seed):
    ref, port = _sides()
    for n, op in enumerate(_ops(800 + seed)):
        _apply(ref, op)
        _apply(port, op)
        assert _journal(port.cluster) == _journal(ref.cluster), f"op {n} {op}"
    assert _snapshot(port.cluster) == _snapshot(ref.cluster)
    assert port.cluster.synchronized() and ref.cluster.synchronized()


def test_every_kind_of_mutation_names_its_node_in_the_journal():
    _ref, port = _sides()
    journal = port.cluster.delta_journal
    port.create_node("k-a", ZONES[0], 8)
    port.create_node("k-b", ZONES[1], 8)
    mark = journal.current_epoch()
    port.bind("k-p", "k-a", 0.5, daemon=True)
    assert [(d.node, d.kind) for d in journal.deltas_since(mark)] == [("k-a", delta.POD_BOUND)]
    state = {s.name: s for s in port.cluster.nodes_snapshot()}["k-a"]
    assert state.available["cpu"] == 7.5 and state.daemonset_requested["cpu"] == 0.5
    mark = journal.current_epoch()
    port.rebind("k-p", "k-b")
    assert [(d.node, d.kind) for d in journal.deltas_since(mark)] == [("k-a", delta.POD_REMOVED), ("k-b", delta.POD_BOUND)]
    mark = journal.current_epoch()
    port.update_node("k-a", 16)
    port.delete_node("k-b")
    assert [(d.node, d.kind) for d in journal.deltas_since(mark)] == [("k-a", delta.NODE_ADDED), ("k-b", delta.NODE_REMOVED)]
    mark = journal.current_epoch()
    port.cluster.resync()
    assert journal.dirty_since(mark) is None, "a resync re-lists and must void every checkpoint"


def test_a_watch_gap_buffers_then_replays_into_the_journal():
    _ref, port = _sides()
    port.create_node("g-a", ZONES[0], 8)
    journal = port.cluster.delta_journal
    mark = journal.current_epoch()
    port.kube.chaos_watch_gap_begin()
    port.bind("g-p", "g-a", 1.0, daemon=False)
    assert port.kube.chaos_gap_open() and journal.dirty_since(mark) == frozenset()
    port.kube.chaos_watch_gap_end()
    assert journal.dirty_since(mark) == frozenset({"g-a"})
    # a compacted gap relists: MODIFIED for the live, DELETED for the gone
    events = []
    port.kube.watch("Node", lambda e: events.append((e.type, e.obj.name)), replay=False)
    port.kube.chaos_watch_gap_begin()
    port.delete_node("g-a")
    port.kube.chaos_compact()
    port.kube.chaos_watch_gap_end()
    assert events == [(DELETED, "g-a")] and MODIFIED not in {t for t, _ in events}
    assert port.cluster.nodes_snapshot() == []


def test_a_watch_gap_journals_the_same_kube_events_on_both_packages():
    """With the journal on, a watch gap records `watch-gap` when it opens and,
    when it closes after a compaction dropped its events, `relist`; an
    installed kube fault plan records the gap's actions in its history. Both
    packages record the same."""
    import karpenter_tpu.journal as ref_journal
    import karpenter_tpu.kube.chaos as ref_chaos
    from karpenter_tpu_torch import journal
    from karpenter_tpu_torch.kube import chaos

    records = []
    for side, journal_module, chaos_module in zip(_sides(), (ref_journal, journal), (ref_chaos, chaos)):
        JOURNAL, KUBE_CHAOS = journal_module.JOURNAL, chaos_module.KUBE_CHAOS
        JOURNAL.enable()
        JOURNAL.reset()
        KUBE_CHAOS.install(chaos_module.KubeFaultPlan([], seed=3))
        try:
            side.create_node("j-a", ZONES[0], 8)
            side.kube.chaos_watch_gap_begin()  # a plain gap: replayed, no relist
            side.bind("j-p", "j-a", 1.0, daemon=False)
            side.kube.chaos_watch_gap_end()
            side.kube.chaos_watch_gap_begin()  # a compacted gap: relisted
            side.create_node("j-b", ZONES[1], 4)
            side.delete_node("j-a")
            side.kube.chaos_compact()
            side.kube.chaos_watch_gap_end()
            # events() is newest first
            events = [(e["entity"], e["event"], e["attrs"]) for e in reversed(JOURNAL.events(limit=100)) if e["kind"] == "kube"]
            records.append((events, KUBE_CHAOS.plan.history(), [n.node.name for n in side.cluster.nodes_snapshot()]))
        finally:
            KUBE_CHAOS.clear()
            JOURNAL.disable()
            JOURNAL.reset()
    ref, port = records
    assert [e[1] for e in port[0]] == ["watch-gap", "watch-gap", "relist"]
    assert port[0][2][2] == {"transport": "inprocess", "events": 3}  # j-b and j-p live, j-a gone
    assert [h["action"] for h in port[1]] == ["watch-gap-begin", "watch-gap-end", "watch-gap-begin", "compact", "watch-gap-end"]
    assert port[2] == ["j-b"]
    assert port == ref
