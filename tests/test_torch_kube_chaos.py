"""The control-plane fault domain (kube/chaos.py) on the port, held against the
JAX package.

- tests/test_kube_chaos.py as written on the port (a port copy of the module
  through `port_copy`): plan determinism, injection on the in-memory store
  and through the HTTP apiserver, watch gaps, compactions and lease chaos;
- tests/test_kube_recovery.py's fault-plan cases: typed, counted conflict
  exhaustion, the delete conflict over HTTP, one conflict short of
  exhaustion, and the lease CAS loss;
- tests/test_conflict_storm.py's racing writers on both packages, with every
  409 a writer caught counted in `karpenter_kube_conflicts_total`;
- one plan, seed and verb sequence on both packages and both kube transports
  (the in-memory store and the HTTP apiserver behind HttpKubeClient): the
  plan histories are byte-equal, and so are the imperative actions' (watch
  gap, compaction, lease steal) on each transport.
"""

from __future__ import annotations

import json
import threading

import pytest

from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_scheduler_catalog import port_copy
from tests.test_torch_tracing import without

_CHAOS = port_copy("test_kube_chaos")
_clear_plan = _CHAOS._clear_plan
TestPlanDeterminism = _CHAOS.TestPlanDeterminism
TestInMemoryInjection = _CHAOS.TestInMemoryInjection
TestHttpInjection = _CHAOS.TestHttpInjection
TestLeaseChaos = _CHAOS.TestLeaseChaos

_RECOVERY = port_copy("test_kube_recovery")
server = _RECOVERY.server
TestRetryOnConflict = _RECOVERY.TestRetryOnConflict
TestElectorRenewalFailure = without(_RECOVERY.TestElectorRenewalFailure, "test_renewal_failure_transitions_is_leader_false")

SIDES = ("ref", "port")


@pytest.fixture(autouse=True)
def _clear_both_plans():
    """No plan outlives its test, on either package."""
    yield
    import karpenter_tpu.kube.chaos as ref_chaos
    from karpenter_tpu_torch.kube import chaos

    ref_chaos.KUBE_CHAOS.clear()
    chaos.KUBE_CHAOS.clear()


def _package(side: str):
    """(api objects, kube.chaos, kube.cluster, kube.apiserver, kube.client,
    kube.leaderelection) of one package."""
    if side == "ref":
        from karpenter_tpu.api import objects
        from karpenter_tpu.kube import apiserver, chaos, client, cluster, leaderelection
    else:
        from karpenter_tpu_torch.api import objects
        from karpenter_tpu_torch.kube import apiserver, chaos, client, cluster, leaderelection
    return objects, chaos, cluster, apiserver, client, leaderelection


def _node(objects, name: str):
    return objects.Node(
        metadata=objects.ObjectMeta(name=name, namespace=""),
        spec=objects.NodeSpec(),
        status=objects.NodeStatus(capacity={"cpu": 8.0}, allocatable={"cpu": 8.0}),
    )


class _Transport:
    """One package's kube transport: the in-memory store, or an apiserver
    and an HttpKubeClient in front of it. `write` is the conditional write
    each transport's injector sees as the verb "update"."""

    def __init__(self, side: str, transport: str):
        self.objects, self.chaos, cluster, apiserver, client, self.leaderelection = _package(side)
        self.Conflict = cluster.Conflict
        self.transport = transport
        self.server = None
        if transport == "inprocess":
            self.kube = cluster.KubeCluster()
            self.write = self.kube.update
            self.actions = self.kube
        else:
            self.server = apiserver.APIServer().start()
            self.kube = client.HttpKubeClient(self.server.url)
            self.write = self.kube.update_no_retry
            self.actions = self.server.state

    def close(self):
        if self.server is not None:
            self.kube.stop()
            self.server.stop()


SPECS = [
    {"fault": "conflict", "verb": "update", "obj_kind": "Node", "nth": 2, "count": 2},
    {"fault": "conflict", "verb": "create", "obj_kind": "Node", "probability": 0.4},
    {"fault": "stale-read", "verb": "get", "obj_kind": "Node", "probability": 0.5},
    {"fault": "conflict", "verb": "delete", "nth": 1},
]


def _drive_verbs(t: _Transport) -> list:
    """A fixed verb sequence; every branch is taken the same way on every
    transport (a conflict is recorded, never retried), so the injector is
    consulted at the same calls. Returns what each call observed."""
    seen = []
    for i in range(4):
        try:
            t.kube.create(_node(t.objects, f"det-{i}"))
            seen.append("created")
        except t.Conflict:
            seen.append("create-conflict")
    names = [n.metadata.name for n in t.kube.list_nodes()]
    for round_ in range(3):
        for name in sorted(names):
            node = t.kube.get_node(name)
            node.metadata.labels["round"] = str(round_)
            try:
                t.write(node)
                seen.append("written")
            except t.Conflict:
                seen.append("write-conflict")
    for name in sorted(names)[:2]:
        try:
            t.kube.delete(t.kube.get_node(name), grace=False)
            seen.append("deleted")
        except t.Conflict:
            seen.append("delete-conflict")
    return seen


def _run(side: str, transport: str, drive) -> tuple:
    t = _Transport(side, transport)
    plan = t.chaos.KubeFaultPlan.from_specs(SPECS, seed=17)
    try:
        t.chaos.KUBE_CHAOS.install(plan)
        seen = drive(t)
    finally:
        t.chaos.KUBE_CHAOS.clear()
        t.close()
    return seen, json.dumps(plan.history(), sort_keys=True)


def test_one_plan_gives_one_history_on_both_packages_and_both_transports():
    runs = {(side, transport): _run(side, transport, _drive_verbs) for side in SIDES for transport in ("inprocess", "http")}
    histories = {key: history for key, (_seen, history) in runs.items()}
    assert len(set(histories.values())) == 1, histories
    fired = {h["fault"] for h in json.loads(histories["port", "inprocess"])}
    assert fired == {"conflict", "stale-read"}, fired
    for transport in ("inprocess", "http"):
        assert runs["port", transport][0] == runs["ref", transport][0], transport


def _drive_actions(t: _Transport) -> list:
    """The imperative chaos verbs on one transport: a plain gap, a compacted
    gap, and a lease steal; each is recorded into the plan's history."""
    t.kube.create(_node(t.objects, "act-0"))
    t.actions.chaos_watch_gap_begin()
    t.kube.create(_node(t.objects, "act-1"))
    t.actions.chaos_watch_gap_end()
    t.actions.chaos_watch_gap_begin()
    t.kube.create(_node(t.objects, "act-2"))
    t.actions.chaos_compact()
    t.actions.chaos_watch_gap_end()
    if t.transport == "http":
        t.actions.chaos_kill_watches()
    lease = t.objects.Lease(
        metadata=t.objects.ObjectMeta(name="karpenter-leader-election", namespace="kube-system"),
        spec=t.objects.LeaseSpec(holder_identity="holder", lease_duration_seconds=5),
    )
    t.kube.create(lease)
    stolen = t.leaderelection.steal_lease(t.kube, identity="thief")
    return [stolen, sorted(n.metadata.name for n in t.kube.list_nodes())]


@pytest.mark.parametrize("transport", ["inprocess", "http"])
def test_chaos_actions_record_one_history_on_both_packages(transport):
    ref, port = (_run(side, transport, _drive_actions) for side in SIDES)
    assert port == ref
    actions = [h.get("action") for h in json.loads(port[1]) if "action" in h]
    if transport == "http":  # a blackout kills the live streams as it opens
        want = ["watch-gap-begin", "watch-kill", "watch-gap-end", "watch-gap-begin", "watch-kill", "compact", "watch-gap-end", "watch-kill"]
    else:
        want = ["watch-gap-begin", "watch-gap-end", "watch-gap-begin", "compact", "watch-gap-end"]
    assert actions == want + ["lease-steal"]
    assert port[0] == [True, ["act-0", "act-1", "act-2"]]


# -- tests/test_conflict_storm.py::test_racing_rmw_writers_lose_no_updates ---------


@pytest.mark.parametrize("side", SIDES)
def test_racing_writers_count_every_conflict_they_catch(side):
    """Three writers race read-modify-write updates of one node through the
    HTTP apiserver: no update is lost, and every 409 a writer caught is one
    count of karpenter_kube_conflicts_total{verb="update_no_retry"}."""
    objects, chaos, cluster, apiserver, client, _ = _package(side)
    rounds, writers = 25, 3
    srv = apiserver.APIServer().start()
    clients = [client.HttpKubeClient(srv.url) for _ in range(writers)]
    try:
        clients[0].create(_node(objects, "storm-node"))
        caught = [0] * writers
        before = chaos.KUBE_CONFLICTS.value(kind="Node", verb="update_no_retry")

        def writer(idx):
            c = clients[idx]
            for r in range(rounds):
                while True:
                    node = c.get_node("storm-node")
                    node.metadata.labels[f"w{idx}"] = str(r)
                    try:
                        c.update_no_retry(node)
                        break
                    except cluster.Conflict:
                        caught[idx] += 1

        threads = [threading.Thread(target=writer, args=(i,)) for i in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        final = clients[0].get_node("storm-node")
        assert all(final.metadata.labels[f"w{i}"] == str(rounds - 1) for i in range(writers))
        assert sum(caught) > 0, "no 409s observed"
        assert chaos.KUBE_CONFLICTS.value(kind="Node", verb="update_no_retry") - before == sum(caught)
    finally:
        for c in clients:
            c.stop()
        srv.stop()
