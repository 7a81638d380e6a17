"""The port's HTTP kube tier held against the JAX package, case by case.

Each case runs on both packages, written once against an `HKit` (a Kit of
tests/test_torch_provisioning.py with one package's apiserver, client,
Lease elector, state cluster and Runtime). The case's own assertions run
on both sides, and the two records must be equal: what each side saw, and
the server's objects as wire dicts with the volatile fields removed (uid,
resourceVersion, timestamps, Lease holders and times).

- tests/test_kube_backend.py's TestWireProtocol, TestControllersOverHttp,
  TestLeaderElection and TestRuntimeOverHttp;
- tests/test_conflict_storm.py;
- tests/test_kube_recovery.py's stream-close, compaction, backoff-jitter
  and renewal-failure cases (its fault-plan cases are in
  tests/test_torch_kube_chaos.py);
- the port's client against the JAX package's server and the JAX package's
  client against the port's, on one CRUD and watch sequence: the two wires
  are one protocol.

The port's Runtimes run on the CPU. Every wait has a deadline; every
server, client and Runtime a case starts is stopped by the `wire`
fixture's finalizer.
"""

from __future__ import annotations

import copy
import threading
import time

import pytest

from tests.test_torch_provisioning import Kit, reference_singletons  # noqa: F401
from tests.test_torch_runtime import _process_state, reference_auditor_off  # noqa: F401

SIDES = ("ref", "port")


class HKit(Kit):
    """Kit with one package's HTTP kube tier and the controllers on top."""

    def __init__(self, side: str, mode: str = "host"):
        super().__init__(side, mode)
        if side == "ref":
            from karpenter_tpu import runtime
            from karpenter_tpu.config import Config
            from karpenter_tpu.controllers.provisioning import ProvisionerController
            from karpenter_tpu.controllers.state.cluster import Cluster
            from karpenter_tpu.events import Recorder
            from karpenter_tpu.kube import apiserver, client, leaderelection
            from karpenter_tpu.utils import clock, options
        else:
            from karpenter_tpu_torch import runtime
            from karpenter_tpu_torch.config import Config
            from karpenter_tpu_torch.controllers.provisioning import ProvisionerController
            from karpenter_tpu_torch.controllers.state.cluster import Cluster
            from karpenter_tpu_torch.events import Recorder
            from karpenter_tpu_torch.kube import apiserver, client, leaderelection
            from karpenter_tpu_torch.utils import clock, options
        self.runtime, self.Config, self.ProvisionerController = runtime, Config, ProvisionerController
        self.Cluster, self.Recorder, self.apiserver, self.client = Cluster, Recorder, apiserver, client
        self.leaderelection, self.clock, self.options = leaderelection, clock, options

    def node_object(self, name: str, labels=None, cpu: float = 8.0):
        obj = self.obj
        return obj.Node(
            metadata=obj.ObjectMeta(name=name, namespace="", labels=dict(labels or {})),
            spec=obj.NodeSpec(),
            status=obj.NodeStatus(capacity={"cpu": cpu}, allocatable={"cpu": cpu}),
        )


class Wire:
    """Starts servers, clients and Runtimes and stops them all at the end."""

    def __init__(self):
        self._stops = []

    def server(self, k, **kw):
        srv = k.apiserver.APIServer(**kw).start()
        self._stops.append(srv.stop)
        return srv

    def client(self, k, url, **kw):
        c = k.client.HttpKubeClient(url, **kw)
        self._stops.append(c.stop)
        return c

    def runtime(self, k, url, **opts):
        """tests/test_kube_backend.py's TestRuntimeOverHttp._runtime: a
        Runtime over its own client, the exact host loop, four fake types."""
        kube = self.client(k, url, clock=k.clock.Clock())
        options = k.options.Options(batch_max_duration=0.3, batch_idle_duration=0.05, dense_solver_enabled=False, **opts)
        extra = {"device": "cpu"} if k.side == "port" else {}
        rt = k.runtime.Runtime(kube=kube, cloud_provider=k.fake.FakeCloudProvider(k.fake.instance_types(4)), options=options, **extra)

        def stop():
            if not rt._stop.is_set():
                rt.stop()

        self._stops.append(stop)
        return rt

    def close(self):
        for stop in reversed(self._stops):
            stop()
        self._stops.clear()


@pytest.fixture
def wire():
    w = Wire()
    yield w
    w.close()


def eventually(predicate, timeout: float = 10.0, interval: float = 0.05, message: str = "condition"):
    """The envtest Eventually: real watches are asynchronous."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


_VOLATILE_META = ("uid", "resourceVersion", "creationTimestamp")


def scrub(wire_obj: dict) -> dict:
    """A wire dict without what differs between runs: server-minted ids and
    versions, timestamps (a deletionTimestamp kept only as present), and a
    Lease's holder and times."""
    out = copy.deepcopy(wire_obj)
    meta = out.get("metadata") or {}
    for key in _VOLATILE_META:
        meta.pop(key, None)
    if "deletionTimestamp" in meta:
        meta["deletionTimestamp"] = "set"
    for ref in meta.get("ownerReferences") or []:
        ref.pop("uid", None)
    (out.get("status") or {}).pop("startTime", None)
    if out.get("kind") == "Lease":
        spec = out.get("spec") or {}
        for key in ("holderIdentity", "acquireTime", "renewTime"):
            spec.pop(key, None)
    return out


def server_record(srv) -> dict:
    """The server's objects, scrubbed, by kind/namespace/name."""
    state = srv.state
    with state._lock:
        return {f"{k}/{ns}/{n}": scrub(w) for (k, ns, n), w in sorted(state._objects.items())}


def both(scenario, apart=None):
    """`scenario(kit, wire)` on the JAX package, then on the port, each
    with its own servers; the two records must be equal. `apart(record)`,
    where given, splits a record into the part that must be equal and the
    part a deliberate difference sets apart, returned as (ref's, port's)."""
    records = []
    for side in SIDES:
        w = Wire()
        try:
            records.append(scenario(HKit(side), w))
        finally:
            w.close()
    ref, port = records
    if apart is not None:
        (ref, ref_own), (port, port_own) = apart(ref), apart(port)
    assert port == ref
    return port if apart is None else (ref_own, port_own)


def provisioner_spec_apart(record):
    """The stored default Provisioner's spec, out of the server record at
    the end of `record`: the reference's counter writes its status with a
    full admitted update, which defaults the spec; the port's writes
    /status, which keeps the spec as written (ROADMAP, "Deliberate
    differences", was C9)."""
    objects = dict(record[-1])
    stored = dict(objects["Provisioner//default"])
    spec = stored.pop("spec")
    objects["Provisioner//default"] = stored
    return record[:-1] + [objects], spec


# -- tests/test_kube_backend.py: TestWireProtocol ------------------------------


class TestWireProtocol:
    def test_crud_round_trip(self):
        def scenario(k, w):
            srv = w.server(k)
            client = w.client(k, srv.url)
            pod = k.pod(requests={"cpu": "1", "memory": "1Gi"}, labels={"app": "web"})
            client.create(pod)
            assert pod.metadata.resource_version > 0
            fetched = client.get("Pod", pod.name, pod.namespace)
            assert fetched is not None
            assert fetched.metadata.labels == {"app": "web"}
            assert fetched.spec.containers[0].resources.requests["cpu"] == 1.0
            assert fetched is not pod  # decoded copies, not shared references
            fetched.metadata.labels["tier"] = "front"
            client.update(fetched)
            again = client.get("Pod", pod.name, pod.namespace)
            assert again.metadata.labels == {"app": "web", "tier": "front"}
            mid = server_record(srv)
            client.delete(again, grace=False)
            assert client.get("Pod", pod.name, pod.namespace) is None
            return [mid, server_record(srv)]

        both(scenario)

    def test_create_conflict_and_update_not_found(self):
        def scenario(k, w):
            client = w.client(k, w.server(k).url)
            pod = k.pod()
            client.create(pod)
            with pytest.raises(k.kube_module.Conflict):
                client.create(k.make_pod(name=pod.name))
            with pytest.raises(k.kube_module.NotFound):
                client.update(k.make_pod(name="never-created"))
            return pod.name

        both(scenario)

    def test_optimistic_concurrency(self):
        def scenario(k, w):
            srv = w.server(k)
            client = w.client(k, srv.url)
            client.create(k.obj.Node(metadata=k.obj.ObjectMeta(name="n1", namespace="")))
            stale = client.get("Node", "n1", "")
            fresh = client.get("Node", "n1", "")
            fresh.metadata.labels["winner"] = "fresh"
            client.update_no_retry(fresh)
            stale.metadata.labels["winner"] = "stale"
            with pytest.raises(k.kube_module.Conflict):
                client.update_no_retry(stale)
            client.update(stale)  # last-write-wins through RetryOnConflict
            assert client.get("Node", "n1", "").metadata.labels["winner"] == "stale"
            return server_record(srv)

        both(scenario)

    def test_finalizer_lifecycle(self):
        def scenario(k, w):
            srv = w.server(k)
            client = w.client(k, srv.url)
            node = k.obj.Node(metadata=k.obj.ObjectMeta(name="fin", namespace="", finalizers=[k.lbl.TERMINATION_FINALIZER]))
            client.create(node)
            client.delete(node)
            terminating = client.get("Node", "fin", "")
            assert terminating is not None
            assert terminating.metadata.deletion_timestamp is not None
            mid = server_record(srv)
            client.finalize(terminating)
            assert client.get("Node", "fin", "") is None
            return [mid, server_record(srv)]

        both(scenario)

    def test_eviction_subresource_respects_pdb(self):
        def scenario(k, w):
            srv = w.server(k)
            client = w.client(k, srv.url)
            obj = k.obj
            pod = k.pod(labels={"app": "guarded"})
            client.create(pod)
            client.create(
                obj.PodDisruptionBudget(
                    metadata=obj.ObjectMeta(name="guard", namespace="default"),
                    selector=obj.LabelSelector(match_labels={"app": "guarded"}),
                    disruptions_allowed=0,
                )
            )
            assert client.evict_pod(pod) is False  # 429
            assert client.get("Pod", pod.name, pod.namespace) is not None
            pdb = client.get("PodDisruptionBudget", "guard", "default")
            pdb.disruptions_allowed = 1
            client.update(pdb)
            assert client.evict_pod(pod) is True  # 201 + delete
            assert client.get("Pod", pod.name, pod.namespace) is None
            return server_record(srv)

        both(scenario)

    def test_binding_subresource(self):
        def scenario(k, w):
            srv = w.server(k)
            client = w.client(k, srv.url)
            client.create(k.obj.Node(metadata=k.obj.ObjectMeta(name="target", namespace="")))
            pod = k.pod()
            client.create(pod)
            client.bind_pod(pod, "target")
            bound = client.get("Pod", pod.name, pod.namespace)
            assert bound.spec.node_name == "target"
            assert bound.status.phase == "Running"
            return server_record(srv)

        both(scenario)

    def test_watch_streams_all_event_types(self):
        def scenario(k, w):
            client = w.client(k, w.server(k).url)
            events = []
            client.watch("Node", lambda e: events.append((e.type, e.obj.name)))
            client.create(k.obj.Node(metadata=k.obj.ObjectMeta(name="w1", namespace="")))
            eventually(lambda: ("ADDED", "w1") in events, message="ADDED event")
            current = client.get("Node", "w1", "")
            current.metadata.labels["x"] = "y"
            client.update(current)
            eventually(lambda: ("MODIFIED", "w1") in events, message="MODIFIED event")
            client.delete(current, grace=False)
            eventually(lambda: ("DELETED", "w1") in events, message="DELETED event")
            return list(events)

        both(scenario)

    def test_watch_replays_preexisting_state(self):
        def scenario(k, w):
            client = w.client(k, w.server(k).url)
            client.create(k.obj.Node(metadata=k.obj.ObjectMeta(name="pre", namespace="")))
            seen = []
            client.watch("Node", lambda e: seen.append(e.obj.name))
            eventually(lambda: "pre" in seen, message="replayed object")
            return list(seen)

        both(scenario)


# -- one protocol: each package's client against the other's server ----------


def _crud_and_watch(client_kit, srv, w) -> dict:
    """One CRUD and watch sequence through `client_kit`'s client against
    `srv`: what the client decoded, what the watch delivered, and the
    server's objects at the end."""
    k = client_kit
    obj = k.obj
    client = w.client(k, srv.url)
    events = []
    # watch() returns before its informer has listed: a sentinel written
    # first and replayed by that LIST marks the point from which the stream
    # misses no write, so the sequence below never races the informer
    client.create(obj.Node(metadata=obj.ObjectMeta(name="wire-sentinel", namespace="")))
    client.watch("Node", lambda e: events.append((e.type, e.obj.name, dict(e.obj.metadata.labels))))
    eventually(lambda: ("ADDED", "wire-sentinel", {}) in events, message="the watch's initial list")
    client.create(k.make_provisioner())
    pod = k.make_pod(name="wire-pod", requests={"cpu": "1", "memory": "1Gi"}, labels={"app": "web"})
    client.create(pod)
    node = obj.Node(
        metadata=obj.ObjectMeta(name="wire-node", namespace="", labels={k.lbl.PROVISIONER_NAME_LABEL: "default"}),
        status=obj.NodeStatus(capacity={"cpu": 4.0}, allocatable={"cpu": 4.0}),
    )
    client.create(node)
    fetched = client.get("Node", "wire-node", "")
    fetched.metadata.labels["tier"] = "front"
    client.update(fetched)
    client.bind_pod(pod, "wire-node")
    bound = client.get("Pod", "wire-pod", "default")
    provisioner = client.get("Provisioner", "default", "")
    # whichever package serves, objects decode into the client package's classes
    package = k.obj.__name__.split(".")[0] + "."
    for decoded in (bound, bound.spec, bound.spec.containers[0], bound.metadata, provisioner, provisioner.spec):
        assert type(decoded).__module__.startswith(package), type(decoded)
    eventually(lambda: ("MODIFIED", "wire-node", {k.lbl.PROVISIONER_NAME_LABEL: "default", "tier": "front"}) in events, message="the update's event")
    client.delete(fetched, grace=False)
    eventually(lambda: any(e[0] == "DELETED" for e in events), message="the delete's event")
    return {
        "decoded_pod": (bound.spec.node_name, bound.status.phase, bound.metadata.labels, bound.spec.containers[0].resources.requests),
        "decoded_provisioner": (provisioner.name, provisioner.kind),
        "pods": sorted(p.name for p in client.list_pods()),
        "events": list(events),
        "server": server_record(srv),
    }


@pytest.mark.parametrize("client_side,server_side", [("ref", "ref"), ("port", "ref"), ("ref", "port"), ("port", "port")])
def test_each_client_speaks_to_each_server(client_side, server_side, wire):
    """The same sequence gives the same record whichever package serves and
    whichever package's client talks to it; objects cross only as wire
    dicts."""
    record = _crud_and_watch(HKit(client_side), wire.server(HKit(server_side)), wire)
    same = Wire()
    try:
        baseline = _crud_and_watch(HKit("ref"), same.server(HKit("ref")), same)
    finally:
        same.close()
    assert record == baseline


# -- tests/test_kube_backend.py: TestControllersOverHttp -----------------------


def _http_env(k, w, srv):
    """tests/test_kube_backend.py's HttpEnv: a provisioning controller and
    state cluster over their own client."""
    kube = w.client(k, srv.url)
    provider = k.fake.FakeCloudProvider(None)
    cluster = k.Cluster(kube, provider)
    recorder = k.Recorder()
    controller = k.ProvisionerController(kube, cluster, provider, config=k.Config(), recorder=recorder, wait_for_cluster_sync=False)
    return kube, controller, recorder, cluster


class TestControllersOverHttp:
    def test_provisioning_e2e(self):
        def scenario(k, w):
            srv = w.server(k)
            kube, controller, recorder, _ = _http_env(k, w, srv)
            kube.create(k.make_provisioner())
            for _ in range(5):
                kube.create(k.pod(requests={"cpu": "1"}))
            eventually(lambda: len(kube.pending_pods()) == 5, message="pods visible over HTTP")
            controller.trigger_and_wait()
            nodes = eventually(lambda: kube.list_nodes() or None, message="nodes launched")
            assert len(nodes) >= 1
            nominated = sorted(e.object_name for e in recorder.of("NominatePod"))
            assert nominated
            pod = sorted(kube.pending_pods(), key=lambda p: p.name)[0]
            kube.bind_pod(pod, nodes[0].name)
            eventually(lambda: any(p.spec.node_name == nodes[0].name for p in kube.list_pods()), message="binding visible")
            return [nominated, server_record(srv)]

        both(scenario)

    def test_state_cluster_tracks_http_watches(self):
        def scenario(k, w):
            srv = w.server(k)
            kube, _, _, cluster = _http_env(k, w, srv)
            node = k.obj.Node(metadata=k.obj.ObjectMeta(name="tracked", namespace="", labels={k.lbl.PROVISIONER_NAME_LABEL: "default"}))
            node.status.conditions = [k.obj.NodeCondition(type="Ready", status="True")]
            node.status.allocatable = {"cpu": 4.0}
            kube.create(node)

            def known():
                found = []
                cluster.for_each_node(lambda s: found.append(s.name) or True)
                return found if "tracked" in found else None

            return eventually(known, message="state cluster ingests the watch stream")

        both(scenario)


# -- tests/test_kube_backend.py: TestLeaderElection ----------------------------


class TestLeaderElection:
    def test_single_leader_among_candidates(self):
        def scenario(k, w):
            srv = w.server(k)
            a, b = w.client(k, srv.url), w.client(k, srv.url)
            ea = k.leaderelection.LeaseElector(a, "candidate-a", lease_duration=2.0, renew_period=0.1)
            eb = k.leaderelection.LeaseElector(b, "candidate-b", lease_duration=2.0, renew_period=0.1)
            try:
                ea.start()
                eb.start()
                eventually(lambda: ea.is_leader() or eb.is_leader(), message="a leader emerges")
                time.sleep(0.5)  # several renew rounds
                assert ea.is_leader() != eb.is_leader(), "exactly one leader at a time"
                leader, follower = (ea, eb) if ea.is_leader() else (eb, ea)
                leader.stop(release=True)  # the follower takes over without waiting out the lease
                eventually(lambda: follower.is_leader(), timeout=10.0, message="failover")
                lease = a.get("Lease", ea.name, ea.namespace)
                assert lease.spec.holder_identity == follower.identity
                return [lease.spec.lease_transitions, server_record(srv)]
            finally:
                ea.stop(release=False)
                eb.stop(release=False)

        both(scenario)

    def test_expired_lease_is_taken_over(self):
        def scenario(k, w):
            srv = w.server(k)
            a, b = w.client(k, srv.url), w.client(k, srv.url)
            ea = k.leaderelection.LeaseElector(a, "dying", lease_duration=0.3, renew_period=0.05)
            assert ea.try_acquire_or_renew()
            eb = k.leaderelection.LeaseElector(b, "successor", lease_duration=0.3, renew_period=0.05)
            assert not eb.try_acquire_or_renew()  # still held
            time.sleep(0.4)
            assert eb.try_acquire_or_renew()
            lease = b.get("Lease", eb.name, eb.namespace)
            assert lease.spec.holder_identity == "successor"
            assert lease.spec.lease_transitions == 1
            return server_record(srv)

        both(scenario)


# -- tests/test_kube_backend.py: TestRuntimeOverHttp ---------------------------


class TestRuntimeOverHttp:
    def test_runtime_end_to_end_over_http(self):
        def scenario(k, w):
            srv = w.server(k)
            rt = w.runtime(k, srv.url, leader_elect=True)
            driver = w.client(k, srv.url)
            rt.start()
            assert rt.elector.wait_for_leadership(timeout=10)
            driver.create(k.make_provisioner())
            for _ in range(3):
                driver.create(k.pod(requests={"cpu": "0.5"}))
            rt.provision_once()
            nodes = eventually(lambda: driver.list_nodes() or None, message="nodes over HTTP")
            assert len(nodes) >= 1
            lease = driver.get("Lease", "karpenter-leader-election", "kube-system")
            assert lease is not None and lease.spec.holder_identity == rt.elector.identity
            driver.delete(nodes[0])
            rt.reconcile_once()
            eventually(lambda: driver.get_node(nodes[0].name) is None, message="node drained and finalized over HTTP")
            rt.stop()
            released = driver.get("Lease", "karpenter-leader-election", "kube-system")
            assert released.spec.renew_time == 0.0, "stop() releases the Lease in the server"
            # the started batch loop and provision_once() race for the pods,
            # so the node count varies run to run on either package
            return [len(nodes) >= 1, sorted(p.name for p in driver.list_pods()), released.spec.renew_time]

        both(scenario)

    def test_consolidation_end_to_end_over_http(self):
        def scenario(k, w):
            srv = w.server(k)
            rt = w.runtime(k, srv.url, leader_elect=False)
            driver = w.client(k, srv.url)
            rt.cluster.nomination_ttl = 0.2  # let fresh nominations lapse fast
            # nodes launch one at a time, so each pod lands on the same node
            # name in every run (parallel launches name them by arrival)
            rt.provisioner.LAUNCH_WORKERS = 1
            driver.create(k.make_provisioner(consolidation_enabled=True))
            pods = []
            for i in range(2):
                pod = k.make_pod(name=f"work-{i}", requests={"cpu": "3"})
                pod.metadata.owner_references.append(k.obj.OwnerReference(kind="ReplicaSet", name="rs"))
                pods.append(driver.create(pod))
            rt.provision_once()
            nodes = eventually(lambda: driver.list_nodes() or None, message="nodes over HTTP")
            assert len(nodes) == 2, "3-cpu pods cannot share a 4-cpu node"
            for node in nodes:
                node.status.conditions = [k.obj.NodeCondition(type="Ready", status="True")]
                driver.update(node)
            rt.reconcile_once()
            eventually(
                lambda: all(
                    (driver.get_node(n.name) or n).metadata.labels.get(k.lbl.LABEL_NODE_INITIALIZED) == "true" for n in nodes
                ),
                message="nodes initialized over HTTP",
            )
            # the consolidation pass reads the Runtime's Cluster, which sees
            # the server through its watch
            eventually(
                lambda: all((lambda state: state is not None and state.initialized())(rt.cluster.get_state_node(n.name)) for n in nodes),
                message="nodes initialized in the Cluster",
            )
            def counted():
                """The pod keys the Runtime's Cluster counts on each node."""
                return [sorted(rt.cluster.get_state_node(n.name).pod_requests) for n in nodes]

            for pod, node in zip(pods, nodes):
                driver.bind_pod(pod, node.name)
            # the watch delivers in order: both bindings, then the delete;
            # waiting for each keeps the consolidation pass off a half-seen
            # cluster (a node whose pod's delete has not arrived yet)
            eventually(lambda: counted() == [["default/work-0"], ["default/work-1"]], message="both bindings in the Cluster")
            driver.delete(pods[1], grace=False)
            eventually(lambda: counted() == [["default/work-0"], []], message="the delete in the Cluster")
            # the round's nominations lapse one node at a time: a pass that
            # sees only the busy node's lapsed would consolidate it instead
            eventually(lambda: not any(rt.cluster.is_node_nominated(n.name) for n in nodes), message="the nominations lapsed")
            action = eventually(
                lambda: (lambda a: a if a.type.name != "NO_ACTION" else None)(rt.consolidation.process_cluster()),
                message="consolidation action over HTTP",
            )
            assert action.type.name == "DELETE_EMPTY"
            rt.reconcile_once()
            eventually(lambda: len(driver.list_nodes()) == 1 or None, message="empty node consolidated away over HTTP")
            assert driver.get("Pod", "work-0", "default") is not None
            # the provisioner's status counts the nodes the Cluster knows:
            # once the delete has reached it, one more pass settles the count
            gone = [n.name for n in nodes if driver.get_node(n.name) is None]
            eventually(lambda: all(rt.cluster.get_state_node(n) is None for n in gone), message="the node's delete in the Cluster")
            rt.reconcile_once()
            return [action.type.name, gone, server_record(srv)]

        ref_spec, port_spec = both(scenario, apart=provisioner_spec_apart)
        # another client wrote the provisioner with no admission (no webhook is
        # registered in the server): the port's status write keeps its spec
        # as written, the reference's full update defaults the weight
        assert "weight" not in port_spec
        assert ref_spec == {**port_spec, "weight": 0}

    def test_two_runtimes_one_leader(self):
        def scenario(k, w):
            srv = w.server(k)
            rt_a = w.runtime(k, srv.url, leader_elect=True)
            rt_b = w.runtime(k, srv.url, leader_elect=True)
            rt_a.elector.renew_period = rt_b.elector.renew_period = 0.1
            rt_a.elector.start()
            rt_b.elector.start()
            eventually(lambda: rt_a.elector.is_leader() or rt_b.elector.is_leader(), message="leader")
            time.sleep(0.5)
            assert rt_a.elector.is_leader() != rt_b.elector.is_leader(), "two runtime processes must never lead concurrently"
            return server_record(srv)

        both(scenario)


# -- tests/test_conflict_storm.py ----------------------------------------------


ROUNDS = 25
WRITERS = 3


class TestConflictStorm:
    def test_racing_rmw_writers_lose_no_updates(self):
        def scenario(k, w):
            srv = w.server(k)
            seed_client = w.client(k, srv.url)
            seed_client.create(k.node_object("storm-node", labels={"seed": "true"}))
            conflicts = [0] * WRITERS
            errors = []
            clients = [w.client(k, srv.url) for _ in range(WRITERS)]

            def writer(idx: int):
                client = clients[idx]
                try:
                    for round_no in range(ROUNDS):
                        while True:
                            node = client.get_node("storm-node")
                            node.metadata.labels[f"writer-{idx}"] = str(round_no + 1)
                            try:
                                client.update_no_retry(node)
                                break
                            except k.kube_module.Conflict:
                                conflicts[idx] += 1
                                if conflicts[idx] > ROUNDS * WRITERS * WRITERS:
                                    raise AssertionError("unbounded conflict retries: no forward progress")
                except Exception as err:  # noqa: BLE001 - surfaced in the main thread
                    errors.append(err)

            threads = [threading.Thread(target=writer, args=(i,)) for i in range(WRITERS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not errors, errors
            final = seed_client.get_node("storm-node")
            for idx in range(WRITERS):
                assert final.metadata.labels.get(f"writer-{idx}") == str(ROUNDS), final.metadata.labels
            assert sum(conflicts) > 0, "no 409s observed"
            return server_record(srv)

        both(scenario)

    def test_blind_update_retry_resolves_conflicts(self):
        def scenario(k, w):
            srv = w.server(k)
            a, b = w.client(k, srv.url), w.client(k, srv.url)
            a.create(k.node_object("rmw-node", labels={"seed": "true"}))
            node_a = a.get_node("rmw-node")
            node_b = b.get_node("rmw-node")
            node_b.metadata.labels["from-b"] = "1"
            b.update(node_b)
            node_a.metadata.labels["from-a"] = "1"
            a.update(node_a)  # refreshes the version and resends its state
            assert a.get_node("rmw-node").metadata.labels.get("from-a") == "1"
            return server_record(srv)

        both(scenario)

    def test_state_cache_converges_under_storm(self):
        def scenario(k, w):
            srv = w.server(k)
            seed_client = w.client(k, srv.url)
            seed_client.create(k.node_object("storm-node", labels={"seed": "true"}))
            cluster = k.Cluster(w.client(k, srv.url), k.fake.FakeCloudProvider(k.fake.instance_types(3)))
            stop = threading.Event()
            churn_clients = [w.client(k, srv.url) for _ in range(2)]

            def churn(client):
                i = 0
                while not stop.is_set():
                    while True:
                        node = client.get_node("storm-node")
                        node.metadata.labels["churn"] = str(i)
                        try:
                            client.update_no_retry(node)
                            break
                        except k.kube_module.Conflict:
                            continue
                    i += 1

            churners = [threading.Thread(target=churn, args=(c,)) for c in churn_clients]
            for t in churners:
                t.start()
            time.sleep(0.5)
            stop.set()
            for t in churners:
                t.join(timeout=10)
            want = seed_client.get_node("storm-node").metadata.labels.get("churn")

            def converged():
                state = cluster.get_state_node("storm-node")
                return state is not None and state.node.metadata.labels.get("churn") == want

            eventually(converged, timeout=5.0, message="the state cache converges to the final object")
            return sorted(seed_client.get_node("storm-node").metadata.labels)

        both(scenario)


# -- tests/test_kube_recovery.py -----------------------------------------------


class TestKubeRecovery:
    def test_stream_close_resumes_without_replaying_or_losing(self):
        def scenario(k, w):
            srv = w.server(k)
            client = w.client(k, srv.url)
            events = []
            lock = threading.Lock()

            def handler(e):
                with lock:
                    events.append((e.type, e.obj.name))

            client.watch("Node", handler)
            client.create(k.node_object("a"))
            eventually(lambda: events, timeout=5, interval=0.02, message="the first event")
            srv.state.chaos_kill_watches()  # connection drop, journal intact
            client.create(k.node_object("b"))
            eventually(lambda: ("ADDED", "b") in events, timeout=5, interval=0.02, message="the event after the drop")
            with lock:
                assert events.count(("ADDED", "a")) == 1, "reconnect-from-RV must not replay delivered events"
                assert events.count(("ADDED", "b")) == 1, events
                return list(events)

        both(scenario)

    def test_compacted_journal_forces_full_relist(self):
        def scenario(k, w):
            srv = w.server(k)
            client = w.client(k, srv.url)
            doomed = client.create(k.node_object("doomed"))
            events = []
            lock = threading.Lock()

            def handler(e):
                with lock:
                    events.append((e.type, e.obj.name))

            client.watch("Node", handler)
            eventually(lambda: events, timeout=5, interval=0.02, message="the replay")
            srv.state.chaos_watch_gap_begin()  # blackout: no reconnect lands
            writer = w.client(k, srv.url)
            writer.delete(doomed, grace=False)
            writer.create(k.node_object("fresh"))
            srv.state.chaos_compact()  # the gap's events leave the journal
            srv.state.chaos_watch_gap_end()
            eventually(
                lambda: ("DELETED", "doomed") in events and ("ADDED", "fresh") in events,
                timeout=8, interval=0.02, message="the relist diff",
            )
            with lock:
                return list(events)

        both(scenario)

    def test_backoff_sleeps_are_jittered_and_bounded(self):
        def scenario(k, w):
            srv = w.server(k)
            sleeps = []

            class RecordingClock:
                def now(self):
                    return time.monotonic()

                def sleep(self, seconds):
                    sleeps.append(seconds)
                    time.sleep(min(seconds, 0.02))  # compress the wait, keep the record

            client = w.client(k, srv.url, clock=RecordingClock())
            srv.state.chaos_watch_gap_begin()
            client.watch("Node", lambda e: None)
            eventually(lambda: len(sleeps) >= 8, timeout=5, interval=0.02, message="repeated reconnects")
            srv.state.chaos_watch_gap_end()
            client.stop()
            assert all(0.0 <= s <= k.client.WATCH_BACKOFF_CAP for s in sleeps)
            assert len(set(round(s, 6) for s in sleeps)) > 1, f"jitter must vary the sleeps: {sleeps[:8]}"
            # the seeded full-jitter draws: the same schedule on both packages
            return [round(s, 12) for s in sleeps[:8]]

        both(scenario)

    @pytest.mark.parametrize("backend", ["memory", "http"])
    def test_renewal_failure_transitions_is_leader_false(self, backend, wire):
        """A holder whose renew round fails (the kube verbs raise) reports
        is_leader() False within a renew period, and leads again once the
        outage ends; over HTTP too."""

        def scenario(k, w):
            if backend == "memory":
                kube = k.kube_module.KubeCluster()
            else:
                kube = w.client(k, w.server(k).url)
            elector = k.leaderelection.LeaseElector(kube, identity="holder", lease_duration=2.0, renew_period=0.05)
            elector.start()
            try:
                assert elector.wait_for_leadership(timeout=5)
                real_get = kube.get
                outage = threading.Event()

                def failing_get(kind, name, namespace="default"):
                    if outage.is_set() and kind == "Lease":
                        raise ConnectionError("apiserver unreachable")
                    return real_get(kind, name, namespace)

                kube.get = failing_get
                flaps = k.leaderelection.LEADER_FLAPS.value()
                outage.set()
                eventually(lambda: not elector.is_leader(), timeout=5, interval=0.01, message="the step-down")
                outage.clear()
                eventually(lambda: elector.is_leader(), timeout=5, interval=0.01, message="the re-renew")
                return [elector.is_leader(), k.leaderelection.LEADER_FLAPS.value() - flaps]
            finally:
                elector.stop()

        ref, port = [scenario(HKit(side), wire) for side in SIDES]
        assert ref[0] == port[0] is True
        assert ref[1] >= 1 and port[1] >= 1, "each elector counts the lost transition"
