"""The port's shared informer: one ListAndWatch stream per kind, read from.

`karpenter_tpu_torch.kube.client.HttpKubeClient` keeps one informer per
kind (client-go's SharedIndexInformer): the first watch() of a kind starts
its stream, every later watch() joins it, and `cached_pods` / `cached_node`
read its store with no request once its first LIST is in. The JAX
package's client opens a stream per watch() and sends a LIST for every
list. Every case runs against an in-process `kube/apiserver.py` APIServer
on 127.0.0.1; counts and placements are compared exactly, $/hour to 1e-9
relative (the same prices summed in another order).

- one stream for many handlers: four handlers of one kind, one watch
  request counted at the server;
- the informer's behaviour: a late handler's replay, delivery order,
  unwatch by identity, watcher_count, a 410 relist's diff reaching every
  handler, deletes leaving the store, the namespace index, a handler that
  raises, late handlers and readers racing the stream (more threads than
  cores), and a cached read that waits for the first sync and raises
  after its deadline, never sending a request of its own;
- held against the reference (ROADMAP C2): a topology-spread, pod-affinity
  and anti-affinity batch over bound pods in three namespaces, solved by
  both packages over HTTP and in memory: the same placements, node types
  and $/hour. The port's solve sends no request (no Pod LIST from
  `_count_domains`, no Node GET); the reference's sends a Pod LIST per
  group namespace and a Node GET per counted pod;
- read-only: after a Runtime round over HTTP with the journal and the SLO
  accountant on, every cached object equals a fresh decode of its wire
  form;
- the pod scraper over HTTP: the same gauge series as the reference's, with
  no request.

Every server, client and Runtime a case starts is stopped.
"""

from __future__ import annotations

import importlib
import threading
import time
import types
from collections import Counter

import pytest

from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_runtime import _process_state, reference_auditor_off  # noqa: F401

SIDES = ("ref", "port")
ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")
NAMESPACES = ("alpha", "beta", "gamma")


def _pkg(side: str) -> types.SimpleNamespace:
    root = "karpenter_tpu" if side == "ref" else "karpenter_tpu_torch"

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    helpers = importlib.import_module("tests.helpers") if side == "ref" else mod("testing")
    return types.SimpleNamespace(
        side=side,
        objects=mod("api.objects"),
        lbl=mod("api.labels"),
        apiserver=mod("kube.apiserver"),
        client=mod("kube.client"),
        cluster=mod("kube.cluster"),
        codec=mod("kube.codec"),
        fake=mod("cloudprovider.fake"),
        scheduler=mod("scheduler"),
        state=mod("controllers.state.cluster"),
        pod_metrics=mod("controllers.metrics.pod"),
        metrics=mod("metrics"),
        make_pod=helpers.make_pod,
        make_node=helpers.make_node,
        make_provisioner=helpers.make_provisioner,
    )


PORT = _pkg("port")


class _Stops:
    def __init__(self):
        self._stops = []

    def add(self, stop):
        self._stops.append(stop)
        return stop

    def close(self):
        for stop in reversed(self._stops):
            stop()


@pytest.fixture
def stops():
    s = _Stops()
    yield s
    s.close()


def _server(p, stops):
    srv = p.apiserver.APIServer().start()
    stops.add(srv.stop)
    return srv


def _client(p, url, stops, **kw):
    c = p.client.HttpKubeClient(url, **kw)
    stops.add(c.stop)
    return c


def eventually(predicate, timeout: float = 10.0, interval: float = 0.02, message: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


class RequestLog:
    """Every request a client sends through its one request path, with the
    sending thread's name: (thread, method, path)."""

    def __init__(self, client):
        self.entries = []
        self._lock = threading.Lock()
        request = client._request

        def logged(method, path, body=None):
            with self._lock:
                self.entries.append((threading.current_thread().name, method, path.split("?")[0]))
            return request(method, path, body)

        client._request = logged

    def of_thread(self, name: str) -> list:
        with self._lock:
            return [(m, path) for t, m, path in self.entries if t == name]

    def count(self, method: str, path: str) -> int:
        with self._lock:
            return sum(1 for _t, m, p in self.entries if (m, p) == (method, path))


def _count_subscribes(srv) -> Counter:
    """Watch requests the server accepted, by kind."""
    opened: Counter = Counter()
    subscribe = srv.state.subscribe

    def counted(kind, since_rv):
        out = subscribe(kind, since_rv)
        opened[kind] += 1
        return out

    srv.state.subscribe = counted
    return opened


def _pod(name: str, namespace: str = "default", **kw):
    return PORT.make_pod(name=name, namespace=namespace, requests={"cpu": "0.5"}, **kw)


def _recorder(log: list, lock: threading.Lock):
    def handler(event):
        with lock:
            log.append((event.type, event.obj.metadata.name))

    return handler


# -- one stream for many handlers ------------------------------------------------


def test_four_handlers_of_one_kind_share_one_stream(stops):
    srv = _server(PORT, stops)
    opened = _count_subscribes(srv)
    client = _client(PORT, srv.url, stops)
    requests = RequestLog(client)
    writer = _client(PORT, srv.url, stops)
    lock = threading.Lock()
    seen = [[] for _ in range(4)]
    objects = [[] for _ in range(4)]
    for i in range(4):
        def handler(event, i=i):
            with lock:
                seen[i].append((event.type, event.obj.metadata.name))
                objects[i].append(event.obj)

        client.watch("Pod", handler)
    for i in range(3):
        writer.create(_pod(f"p{i}"))
    eventually(lambda: all(len(s) == 3 for s in seen), message="three events at each handler")
    assert opened == Counter({"Pod": 1}), opened
    assert requests.count("GET", "/api/v1/pods") == 1, "one LIST, the informer's"
    assert client.watcher_count() == 4
    with lock:
        assert seen[0] == [("ADDED", f"p{i}") for i in range(3)]
        assert all(s == seen[0] for s in seen)
        # one decode per event: every handler holds the same object
        assert all(a is b for col in zip(*objects) for a, b in zip(col, col[1:]))
    assert len([t for t in client._watch_threads if t.is_alive()]) == 1


# -- the informer's behaviour ----------------------------------------------------


def test_late_handler_replays_the_store_then_sees_each_event_in_order(stops):
    srv = _server(PORT, stops)
    opened = _count_subscribes(srv)
    client = _client(PORT, srv.url, stops)
    writer = _client(PORT, srv.url, stops)
    lock = threading.Lock()
    first, late, future = [], [], []
    writer.create(_pod("pre"))
    client.watch("Pod", _recorder(first, lock))
    eventually(lambda: ("ADDED", "pre") in first, message="the first LIST's replay")
    writer.create(_pod("before-late"))
    eventually(lambda: ("ADDED", "before-late") in first, message="the streamed ADDED")
    client.watch("Pod", _recorder(late, lock))  # replay=True: the store, as ADDED
    client.watch("Pod", _recorder(future, lock), replay=False)
    with lock:
        assert sorted(late) == [("ADDED", "before-late"), ("ADDED", "pre")]
        assert future == []
    pod = writer.get("Pod", "pre", "default")
    pod.metadata.labels["tier"] = "front"
    writer.update(pod)
    writer.delete(pod, grace=False)
    tail = [("MODIFIED", "pre"), ("DELETED", "pre")]
    eventually(lambda: first[-2:] == tail and late[-2:] == tail and future == tail, message="the update and the delete at every handler")
    with lock:
        assert first == [("ADDED", "pre"), ("ADDED", "before-late")] + tail
        assert late[2:] == tail
    assert opened == Counter({"Pod": 1})
    assert client.watcher_count() == 3


def test_unwatch_matches_by_identity_and_the_stream_goes_on(stops):
    srv = _server(PORT, stops)
    opened = _count_subscribes(srv)
    client = _client(PORT, srv.url, stops)
    writer = _client(PORT, srv.url, stops)
    lock = threading.Lock()
    kept, dropped = [], []

    class Holder:
        def on_event(self, event):
            with lock:
                dropped.append(event.obj.metadata.name)

    holder = Holder()
    keep = _recorder(kept, lock)
    client.watch("Pod", keep)
    client.watch("Pod", holder.on_event)
    client.watch("Node", keep)
    assert client.watcher_count() == 3  # registrations, not streams
    # a bound method is a new object at each access: the reference's
    # identity match leaves its registration in place
    client.unwatch("Pod", holder.on_event)
    assert client.watcher_count() == 3
    writer.create(_pod("a"))
    eventually(lambda: "a" in dropped, message="the bound method still registered")
    registered = client._informers["Pod"].listeners[1].handler
    client.unwatch("Pod", registered)
    assert client.watcher_count() == 2
    writer.create(_pod("b"))
    eventually(lambda: ("ADDED", "b") in kept, message="the kept handler's event")
    with lock:
        assert dropped == ["a"]
    # the informer outlives its handlers: the store stays current
    client.unwatch("Pod", keep)
    assert client.watcher_count() == 1
    writer.create(_pod("c"))
    eventually(lambda: len(client.cached_pods()) == 3, message="the store after every unwatch")
    assert opened == Counter({"Pod": 1, "Node": 1})


def test_a_relist_after_410_sends_the_diff_to_every_handler(stops):
    srv = _server(PORT, stops)
    opened = _count_subscribes(srv)
    client = _client(PORT, srv.url, stops)
    requests = RequestLog(client)
    writer = _client(PORT, srv.url, stops)
    doomed = writer.create(_pod("doomed"))
    writer.create(_pod("kept"))
    lock = threading.Lock()
    replayed, live = [], []
    client.watch("Pod", _recorder(replayed, lock))
    client.watch("Pod", _recorder(live, lock), replay=False)
    eventually(lambda: len(replayed) == 2, message="the replay")
    srv.state.chaos_watch_gap_begin()  # the stream killed, re-subscribes refused
    writer.delete(doomed, grace=False)
    writer.create(_pod("fresh"))
    kept = writer.get("Pod", "kept", "default")
    kept.metadata.labels["moved"] = "yes"
    writer.update(kept)
    srv.state.chaos_compact()  # the gap's events leave the journal: 410 on reconnect
    srv.state.chaos_watch_gap_end()
    diff = {("DELETED", "doomed"), ("ADDED", "fresh"), ("MODIFIED", "kept")}
    eventually(lambda: diff <= set(replayed) and diff <= set(live), timeout=10, message="the relist diff at both handlers")
    with lock:
        assert sorted(live) == sorted(diff)
        assert sorted(replayed[2:]) == sorted(diff)
    assert requests.count("GET", "/api/v1/pods") == 2, "the first LIST and one relist"
    assert {p.name: p.metadata.labels.get("moved") for p in client.cached_pods()} == {"fresh": None, "kept": "yes"}
    assert opened["Pod"] >= 2  # the first stream and the one after the relist


def test_the_store_indexes_namespaces_and_names_and_drops_deletes(stops):
    srv = _server(PORT, stops)
    client = _client(PORT, srv.url, stops)
    writer = _client(PORT, srv.url, stops)
    for ns in NAMESPACES:
        for i in range(2):
            writer.create(_pod(f"{ns}-{i}", namespace=ns))
    for i in range(2):
        writer.create(PORT.make_node(name=f"n{i}", allocatable={"cpu": "4"}))
    assert sorted(p.name for p in client.cached_pods("beta")) == ["beta-0", "beta-1"]
    assert len(client.cached_pods()) == 6
    assert client.cached_pods("nowhere") == []
    assert client.cached_node("n1").name == "n1"
    assert client.cached_node("missing") is None and client.cached_node("") is None
    writer.delete(writer.get("Pod", "beta-0", "beta"), grace=False)
    writer.delete(writer.get("Pod", "gamma-0", "gamma"), grace=False)
    writer.delete(writer.get("Pod", "gamma-1", "gamma"), grace=False)
    writer.delete(writer.get_node("n1"), grace=False)
    eventually(lambda: len(client.cached_pods()) == 3 and client.cached_node("n1") is None, message="the deletes")
    assert [p.name for p in client.cached_pods("beta")] == ["beta-1"]
    assert client.cached_pods("gamma") == []
    informer = client._informers["Pod"]
    assert "gamma" not in informer.by_namespace
    assert sorted(informer.store) == [("alpha", "alpha-0"), ("alpha", "alpha-1"), ("beta", "beta-1")]
    # a pod recreated under its name is the new incarnation
    writer.create(_pod("beta-0", namespace="beta"))
    eventually(lambda: len(client.cached_pods("beta")) == 2, message="the recreate")
    assert informer.store[("beta", "beta-0")].uid == writer.get("Pod", "beta-0", "beta").uid


def test_a_handler_that_raises_ends_neither_the_stream_nor_the_others(stops):
    srv = _server(PORT, stops)
    opened = _count_subscribes(srv)
    client = _client(PORT, srv.url, stops)
    requests = RequestLog(client)
    writer = _client(PORT, srv.url, stops)
    lock = threading.Lock()
    good, bad = [], []

    def raising(event):
        with lock:
            bad.append(event.obj.metadata.name)
        if event.obj.metadata.name.startswith("boom"):
            raise RuntimeError("a handler's fault")

    client.watch("Pod", raising)
    client.watch("Pod", _recorder(good, lock))
    for name in ("ok-1", "boom-1", "ok-2", "boom-2", "ok-3"):
        writer.create(_pod(name))
    eventually(lambda: len(good) == 5 and len(bad) == 5, message="every event at both handlers")
    with lock:
        assert [n for _t, n in good] == ["ok-1", "boom-1", "ok-2", "boom-2", "ok-3"]
        assert bad == ["ok-1", "boom-1", "ok-2", "boom-2", "ok-3"], "each event once, none replayed"
    assert client._informers["Pod"].handler_errors == 2
    assert opened == Counter({"Pod": 1}), "no reconnect"
    assert requests.count("GET", "/api/v1/pods") == 1, "no relist"


def test_a_slow_handler_holds_back_neither_the_store_nor_the_others(stops):
    """Each handler has its own queue and thread: while one is blocked in
    its first event, the store and another handler take in every later
    one; once released it gets them all, in order, once."""
    srv = _server(PORT, stops)
    client = _client(PORT, srv.url, stops)
    writer = _client(PORT, srv.url, stops)
    lock = threading.Lock()
    release = threading.Event()
    stops.add(release.set)
    slow, fast = [], []

    def blocked(event):
        release.wait(20)
        with lock:
            slow.append((event.type, event.obj.metadata.name))

    client.watch("Pod", blocked)
    client.watch("Pod", _recorder(fast, lock))
    names = [f"q{i:02d}" for i in range(20)]
    for name in names:
        writer.create(_pod(name))
    eventually(lambda: len(client.cached_pods()) == len(names) and len(fast) == len(names), message="the store and the free handler")
    with lock:
        assert slow == [], "the blocked handler is still in its first event"
    release.set()
    eventually(lambda: len(slow) == len(names), message="the blocked handler's backlog")
    with lock:
        assert slow == fast == [("ADDED", name) for name in names]


def test_late_handlers_and_readers_racing_the_stream_miss_and_repeat_nothing(stops):
    """More threads than cores, a short switch interval: handlers join
    while every pod is updated. Each ends with each pod ADDED once and at
    its last version (a replay delivered after a later event would leave it
    stale), and readers always see the whole store."""
    import os
    import sys

    srv = _server(PORT, stops)
    client = _client(PORT, srv.url, stops)
    writer = _client(PORT, srv.url, stops)
    names = [f"s{i:03d}" for i in range(150)]
    for name in names:
        writer.create(_pod(name))
    eventually(lambda: len(client.cached_pods()) == len(names), message="the first LIST")
    workers = min(32, (os.cpu_count() or 4) + 2)
    lock = threading.Lock()
    views = [{} for _ in range(workers)]
    added = [Counter() for _ in range(workers)]
    errors = []
    done = threading.Event()

    def join_late(i):
        def handler(event):
            with lock:
                views[i][event.obj.metadata.name] = event.obj.metadata.labels.get("v")
                added[i][event.obj.metadata.name] += event.type == "ADDED"

        time.sleep(0.02 * i)  # joins spread over the updates
        client.watch("Pod", handler)

    def read():
        while not done.is_set():
            try:
                size = len(client.cached_pods())
            except Exception as exc:  # noqa: BLE001 - the test's evidence
                errors.append(repr(exc))
                return
            if size != len(names):
                errors.append(f"a read saw {size} pods")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=join_late, args=(i,), daemon=True) for i in range(workers)]
        threads += [threading.Thread(target=read, daemon=True) for _ in range(workers)]
        for t in threads:
            t.start()
        for name in names:
            pod = writer.get("Pod", name, "default")
            pod.metadata.labels["v"] = "1"
            writer.update(pod)
        final = {name: "1" for name in names}
        eventually(lambda: all(view == final for view in views), timeout=30, message="every pod at its last version at every handler")
        done.set()
        for t in threads:
            t.join(timeout=10)
    finally:
        sys.setswitchinterval(interval)
        done.set()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    with lock:
        assert all(counts == Counter({name: 1 for name in names}) for counts in added)


class _HeldList:
    """Hold the server's Pod LIST until released, so an informer cannot
    sync."""

    def __init__(self, srv):
        self.release = threading.Event()
        listing = srv.state.list

        def held(kind, namespace):
            if kind == "Pod":
                self.release.wait(20)
            return listing(kind, namespace)

        srv.state.list = held


def test_a_cached_read_waits_for_the_first_list(stops):
    srv = _server(PORT, stops)
    writer = _client(PORT, srv.url, stops)
    for i in range(3):
        writer.create(_pod(f"p{i}"))
    held = _HeldList(srv)
    client = _client(PORT, srv.url, stops)
    requests = RequestLog(client)
    out = []
    reader = threading.Thread(target=lambda: out.append(client.cached_pods()), name="reader", daemon=True)
    reader.start()
    time.sleep(0.3)
    assert not out and reader.is_alive(), "a read before the first LIST is in must wait"
    held.release.set()
    reader.join(timeout=10)
    assert not reader.is_alive()
    assert sorted(p.name for p in out[0]) == ["p0", "p1", "p2"]
    assert requests.of_thread("reader") == [], "the read itself sends no request"
    assert requests.count("GET", "/api/v1/pods") == 1


def test_a_cached_read_raises_after_its_deadline_and_never_lists(stops, monkeypatch):
    srv = _server(PORT, stops)
    held = _HeldList(srv)
    client = _client(PORT, srv.url, stops)
    stops.add(held.release.set)  # let the informer's LIST end before the server stops
    requests = RequestLog(client)
    monkeypatch.setattr(PORT.client, "CACHE_SYNC_TIMEOUT", 0.3)
    t0 = time.monotonic()
    with pytest.raises(PORT.client.CacheNotSynced):
        client.cached_pods()
    waited = time.monotonic() - t0
    assert 0.3 <= waited < 5.0, waited
    with pytest.raises(PORT.client.CacheNotSynced):
        client.cached_pods("default")
    assert requests.of_thread(threading.current_thread().name) == [], "no LIST in place of the cache"
    assert requests.count("GET", "/api/v1/pods") == 1, "the informer's LIST alone"
    # in memory the store is the cache: the same reads, no wait
    kube = PORT.cluster.KubeCluster()
    kube.create(_pod("mem"))
    kube.create(PORT.make_node(name="m0", allocatable={"cpu": "1"}))
    assert [p.name for p in kube.cached_pods("default")] == ["mem"] and kube.cached_node("m0").name == "m0"


# -- held against the reference (ROADMAP C2) ------------------------------------


def _node(p, name: str, zone: str):
    lbl = p.lbl
    labels = {
        lbl.PROVISIONER_NAME_LABEL: "default",
        lbl.LABEL_INSTANCE_TYPE: "standing-4x16",
        lbl.LABEL_TOPOLOGY_ZONE: zone,
        lbl.LABEL_CAPACITY_TYPE: "on-demand",
        lbl.LABEL_HOSTNAME: name,
    }
    return p.make_node(name=name, labels=labels, allocatable={"cpu": "4", "memory": "16Gi", "pods": "110"})


# (name, namespace, labels, node): the bound pods the topology counts
BOUND = (
    ("web-0", "alpha", {"app": "web"}, "z1-a"),
    ("web-1", "alpha", {"app": "web"}, "z1-b"),
    ("web-2", "alpha", {"app": "web"}, "z2-a"),
    ("cache-0", "beta", {"app": "cache"}, "z2-b"),
    ("cache-1", "beta", {"app": "cache"}, "z2-b"),
    ("db-0", "gamma", {"app": "db"}, "z1-a"),
    ("db-1", "gamma", {"app": "db"}, "z3-a"),
    ("db-2", "beta", {"app": "db"}, "z2-a"),
)


def _cluster_objects(p) -> list:
    nodes = [_node(p, f"z{z + 1}-{s}", zone) for z, zone in enumerate(ZONES) for s in "ab"]
    bound = [
        p.make_pod(name=name, namespace=ns, labels=labels, requests={"cpu": "0.5"}, node_name=node, phase="Running", unschedulable=False)
        for name, ns, labels, node in BOUND
    ]
    return nodes + bound


def _batch(p) -> list:
    obj, lbl = p.objects, p.lbl
    spread = obj.TopologySpreadConstraint(max_skew=1, topology_key=lbl.LABEL_TOPOLOGY_ZONE, label_selector=obj.LabelSelector(match_labels={"app": "web"}))
    near_cache = obj.PodAffinityTerm(topology_key=lbl.LABEL_TOPOLOGY_ZONE, label_selector=obj.LabelSelector(match_labels={"app": "cache"}))
    # a term over two namespaces: one group, two namespaces counted
    apart = obj.PodAffinityTerm(topology_key=lbl.LABEL_HOSTNAME, label_selector=obj.LabelSelector(match_labels={"app": "db"}), namespaces=["gamma", "beta"])
    pods = [p.make_pod(name=f"new-web-{i}", namespace="alpha", labels={"app": "web"}, requests={"cpu": "1"}, topology_spread_constraints=[spread]) for i in range(7)]
    pods += [p.make_pod(name=f"new-api-{i}", namespace="beta", labels={"app": "api"}, requests={"cpu": "1"}, pod_requirements=[near_cache]) for i in range(3)]
    pods += [p.make_pod(name=f"new-db-{i}", namespace="gamma", labels={"app": "db"}, requests={"cpu": "1"}, pod_anti_requirements=[apart]) for i in range(5)]
    return pods


def _solve(p, kube, cluster) -> tuple:
    """build_scheduler(...).solve of the batch on `kube` and the state
    cluster's nodes, with the exact host loop: (outcome, group namespaces
    the topology counted)."""
    provider = p.fake.FakeCloudProvider(p.fake.instance_types(20))
    pods = _batch(p)
    scheduler = p.scheduler.build_scheduler([p.make_provisioner()], provider, pods, kube=kube, cluster=cluster, state_nodes=cluster.nodes_snapshot())
    results = scheduler.solve(pods)
    groups = list(scheduler.topology.topologies.values())  # the groups that count domains
    new = [n for n in results.new_nodes if n.pods]
    return {
        "new": sorted((n.instance_type_options[0].name(), tuple(sorted(q.name for q in n.pods))) for n in new),
        "existing": sorted((v.node.name, tuple(sorted(q.name for q in v.pods))) for v in results.existing_nodes if v.pods),
        "unschedulable": sorted(q.name for q in results.unschedulable),
        "price_per_hour": sum(n.instance_type_options[0].price() for n in new),
    }, groups


def _seeded(p, kube) -> None:
    for o in _cluster_objects(p):
        kube.create(o)


def _over_http(p, stops) -> dict:
    srv = _server(p, stops)
    _seeded(p, _client(p, srv.url, stops))
    kube = _client(p, srv.url, stops)
    cluster = p.state.Cluster(kube, None)
    # the solve reads after every bind is delivered: the cache's lag is
    # Go Karpenter's too (ROADMAP, "Deliberate differences")
    want = len(BOUND)
    eventually(lambda: sum(1 for pod in kube.list_pods() if pod.spec.node_name) == want, message="the bound pods")
    eventually(lambda: len(cluster.nodes_snapshot()) == 6 and sum(len(s.pod_requests) for s in cluster.nodes_snapshot()) == want, message="the state cluster")
    requests = RequestLog(kube)
    thread = threading.current_thread().name
    outcome, groups = _solve(p, kube, cluster)
    cluster.detach()
    sent = requests.of_thread(thread)
    pod_lists = [path for m, path in sent if m == "GET" and path.endswith("/pods")]
    node_gets = [path for m, path in sent if m == "GET" and "/nodes/" in path]
    return {
        "outcome": outcome,
        "pod_lists": sorted(pod_lists),
        "node_gets": len(node_gets),
        "group_namespaces": sorted(p.codec.rest_path("Pod", ns) for g in groups for ns in g.namespaces),
        "pods_cached": len(kube.cached_pods()) if p.side == "port" else None,
    }


def _in_memory(p, objects=None) -> dict:
    kube = p.cluster.KubeCluster()
    for o in objects if objects is not None else _cluster_objects(p):
        kube.create(o)
    cluster = p.state.Cluster(kube, None)
    return _solve(p, kube, cluster)[0]


def _same_outcome(a: dict, b: dict) -> bool:
    price = abs(a["price_per_hour"] - b["price_per_hour"]) <= 1e-9 * max(1.0, b["price_per_hour"])
    return price and {k: v for k, v in a.items() if k != "price_per_hour"} == {k: v for k, v in b.items() if k != "price_per_hour"}


def test_topology_reads_the_cache_held_against_the_reference(stops):
    port = _over_http(PORT, stops)
    ref = _over_http(_pkg("ref"), stops)
    memory = {side: _in_memory(PORT if side == "port" else _pkg("ref")) for side in SIDES}
    for got in (port["outcome"], ref["outcome"], memory["ref"]):
        assert _same_outcome(got, memory["port"]), (got, memory["port"])
    out = memory["port"]
    assert not out["unschedulable"] and out["new"], out
    # the constraints bit: no new web pod beside a crowded zone's, the api
    # pods in the cache's zone, the db pods apart from every db host
    by_node = dict(out["existing"])
    for name in ("z1-a", "z3-a", "z2-a"):
        assert not any(q.startswith("new-db") for q in by_node.get(name, ())), (name, by_node)
    assert all(node.startswith("z2-") for node, placed in out["existing"] for q in placed if q.startswith("new-api")), out
    # the fault beside its repair: the reference LISTs every group
    # namespace and GETs each counted pod's node; the port sends nothing
    assert ref["pod_lists"] and ref["pod_lists"] == ref["group_namespaces"], ref
    assert ref["node_gets"] > 0
    assert port["group_namespaces"] == ref["group_namespaces"]
    assert port["pod_lists"] == [] and port["node_gets"] == 0, port
    assert port["pods_cached"] == len(BOUND)


def test_topology_counts_a_pod_bound_to_a_node_the_cache_has_not_decoded(stops):
    """The Pod and Node streams run apart: a pod the Pod informer shows
    bound to a node the Node informer has not decoded yet is counted, its
    node read directly, and the solve equals the in-memory one of the
    objects in the same order (db-1 on z3-a keeps the anti-affine db pods
    off z3-a)."""
    srv = _server(PORT, stops)
    writer = _client(PORT, srv.url, stops)
    late = ("z3-a", "db-1")
    objects = _cluster_objects(PORT)
    objects = [o for o in objects if o.metadata.name not in late] + [o for o in objects if o.metadata.name in late]
    for o in objects[:-2]:
        writer.create(o)
    kube = _client(PORT, srv.url, stops)
    cluster = PORT.state.Cluster(kube, None)
    eventually(lambda: len(cluster.nodes_snapshot()) == 5, message="the early nodes")
    informer = kube._informers["Node"]
    held = []
    informer.apply = held.append  # the Node stream's events wait here from now on
    for o in objects[-2:]:
        writer.create(o)  # the node, then the pod bound to it
    eventually(lambda: any(q.spec.node_name == "z3-a" for q in kube.cached_pods("gamma") if q.name == "db-1"), message="db-1 in the Pod store")
    # the state Cluster learns the node from the pod's event (its prefetch)
    eventually(lambda: sum(len(s.pod_requests) for s in cluster.nodes_snapshot()) == len(BOUND), message="the state cluster")
    assert kube.cached_node("z3-a") is None and [e.obj.metadata.name for e in held] == ["z3-a"]
    requests = RequestLog(kube)
    outcome, _groups = _solve(PORT, kube, cluster)
    cluster.detach()
    sent = set(requests.of_thread(threading.current_thread().name))
    order = [o.metadata.name for o in objects]
    twin = sorted(_cluster_objects(PORT), key=lambda o: order.index(o.metadata.name))
    assert _same_outcome(outcome, _in_memory(PORT, twin)), outcome
    assert not any(node == "z3-a" for node, placed in outcome["existing"] for q in placed if q.startswith("new-db")), outcome
    assert sent == {("GET", "/api/v1/nodes/z3-a")}, sent
    # the event arrives: the store has the node
    del informer.apply
    for event in held:
        informer.apply(event)
    assert kube.cached_node("z3-a").name == "z3-a"


def test_a_write_through_the_state_cluster_leaves_the_informers_objects_alone(stops):
    """The state Cluster keeps its own copy of each node: the disruption
    methods' flag (retry_on_conflict with held=the state node) and a delete
    write back into that copy, never into the Node informer's object, which
    the topology and the scraper read on other threads. The store takes the
    written state from the watch event."""
    from karpenter_tpu_torch.controllers.disruption.methods import DriftMethod

    codec, lbl = PORT.codec, PORT.lbl
    srv = _server(PORT, stops)
    _seeded(PORT, _client(PORT, srv.url, stops))
    kube = _client(PORT, srv.url, stops)
    cluster = PORT.state.Cluster(kube, None)
    eventually(lambda: len(cluster.nodes_snapshot()) == 6, message="the state cluster")
    informer = kube._informers["Node"]
    states = {s.name: s for s in cluster.nodes_snapshot()}
    shared = {name: informer.store[("", name)] for name in ("z1-a", "z2-b")}
    before = {name: codec.to_wire(obj) for name, obj in shared.items()}
    assert all(states[name].node is not obj for name, obj in shared.items())
    method = DriftMethod(kube, cluster, None, kube.clock)
    assert method._write_flag(states["z1-a"], "true")
    assert states["z1-a"].node.metadata.annotations[lbl.DRIFTED_ANNOTATION] == "true"
    assert codec.to_wire(shared["z1-a"]) == before["z1-a"], "the informer's object was written"
    eventually(lambda: informer.store[("", "z1-a")].metadata.annotations.get(lbl.DRIFTED_ANNOTATION) == "true", message="the write's event")
    kube.delete(states["z2-b"].node)
    eventually(lambda: kube.cached_node("z2-b") is None or kube.cached_node("z2-b").metadata.deletion_timestamp is not None, message="the delete's event")
    for name, obj in shared.items():
        assert codec.to_wire(obj) == before[name], name
    cluster.detach()


# -- read-only: the store after a Runtime round over HTTP -------------------------


def test_a_round_over_http_leaves_every_cached_object_equal_to_its_wire_form(stops):
    from karpenter_tpu_torch.journal import JOURNAL
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.slo import SLO
    from karpenter_tpu_torch.utils.options import Options

    codec = PORT.codec
    srv = _server(PORT, stops)
    writer = _client(PORT, srv.url, stops)
    _seeded(PORT, writer)
    writer.create(PORT.make_provisioner())
    kube = _client(PORT, srv.url, stops)
    for singleton in (JOURNAL, SLO):
        singleton.reset()
        stops.add(singleton.reset)
    options = Options(
        batch_max_duration=0.3, batch_idle_duration=0.05, dense_solver_enabled=False, leader_elect=False,
        enable_journal=True, enable_slo=True,
    )
    rt = Runtime(kube=kube, cloud_provider=PORT.fake.FakeCloudProvider(PORT.fake.instance_types(20)), options=options, device="cpu")
    stops.add(lambda: rt._stop.is_set() or rt.stop())
    eventually(lambda: len(kube.cached_pods()) == len(BOUND), message="the informer's first LIST")
    rt.start()
    batch = _batch(PORT)
    for pod in batch:
        writer.create(pod)
    names = {pod.name for pod in batch}

    def nominated():
        return {e.object_name for e in rt.recorder.of("NominatePod")} >= names

    eventually(nominated, timeout=30, message="every pod nominated")
    rt.pod_metrics.scrape()
    rt.stop()
    # the kubelet's part: bind every nominated pod, as the apiserver records it
    for event in rt.recorder.of("NominatePod"):
        node = event.message.split()[-1]
        pod = writer.get("Pod", event.object_name, next(p.namespace for p in batch if p.name == event.object_name))
        writer.bind_pod(pod, node)
    total = len(BOUND) + len(batch)
    eventually(lambda: sum(1 for p in kube.cached_pods() if p.spec.node_name) == total, message="the binds in the store")
    eventually(lambda: len(kube._informers["Node"].store) == len(writer.list_nodes()), message="the launched nodes in the store")
    for kind in ("Pod", "Node"):
        informer = kube._informers[kind]
        with informer.lock:
            cached = list(informer.store.values())
        for obj in cached:
            wire = srv.state.get(kind, obj.metadata.namespace if kind == "Pod" else "", obj.metadata.name)
            assert codec.to_wire(obj) == codec.to_wire(codec.from_wire(wire, kind)), (kind, obj.metadata.name)
    assert kube._informers["Pod"].handler_errors == 0 and kube._informers["Node"].handler_errors == 0


# -- the pod scraper over HTTP ---------------------------------------------------


def _scrape_over_http(p, stops) -> dict:
    srv = _server(p, stops)
    writer = _client(p, srv.url, stops)
    _seeded(p, writer)
    owned = p.make_pod(name="owned", namespace="alpha", requests={"cpu": "0.5"}, node_name="z3-b", phase="Running", unschedulable=False)
    owned.metadata.owner_references.append(p.objects.OwnerReference(kind="ReplicaSet", name="web-rs", api_version="apps/v1"))
    writer.create(owned)
    writer.create(p.make_pod(name="pending", namespace="beta", node_selector={p.lbl.PROVISIONER_NAME_LABEL: "special"}))
    writer.create(p.make_pod(name="orphan", namespace="gamma", node_name="gone", phase="Running", unschedulable=False))
    kube = _client(p, srv.url, stops)
    if p.side == "port":
        eventually(lambda: len(kube.cached_pods()) == len(BOUND) + 3 and kube.cached_node("z3-b"), message="the informers")
    requests = RequestLog(kube)
    registry = p.metrics.Registry()
    controller = p.pod_metrics.PodMetricsController(kube, registry)
    controller.scrape()
    sent = requests.of_thread(threading.current_thread().name)
    return {"series": sorted(controller.gauge.values().items()), "sent": sent}


def test_the_pod_scraper_reads_the_cache_held_against_the_reference(stops):
    port = _scrape_over_http(PORT, stops)
    ref = _scrape_over_http(_pkg("ref"), stops)
    assert port["series"] == ref["series"]
    assert len(port["series"]) == len(BOUND) + 3
    labels = {series[0][0]: series[0] for series in port["series"]}
    assert labels["owned"][2] == "/apis/apps/v1/namespaces/alpha/replicasets/web-rs"
    assert labels["pending"][4] == "special" and labels["orphan"][5] == "N/A"
    assert port["sent"] == [], port["sent"]
    assert ("GET", "/api/v1/pods") in ref["sent"] and sum(1 for _m, path in ref["sent"] if "/nodes/" in path) == len(BOUND) + 2
