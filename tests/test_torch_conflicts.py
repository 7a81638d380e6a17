"""A write that meets a conflict, on the port and on the JAX package.

The port writes every read-modify-write of a Node or a Provisioner through
`retry_on_conflict`, client-go's RetryOnConflict, on both of its kube
backends: it reads the object, applies the caller's edit to a copy, writes
the copy with the resourceVersion it read, and on a 409 reads again and
re-applies the edit. The JAX package's controllers write with a plain
update. Each case below runs on both packages with the same inputs and
shows the two behaviours side by side (ROADMAP C, "Deliberate differences"):

- C8, over HTTP: a node controller reconciles a stale copy of a node after
  another writer set a field (the kubelet's Ready, a label, a taint). The
  JAX package's update resends its stale object after the 409 and the field
  is lost; the port keeps it, and a node made Ready in between is
  initialized on that write.
- C4, in memory: an injected conflict at `bind_pod` leaves the JAX
  package's stored pod bound with no watch event; the port's stored pod is
  untouched, and the next bind lands and is seen.
- C5: under Node update conflicts no retry absorbs, the JAX package's
  node-lifecycle thread ends; the port's Runtime stays healthy, requeues the
  node and initializes every node, in memory and over HTTP, where
  cmd.controller's wait goes on until it is signalled.
- The primitive itself on both port backends: racing writers lose no
  update, exhaustion raises ConflictExhausted after
  RETRY_ON_CONFLICT_ATTEMPTS with nothing stored, a stale read costs one
  re-read, a write from the caller's object reads nothing, a delete or a
  finalize in between is never undone, and an edit that declines writes
  nothing.

Every server, client and Runtime a case starts is stopped; every fault plan
installed is cleared.
"""

from __future__ import annotations

import importlib
import os
import signal
import socket
import sys
import threading
import types

import pytest

from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_runtime import RKit, _process_state, _wait, reference_auditor_off, runtimes  # noqa: F401

SIDES = ("ref", "port")
BACKENDS = ("inprocess", "http")


def _pkg(side: str) -> types.SimpleNamespace:
    root = "karpenter_tpu" if side == "ref" else "karpenter_tpu_torch"

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    helpers = importlib.import_module("tests.helpers") if side == "ref" else mod("testing")
    return types.SimpleNamespace(
        side=side,
        objects=mod("api.objects"),
        lbl=mod("api.labels"),
        chaos=mod("kube.chaos"),
        cluster=mod("kube.cluster"),
        client=mod("kube.client"),
        apiserver=mod("kube.apiserver"),
        NodeController=mod("controllers.node").NodeController,
        make_provisioner=helpers.make_provisioner,
    )


def _node(p, name: str, ready: bool, owned: bool = True):
    objects = p.objects
    labels = {p.lbl.PROVISIONER_NAME_LABEL: "default"} if owned else {}
    return objects.Node(
        metadata=objects.ObjectMeta(name=name, namespace="", labels=labels),
        spec=objects.NodeSpec(),
        status=objects.NodeStatus(
            capacity={"cpu": 8.0},
            allocatable={"cpu": 8.0},
            conditions=[objects.NodeCondition(type="Ready", status="True" if ready else "False")],
        ),
    )


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


def _backend(p, backend: str, stops: _Stops, writers: int = 2) -> list:
    """`writers` kube clients on one store: one KubeCluster shared, or an
    apiserver with a client each."""
    if backend == "inprocess":
        return [p.cluster.KubeCluster()] * writers
    srv = p.apiserver.APIServer().start()
    stops.add(srv.stop)
    clients = [p.client.HttpKubeClient(srv.url) for _ in range(writers)]
    for client in clients:
        stops.add(client.stop)
    return clients


def _plan(p, *specs, seed: int = 0):
    plan = p.chaos.KubeFaultPlan.from_specs(list(specs), seed=seed)
    p.chaos.KUBE_CHAOS.install(plan)
    return plan


# -- C8: the retried update re-applies its edit, over HTTP -----------------------------

SECOND_WRITERS = ("ready", "label", "taint")
MAINTENANCE = "example.com/maintenance"


def _second_write(p, node, what: str) -> None:
    if what == "ready":
        node.status.conditions = [p.objects.NodeCondition(type="Ready", status="True")]
    elif what == "label":
        node.metadata.labels["team"] = "search"
    else:
        node.spec.taints.append(p.objects.Taint(key=MAINTENANCE, effect="NoSchedule"))


def _kept(p, node, what: str) -> dict:
    return {
        "ready": node.ready(),
        "initialized": node.metadata.labels.get(p.lbl.LABEL_NODE_INITIALIZED) == "true",
        "finalizer": p.lbl.TERMINATION_FINALIZER in node.metadata.finalizers,
        "label": node.metadata.labels.get("team") == "search",
        "taint": any(t.key == MAINTENANCE for t in node.spec.taints),
    }


def _stale_reconcile(side: str, what: str, stops: _Stops) -> tuple:
    """Writer A (the node controller's client) reads node `n`; the second
    writer then sets `what` on it; A's node controller reconciles its stale
    copy. The node lacks the termination finalizer, so the reconcile
    writes. Returns what the server holds and what A's copy shows."""
    p = _pkg(side)
    a, b = _backend(p, "http", stops)
    a.create(p.make_provisioner())
    b.create(_node(p, "n", ready=what != "ready"))
    stale = a.get_node("n")
    fresh = b.get_node("n")
    _second_write(p, fresh, what)
    b.update(fresh)
    p.NodeController(a, None).reconcile(stale)
    return _kept(p, b.get_node("n"), what), _kept(p, stale, what)


@pytest.mark.parametrize("what", SECOND_WRITERS)
def test_a_stale_reconcile_keeps_what_another_writer_set_over_http(what, stops):
    ref, _ = _stale_reconcile("ref", what, stops)
    port, held = _stale_reconcile("port", what, stops)
    # the port: the field survives, the controller's finalizer lands, and a
    # node made Ready in between is initialized on that very write
    assert port == {"ready": True, "initialized": True, "finalizer": True, "label": what == "label", "taint": what == "taint"}
    assert held == port, "the caller's object carries the written state"
    # the JAX package: the retried update resends the stale object, so the
    # other writer's field is gone (and a node that was not Ready when read
    # is not initialized)
    assert ref["finalizer"] and not ref[what]
    assert ref["initialized"] == (what != "ready")


# -- C4: an injected conflict at bind_pod lands nothing ---------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_an_injected_bind_conflict_stores_nothing(side):
    p = _pkg(side)
    kube = p.cluster.KubeCluster()
    pod = p.objects.Pod(metadata=p.objects.ObjectMeta(name="web-0", namespace="default"))
    kube.create(pod)
    seen = []
    kube.watch("Pod", lambda event: seen.append((event.type, event.obj.spec.node_name)), replay=False)
    conflicts = p.chaos.conflicts_total()
    _plan(p, {"fault": "conflict", "verb": "update", "obj_kind": "Pod", "nth": 1, "count": 1})
    try:
        with pytest.raises(p.cluster.Conflict):
            kube.bind_pod(kube.get("Pod", "web-0", "default"), "node-a")
        stored = kube.get("Pod", "web-0", "default")
        assert seen == [] and p.chaos.conflicts_total() == conflicts + 1
        if side == "ref":
            # the edit landed in the store with no event: a binder that
            # re-reads and skips bound pods never sends it to the informers
            assert stored.spec.node_name == "node-a" and stored.status.phase == "Running"
            return
        assert stored.spec.node_name == "" and stored.status.phase != "Running" and stored.status.start_time is None
        kube.bind_pod(stored, "node-a")
    finally:
        p.chaos.KUBE_CHAOS.clear()
    assert kube.get("Pod", "web-0", "default").spec.node_name == "node-a"
    assert seen == [("MODIFIED", "node-a")]


# -- C5: a conflict requeues and ends no loop ------------------------------------------

NODES = 4
# the first six Node updates conflict: the port's first write exhausts its
# four attempts and is requeued, the second absorbs two and lands
STORM = {"fault": "conflict", "verb": "update", "obj_kind": "Node", "nth": 1, "count": 6}
LEASE = dict(leader_elect=True, lease_duration=1.0, lease_renew_period=0.05)


def _initialized(kit, kube) -> bool:
    nodes = kube.list_nodes()
    return len(nodes) == NODES and all(n.metadata.labels.get(kit.labels.LABEL_NODE_INITIALIZED) == "true" for n in nodes)


def _seed_nodes(kit, kube) -> None:
    kube.create(kit.make_provisioner())
    for i in range(NODES):
        node = kit.make_node(f"standing-{i}", labels={kit.labels.PROVISIONER_NAME_LABEL: "default"}, allocatable={"cpu": "4"})
        kube.create(node)


def _lifecycle_thread(rt):
    (thread,) = [t for t in rt._threads if t.name == "node-lifecycle"]
    return thread


@pytest.mark.parametrize("side", SIDES)
def test_node_update_conflicts_end_no_loop_in_memory(side, runtimes):  # noqa: F811
    kit = RKit(side)
    chaos = importlib.import_module(f"{kit.root}.kube.chaos")
    kube = kit.KubeCluster()
    _seed_nodes(kit, kube)
    conflicts = chaos.conflicts_total()
    chaos.KUBE_CHAOS.install(chaos.KubeFaultPlan.from_specs([STORM]))
    try:
        rt = runtimes(kit, kube, kit.fake_provider(4), **LEASE)
        rt.start()
        if side == "ref":
            # the first conflict raises out of the lifecycle pass: the thread
            # ends, and healthy() does not look at it
            assert _wait(lambda: not _lifecycle_thread(rt).is_alive(), timeout=15.0)
            assert rt.healthy() and not _initialized(kit, kube)
            return
        assert _wait(lambda: _initialized(kit, kube), timeout=15.0), [n.metadata.labels for n in kube.list_nodes()]
        assert rt.healthy() and rt.error is None and _lifecycle_thread(rt).is_alive()
        assert rt.node_controller.requeued >= 1
        assert chaos.conflicts_total() - conflicts == STORM["count"] == chaos.KUBE_CHAOS.fired()
    finally:
        chaos.KUBE_CHAOS.clear()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_conflicts_exhausted_over_http_end_the_reference_thread(runtimes):  # noqa: F811
    """The JAX package over HTTP: four 409s exhaust its update's retries and
    the ConflictExhausted ends the node-lifecycle thread."""
    kit = RKit("ref")
    p = _pkg("ref")
    srv = p.apiserver.APIServer().start()
    kube = p.client.HttpKubeClient(srv.url)
    try:
        _seed_nodes(kit, kube)
        conflicts = p.chaos.conflicts_total()
        _plan(p, dict(STORM, count=p.client.HttpKubeClient.RETRY_ON_CONFLICT_ATTEMPTS))
        rt = runtimes(kit, kube, kit.fake_provider(4), **LEASE)
        rt.start()
        assert _wait(lambda: not _lifecycle_thread(rt).is_alive(), timeout=15.0)
        assert p.chaos.conflicts_total() - conflicts == p.client.HttpKubeClient.RETRY_ON_CONFLICT_ATTEMPTS
        rt.stop()
    finally:
        p.chaos.KUBE_CHAOS.clear()
        kube.stop()
        srv.stop()


def test_conflicts_exhausted_over_http_do_not_end_the_controller_process(monkeypatch):
    """The port's cmd.controller over HTTP, its Runtime on the CPU: the node
    controller's first write meets four 409s, ConflictExhausted, and is
    requeued; every node is initialized, the runtime stays healthy, and
    main's wait goes on until SIGTERM, after which main returns 0."""
    import karpenter_tpu_torch.runtime as runtime_module
    from karpenter_tpu_torch.cmd import controller
    from karpenter_tpu_torch.kube.cluster import RETRY_ON_CONFLICT_ATTEMPTS

    kit = RKit("port")
    p = _pkg("port")
    srv = p.apiserver.APIServer().start()
    seed = p.client.HttpKubeClient(srv.url)
    kube = p.client.HttpKubeClient(srv.url)
    built, cls = [], runtime_module.Runtime
    seen = {}

    def runtime(**kwargs):
        built.append(cls(**kwargs, device="cpu"))
        return built[-1]

    def watch_then_signal():
        seen["settled"] = _wait(lambda: bool(built) and _initialized(kit, seed) and built[0].node_controller.requeued >= 1, timeout=30.0)
        seen["healthy"] = bool(built) and built[0].healthy()
        os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(controller, "build_kube_backend", lambda options: (kube, srv.url))
    monkeypatch.setattr(runtime_module, "Runtime", runtime)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    watcher = threading.Thread(target=watch_then_signal, daemon=True)
    try:
        _seed_nodes(kit, seed)
        conflicts = p.chaos.conflicts_total()
        _plan(p, dict(STORM, count=RETRY_ON_CONFLICT_ATTEMPTS))
        watcher.start()
        code = controller.main([
            "--health-probe-port", str(_free_port()), "--metrics-port", str(_free_port()),
            "--lease-renew-period", "0.05", "--dense-min-batch", "1",
        ])
        watcher.join(timeout=10.0)
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
        p.chaos.KUBE_CHAOS.clear()
        for client in (kube, seed):
            client.stop()
        srv.stop()
    assert code == 0
    assert seen == {"settled": True, "healthy": True}
    rt = built[0]
    assert rt.error is None and rt.node_controller.requeued >= 1
    assert p.chaos.conflicts_total() - conflicts == RETRY_ON_CONFLICT_ATTEMPTS


# -- the primitive on both port backends ------------------------------------------------

ROUNDS = 25


@pytest.mark.parametrize("backend", BACKENDS)
def test_racing_writers_lose_no_update(backend, stops):
    """Each writer applies ROUNDS label edits to one Node through
    retry_on_conflict; a call that exhausts its attempts is made again. In
    memory, more writers than cores and a short switch interval; over HTTP,
    three clients."""
    p = _pkg("port")
    writers = (os.cpu_count() or 1) + 1 if backend == "inprocess" else 3
    clients = _backend(p, backend, stops, writers=writers)
    kube = clients[0]
    kube.create(_node(p, "storm", ready=True, owned=False))
    requeued = [0] * writers
    errors = []

    def writer(idx: int) -> None:
        try:
            for round_no in range(1, ROUNDS + 1):
                def mutate(node, value=str(round_no)):
                    node.metadata.labels[f"writer-{idx}"] = value
                    return True

                while True:
                    try:
                        clients[idx].retry_on_conflict("Node", "storm", "", mutate)
                        break
                    except p.cluster.ConflictExhausted:
                        requeued[idx] += 1
                        assert requeued[idx] <= ROUNDS * writers, "no forward progress"
        except Exception as err:  # noqa: BLE001 - surfaced below
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(i,)) for i in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    labels = kube.get_node("storm").metadata.labels
    assert {f"writer-{i}": labels.get(f"writer-{i}") for i in range(writers)} == {f"writer-{i}": str(ROUNDS) for i in range(writers)}


def _watched(kube, backend: str) -> list:
    seen = []
    if backend == "inprocess":
        kube.watch("Node", lambda event: seen.append(event.type), replay=False)
    return seen


@pytest.mark.parametrize("backend", BACKENDS)
def test_exhaustion_raises_after_the_attempts_and_stores_nothing(backend, stops):
    p = _pkg("port")
    kube, _ = _backend(p, backend, stops)
    kube.create(_node(p, "n", ready=True, owned=False))
    version = kube.get_node("n").metadata.resource_version
    seen = _watched(kube, backend)
    conflicts = p.chaos.conflicts_total()
    calls = []

    def mutate(node):
        calls.append(node.metadata.resource_version)
        node.metadata.labels["edited"] = "true"
        return True

    _plan(p, dict(STORM, count=p.cluster.RETRY_ON_CONFLICT_ATTEMPTS + 1))
    try:
        with pytest.raises(p.cluster.ConflictExhausted, match="after 4 attempts"):
            kube.retry_on_conflict("Node", "n", "", mutate)
    finally:
        p.chaos.KUBE_CHAOS.clear()
    assert len(calls) == p.cluster.RETRY_ON_CONFLICT_ATTEMPTS
    assert p.chaos.conflicts_total() - conflicts == p.cluster.RETRY_ON_CONFLICT_ATTEMPTS
    stored = kube.get_node("n")
    assert "edited" not in stored.metadata.labels and stored.metadata.resource_version == version and seen == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_stale_read_costs_one_re_read(backend, stops):
    p = _pkg("port")
    kube, _ = _backend(p, backend, stops)
    # a version above 1: a read served one behind then still names one (a
    # resourceVersion of 0 is an unconditional write on the wire)
    kube.create(_node(p, "first", ready=True, owned=False))
    kube.create(_node(p, "n", ready=True, owned=False))
    conflicts = p.chaos.conflicts_total()
    calls = []

    def mutate(node):
        calls.append(node.metadata.resource_version)
        node.metadata.labels["edited"] = "true"
        return True

    _plan(p, {"fault": "stale-read", "verb": "get", "obj_kind": "Node", "nth": 1, "count": 1})
    try:
        written = kube.retry_on_conflict("Node", "n", "", mutate)
    finally:
        p.chaos.KUBE_CHAOS.clear()
    assert calls[0] == calls[1] - 1 and len(calls) == 2, calls
    assert p.chaos.conflicts_total() - conflicts == 1
    stored = kube.get_node("n")
    assert stored.metadata.labels["edited"] == "true" == written.metadata.labels["edited"]
    assert stored.metadata.resource_version == written.metadata.resource_version


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_write_from_the_held_object_reads_nothing(backend, stops):
    """The first attempt edits a copy of the caller's object: a write that
    meets no conflict makes no read, and the held object carries it."""
    p = _pkg("port")
    kube, _ = _backend(p, backend, stops)
    kube.create(_node(p, "n", ready=True, owned=False))
    held = kube.get_node("n")
    conflicts = p.chaos.conflicts_total()

    def no_read(*args, **kwargs):
        raise AssertionError("the first attempt read the object")

    kube.get = no_read
    try:
        written = kube.retry_on_conflict("Node", "n", "", lambda node: node.metadata.labels.update(edited="true") is None, held=held)
    finally:
        del kube.get
    stored = kube.get_node("n")
    assert p.chaos.conflicts_total() == conflicts
    assert stored.metadata.labels["edited"] == held.metadata.labels["edited"] == written.metadata.labels["edited"] == "true"
    assert held.metadata.resource_version == stored.metadata.resource_version


RACING_VERBS = ("delete", "finalize")


@pytest.mark.parametrize("verb", RACING_VERBS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_a_write_cannot_undo_a_delete_or_a_finalize_in_between(backend, verb, stops):
    """Another writer deletes the node (it has a finalizer, so it turns
    terminating) or strips its finalizers while the edit is being made. The
    write then loses, re-reads and re-applies its edit: the node stays
    terminating, or without its finalizers. In memory both verbs edit the
    stored object in place, with no new resourceVersion."""
    p = _pkg("port")
    kube, other = _backend(p, backend, stops)
    node = _node(p, "n", ready=True, owned=False)
    node.metadata.finalizers = [p.lbl.TERMINATION_FINALIZER]
    kube.create(node)
    held = kube.get_node("n")
    conflicts = p.chaos.conflicts_total()
    calls = []

    def mutate(fresh):
        if not calls:
            getattr(other, verb)(other.get_node("n"))
        calls.append(fresh.metadata.resource_version)
        fresh.metadata.labels["edited"] = "true"
        return True

    kube.retry_on_conflict("Node", "n", "", mutate, held=held)
    stored = other.get_node("n")
    assert len(calls) == 2 and p.chaos.conflicts_total() - conflicts == 1, calls
    assert stored.metadata.labels["edited"] == "true"
    if verb == "delete":
        assert stored.metadata.deletion_timestamp is not None
        assert stored.metadata.finalizers == [p.lbl.TERMINATION_FINALIZER]
    else:
        assert stored.metadata.deletion_timestamp is None and stored.metadata.finalizers == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_an_edit_that_declines_writes_nothing(backend, stops):
    p = _pkg("port")
    kube, _ = _backend(p, backend, stops)
    kube.create(_node(p, "n", ready=True, owned=False))
    version = kube.get_node("n").metadata.resource_version
    seen = _watched(kube, backend)
    assert kube.retry_on_conflict("Node", "n", "", lambda node: False) is None
    assert kube.get_node("n").metadata.resource_version == version and seen == []
    with pytest.raises(p.cluster.NotFound):
        kube.retry_on_conflict("Node", "gone", "", lambda node: True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_caller_keeps_one_object_with_the_write(backend, stops):
    """A writer that goes on with the object it passed (the disruption and
    drift paths) sees the written taints, labels and resourceVersion, and a
    field another writer set in between."""
    p = _pkg("port")
    kube, other = _backend(p, backend, stops)
    kube.create(_node(p, "n", ready=True, owned=False))
    held = kube.get_node("n")
    theirs = other.get_node("n")
    theirs.metadata.labels["team"] = "search"
    other.update(theirs)

    def cordon(node):
        node.spec.unschedulable = True
        node.spec.taints.append(p.objects.Taint(key=MAINTENANCE, effect="NoSchedule"))
        return True

    written = kube.retry_on_conflict("Node", "n", "", cordon, held=held)
    stored = other.get_node("n")
    for obj in (held, written, stored):
        assert obj.spec.unschedulable and [t.key for t in obj.spec.taints] == [MAINTENANCE]
        assert obj.metadata.labels["team"] == "search"
        assert obj.metadata.resource_version == stored.metadata.resource_version
