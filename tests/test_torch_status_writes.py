"""A Provisioner status write that leaves the spec alone, held beside the
JAX package on the CPU.

The counter controller writes each Provisioner's status. In the JAX package
that write is a full update, and the in-process admission chain admits it:
a Provisioner that another client wrote with no admission gets its
defaults on that write. On the simulated cloud the defaults add the
on-demand and amd64 requirements, which changes the template hash, and the
drift method then flags every node launched before the write. The port's
counter writes the status subresource (`retry_on_conflict(...,
status_only=True)`), in memory, over HTTP (`PUT
.../provisioners/{name}/status`, which the apiserver lands with the stored
spec and no webhook) and through the admission chain, which lets it by.

Cases, in memory and over HTTP:
- a Provisioner written with no admission, a round launched from it: after
  the counter's status write the port's stored spec is as written and its
  drift pass flags no node; the reference's spec is defaulted and every
  node is flagged;
- a status write carrying a spec edit lands no spec change (status,
  resourceVersion and the watch event do land);
- over HTTP, with a webhook registered in the apiserver for provisioners, a
  status write reaches no webhook while a spec update still does;
- a status write that meets a conflict re-reads and re-applies its edit,
  as retry_on_conflict does for any write: an injected 409 costs one
  attempt, and a spec another writer landed in between survives.

Every server and client a case starts is stopped, every fault plan
installed is cleared.
"""

from __future__ import annotations

import copy
import importlib
import time
import types

import pytest

from tests.test_torch_conflicts import BACKENDS, _Stops, stops  # noqa: F401

SIDES = ("ref", "port")
PODS = 6


def _pkg(side: str) -> types.SimpleNamespace:
    root = "karpenter_tpu" if side == "ref" else "karpenter_tpu_torch"

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    helpers = importlib.import_module("tests.helpers") if side == "ref" else mod("testing")
    simulated = mod("cloudprovider.simulated")
    return types.SimpleNamespace(
        side=side,
        lbl=mod("api.labels"),
        chaos=mod("kube.chaos"),
        cluster=mod("kube.cluster"),
        client=mod("kube.client"),
        apiserver=mod("kube.apiserver"),
        codec=mod("kube.codec"),
        webhooks=mod("webhooks"),
        webhookserver=mod("kube.webhookserver"),
        Cluster=mod("controllers.state.cluster").Cluster,
        ProvisionerController=mod("controllers.provisioning").ProvisionerController,
        CounterController=mod("controllers.counter").CounterController,
        DriftMethod=mod("controllers.disruption.methods").DriftMethod,
        CloudBackend=simulated.CloudBackend,
        SimulatedCloudProvider=simulated.SimulatedCloudProvider,
        FakeCloudProvider=mod("cloudprovider.fake").FakeCloudProvider,
        FakeClock=mod("utils.clock").FakeClock,
        make_provisioner=helpers.make_provisioner,
        make_pod=helpers.make_pod,
        make_node=helpers.make_node,
    )


def _kube(p, backend: str, stops: _Stops, clock):
    """The controllers' client and another writer's, on one store: one
    KubeCluster, or an apiserver with a client each."""
    if backend == "inprocess":
        kube = p.cluster.KubeCluster(clock=clock)
        return kube, kube, None
    srv = p.apiserver.APIServer().start()
    stops.add(srv.stop)
    kube, writer = p.client.HttpKubeClient(srv.url, clock=clock), p.client.HttpKubeClient(srv.url, clock=clock)
    stops.add(kube.stop)
    stops.add(writer.stop)
    return kube, writer, srv


def _spec(p, provisioner) -> dict:
    return p.codec.to_wire(provisioner)["spec"]


def _eventually(fn, message: str, timeout: float = 20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {message}")


def drift_scenario(side: str, backend: str, stops: _Stops) -> dict:
    """Another client writes the Provisioner with no admission; the
    controllers' client has the admission chain. A round launches nodes
    from the Provisioner as written; they are initialized and their
    nominations lapse. Then the counter writes the status, and a drift
    pass runs."""
    p = _pkg(side)
    clock = p.FakeClock()
    kube, writer, _ = _kube(p, backend, stops, clock)
    writer.create(p.make_provisioner())
    written = _spec(p, writer.get("Provisioner", "default", ""))
    provider = p.SimulatedCloudProvider(backend=p.CloudBackend(clock=clock), kube=kube, clock=clock)
    p.webhooks.register(kube, provider)
    cluster = p.Cluster(kube, provider, clock=clock)
    controller = p.ProvisionerController(kube, cluster, provider, wait_for_cluster_sync=False, clock=clock)
    for i in range(PODS):
        writer.create(p.make_pod(name=f"work-{i}", requests={"cpu": "1", "memory": "1Gi"}))
    controller.provision()
    nodes = [n.name for n in writer.list_nodes()]
    assert nodes, "the round launched nothing"
    for name in nodes:
        node = writer.get_node(name)
        node.metadata.labels[p.lbl.LABEL_NODE_INITIALIZED] = "true"
        writer.update(node)
    _eventually(
        lambda: all((lambda s: s is not None and s.initialized())(cluster.get_state_node(n)) for n in nodes),
        "the nodes initialized in cluster state",
    )
    clock.step(cluster.nomination_ttl + 1.0)
    p.CounterController(kube, cluster).reconcile_all()
    stored = writer.get("Provisioner", "default", "")
    commands = p.DriftMethod(kube, cluster, controller, clock).propose()
    flagged = sorted(n.name for n in writer.list_nodes() if n.metadata.annotations.get(p.lbl.DRIFTED_ANNOTATION) == "true")
    return {
        "kept": _spec(p, stored) == written,
        "requirements": sorted(r.key for r in stored.spec.requirements),
        "counted_cpu": stored.status.resources.get("cpu", 0.0),
        "nodes": sorted(nodes),
        "flagged": flagged,
        "commands": sorted(n for c in commands for n in c.node_names()),
    }


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_status_write_leaves_an_unadmitted_spec_and_its_nodes_alone(backend, stops):
    ref, port = (drift_scenario(side, backend, stops) for side in SIDES)
    for record in (ref, port):
        assert record["counted_cpu"] > 0, "the counter wrote no status"
    assert port["kept"] and port["requirements"] == []
    assert port["flagged"] == [] and port["commands"] == []
    # the reference's admitted full update defaults the spec and drifts
    # every node launched before it
    assert not ref["kept"]
    assert ref["requirements"] == sorted(["karpenter.sh/capacity-type", "kubernetes.io/arch"])
    assert ref["flagged"] == ref["nodes"] == ref["commands"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_status_write_lands_no_spec_edit(backend, stops):
    p = _pkg("port")
    clock = p.FakeClock()
    kube, writer, _ = _kube(p, backend, stops, clock)
    writer.create(p.make_provisioner())
    p.webhooks.register(kube, p.FakeCloudProvider())
    # a copy: in memory a read returns the stored object itself
    before = copy.deepcopy(writer.get("Provisioner", "default", ""))
    events = []
    kube.watch("Provisioner", lambda event: events.append((event.type, event.obj.metadata.resource_version)), replay=False)

    def mutate(provisioner) -> bool:
        provisioner.spec.weight = 7
        provisioner.spec.labels["team"] = "search"
        provisioner.status.resources = {"cpu": 4.0}
        return True

    written = kube.retry_on_conflict("Provisioner", "default", "", mutate, status_only=True)
    stored = writer.get("Provisioner", "default", "")
    assert _spec(p, stored) == _spec(p, before)
    assert stored.status.resources == {"cpu": 4.0} == written.status.resources
    assert written.spec.weight is None and "team" not in written.spec.labels, "the returned object carries the edit"
    assert stored.metadata.resource_version > before.metadata.resource_version
    _eventually(lambda: events == [("MODIFIED", stored.metadata.resource_version)], "the MODIFIED event")


def test_a_status_write_reaches_no_webhook_over_http(stops):
    """A webhook registered in the apiserver for provisioners (the repo's
    admission webhook server, defaulting and validation): the counter's
    status write reaches neither, while a spec update through
    retry_on_conflict reaches both and is defaulted."""
    p = _pkg("port")
    webhook = p.webhookserver.AdmissionWebhookServer(cloud_provider=p.FakeCloudProvider()).start()
    stops.add(webhook.stop)
    clock = p.FakeClock()
    kube, writer, srv = _kube(p, "http", stops, clock)
    writer.create(p.make_provisioner())  # before the registration: no admission
    srv.state.register_webhooks(
        kinds={"Provisioner"}, mutate_url=webhook.url + "/mutate", validate_url=webhook.url + "/validate", ca_pem=webhook.cert.ca_pem,
    )
    calls = []
    call = srv.state._call_webhook

    def recorded(url, ctx, wire, operation):
        calls.append((url.rsplit("/", 1)[-1], operation))
        return call(url, ctx, wire, operation)

    srv.state._call_webhook = recorded

    def status(provisioner) -> bool:
        provisioner.status.resources = {"cpu": 2.0}
        return True

    kube.retry_on_conflict("Provisioner", "default", "", status, status_only=True)
    assert calls == []
    assert writer.get("Provisioner", "default", "").spec.weight is None

    def label(provisioner) -> bool:
        provisioner.spec.labels["team"] = "search"
        return True

    kube.retry_on_conflict("Provisioner", "default", "", label)
    assert calls == [("mutate", "UPDATE"), ("validate", "UPDATE")]
    stored = writer.get("Provisioner", "default", "")
    assert stored.spec.labels["team"] == "search" and stored.spec.weight == 0
    assert stored.status.resources == {"cpu": 2.0}


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_status_write_retries_on_a_conflict(backend, stops):
    """An injected 409 costs the counter's status write one attempt; a
    status write from a stale copy re-reads, re-applies its edit and keeps
    the spec another writer landed in between."""
    p = _pkg("port")
    clock = p.FakeClock()
    kube, writer, _ = _kube(p, backend, stops, clock)
    writer.create(p.make_provisioner())
    stale = copy.deepcopy(writer.get("Provisioner", "default", ""))
    cluster = p.Cluster(kube, None, clock=clock)
    writer.create(p.make_node(name="n", labels={p.lbl.PROVISIONER_NAME_LABEL: "default"}, allocatable={"cpu": 4, "memory": "8Gi", "pods": 10}))
    _eventually(lambda: cluster.get_state_node("n") is not None, "the node in cluster state")
    conflicts = p.chaos.conflicts_total()
    plan = p.chaos.KubeFaultPlan.from_specs(
        [{"fault": "conflict", "verb": "update", "obj_kind": "Provisioner", "nth": 1, "count": 1}], seed=0
    )
    p.chaos.KUBE_CHAOS.install(plan)
    try:
        p.CounterController(kube, cluster).reconcile_all()
    finally:
        p.chaos.KUBE_CHAOS.clear()
    assert p.chaos.conflicts_total() - conflicts == 1
    assert writer.get("Provisioner", "default", "").status.resources["cpu"] == 4.0

    edited = writer.get("Provisioner", "default", "")
    edited.spec.labels["team"] = "search"
    writer.update(edited)
    attempts = []

    def status(provisioner) -> bool:
        attempts.append(provisioner.metadata.resource_version)
        provisioner.status.resources = {"cpu": 8.0}
        return True

    kube.retry_on_conflict("Provisioner", "default", "", status, held=stale, status_only=True)
    stored = writer.get("Provisioner", "default", "")
    assert len(attempts) == 2 and attempts[0] < attempts[1], attempts
    assert stored.spec.labels["team"] == "search" and stored.status.resources == {"cpu": 8.0}
    assert stale.spec.labels["team"] == "search", "the held object did not get the stored state"
