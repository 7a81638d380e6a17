"""The restart after a device-lost the card raised (ROADMAP C7), on the CPU.

The port has no host rung: a device-lost the card raised ends the batch
loop (solver/faults.py ends_the_loop), healthy() turns false, stop()
releases the Lease and re-raises the fault, and the entry point exits
non-zero on it; a fresh process, with a fresh CUDA context, picks up the
batch. Here the two processes are two Runtimes in turn on one cluster, on
the CPU (`device="cpu"`), with leader election on and short lease and renew
periods; the device-side assert is stood in for as tests/test_torch_runtime.py
stands it in: a RuntimeError naming it, raised from the port's
solver.dense.bucket_cost_packed (K1's seam), which classify() maps to a
device-lost that was not injected.

- an empty cluster: Runtime A ends on the fault with the Lease released and
  no Node; Runtime B wins the Lease within a few renew periods and places
  every pod, with the node types, count and $/hour of the JAX package's
  Runtime round of the same batch with no fault;
- standing nodes on one simulated cloud backend: A places a first batch,
  which the test binds, then ends on the second batch's K1 (after the warm
  fill, K2's seam); B's recovery sweep finds no ghost and no orphan and
  deletes no node, and B's round gives the JAX package's outcome for the
  second batch on the same standing cluster;
- the entry point: cmd.controller.main on the in-memory backend raises the
  device-lost, having released the Lease.

The JAX package's singletons are restored after each test
(reference_singletons), its residency auditor off (its sampled audit raises
on Python 3.12, ROADMAP C).
"""

from __future__ import annotations

import copy
import signal
import socket
import time

import pytest

from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_runtime import RKit, _process_state, _wait, runtimes  # noqa: F401

CPUS = (0.5, 1.0, 1.5, 2.0)
MEMORY = ("512Mi", "1Gi", "2Gi")
FAKE_TYPES = 30
EMPTY_PODS = 40
# the standing case's batches (the port's testing.reclaim_wave_workload:
# build_workload's requests, zonal spread and generic pods, no affinity
# cohorts): the first places and is bound, the second overflows it
STANDING_PODS = (200, 120)
LEASE = dict(leader_elect=True, lease_duration=1.0, lease_renew_period=0.05)
WINDOWS = dict(batch_idle_duration=0.05, batch_max_duration=0.3, dense_min_batch=1)


@pytest.fixture(autouse=True)
def reference_auditor_off(reference_singletons):  # noqa: F811
    from karpenter_tpu.solver.audit import AUDITOR

    AUDITOR.disable()
    yield


def _asserting(*args, **kwargs):
    raise RuntimeError("CUDA error: device-side assert triggered")


def _batch(kit, tag: str, count: int) -> list:
    return [
        kit.make_pod(f"{tag}-{i:03d}", requests={"cpu": CPUS[i % len(CPUS)], "memory": MEMORY[i % len(MEMORY)]})
        for i in range(count)
    ]


def _placements(rt) -> list:
    """Wrap the Runtime's launch_nodes: each call's (node name, pods)
    placements, launched nodes and nominations onto standing ones."""
    sink = []
    launch_nodes = rt.provisioner.launch_nodes

    def watched(results, ice_failures=None, placed=None):
        mine = [] if placed is None else placed
        n0 = len(mine)
        launched = launch_nodes(results, ice_failures=ice_failures, placed=mine)
        sink.extend(mine[n0:])
        return launched

    rt.provisioner.launch_nodes = watched
    return sink


def _placed_names(placed) -> set:
    return {pod.name for _node, pods in placed for pod in pods}


def _lease(kube, rt):
    return kube.get("Lease", rt.elector.name, rt.elector.namespace)


def _end_on_the_fault(rt, kube):
    """A's batch loop meets the stood-in device-lost: the runtime turns
    unhealthy, stop() re-raises it (not injected), the Lease is released."""
    from karpenter_tpu_torch.solver.faults import SolverDeviceLostError

    assert _wait(lambda: not rt.healthy(), timeout=20.0), "the device-lost must end the batch loop"
    assert isinstance(rt.error, SolverDeviceLostError) and not rt.error.injected
    with pytest.raises(SolverDeviceLostError, match="device-side assert"):
        rt.stop()
    lease = _lease(kube, rt)
    assert lease.spec.holder_identity == rt.elector.identity and lease.spec.renew_time == 0.0, "the Lease is released"


def _outcome(nodes, price) -> dict:
    """Launched nodes by instance type, their count and $/hour."""
    from collections import Counter

    from karpenter_tpu_torch.api import labels as lbl

    types = Counter(n.metadata.labels[lbl.LABEL_INSTANCE_TYPE] for n in nodes)
    return {"types": dict(sorted(types.items())), "nodes": len(nodes), "price_per_hour": round(sum(price(n) for n in nodes), 9)}


def test_empty_cluster_successor_places_the_held_batch(runtimes, monkeypatch):  # noqa: F811
    import karpenter_tpu_torch.solver.dense as dense

    port, ref = RKit("port"), RKit("ref")
    kube = port.KubeCluster()
    a = runtimes(port, kube, port.fake_provider(FAKE_TYPES), **LEASE, **WINDOWS)
    kube.create(port.make_provisioner())
    launch = dense.bucket_cost_packed
    monkeypatch.setattr(dense, "bucket_cost_packed", _asserting)
    a.start()
    for pod in _batch(port, "lost", EMPTY_PODS):
        kube.create(pod)
    _end_on_the_fault(a, kube)
    assert not kube.list_nodes(), "the faulted round launches nothing"
    assert len(kube.pending_pods()) == EMPTY_PODS

    # the supervisor's restart: a fresh Runtime, nothing armed
    monkeypatch.setattr(dense, "bucket_cost_packed", launch)
    b = runtimes(port, kube, port.fake_provider(FAKE_TYPES), **LEASE, **WINDOWS)
    placed = _placements(b)
    t0 = time.monotonic()
    b.start()
    # a released Lease is won on the first round, not after it expires
    assert b.elector.is_leader() and time.monotonic() - t0 < LEASE["lease_duration"]
    lease = _lease(kube, b)
    assert lease.spec.holder_identity == b.elector.identity and lease.spec.lease_transitions == 1
    names = {f"lost-{i:03d}" for i in range(EMPTY_PODS)}
    # the round's results are kept once its launch has returned: wait for both
    assert _wait(lambda: names <= _placed_names(placed) and b.provisioner.last_results is not None, timeout=20.0), "the successor places every pod of the held batch"
    assert b.healthy() and b.provisioner.last_results is not None and not b.provisioner.last_results.unschedulable

    # the JAX package's Runtime round of the same batch, no fault
    ref_kube = ref.KubeCluster()
    ref_provider = ref.fake_provider(FAKE_TYPES)
    ref_rt = runtimes(ref, ref_kube, ref_provider, **LEASE, **WINDOWS)
    ref_kube.create(ref.make_provisioner())
    for pod in _batch(ref, "lost", EMPTY_PODS):
        ref_kube.create(pod)
    ref_results = ref_rt.provision_once()
    assert not ref_results.unschedulable
    prices = {it.name(): it.price() for it in port.fake.instance_types(FAKE_TYPES)}
    ref_prices = {it.name(): it.price() for it in ref.fake.instance_types(FAKE_TYPES)}
    assert prices == ref_prices

    def price(node):
        return prices[node.metadata.labels["node.kubernetes.io/instance-type"]]

    b.stop()
    assert _outcome(kube.list_nodes(), price) == _outcome(ref_kube.list_nodes(), price)


def _to_reference(obj):
    """A port object as the JAX package's, through the wire codecs."""
    from karpenter_tpu.kube.codec import from_wire
    from karpenter_tpu_torch.kube.codec import to_wire

    return from_wire(to_wire(copy.deepcopy(obj)), obj.kind)


def _launch_past(kit, backend, count: int) -> None:
    """Launch `count` instances on a fresh cloud backend, so the ids of its
    next launches follow those of the standing cluster copied into it
    instead of colliding with its nodes' names."""
    template = backend.ensure_launch_template("restart-ids", "img", [], "")
    for _ in range(count):
        spec = kit.backend.FleetInstanceSpec(
            instance_type=backend.catalog[0].name, zone="zone-a", capacity_type="on-demand", launch_template_id=template.template_id
        )
        backend.create_fleet(kit.backend.FleetRequest(specs=[spec], capacity_type="on-demand"))


def test_standing_nodes_survive_the_restart_and_the_successor_places_the_overflow(runtimes, monkeypatch):  # noqa: F811
    import karpenter_tpu_torch.solver.dense as dense
    import karpenter_tpu_torch.solver.warmfill as fill
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.api import labels as lbl

    port, ref = RKit("port"), RKit("ref")
    kube = port.KubeCluster()
    backend = port.backend.CloudBackend(clock=kube.clock)

    def provider():
        return port.provider.SimulatedCloudProvider(backend=backend, kube=kube, clock=kube.clock)

    options = dict(**LEASE, **WINDOWS, gc_registration_grace=0.5)
    a = runtimes(port, kube, provider(), **options)
    # created through the admission A registered: defaulted as the
    # webhook leaves it, so the spec nodes are hashed against never changes
    kube.create(port.make_provisioner())
    placed_a = _placements(a)
    launch, admission = dense.bucket_cost_packed, fill.admission_counts
    armed, fills = [], []

    def asserting(*args, **kwargs):
        if armed:
            _asserting()
        return launch(*args, **kwargs)

    def counted_fill(*args, **kwargs):
        if armed:
            fills.append(1)
        return admission(*args, **kwargs)

    monkeypatch.setattr(dense, "bucket_cost_packed", asserting)
    monkeypatch.setattr(fill, "admission_counts", counted_fill)
    a.start()
    first, second = STANDING_PODS
    for pod in testing.rename(testing.reclaim_wave_workload(first), "rsb1"):
        kube.create(pod)
    assert _wait(lambda: len(_placed_names(placed_a)) == first, timeout=20.0), "A places the first batch"
    # the kubelet's part: each node Ready, each pod bound to it
    for node_name, pods in list(placed_a):
        node = kube.get_node(node_name)
        node.status.conditions = [port.objects.NodeCondition(type="Ready", status="True")]
        kube.update(node)
        for pod in pods:
            kube.bind_pod(kube.get("Pod", pod.name, pod.namespace), node_name)
    assert _wait(lambda: all(n.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) == "true" for n in kube.list_nodes()), timeout=10.0)
    standing = {n.name for n in kube.list_nodes()}
    instances = set(backend.instances)
    assert standing and len(instances) == len(standing)

    armed.append(True)
    for pod in testing.rename(testing.reclaim_wave_workload(second, seed=43), "rsb2"):
        kube.create(pod)
    _end_on_the_fault(a, kube)
    assert fills, "the armed round ran the warm fill (K2) before K1"
    assert {n.name for n in kube.list_nodes()} == standing, "the faulted round launches nothing"
    assert len(kube.pending_pods()) == second
    snapshot = [copy.deepcopy(o) for o in kube.list_provisioners() + kube.list_nodes() + kube.list_pods()]

    # the supervisor's restart on the same cloud, nothing armed
    monkeypatch.setattr(dense, "bucket_cost_packed", launch)
    monkeypatch.setattr(fill, "admission_counts", admission)
    b = runtimes(port, kube, provider(), **options)
    placed_b = _placements(b)
    sweeps = []
    sweep = b.gc.reconcile

    def recorded_sweep():
        out = sweep()
        sweeps.append(out)
        return out

    b.gc.reconcile = recorded_sweep
    b.start()
    names = {f"dp-rsb2-{i:04d}" for i in range(second)}
    assert _wait(lambda: names <= _placed_names(placed_b), timeout=30.0), "the successor places every pod of the held batch"
    assert sweeps and sweeps[0] == {"orphans": [], "ghosts": []}, "the recovery sweep finds no ghost and no orphan"
    b.stop()
    nodes = kube.list_nodes()
    assert standing <= {n.name for n in nodes if n.metadata.deletion_timestamp is None}, "no standing node is deleted"
    assert instances <= set(backend.instances)
    new_nodes = [n for n in nodes if n.name not in standing]
    onto_standing = sum(len(pods) for node, pods in placed_b if node in standing)

    # the JAX package's Runtime round of the second batch on the same
    # standing cluster, no fault
    ref_kube = ref.KubeCluster()
    ref_backend = ref.backend.CloudBackend(clock=ref_kube.clock)
    _launch_past(ref, ref_backend, len(instances))
    ref_provider = ref.provider.SimulatedCloudProvider(backend=ref_backend, kube=ref_kube, clock=ref_kube.clock)
    for obj in snapshot:
        ref_kube.create(_to_reference(obj))
    ref_rt = runtimes(ref, ref_kube, ref_provider, **options)
    ref_results = ref_rt.provision_once()
    assert not ref_results.unschedulable
    ref_new = [n for n in ref_kube.list_nodes() if n.name not in standing]

    def price(node):
        labels = node.metadata.labels
        if labels.get(lbl.LABEL_CAPACITY_TYPE) == "spot":
            return backend.spot_prices[(labels[lbl.LABEL_INSTANCE_TYPE], labels[lbl.LABEL_TOPOLOGY_ZONE])]
        return backend.od_prices[labels[lbl.LABEL_INSTANCE_TYPE]]

    assert onto_standing == sum(len(v.pods) for v in ref_results.existing_nodes)
    assert 0 < onto_standing < second and new_nodes, "the second batch overflows the standing room"
    assert _outcome(new_nodes, price) == _outcome(ref_new, price)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_the_entry_point_raises_the_device_lost_after_releasing_the_lease(monkeypatch):
    """cmd.controller.main on the in-memory backend, its Runtime on the CPU:
    the batch loop's device-lost ends main's wait, stop() releases the
    Lease and main raises the fault, so the process exits non-zero on it."""
    import karpenter_tpu_torch.runtime as runtime_module
    import karpenter_tpu_torch.solver.dense as dense
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cmd import controller
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.kube.leaderelection import LEASE_NAME, LEASE_NAMESPACE
    from karpenter_tpu_torch.solver.faults import SolverDeviceLostError

    kube = KubeCluster()
    kube.create(testing.make_provisioner())
    for pod in _batch(RKit("port"), "main", 8):
        kube.create(pod)
    built, cls = [], runtime_module.Runtime

    def runtime(**kwargs):
        built.append(cls(**kwargs, device="cpu"))
        return built[-1]

    monkeypatch.setattr(controller, "build_kube_backend", lambda options: (kube, ""))
    monkeypatch.setattr(runtime_module, "Runtime", runtime)
    monkeypatch.setattr(dense, "bucket_cost_packed", _asserting)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        with pytest.raises(SolverDeviceLostError, match="device-side assert") as raised:
            controller.main([
                "--health-probe-port", str(_free_port()), "--metrics-port", str(_free_port()),
                "--dense-min-batch", "1", "--lease-renew-period", "0.05",
                "--batch-idle-duration", "0.05", "--batch-max-duration", "0.3",
            ])
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    assert not raised.value.injected
    rt = built[0]
    assert not rt.healthy() and not any(t.is_alive() for t in rt.threads())
    lease = kube.get("Lease", LEASE_NAME, LEASE_NAMESPACE)
    assert lease.spec.holder_identity == rt.elector.identity and lease.spec.renew_time == 0.0
    assert not kube.list_nodes() and len(kube.pending_pods()) == 8
