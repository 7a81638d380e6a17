"""A recorded Runtime round on both packages.

The same round as chip_smoke.py's runtime_round_recorded, at a small size
on the CPU: standing 16-CPU nodes, the default provisioner, and a seeded
batch of bench.py's mixed workload, under a Runtime with the flight
recorder, the journal, the SLO accountant and the capsules on. One
synchronous provision_once(), every pod the journal saw nominated bound to
its node (the kube-scheduler's part), then one reconcile_once(): the node
controller initializes the new nodes and the SLO scraper prices the
cluster and runs its ideal repack. Timings are left out; the rest must be equal on both
packages:

- the journal's events counted by (kind, event), and its waterfall's
  completed pods and conservation verdict;
- the SLO pending-duration and node-ready summaries' counts, the cluster
  and ideal $/hour and the drift ratio;
- each flight record's signature (less the padded dims), fill routing,
  pods committed and to host, solve for solve (the round's and the ideal
  repack's); the port's records name the plain dispatch and no build;
- no capsule fires.

The JAX package's residency auditor is disabled (its tuple seed, ROADMAP C).
"""

from __future__ import annotations

from collections import Counter

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_runtime import RKit

PODS = 900
STANDING = 12
TYPES = 60
SEED = 13

# the flight-record fields that depend neither on the clock nor on the
# device runtime (the JAX package records its XLA compilations, a dispatch
# flavor and padded dims of its own, sharded over the test process's
# virtual devices)
RECORD_FIELDS = ("signature", "fill_routing", "pods_committed", "pods_to_host")
PADDED = ("buckets_padded", "types_padded")


def _standing(kit, kube, count: int) -> None:
    """testing.standing_cluster's nodes, through either package's make_node."""
    lbl = kit.labels
    for i in range(count):
        kube.create(
            kit.make_node(
                name=f"churn-n{i:04d}",
                labels={
                    lbl.PROVISIONER_NAME_LABEL: "default",
                    lbl.LABEL_INSTANCE_TYPE: "fake-it-15",
                    lbl.LABEL_TOPOLOGY_ZONE: ("test-zone-1", "test-zone-2", "test-zone-3")[i % 3],
                    lbl.LABEL_CAPACITY_TYPE: "on-demand",
                },
                allocatable={"cpu": 16, "memory": "32Gi", "pods": 110},
            )
        )


def _workload(kit):
    if kit.side == "ref":
        import bench

        return bench.build_workload(PODS, seed=SEED)
    from karpenter_tpu_torch import testing

    return testing.build_workload(PODS, seed=SEED)


def recorded_round(side: str) -> dict:
    kit = RKit(side)
    root = kit.root
    journal = __import__(f"{root}.journal", fromlist=["JOURNAL"])
    slo = __import__(f"{root}.slo", fromlist=["SLO"])
    flight = __import__(f"{root}.flight", fromlist=["FLIGHT"])
    capsule = __import__(f"{root}.capsule", fromlist=["CAPSULE"])
    singletons = (journal.JOURNAL, slo.SLO, flight.FLIGHT, capsule.CAPSULE)
    for singleton in singletons:
        singleton.reset()
    kube = kit.KubeCluster()
    _standing(kit, kube, STANDING)
    kube.create(kit.make_provisioner())
    rt = kit.build(
        kube, kit.fake_provider(TYPES), leader_elect=False, dense_min_batch=1,
        enable_solver_telemetry=True, enable_journal=True, enable_slo=True, enable_capsules=True,
        journal_ring_size=65536,
    )
    # nodes launch one at a time, so both packages' clusters hold them in one
    # order and sum the cluster's $/hour in it (ROADMAP C)
    rt.provisioner.LAUNCH_WORKERS = 1
    try:
        for pod in _workload(kit):
            kube.create(pod)
        rt.provision_once()
        bound = _bind_nominated(kube, journal.JOURNAL)
        rt.reconcile_once()
        assert capsule.CAPSULE.poll() == 0
        events = journal.JOURNAL.events(limit=1_000_000)
        waterfall = journal.JOURNAL.waterfall_index()
        pending = slo.PENDING_LATENCY
        ready = slo.NODE_READY
        return {
            "bound": bound,
            "journal": sorted(Counter((e["kind"], e["event"]) for e in events).items()),
            "waterfall": (waterfall["pods_completed"], waterfall["conservation"]["violations"]),
            "pending_counts": sorted((tuple(sorted(labels.items())), pending.count(**labels)) for labels in pending.series()),
            "ready_counts": sorted((tuple(sorted(labels.items())), ready.count(**labels)) for labels in ready.series()),
            "cost": (slo.CLUSTER_COST.value(), slo.IDEAL_COST.value(), slo.COST_DRIFT.value()),
            "records": [_record(r) for r in flight.FLIGHT.records()],
            "dispatch": [r.dispatch for r in flight.FLIGHT.records()] if side == "port" else None,
            "builds": [r.compiled_fns for r in flight.FLIGHT.records()] if side == "port" else None,
            "capsules": capsule.CAPSULE.captures_total(),
        }
    finally:
        rt.stop()
        for singleton in singletons:
            singleton.disable()
            singleton.reset()


def _record(record) -> dict:
    out = {k: record.to_dict()[k] for k in RECORD_FIELDS}
    out["signature"] = {k: v for k, v in out["signature"].items() if k not in PADDED}
    return out


def _bind_nominated(kube, journal) -> int:
    """Bind every pod the journal saw nominated to the node it names (the
    Runtime's event ring keeps too few events for a whole batch)."""
    pods = {p.name: p for p in kube.list_pods()}
    nodes = {n.name for n in kube.list_nodes()}
    bound = 0
    for event in reversed(journal.events(limit=1_000_000)):
        if event["kind"] != "pod" or event["event"] != "nominated":
            continue
        pod = pods.get(event["entity"])
        node_name = event["attrs"]["node"]
        if pod is None or pod.spec.node_name or node_name not in nodes:
            continue
        kube.bind_pod(pod, node_name)
        bound += 1
    return bound


def test_recorded_round_on_both_packages():
    ref, port = recorded_round("ref"), recorded_round("port")
    assert port["bound"] == PODS, port["bound"]
    journal = dict(port["journal"])
    assert journal[("pod", "created")] == journal[("pod", "bound")] == PODS
    assert journal[("pod", "solved")] == PODS
    assert port["waterfall"] == (min(PODS, 4096), 0)
    assert sum(n for _labels, n in port["pending_counts"]) == PODS
    assert len(port["records"]) >= 2, "the round's solve and the ideal repack"
    assert port.pop("dispatch") == ["plain"] * len(port["records"])
    assert port.pop("builds") == [{}] * len(port["records"])
    assert port["cost"][2] >= 1.0
    assert port["capsules"] == 0
    ref.pop("dispatch"), ref.pop("builds")
    assert port == ref
