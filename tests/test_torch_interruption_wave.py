"""A spot reclaim wave held on both packages: chip_smoke.py's
`interruption_reclaim_wave` cell, shrunk.

The repo's spot_reclaim_wave scenario (karpenter_tpu/scenarios/campaign.py,
SpotReclaimWave: the first populated nodes in store order, at most 8)
scaled to 2,000 ReplicaSet-owned pods of build_workload's request mix
(the first seventh in zonal-spread cohorts, the rest generic) on a
spot-only provisioner over the simulated cloud's default catalog: the
fewest pods whose fleet (19 nodes) gives the primitive its 8 victims
(fraction 0.6 of the populated nodes, at most 8). One round launches the
fleet; the nodes turn Ready, the nominations bind. Then 8 nodes get a
spot notice; the interruption controller handles them (the reclaimed pool
quarantined, the victim's pods re-solved with the victim excluded, the
replacement launched, the victim drained). A stand-in ReplicaSet recreates
each evicted pod, one round places them, the clock passes the deadlines,
the cloud reclaims what is due and the gc sweep runs.

Both packages run it in-process (the reference's Runtime, the port's
SimulatedEnv), with the exact host loop and with the dense solve at
min_batch=1, and must agree on the victims, the quarantined pools, each
notice's re-solve (its pods, the pods it put on standing nodes, its route
and the replacements' type, zone and capacity type), the post-drain
round's outcome and the end state. No replacement or post-drain launch
lands on a quarantined pool. A wave books standing capacity that an
earlier notice of the same wave already booked (each re-solve reads a
fresh `nodes_snapshot()` that counts neither the pods earlier notices
placed there nor the earlier replacements): both packages do so alike,
and the post-drain round pays for it.

A second case holds the solver's caches against a quarantine: two solves
on one DenseSolver, the first solve's pool quarantined between them.
"""

from __future__ import annotations

import pytest

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_interruption import RefSimulatedEnv, SKit, leader_cleared  # noqa: F401
from tests.test_torch_provisioning import MODES, reference_singletons, run_both  # noqa: F401

WAVE_PODS = 2000
# SpotReclaimWave's rule (karpenter_tpu/scenarios/primitives.py:244-261)
WAVE_FRACTION, MAX_VICTIMS = 0.6, 8
# every event of the set-up and the wave is kept: nominations are read back
# from the recorder, whose default ring keeps 1,000
EVENT_CAPACITY = 100_000


def wave_workload(k, count: int, seed: int = 42):
    """The pods of the wave, named alike on both packages: the reference's
    built here from its classes as testing.reclaim_wave_workload builds the
    port's (the same draws from the same seed)."""
    if k.side == "port":
        from karpenter_tpu_torch.testing import reclaim_wave_workload

        pods = reclaim_wave_workload(count, seed)
    else:
        pods = _reference_wave_workload(k, count, seed)
    for i, pod in enumerate(pods):
        pod.metadata.name = f"wave-{i:05d}"
    return pods


def _reference_wave_workload(k, count: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    cpus = [0.1, 0.25, 0.5, 1.0, 1.5]
    mems = ["100Mi", "256Mi", "512Mi", "1Gi", "2Gi", "4Gi"]
    values = "abcdefg"

    def size():
        return {"cpu": cpus[rng.integers(len(cpus))], "memory": mems[rng.integers(len(mems))]}

    pods = []
    for _ in range(count // 7):
        label = {"spread": values[rng.integers(7)]}
        constraint = k.obj.TopologySpreadConstraint(
            max_skew=1, topology_key=k.lbl.LABEL_TOPOLOGY_ZONE, label_selector=k.obj.LabelSelector(match_labels=label)
        )
        pods.append(k.owned(labels=label, requests=size(), topology_spread_constraints=[constraint]))
    while len(pods) < count:
        pods.append(k.owned(labels={"app": values[rng.integers(7)]}, requests=size()))
    return pods


def replicaset_stand_in(k, env) -> list:
    """A ReplicaSet-owned pod that is deleted comes back pending under a new
    name, with its labels, requests and spread constraints."""
    recreated = []

    def on_pod(event):
        pod = event.obj
        if event.type != k.kube_module.DELETED or not any(r.kind == "ReplicaSet" for r in pod.metadata.owner_references):
            return
        name = f"rs-{len(recreated):06d}"
        recreated.append(name)
        env.kube.create(k.owned(
            name=name, labels=dict(pod.metadata.labels), requests=dict(pod.spec.containers[0].resources.requests),
            topology_spread_constraints=list(pod.spec.topology_spread_constraints),
        ))

    env.kube.watch("Pod", on_pod, replay=False)
    return recreated


def bind_nominated(env) -> int:
    """Bind each pending pod nominated onto a node in the store to it."""
    nodes = {n.name for n in env.kube.list_nodes()}
    pods = {p.name: p for p in env.kube.list_pods()}
    bound = 0
    for event in env.recorder.of("NominatePod"):
        pod, node = pods.get(event.object_name), event.message.split()[-1]
        if pod is not None and not pod.spec.node_name and node in nodes:
            env.kube.bind_pod(pod, node)
            bound += 1
    return bound


def pool(k, node) -> tuple:
    labels = node.metadata.labels
    return (labels[k.lbl.LABEL_INSTANCE_TYPE], labels[k.lbl.LABEL_TOPOLOGY_ZONE], labels[k.lbl.LABEL_CAPACITY_TYPE])


def wave_env(k):
    """The fleet: the spot-only provisioner, the pods, one round, every node
    Ready, every nomination bound, the node controller run."""
    if k.side == "ref":
        from collections import deque

        env = RefSimulatedEnv(interruption_queue="interruptions")
        env.recorder.events = deque(maxlen=EVENT_CAPACITY)
        env.recorder.inner.events = deque(maxlen=EVENT_CAPACITY)
    else:
        from karpenter_tpu_torch.testing import SimulatedEnv

        env = SimulatedEnv(event_capacity=EVENT_CAPACITY)
    k._routed(env, k.mode_solver())
    env.kube.create(k.make_provisioner(
        requirements=[k.obj.NodeSelectorRequirement(key=k.lbl.LABEL_CAPACITY_TYPE, operator=k.obj.OP_IN, values=["spot"])]
    ))
    for pod in wave_workload(k, WAVE_PODS):
        env.kube.create(pod)
    env.provision()
    for node in env.kube.list_nodes():
        node.status.conditions = [k.obj.NodeCondition(type="Ready", status="True")]
        env.kube.update(node)
    bind_nominated(env)
    env.node_controller.reconcile_all()
    return env


def run_wave(k, env) -> dict:
    """The wave, its converge and its record; the checks that hold on both
    packages run here."""
    kube, backend, provider = env.kube, env.backend, env.provider
    recreated = replicaset_stand_in(k, env)
    notices = []
    ctrl = env.provisioner_controller
    schedule, launch = ctrl.schedule, ctrl.launch_nodes

    def traced_schedule(pods, state_nodes, opts=None, **kwargs):
        solver = ctrl.dense_solver
        before = None if solver is None else (solver.stats.batches, solver.stats.pods_to_host)
        results = schedule(pods, state_nodes, opts, **kwargs)
        if opts is not None and opts.simulation_mode:
            notices.append({
                "pods": len(pods),
                "on_existing": sum(len(v.pods) for v in results.existing_nodes),
                "new_node_pods": sum(len(n.pods) for n in results.new_nodes),
                "unschedulable": len(results.unschedulable),
                "dense_batches": None if solver is None else solver.stats.batches - before[0],
                "pods_to_host": None if solver is None else solver.stats.pods_to_host - before[1],
                "quarantined": sorted(provider.unavailable.snapshot()),
            })
        return results

    def traced_launch(results, *args, **kwargs):
        names = launch(results, *args, **kwargs)
        if notices and "replacements" not in notices[-1]:
            notices[-1]["replacements"] = [pool(k, kube.get_node(name)) for name in names]
        return names

    ctrl.schedule, ctrl.launch_nodes = traced_schedule, traced_launch
    populated = [n for n in kube.list_nodes() if kube.pods_on_node(n.name)]
    victims = populated[: max(1, min(MAX_VICTIMS, int(len(populated) * WAVE_FRACTION)))]
    deadlines = [backend.interrupt_spot_instance(env.instance_id(n)) for n in victims]
    polls = 0
    while backend.notifications.depth() and polls < 10:
        env.interruption.poll_once()
        polls += 1
    assert backend.notifications.depth() == 0, "every notice handled and deleted"
    assert len(notices) == len(victims), "one re-solve per victim"
    ctrl.schedule, ctrl.launch_nodes = schedule, launch
    for notice in notices:
        quarantined = set(notice["quarantined"])
        assert not [p for p in notice.get("replacements", []) if p in quarantined], "replacement on a quarantined pool"
    for _ in range(4):
        if all(kube.get_node(v.name) is None for v in victims):
            break
        env.termination_controller.reconcile_all()
    assert all(kube.get_node(v.name) is None for v in victims)
    drained = len(recreated)
    quarantined = set(provider.unavailable.snapshot())
    before = {n.name for n in kube.list_nodes()}
    results = env.provision()
    post_drain = [pool(k, n) for n in kube.list_nodes() if n.name not in before]
    assert not [p for p in post_drain if p in quarantined], "post-drain launch on a quarantined pool"
    bind_nominated(env)
    pending = sorted(p.name for p in kube.list_pods() if not p.spec.node_name)
    env.clock.step(max(deadlines) - env.clock.now() + 1.0)
    reclaimed = backend.reclaim_due_instances()
    swept = env.gc.reconcile()
    live = {i.instance_id for i in backend.list_instances()}
    nodes = {n.name: n for n in kube.list_nodes()}
    assert all(env.instance_id(n) in live for n in nodes.values()), "a node points at a dead instance"
    assert all(p.spec.node_name in nodes for p in kube.list_pods() if p.spec.node_name), "a pod bound to a gone node"
    return {
        "victims": [(v.name, pool(k, v)) for v in victims],
        "quarantined": sorted(quarantined),
        "notices": notices,
        "drained_pods": drained,
        "round": {
            "on_existing": sum(len(v.pods) for v in results.existing_nodes),
            "new_nodes": sorted(
                (n.instance_type_options[0].name(), len(n.pods)) for n in results.new_nodes if n.pods
            ),
            "unschedulable": len(results.unschedulable),
        },
        "post_drain_launches": sorted(post_drain),
        "pending_after_round": pending,
        "reclaimed": reclaimed,
        "gc": swept,
        "nodes": sorted((name, pool(k, n)) for name, n in nodes.items()),
        "pods_bound": sum(1 for p in kube.list_pods() if p.spec.node_name),
        "pods": len(kube.list_pods()),
    }


@pytest.mark.parametrize("mode", MODES)
def test_spot_reclaim_wave_matches_reference(mode):
    def scenario(k):
        env = wave_env(k)
        fleet = sorted(pool(k, n) for n in env.kube.list_nodes())
        record = run_wave(k, env)
        if k.mode == "dense":
            assert all(n["dense_batches"] >= 1 for n in record["notices"]), "every re-solve runs dense at min_batch 1"
        assert len(record["victims"]) == MAX_VICTIMS
        assert record["quarantined"], "the reclaimed pools are quarantined"
        assert record["gc"] == {"orphans": [], "ghosts": []}
        return [fleet, record]

    ref, port = run_both(lambda k: scenario(SKit(k.side, k.mode)), mode)
    assert port == ref


def test_quarantine_between_two_solves_on_one_dense_solver():
    """The port caches the availability cube on every DenseSolver (keyed on
    the catalog's avail array) and the catalog encoding (keyed on the
    instance-type objects): a quarantine rebuilds the simulated catalog's
    objects, so the second solve must miss both caches and see the cell
    zeroed. Both packages make the same choices and count the same masked
    offerings."""

    def scenario(k):
        clock = k.clock.FakeClock()
        kube = k.kube_module.KubeCluster(clock=clock)
        provider = k.provider.SimulatedCloudProvider(backend=k.backend.CloudBackend(clock=clock), kube=kube, clock=clock)
        provisioner = k.make_provisioner(
            requirements=[k.obj.NodeSelectorRequirement(key=k.lbl.LABEL_CAPACITY_TYPE, operator=k.obj.OP_IN, values=["spot"])]
        )
        solver = k.solver()
        choices, cubes = [], []
        for step in range(2):
            pods = k.pods(12, requests={"cpu": "1", "memory": "1Gi"})
            results = k.build_scheduler([provisioner], provider, pods, dense_solver=solver).solve(pods)
            node = next(n for n in results.new_nodes if n.pods)
            it = node.instance_type_options[0]
            cheapest = min(
                (o for o in it.offerings() if o.available and o.capacity_type == "spot"), key=lambda o: o.price
            )
            choices.append((it.name(), cheapest.zone, solver.stats.masked_offerings, len(node.pods)))
            if k.side == "port":
                cubes.append(solver._avail_cube_dev)
            if step == 0:
                provider.mark_offering_unavailable(it.name(), cheapest.zone, "spot")
        assert choices[0][2] == 0 and choices[1][2] == 1, "the second solve counts the quarantined cell"
        assert choices[1][:2] != choices[0][:2], "the second solve routes around the quarantined pool"
        if k.side == "port":
            (first, _), (second, cube) = cubes
            assert second is not first, "the quarantine missed the cached cube"
            assert int(first.sum()) - int(second.sum()) == 1, "the quarantined cell is zeroed"
            assert float(cube.sum()) == float(second.sum()), "the resident cube is the new catalog's"
        return choices

    ref, port = run_both(lambda k: scenario(SKit(k.side, k.mode)), "dense")
    assert port == ref
