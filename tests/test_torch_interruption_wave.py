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
min_batch=1, and must agree on what the port's repair leaves as it was:
the fleet, the victims, the quarantined pools, each notice's pods and the
quarantine it sees, the first notice's re-solve and bookings, and the end
state's invariants (no pod pending, gc clean, no node on a dead instance).
No replacement or post-drain launch lands on a quarantined pool. The
reference's later notices book capacity an earlier notice of the same wave
already booked: each re-solves on a fresh `nodes_snapshot()` that counts
neither the pods earlier notices placed on standing nodes nor those meant
for the earlier replacements, so at least one node is booked beyond its
room and the post-drain round pays for it. The port's interruption
controller keeps a ledger of what its re-solves placed and counts it in
every later re-solve, on the snapshot and in the topology domains: no node
is booked beyond its room, over one poll or two. Further cases hold the
ledger's lifetime, a spread cohort counted once at its booked nodes, and
the double count the nomination window allows (a successor bound inside it
shrinks a later re-solve's room, never over-books a node).

A second case holds the solver's caches against a quarantine: two solves
on one DenseSolver, the first solve's pool quarantined between them.
"""

from __future__ import annotations

import sys

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


def price(k, backend, node) -> float:
    """$/hour of a node: its pool's price in the simulated cloud's books."""
    type_name, zone, capacity_type = pool(k, node)
    if capacity_type == "spot":
        return backend.get_spot_price(type_name, zone)
    return backend.get_on_demand_price(type_name)


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


def placements(results, names) -> list:
    """The (node name, pods) pairs of a launch that collected none (the
    reference's launch_nodes has no `placed`): each launched node's pods,
    then each standing node's. Every create of the wave succeeds, so the
    names pair with the new nodes in order."""
    new = [vn for vn in results.new_nodes if vn.pods]
    assert len(names) == len(new), "a replacement's create failed"
    return list(zip(names, (vn.pods for vn in new))) + [(v.node.name, v.pods) for v in results.existing_nodes if v.pods]


class Bookings:
    """What the wave booked onto each node against its room: the requests
    of the pods bound to it when the wave starts (daemonset pods aside) and
    of every pod any notice placed on it, against its allocatable less the
    daemonset overhead."""

    def __init__(self, k, env):
        self.res, self.env = k.res, env
        self.overhead = {}
        for pod in env.provisioner_controller.daemonset_pods():
            self.overhead = self.res.merge(self.overhead, self.res.pod_requests(pod))
        self.room, self.used, self.placed, self.launched = {}, {}, [], []
        for node in env.kube.list_nodes():
            self._room(node)
        for pod in env.kube.list_pods():
            if pod.spec.node_name and not any(r.kind == "DaemonSet" for r in pod.metadata.owner_references):
                self._add(pod.spec.node_name, pod)

    def _room(self, node) -> None:
        self.room.setdefault(node.name, self.res.subtract(dict(node.status.allocatable), self.overhead))

    def _add(self, name, pod) -> None:
        self.used[name] = self.res.merge(self.used.get(name, {}), self.res.pod_requests(pod))

    def book(self, placed) -> None:
        """One launch's (node name, pods) pairs; a replacement's room is read
        when it launches."""
        self.placed.append([(name, sorted(p.name for p in pods)) for name, pods in placed])
        for name, pods in placed:
            if name not in self.room:
                self.launched.append(name)
            self._room(self.env.kube.get_node(name))
            for pod in pods:
                self._add(name, pod)

    def launched_price(self, k, backend) -> list:
        """$/hour of each node a notice launched."""
        return [price(k, backend, self.env.kube.get_node(name)) for name in self.launched]

    def over(self) -> list:
        """The nodes booked beyond their room, in some resource."""
        return sorted(
            name for name, used in self.used.items()
            if any(v > self.room[name].get(key, 0.0) + 1e-6 for key, v in used.items())
        )

    def summary(self) -> dict:
        booked = {}
        for name in self.used:
            booked = self.res.merge(booked, self.used[name])
        room = {}
        for name in self.used:
            room = self.res.merge(room, self.room[name])
        return {"overbooked": self.over(), "booked_cpu": booked.get("cpu", 0.0), "room_cpu": room.get("cpu", 0.0)}


def run_wave(k, env, max_messages=None) -> dict:
    """The wave, its converge and its record; the checks that hold on both
    packages run here. With `max_messages` set on the controller instance
    the notices arrive over several polls, with no provisioning round
    between them."""
    kube, backend, provider = env.kube, env.backend, env.provider
    recreated = replicaset_stand_in(k, env)
    notices = []
    ctrl = env.provisioner_controller
    schedule, launch = ctrl.schedule, ctrl.launch_nodes
    bookings = Bookings(k, env)
    if max_messages is not None:
        env.interruption.MAX_MESSAGES = max_messages

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
            placed = kwargs.get("placed")
            bookings.book(placements(results, names) if placed is None else placed)
        return names

    ctrl.schedule, ctrl.launch_nodes = traced_schedule, traced_launch
    fleet_price = sum(price(k, backend, n) for n in kube.list_nodes())
    populated = [n for n in kube.list_nodes() if kube.pods_on_node(n.name)]
    victims = populated[: max(1, min(MAX_VICTIMS, int(len(populated) * WAVE_FRACTION)))]
    deadlines = [backend.interrupt_spot_instance(env.instance_id(n)) for n in victims]
    polls = 0
    while backend.notifications.depth() and polls < 10:
        n0 = len(notices)
        env.interruption.poll_once()
        polls += 1
        for notice in notices[n0:]:
            notice["poll"] = polls
    assert backend.notifications.depth() == 0, "every notice handled and deleted"
    assert len(notices) == len(victims), "one re-solve per victim"
    ctrl.schedule, ctrl.launch_nodes = schedule, launch
    booked = bookings.summary()
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
    post_drain_nodes = [n for n in kube.list_nodes() if n.name not in before]
    post_drain = [pool(k, n) for n in post_drain_nodes]
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
        "polls": polls,
        "bookings": booked,
        "booked": bookings.placed,
        "prices": {
            "fleet": fleet_price,
            "victims": sum(price(k, backend, v) for v in victims),
            "replacements": sum(bookings.launched_price(k, backend)),
            "post_drain": sum(price(k, backend, n) for n in post_drain_nodes),
            "end": sum(price(k, backend, n) for n in nodes.values()),
        },
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


def wave_scenario(k, max_messages=None):
    """A fresh fleet and its wave; the checks that hold on both packages."""
    env = wave_env(k)
    fleet = sorted(pool(k, n) for n in env.kube.list_nodes())
    record = run_wave(k, env, max_messages)
    if k.mode == "dense":
        assert all(n["dense_batches"] >= 1 for n in record["notices"]), "every re-solve runs dense at min_batch 1"
    assert len(record["victims"]) == MAX_VICTIMS
    assert record["quarantined"], "the reclaimed pools are quarantined"
    assert record["gc"] == {"orphans": [], "ghosts": []}
    assert record["pending_after_round"] == [], "every pod placed by the post-drain round"
    record["fleet"] = fleet
    return record


# what the repair leaves as it was: the fleet, the victims, the quarantined
# pools, the pods each notice re-solves and the quarantine it sees, the
# first notice's re-solve and launch, and the end state's invariants
UNTOUCHED = ("fleet", "victims", "quarantined", "drained_pods", "gc", "pending_after_round", "pods")


@pytest.mark.parametrize("mode", MODES)
def test_spot_reclaim_wave_matches_reference(mode):
    """The wave on both packages: what the repair leaves as it was is equal
    (UNTOUCHED, each notice's pods and quarantine, the first notice's
    re-solve and its bookings, which no earlier notice can shift); the
    later notices are held to the new bound, no node booked beyond its
    room, on the port, where the reference books some twice."""
    ref, port = run_both(lambda k: wave_scenario(SKit(k.side, k.mode)), mode)
    assert {key: port[key] for key in UNTOUCHED} == {key: ref[key] for key in UNTOUCHED}
    assert [(n["pods"], n["quarantined"]) for n in port["notices"]] == [(n["pods"], n["quarantined"]) for n in ref["notices"]]
    assert port["notices"][0] == ref["notices"][0], "the first notice's re-solve"
    assert port["booked"][0] == ref["booked"][0], "the first notice's bookings"
    assert port["bookings"]["overbooked"] == [], "a later notice booked a node beyond its room"
    assert port["pods_bound"] == port["pods"]


@pytest.mark.parametrize("mode", MODES)
def test_wave_books_no_node_beyond_its_room(mode):
    """Over the whole wave, the pods bound to each node when it starts plus
    every pod any notice booked onto it stay within its allocatable less
    the daemonset overhead, on the port; the reference's later notices book
    room an earlier notice booked (at least one node over its room). On
    both, every launch is accounted for in the end state's $/hour: the
    fleet less the victims plus the replacements and the post-drain
    launches, to 1e-9 relative."""
    ref, port = run_both(lambda k: wave_scenario(SKit(k.side, k.mode)), mode)
    assert ref["bookings"]["overbooked"], "the reference's wave reached no double-booking"
    assert ref["bookings"]["booked_cpu"] > ref["bookings"]["room_cpu"], "the reference booked more CPU than its nodes hold"
    assert port["bookings"]["overbooked"] == []
    assert port["bookings"]["booked_cpu"] <= port["bookings"]["room_cpu"]
    for record in (ref, port):
        p = record["prices"]
        assert p["end"] == pytest.approx(p["fleet"] - p["victims"] + p["replacements"] + p["post_drain"], rel=1e-9)


@pytest.mark.parametrize("mode", MODES)
def test_wave_notices_over_two_polls(mode):
    """MAX_MESSAGES 4 on the controller instance: the 8 notices arrive in
    two polls, 4 re-solves each, with no provisioning round between them.
    The second poll's re-solves count what the first poll's booked: no
    node beyond its room, and the same bookings as the one-poll wave. The
    reference, split alike, still books some nodes twice."""

    def scenario(k):
        split = wave_scenario(k, max_messages=4)
        assert [n["poll"] for n in split["notices"]] == [1] * 4 + [2] * 4, "the notices did not arrive over two polls"
        return split, wave_scenario(k) if k.side == "port" else None

    (ref, _), (port, whole) = run_both(lambda k: scenario(SKit(k.side, k.mode)), mode)
    assert ref["bookings"]["overbooked"], "the reference's split wave reached no double-booking"
    assert port["bookings"]["overbooked"] == []
    assert port["booked"] == whole["booked"], "the split wave booked otherwise than the one-poll wave"
    assert port["post_drain_launches"] == whole["post_drain_launches"]


def _ledger(interruption) -> list:
    """The ledger's live pairs as the next re-solve reads them."""
    with interruption._lock:
        return interruption._live_bookings()


def _watch_launches(env) -> list:
    """Each launch's (node name, pod names) pairs from now on."""
    launches = []
    launch = env.provisioner_controller.launch_nodes

    def watched(results, *args, **kwargs):
        names = launch(results, *args, **kwargs)
        launches.append(_names(kwargs["placed"]))
        return names

    env.provisioner_controller.launch_nodes = watched
    return launches


def _names(pairs) -> list:
    return [(name, [p.name for p in pods]) for name, pods in pairs]


def _victims(env, count: int) -> list:
    return [n for n in env.kube.list_nodes() if env.kube.pods_on_node(n.name)][:count]


@pytest.mark.parametrize("mode", MODES)
def test_booking_ledger_lifetime(mode):
    """The interruption controller's ledger on the port: each launch of a
    re-solve enters its (node name, pods) pairs, copies of the pods; an
    entry leaves once its node is gone from cluster state (a replacement
    whose node has not reached cluster state yet stays), and every entry
    once the cluster's nomination window has passed on the FakeClock. A
    re-solve that raised enters nothing, and its redelivered notice books
    once."""
    k = SKit("port", mode)
    env = wave_env(k)
    interruption, kube = env.interruption, env.kube
    launches = _watch_launches(env)
    v1, v2 = _victims(env, 2)
    fleet = {n.name for n in kube.list_nodes()}
    env.backend.interrupt_spot_instance(env.instance_id(v1))
    interruption.poll_once()
    assert len(launches) == 1 and launches[0], "the first notice placed nothing"
    live = _ledger(interruption)
    assert _names(live) == launches[0]
    stored = {p.name: p for p in kube.list_pods()}
    assert all(p is not stored.get(p.name) for _, pods in live for p in pods), "the ledger holds the stored pods"

    # a standing node the notice booked is deleted: its entry leaves
    standing = next(name for name, _ in live if name in fleet and name != v2.name)
    kube.delete(kube.get_node(standing))
    kube.finalize(kube.get_node(standing))
    assert env.cluster.get_state_node(standing) is None
    assert _names(_ledger(interruption)) == [pair for pair in launches[0] if pair[0] != standing]

    # an entry whose node has not reached cluster state stays until it has
    # come and gone
    late_pod = next(iter(stored.values()))
    interruption._book([("late-node", [late_pod])])
    assert ("late-node", [late_pod.name]) in _names(_ledger(interruption))

    # the nomination window passes: every entry leaves
    env.clock.step(env.cluster.nomination_ttl + 1.0)
    assert _ledger(interruption) == []

    # a re-solve that raises enters nothing; its redelivered notice books once
    schedule = env.provisioner_controller.schedule
    calls = []

    def flaky(*args, **kwargs):
        calls.append(len(_ledger(interruption)))
        if len(calls) == 1:
            raise RuntimeError("transient failure of the re-solve")
        return schedule(*args, **kwargs)

    env.provisioner_controller.schedule = flaky
    env.backend.interrupt_spot_instance(env.instance_id(v2))
    with pytest.raises(RuntimeError, match="transient failure"):
        interruption.poll_once()
    assert _ledger(interruption) == [] and len(launches) == 1, "the failed re-solve entered a booking"
    env.clock.step(31)
    interruption.poll_once()
    assert calls == [0, 0], "the redelivered notice saw a half-entry of the failed attempt"
    assert len(launches) == 2 and _names(_ledger(interruption)) == launches[1], "the redelivered notice did not book once"


def _topology_module(k):
    if k.side == "port":
        from karpenter_tpu_torch.scheduler import topology
    else:
        from karpenter_tpu.scheduler import topology
    return topology


def _cohort_counts(k, topology, label) -> dict:
    """The zone counts of the spread group of cohort `label` in a topology."""
    (group,) = [
        g for g in topology.topologies.values()
        if g.key == k.lbl.LABEL_TOPOLOGY_ZONE and g.selector is not None and g.selector.match_labels == {"spread": label}
    ]
    return dict(group.domains)


def _zone_counts(k, env, label, pairs) -> dict:
    """The zone counts a re-solve's topology gives the cohort, with `pairs`
    nominated (the port) or none (the reference): a probe pod's."""
    probe = k.owned(labels={"spread": label}, requests={"cpu": 0.1, "memory": "100Mi"}, topology_spread_constraints=[
        k.obj.TopologySpreadConstraint(
            max_skew=1, topology_key=k.lbl.LABEL_TOPOLOGY_ZONE, label_selector=k.obj.LabelSelector(match_labels={"spread": label}),
        )
    ])
    zones = {n.metadata.labels[k.lbl.LABEL_TOPOLOGY_ZONE] for n in env.kube.list_nodes()}
    args = dict(kube=env.kube, cluster=env.cluster, domains={k.lbl.LABEL_TOPOLOGY_ZONE: zones}, pods=[probe])
    if k.side == "port":
        args["nominated"] = pairs
    return _cohort_counts(k, _topology_module(k).Topology(**args), label)


@pytest.mark.parametrize("mode", MODES)
def test_spread_cohort_counted_once_at_its_booked_nodes(mode, monkeypatch):
    """A zonal-spread cohort whose pods sit on two victims, whose notices
    arrive one poll apart; the victims are cordoned and deleting but not
    drained (no termination controller). After the first re-solve, the
    cohort's zone counts as the next re-solve's topology reads them count
    each booked pod once, at its booked node: not also at its victim while
    it is still bound there, and not dropped once its eviction marks the
    stored pod terminating in place. The second re-solve's topology counts
    them so, and the two re-solves together keep the cohort within its max
    skew. The reference counts the first victim's pods at that victim, and
    drops them once terminating."""

    def scenario(k):
        env = wave_env(k)
        kube = env.kube
        env.interruption.termination = None
        populated = _victims(env, 100)
        cohort_of = {n.name: {p.metadata.labels.get("spread") for p in kube.pods_on_node(n.name)} - {None} for n in populated}
        v1, v2, label = next(
            (a, b, min(cohort_of[a.name] & cohort_of[b.name]))
            for i, a in enumerate(populated) for b in populated[i + 1:] if cohort_of[a.name] & cohort_of[b.name]
        )
        zone_of = {n.name: n.metadata.labels[k.lbl.LABEL_TOPOLOGY_ZONE] for n in kube.list_nodes()}
        bookings = []
        launch = env.provisioner_controller.launch_nodes

        def watched(results, *args, **kwargs):
            names = launch(results, *args, **kwargs)
            placed = kwargs.get("placed")
            bookings.append(placements(results, names) if placed is None else placed)
            for name in names:
                zone_of[name] = kube.get_node(name).metadata.labels[k.lbl.LABEL_TOPOLOGY_ZONE]
            return names

        env.provisioner_controller.launch_nodes = watched
        seen = []
        module = _topology_module(k)

        class Recorded(module.Topology):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                if any(p.metadata.labels.get("spread") == label for p in kwargs["pods"]):
                    seen.append(_cohort_counts(k, self, label))

        monkeypatch.setattr(sys.modules[module.__name__.rsplit(".", 1)[0] + ".builder"], "Topology", Recorded)

        def in_cohort(p) -> bool:
            return p.metadata.labels.get("spread") == label

        def counts(skip) -> dict:
            out = {zone: 0 for zone in set(zone_of.values())}
            for p in kube.list_pods():
                if in_cohort(p) and p.spec.node_name and p.spec.node_name not in skip:
                    out[zone_of[p.spec.node_name]] += 1
            return out

        def booked(n) -> list:
            return [(p, name) for placed in bookings[:n] for name, pods in placed for p in pods if in_cohort(p)]

        env.backend.interrupt_spot_instance(env.instance_id(v1))
        env.interruption.poll_once()
        moved = booked(1)
        assert moved and {p.spec.node_name for p, _ in moved} == {v1.name}, "the first victim's cohort pods were not booked"
        after_first = counts({v1.name})
        for _, name in moved:
            after_first[zone_of[name]] += 1
        pairs = _ledger(env.interruption) if k.side == "port" else []
        still_bound = _zone_counts(k, env, label, pairs)
        # the eviction's graceful delete marks each stored pod in place
        for p, _ in moved:
            p.metadata.deletion_timestamp = env.clock.now()
        terminating = _zone_counts(k, env, label, pairs)
        env.backend.interrupt_spot_instance(env.instance_id(v2))
        env.interruption.poll_once()
        assert {p.spec.node_name for p, _ in booked(2)[len(moved):]} == {v2.name}, "the second victim's cohort pods were not booked"
        second_saw = counts({v1.name, v2.name})
        for _, name in moved:
            second_saw[zone_of[name]] += 1
        after_both = counts({v1.name, v2.name})
        for _, name in booked(2):
            after_both[zone_of[name]] += 1
        return {
            "after_first": after_first, "still_bound": still_bound, "terminating": terminating, "moved": len(moved),
            "at_victim": counts(()), "second_saw": second_saw, "second": seen[-1], "after_both": after_both,
        }

    ref, port = run_both(lambda k: scenario(SKit(k.side, k.mode)), mode)
    assert port["still_bound"] == port["after_first"], "a booked pod still bound to its victim is counted there too, or not at its booked node"
    assert port["terminating"] == port["after_first"], "a booked pod was dropped once its stored object is terminating"
    assert port["second"] == port["second_saw"], "the second re-solve did not count the first one's bookings at their nodes"
    assert max(port["after_both"].values()) - min(port["after_both"].values()) <= 1, "the cohort is beyond its max skew"
    assert ref["still_bound"] == ref["at_victim"], "the reference counts the first victim's pods at the victim"
    dropped = {zone: ref["after_first"][zone] - ref["terminating"][zone] for zone in ref["after_first"]}
    assert sum(dropped.values()) == ref["moved"], "the reference drops the terminating pods"
    assert sum(ref["second_saw"].values()) - sum(ref["second"].values()) == ref["moved"]


def test_nominated_anti_affinity_pod_counted_at_its_booked_node():
    """The inverse anti-affinity index counts a nominated pod that is still
    bound to its victim once, at its nominated node; the reference counts
    the bound pod at the victim."""

    def scenario(k):
        env = k.env()
        zone = k.lbl.LABEL_TOPOLOGY_ZONE
        for name, domain in (("victim", "test-zone-1"), ("booked", "test-zone-2")):
            env.kube.create(k.make_node(name=name, labels={zone: domain}, allocatable={"cpu": "4", "memory": "8Gi", "pods": "10"}))
        term = k.obj.PodAffinityTerm(topology_key=zone, label_selector=k.obj.LabelSelector(match_labels={"app": "x"}))
        moved = k.make_pod(name="moved", labels={"app": "x"}, pod_anti_requirements=[term], node_name="victim")
        env.kube.create(moved)
        probe = k.make_pod(name="probe", labels={"app": "x"})
        args = dict(kube=env.kube, cluster=env.cluster, domains={zone: {"test-zone-1", "test-zone-2"}}, pods=[probe])
        if k.side == "port":
            args["nominated"] = [("booked", [moved])]
        (group,) = _topology_module(k).Topology(**args).inverse_topologies.values()
        return dict(group.domains)

    ref, port = run_both(lambda k: scenario(SKit(k.side, k.mode)), "host")
    assert port == {"test-zone-1": 0, "test-zone-2": 1}
    assert ref == {"test-zone-1": 1, "test-zone-2": 0}


@pytest.mark.parametrize("mode", MODES)
def test_window_double_count_costs_room_never_a_node(mode):
    """A successor bound within the nomination window of its pod's booking
    is counted twice by a later re-solve: bound, and booked. The room that
    re-solve sees shrinks by the whole booking, although the successors
    took some of it; its own bookings still put no node beyond its room."""
    from karpenter_tpu_torch.utils import resources as res

    k = SKit("port", mode)
    env = wave_env(k)
    replicaset_stand_in(k, env)
    interruption, kube = env.interruption, env.kube
    v1, v2 = _victims(env, 2)
    env.backend.interrupt_spot_instance(env.instance_id(v1))
    interruption.poll_once()
    assert kube.get_node(v1.name) is None, "the victim was not drained"
    env.provision()
    bind_nominated(env)
    assert not [p for p in kube.list_pods() if not p.spec.node_name], "a successor is pending"
    pairs = _ledger(interruption)
    booked_nodes = {name for name, _ in pairs}
    successors = [p for p in kube.list_pods() if p.metadata.name.startswith("rs-")]
    assert any(p.spec.node_name in booked_nodes for p in successors), "no successor bound where its pod was booked"
    seen = {s.name: s for s in env.provisioner_controller.nominated_snapshot(pairs)}
    plain = {s.name: s for s in env.cluster.nodes_snapshot()}
    for name, pods in pairs:
        for pod in pods:
            plain[name].available = res.subtract(plain[name].available, res.pod_requests(pod))
    for name in booked_nodes:
        assert seen[name].available == pytest.approx(plain[name].available), "the booking was not counted on the bound successors' node"
    bookings = Bookings(k, env)
    launch = env.provisioner_controller.launch_nodes

    def watched(results, *args, **kwargs):
        names = launch(results, *args, **kwargs)
        bookings.book(kwargs["placed"])
        return names

    env.provisioner_controller.launch_nodes = watched
    env.backend.interrupt_spot_instance(env.instance_id(v2))
    interruption.poll_once()
    assert bookings.placed, "the second notice booked nothing"
    assert bookings.over() == [], "a later re-solve booked a node beyond its room"


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
