"""One record of every nomination, read by every re-solve, held beside the
JAX package on the CPU.

A provisioning round nominates pods onto standing nodes and onto the nodes
it launches before those pods bind; cluster state counts bound pods only.
In the JAX package only the round's own capacity-failure re-solve sees
what the round nominated (and it sees nothing else), so:

- a spot notice handled between a round's nominations and their binds
  re-solves on a snapshot that shows the round's room as free, and books it
  a second time (chip_smoke.py's `interruption_reclaim_wave` cell, shrunk
  as tests/test_torch_interruption_wave.py shrinks it: 2,000 pods on 19
  nodes, 8 victims, with a second batch of 400 pods nominated by one round
  and left unbound);
- a round's capacity-failure re-solve cannot see what an interruption
  re-solve booked;
- the disruption what-ifs (consolidation's, and the drift/expiration
  re-simulation) solve on the bound pods only, so room a round nominated
  can justify a DELETE.

The port keeps the record in cluster state (`Cluster.nominate_pods`, from
`ProvisionerController.launch_nodes`, whoever called it) and every re-solve
reads it (`ProvisionerController.nominated_view`): none of the above
happens there. Further cases hold the record's lifetime, and that a
re-solve with no live entry is handed the cluster's snapshot itself, epoch
and all, so the incremental engine serves it (`delta`, not `bypass`).

Tolerance: exact throughout (pod keys, node names, engine pass kinds,
action types); a node is over its room when a resource's bookings exceed
its allocatable less the daemonset overhead by more than 1e-6.
"""

from __future__ import annotations

import pytest

from tests.test_torch_consolidation import DKit, reference_auditor_off  # noqa: F401
from tests.test_torch_interruption import SKit, leader_cleared  # noqa: F401
from tests.test_torch_interruption_wave import (
    MAX_VICTIMS,
    WAVE_FRACTION,
    Bookings,
    placements,
    wave_env,
    wave_workload,
)
from tests.test_torch_provisioner_ice import _strict
from tests.test_torch_provisioning import MODES, Kit, reference_singletons, run_both  # noqa: F401

# the second batch: a fifth of the fleet's pods, as chip_smoke.py's
# nomination_window cell nominates 2,000 onto its 10,000-pod fleet
ROUND_PODS = 400
ROUND_SEED = 43


def second_batch(k, count: int = ROUND_PODS) -> list:
    """testing.reclaim_wave_workload(count, seed=43), named apart from the
    fleet's pods."""
    pods = wave_workload(k, count, seed=ROUND_SEED)
    for i, pod in enumerate(pods):
        pod.metadata.name = f"round-{i:05d}"
    return pods


def wave_victims(env) -> list:
    """SpotReclaimWave's victims: the first populated nodes in store order,
    fraction 0.6, at most 8."""
    populated = [n for n in env.kube.list_nodes() if env.kube.pods_on_node(n.name)]
    return populated[: max(1, min(MAX_VICTIMS, int(len(populated) * WAVE_FRACTION)))]


def booked_launches(k, env, bookings: Bookings) -> list:
    """Book every launch from now on (the round's and the re-solves'), read
    from a wrapper of launch_nodes; returns the list of each launch's pairs.
    The reference's launch collects no pairs: they are rebuilt from its
    results and names."""
    ctrl = env.provisioner_controller
    launch = ctrl.launch_nodes
    launches = []

    def traced(results, *args, **kwargs):
        names = launch(results, *args, **kwargs)
        placed = kwargs.get("placed")
        pairs = placements(results, names) if placed is None else list(placed)
        launches.append(pairs)
        bookings.book(pairs)
        return names

    ctrl.launch_nodes = traced
    return launches


def window_scenario(k) -> dict:
    """The fleet bound; a round on the second batch, its nominations left
    unbound; then the wave's 8 notices in one poll."""
    env = wave_env(k)
    victims = wave_victims(env)
    bookings = Bookings(k, env)
    launches = booked_launches(k, env, bookings)
    for pod in second_batch(k):
        env.kube.create(pod)
    results = env.provision()
    round_launches = len(launches)
    assert not [p for p in env.kube.list_pods() if p.spec.node_name and p.name.startswith("round-")], "a round pod bound"
    for victim in victims:
        env.backend.interrupt_spot_instance(env.instance_id(victim))
    # the one poll takes the 8 notices (the drains' instance-terminated
    # notices come after it)
    assert env.interruption.poll_once() == len(victims)
    return {
        "victims": [v.name for v in victims],
        "on_standing": sum(len(v.pods) for v in results.existing_nodes),
        "re_solve_launches": len(launches) - round_launches,
        "overbooked": bookings.over(),
    }


@pytest.mark.parametrize("mode", MODES)
def test_notice_between_a_rounds_nominations_and_its_binds(mode):
    """The reference's re-solves book the round's nominated room again: at
    least one node beyond its room. The port's count the round's
    nominations: none. The fleet, the victims and the round's nominations
    onto standing nodes are the same on both."""
    ref, port = run_both(lambda k: window_scenario(SKit(k.side, k.mode)), mode)
    assert port["victims"] == ref["victims"] and len(port["victims"]) == MAX_VICTIMS
    assert port["on_standing"] == ref["on_standing"] > 0, "the round nominated nothing onto the fleet"
    assert ref["re_solve_launches"] == port["re_solve_launches"] == MAX_VICTIMS
    assert ref["overbooked"], "the reference's re-solves booked no node beyond its room"
    assert port["overbooked"] == []


def ice_scenario(k) -> dict:
    """One notice, its re-solve booked; then every spot pool of the
    simulated cloud runs dry and a round on the second batch meets a
    capacity failure at every launch: what each capacity-failure re-solve
    counts on the nodes the notice booked."""
    env = wave_env(k)
    (victim,) = wave_victims(env)[:1]
    bookings = Bookings(k, env)
    launches = booked_launches(k, env, bookings)
    env.backend.interrupt_spot_instance(env.instance_id(victim))
    env.interruption.poll_once()
    del env.provisioner_controller.launch_nodes
    (booking,) = launches
    booked = {name: {f"{p.namespace}/{p.name}" for p in pods} for name, pods in booking}
    zones = {subnet.zone for subnet in env.backend.describe_subnets()}
    for info in env.backend.describe_instance_types():
        for zone in zones:
            env.backend.set_pool_capacity(info.name, zone, "spot", 0)
    ctrl = env.provisioner_controller
    schedule = ctrl.schedule
    resolves = []

    def watched(pods, state_nodes, opts=None, **kwargs):
        if opts is None and schedule_calls:
            by_name = {s.name: s for s in state_nodes}
            resolves.append({name: sorted(keys & set(by_name[name].pod_requests)) for name, keys in booked.items() if name in by_name})
        schedule_calls.append(len(pods))
        return schedule(pods, state_nodes, opts, **kwargs)

    schedule_calls = []
    ctrl.schedule = watched
    for pod in second_batch(k):
        env.kube.create(pod)
    env.provision()
    ctrl.schedule = schedule
    return {"booked": {name: sorted(keys) for name, keys in booked.items()}, "resolves": resolves}


@pytest.mark.parametrize("mode", MODES)
def test_ice_resolve_counts_an_interruption_booking(mode):
    """Every capacity-failure re-solve of the round counts each pod the
    notice booked at its booked node on the port; on the reference none."""
    ref, port = run_both(lambda k: ice_scenario(SKit(k.side, k.mode)), mode)
    assert port["booked"] == ref["booked"], "the notice booked otherwise"
    assert ref["resolves"] and port["resolves"], "the round ran no capacity-failure re-solve"
    assert port["resolves"] == [port["booked"]] * len(port["resolves"])
    assert all(counted == {name: [] for name in ref["booked"]} for counted in ref["resolves"])


# -- the disruption what-ifs -----------------------------------------------------


def _what_if_env(k, env_of):
    """Two 4-CPU nodes, each launched for one ReplicaSet-owned pod: 1.5 CPU
    on the candidate, 1 on the other (launched while a taint holds the
    candidate). Then a round nominates a pending 2.5-CPU pod onto the other
    node (a hostname selector) and leaves it unbound. The candidate's pod
    fits on the other node only in its nominated room."""
    catalog = [k.fake.instance_type("it-4", cpu=4, memory="16Gi", price=1.0, offerings=k.od())]
    env = env_of(provisioners=[k.consolidatable()], instance_types=catalog)
    (candidate,) = env.launch_node_with_pods(k.owned(requests={"cpu": "1.5"}))
    _held(k, env, candidate.name, True)
    other = next(n for n in env.launch_node_with_pods(k.owned(requests={"cpu": "1"})) if n.name != candidate.name)
    _held(k, env, candidate.name, False)
    env.kube.create(k.owned(requests={"cpu": "2.5"}, node_selector={k.lbl.LABEL_HOSTNAME: other.name}))
    results = env.provision()
    assert [(v.node.name, len(v.pods)) for v in results.existing_nodes if v.pods] == [(other.name, 1)]
    return env, env.kube.get_node(candidate.name), other


def _held(k, env, name: str, hold: bool) -> None:
    """Put a NoSchedule taint on the node, or take it off."""
    node = env.kube.get_node(name)
    node.spec.taints = [k.obj.Taint(key="example.com/hold", effect="NoSchedule")] if hold else []
    env.kube.update(node)


@pytest.mark.parametrize("mode", MODES)
def test_consolidation_what_if_counts_nominated_room(mode):
    """The reference's what-if puts the candidate's pod into the room the
    round nominated and proposes DELETE; the port's counts the nomination,
    finds no room and no cheaper node, and proposes nothing."""

    def scenario(k):
        env, candidate, other = _what_if_env(k, k.deprov)
        action = env.consolidation.process_cluster()
        return {"type": action.type.name, "nodes": [n.name for n in action.nodes], "candidate": candidate.name}

    ref, port = run_both(lambda k: scenario(DKit(k.side, k.mode)), mode)
    assert ref["type"] == "DELETE" and ref["nodes"] == [ref["candidate"]]
    assert port["type"] == "NO_ACTION"


@pytest.mark.parametrize("mode", MODES)
def test_disruption_resimulation_counts_nominated_room(mode):
    """The drift/expiration re-simulation of the candidate: the reference
    fits its pod onto the other node's nominated room (no replacement);
    the port needs one new node for it."""

    def scenario(k):
        env, candidate, _ = _what_if_env(k, k.disrupt_env)
        method = next(m for m in env.disruption.methods if m.name == "drift")
        replacements = method.resimulate(candidate)
        return None if replacements is None else [len(vn.pods) for vn in replacements]

    ref, port = run_both(lambda k: scenario(DKit(k.side, k.mode)), mode)
    assert ref == []
    assert port == [1]


# -- the record ---------------------------------------------------------------------


def _record_env():
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.controllers.state.cluster import Cluster
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.utils.clock import FakeClock

    kube = KubeCluster(clock=FakeClock())
    testing.standing_cluster(kube, 2)
    return kube, Cluster(kube, None)


def _keys(pairs) -> list:
    return [(name, [p.name for p in pods]) for name, pods in pairs]


def test_the_newest_nomination_of_a_pod_wins():
    from karpenter_tpu_torch.testing import make_pod

    kube, cluster = _record_env()
    a, b = make_pod(name="a", requests={"cpu": "1"}), make_pod(name="b", requests={"cpu": "1"})
    cluster.nominate_pods([("churn-n0000", [a, b])])
    cluster.nominate_pods([("churn-n0001", [a])])
    assert _keys(cluster.nominations()) == [("churn-n0000", ["b"]), ("churn-n0001", ["a"])]
    (entry,) = cluster.nominations(solving=[b])[0][1]
    assert entry.name == "a" and entry is not a, "the record holds the caller's pod"
    a.metadata.deletion_timestamp = 1.0
    assert cluster.nominations()[1][1][0].metadata.deletion_timestamp is None, "an edit of the pod reached the record"


def test_a_pod_bound_at_its_node_is_counted_once():
    """Bound where it was nominated, the pod is counted by its binding: the
    snapshot with its nomination counted equals the bare snapshot on that
    node (StateNode.add_pod keeps a key it holds), and the entry leaves."""
    from karpenter_tpu_torch.testing import make_pod
    from karpenter_tpu_torch.controllers.provisioning import ProvisionerController

    kube, cluster = _record_env()
    pod = kube.create(make_pod(name="a", requests={"cpu": "3", "memory": "1Gi"}))
    cluster.nominate_pods([("churn-n0000", [pod])])
    pairs = cluster.nominations()
    kube.bind_pod(pod, "churn-n0000")
    controller = ProvisionerController(kube, cluster, None, wait_for_cluster_sync=False)
    counted = {s.name: s.available for s in controller.nominated_snapshot(pairs)}
    bare = {s.name: s.available for s in cluster.nodes_snapshot()}
    assert counted == bare
    assert bare["churn-n0000"]["cpu"] == pytest.approx(13.0)
    assert cluster.nominations() == []


def test_an_entry_leaves_with_its_node_and_its_window():
    """An entry whose node was in cluster state and has left goes; an entry
    whose node the watch has not delivered yet stays, until that node has
    come and gone; every entry goes once the nomination window has
    passed."""
    from karpenter_tpu_torch.testing import make_node, make_pod

    kube, cluster = _record_env()
    a, b, c = (make_pod(name=n, requests={"cpu": "1"}) for n in "abc")
    cluster.nominate_pods([("churn-n0000", [a]), ("churn-n0001", [b]), ("late", [c])])
    kube.delete(kube.get_node("churn-n0000"))
    assert _keys(cluster.nominations()) == [("churn-n0001", ["b"]), ("late", ["c"])]
    kube.create(make_node(name="late", allocatable={"cpu": 4, "memory": "8Gi", "pods": 10}))
    assert _keys(cluster.nominations()) == [("churn-n0001", ["b"]), ("late", ["c"])]
    kube.delete(kube.get_node("late"))
    assert _keys(cluster.nominations()) == [("churn-n0001", ["b"])]
    cluster.clock.step(cluster.nomination_ttl - 1.0)
    assert _keys(cluster.nominations()) == [("churn-n0001", ["b"])]
    cluster.clock.step(2.0)
    assert cluster.nominations() == []


def test_a_nomination_drops_the_entries_whose_window_has_passed():
    """With no re-solve reading the record, a launch's nominations still
    drop the expired entries: the record holds one window's nominations."""
    from karpenter_tpu_torch.testing import make_pod

    kube, cluster = _record_env()
    for i in range(50):
        cluster.nominate_pods([("churn-n0000", [make_pod(name=f"old-{i}", requests={"cpu": "0.1"})])])
    cluster.clock.step(cluster.nomination_ttl + 1.0)
    cluster.nominate_pods([("churn-n0001", [make_pod(name="new", requests={"cpu": "0.1"})])])
    assert list(cluster._pod_nominations) == ["default/new"]


def test_a_resolves_own_pods_are_left_out():
    """The pods a re-solve is solving are not counted as nominated: their
    entries stay in the record for the next reader."""
    from karpenter_tpu_torch.testing import make_pod

    kube, cluster = _record_env()
    a, b, c = (make_pod(name=n, requests={"cpu": "1"}) for n in "abc")
    cluster.nominate_pods([("churn-n0000", [a, c]), ("churn-n0001", [b])])
    assert _keys(cluster.nominations(solving=[c, b])) == [("churn-n0000", ["a"])]
    assert _keys(cluster.nominations()) == [("churn-n0000", ["a", "c"]), ("churn-n0001", ["b"])]


def test_a_reader_beside_a_launch_sees_every_live_entry():
    """A launch on one thread re-enters keys of the record while a re-solve
    on another reads it, as the Runtime's batch loop and interruption loop
    do: every read returns each live pod once, and none raises."""
    import sys
    import threading

    from karpenter_tpu_torch.testing import make_pod

    kube, cluster = _record_env()
    pods = [make_pod(name=f"p{i:04d}", requests={"cpu": "0.01"}) for i in range(2000)]
    cluster.nominate_pods([("churn-n0000", pods)])
    stop, faults = threading.Event(), []

    def launch():
        # each pod nominated anew onto the other node and back: the key is
        # popped and re-inserted, the record's size moves
        i = 0
        while not stop.is_set():
            node = ("churn-n0001", "churn-n0000")[(i // len(pods)) % 2]
            cluster.nominate_pods([(node, [pods[i % len(pods)]])])
            i += 1

    def read():
        try:
            for _ in range(200):
                names = [p.name for _, node_pods in cluster.nominations() for p in node_pods]
                if sorted(names) != [p.name for p in pods]:
                    faults.append(f"{len(names)} pods read, {len(set(names))} distinct")
        except RuntimeError as err:
            faults.append(str(err))
        finally:
            stop.set()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch), threading.Thread(target=read)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert faults == []


# -- a re-solve with no live entry is handed the snapshot --------------------------------


def _epoch_round(k, nominate_first: bool) -> dict:
    """Eight standing on-demand nodes; a batch of spot-only pods (which no
    standing node takes), every pool of every type refused, so every launch
    of the round fails and its capacity-failure re-solves run with nothing
    the round nominated. With `nominate_first` one pod is nominated onto a
    standing node beforehand. The incremental engine's pass kind of each
    solve of the round."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver.incremental import IncrementalEngine

    k.reset_names()
    env = k.env(instance_types=k.fake.instance_types(20))
    testing.standing_cluster(env.kube, 8)
    spot = {k.lbl.LABEL_CAPACITY_TYPE: "spot"}
    for i in range(20):
        env.kube.create(k.pod(requests={"cpu": "1", "memory": "1Gi"}, node_selector=spot))
    _strict(env, k, [t.name() for t in env.provider.instance_types_list])
    if nominate_first:
        env.cluster.nominate_pods([("churn-n0003", [k.pod(requests={"cpu": "2"})])])
    controller = env.provisioner_controller
    engine = IncrementalEngine(env.cluster.delta_journal, device="cpu")
    controller.dense_solver = DenseSolver(min_batch=1, device="cpu", incremental=engine)
    schedule = controller.schedule
    kinds = []

    def watched(pods, state_nodes, opts=None, **kwargs):
        before = dict(engine.passes)
        results = schedule(pods, state_nodes, opts, **kwargs)
        kinds.append([kind for kind in engine.passes if engine.passes[kind] != before.get(kind, 0)])
        return results

    controller.schedule = watched
    env.provision()
    return {"kinds": kinds, "launched": len(env.kube.list_nodes()) - 8}


def test_a_resolve_with_no_live_entry_keeps_the_snapshots_epoch():
    """With no live entry on its nodes, the capacity-failure re-solve is
    handed the cluster's snapshot itself and the engine serves it as a
    delta pass; with one, it solves on a plain list and the engine counts a
    bypass."""
    from karpenter_tpu_torch.solver.incremental import PASS_BYPASS, PASS_DELTA, PASS_FULL

    clean = _epoch_round(Kit("port", "dense"), nominate_first=False)
    assert clean["launched"] == 0 and len(clean["kinds"]) == 3, clean
    assert clean["kinds"] == [[PASS_FULL], [PASS_DELTA], [PASS_DELTA]]
    nominated = _epoch_round(Kit("port", "dense"), nominate_first=True)
    assert nominated["kinds"] == [[PASS_FULL], [PASS_BYPASS], [PASS_BYPASS]]
