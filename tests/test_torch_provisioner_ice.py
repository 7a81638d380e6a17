"""The provisioner's capacity-failure ladder and quarantined offerings, held
on both packages; and the port's batch loop, which stops on a failed round.

- The strict-mode round: the fake provider refuses every pool of the
  instance type a first round launched most often (or of every type it
  launched), so each launch on such a type raises a typed
  InsufficientCapacityError; the round re-solves the failed nodes' pods on
  the cluster as it then stands (up to ICE_RESOLVE_ATTEMPTS times) and
  parks what still fails, with the host loop and with the dense solve.
  Both packages must decide the first solve and its launches alike. The
  re-solves differ where the JAX package's re-solve hands out capacity that
  the round already gave to its nominated pods (it reads them from the
  cluster state, where they are not bound yet): the port's counts them, so
  no node ends the round over its capacity. Where the JAX package's round
  books no node over capacity, the two rounds must be equal throughout.
- The port's re-solve on a workload with topology constraints: no node
  over capacity, hostname anti-affinity, zonal self-affinity and zonal
  spread held across the first solve's and the re-solves' placements.
- bench.py's ice_mask shape: build_workload(500, seed=9) on
  instance_types(100), every offering of the 25 cheapest types marked
  unavailable, one round through the provisioning controller.
- The port's own: a round whose solve raises ends the batch loop with the
  error kept and re-raised by stop(); a round whose cluster state has not
  caught up with the API by the sync deadline is held and retried, and a
  stop during that wait ends the loop with no error; a failed remote solve raises out of
  the round instead of falling back to the local scheduler; the
  batcher's window opens, extends and caps under a FakeClock as the JAX
  package's does.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np
import pytest

import bench
from karpenter_tpu_torch import testing
from tests.test_torch_provisioning import MODES, Kit, both, outcome, reference_singletons, round_outcome, run_both  # noqa: F401


def _batch(k, count=80, seed=1):
    """Seeded plain pods of five CPU and four memory sizes."""
    rng = np.random.default_rng(seed)
    cpus = [0.25, 0.5, 1.0, 1.5, 3.0]
    mems = ["256Mi", "1Gi", "2Gi", "4Gi"]
    return [k.pod(requests={"cpu": cpus[rng.integers(5)], "memory": mems[rng.integers(4)]}) for _ in range(count)]


def _env_with_batch(k, types=20):
    k.reset_names()  # every environment names its batch alike
    env = k.env(instance_types=k.fake.instance_types(types))
    for pod in _batch(k):
        env.kube.create(pod)
    return env


def _watch(controller):
    """Record each schedule call (pods in, state nodes, placed new / on
    existing) and each launch call's typed capacity failures."""
    calls = {"schedule": [], "ice": []}
    schedule, launch = controller.schedule, controller.launch_nodes

    def watched_schedule(pods, state_nodes, opts=None, **kwargs):
        results = schedule(pods, state_nodes, opts, **kwargs)
        calls["schedule"].append((
            len(pods), len(state_nodes),
            sum(len(n.pods) for n in results.new_nodes), sum(len(v.pods) for v in results.existing_nodes),
        ))
        return results

    def watched_launch(results, ice_failures=None, **kwargs):
        launched = launch(results, ice_failures=ice_failures, **kwargs)
        calls["ice"].append(sorted(p.name for vn in ice_failures or () for p in vn.pods))
        return launched

    controller.schedule, controller.launch_nodes = watched_schedule, watched_launch
    return calls


def _nominations(env):
    """Node name -> the pods nominated onto it (each once)."""
    pods = {p.name: p for p in env.kube.list_pods()}
    out = collections.defaultdict(dict)
    for event in env.recorder.of("NominatePod"):
        out[event.message.split()[-1]][event.object_name] = pods[event.object_name]
    return out


def _overbooked(env, k):
    """The nodes whose bound and nominated pods together request more than
    the node has, with the resources over."""
    over = []
    nominated = _nominations(env)
    for node in env.kube.list_nodes():
        state = env.cluster.get_state_node(node.name)
        free = dict(state.available)
        for pod in nominated.get(node.name, {}).values():
            free = k.res.subtract(free, k.res.pod_requests(pod))
        short = sorted(r for r, v in free.items() if v < -1e-6)
        if short:
            over.append((node.metadata.labels[k.lbl.LABEL_INSTANCE_TYPE], short))
    return sorted(over)


def _strict(env, k, quarantined):
    """Strict mode with every pool of the `quarantined` types refused; the
    refused pools."""
    assert env.provider.allow_insufficient_capacity is False  # strict mode
    catalog = {t.name(): t for t in env.provider.instance_types_list}
    pools = {(name, o.zone, o.capacity_type) for name in quarantined for o in catalog[name].offerings()}
    env.provider.insufficient_capacity_pools = set(pools)
    return pools


def _refused_types(env, k, refused):
    """After a first round in `env`: the type it launched most often, or
    every type it launched."""
    live = env.provider.live_instances
    launched = collections.Counter(n.metadata.labels[k.lbl.LABEL_INSTANCE_TYPE] for n in env.kube.list_nodes() if n.name in live)
    by_count = sorted(launched.items(), key=lambda kv: (-kv[1], kv[0]))
    return [by_count[0][0]] if refused == "most_launched_type" else sorted(launched)


@pytest.mark.parametrize("refused", ["most_launched_type", "every_launched_type"])
@pytest.mark.parametrize("mode", MODES)
def test_strict_ice_round_resolves_then_parks(mode, refused):
    def scenario(k):
        first = _env_with_batch(k)
        first.provision()
        quarantined = _refused_types(first, k, refused)

        env = _env_with_batch(k)
        pools = _strict(env, k, quarantined)
        controller = env.provisioner_controller
        calls = _watch(controller)
        results = env.provision()

        schedule, ice = calls["schedule"], calls["ice"]
        assert len(schedule) >= 2, "the ladder did not re-solve"
        assert len(schedule) == 1 + controller.ICE_RESOLVE_ATTEMPTS or not ice[-1]
        # the typed failures of each launch are the next solve's batch
        for (retry_pods, *_), failed in zip(schedule[1:], ice):
            assert retry_pods == len(failed) > 0
        for node in env.kube.list_nodes():
            labels = node.metadata.labels
            pool = (labels[k.lbl.LABEL_INSTANCE_TYPE], labels[k.lbl.LABEL_TOPOLOGY_ZONE], labels[k.lbl.LABEL_CAPACITY_TYPE])
            assert pool not in pools, f"node {node.name} launched on a quarantined pool"
        parked = sorted(name for _ns, name in controller._ice_backoff)
        assert parked == (ice[-1] if len(schedule) == 1 + controller.ICE_RESOLVE_ATTEMPTS else []), "the last re-solve's failures must park"
        if mode == "dense":
            assert controller.dense_solver.stats.batches == len(schedule), "a re-solve left the dense path"
        return {
            "first": [quarantined, schedule[0], ice[0], round_outcome(results)],
            "overbooked": _overbooked(env, k),
            "round": [schedule, ice, parked, outcome(env, k)],
        }

    ref, port = run_both(scenario, mode)
    assert port["first"] == ref["first"]
    assert port["overbooked"] == [], "the port's re-solve booked a node over its capacity"
    if refused == "most_launched_type":
        # the case reaches the difference: the JAX package's re-solve fills
        # the retry batch onto the nodes the round launched, as if empty
        assert ref["overbooked"], "the JAX package's round booked no node over capacity"
    if not ref["overbooked"]:
        assert port == ref


@pytest.mark.parametrize("refused", ["most_launched_type", "every_launched_type"])
@pytest.mark.parametrize("mode", MODES)
def test_ice_resolve_holds_capacity_and_topology(mode, refused):
    """The port alone: build_workload's spread, self-affinity and
    anti-affinity cohorts through a strict-mode round, on a cluster of
    standing nodes."""
    k = Kit("port", mode)

    def env_with_workload():
        env = k.env(instance_types=k.fake.instance_types(40))
        testing.standing_cluster(env.kube, 6)
        for i, pod in enumerate(testing.build_workload(280, seed=5)):
            pod.metadata.name = f"w{i:04d}"
            env.kube.create(pod)
        return env

    first = env_with_workload()
    first.provision()
    env = env_with_workload()
    pools = _strict(env, k, _refused_types(first, k, refused))
    calls = _watch(env.provisioner_controller)
    env.provision()
    assert len(calls["schedule"]) >= 2 and calls["ice"][0], "the ladder did not re-solve"
    assert _overbooked(env, k) == []

    zone_of, cohorts = {}, collections.defaultdict(list)
    for node in env.kube.list_nodes():
        labels = node.metadata.labels
        pool = (labels[k.lbl.LABEL_INSTANCE_TYPE], labels[k.lbl.LABEL_TOPOLOGY_ZONE], labels[k.lbl.LABEL_CAPACITY_TYPE])
        assert node.name not in env.provider.live_instances or pool not in pools
        zone_of[node.name] = labels[k.lbl.LABEL_TOPOLOGY_ZONE]
    placed = set()
    for name, pods in _nominations(env).items():
        for pod in pods.values():
            placed.add(pod.name)
            for key, value in pod.metadata.labels.items():
                cohorts[(key, value)].append((name, zone_of[name]))
    assert placed and len(placed) + len(env.provisioner_controller._ice_backoff) == 280
    # a cohort's spread is held only where none of its pods parked: the
    # skew was met when each pod was placed, and a parked pod leaves its
    # zone short afterwards
    short = {(key, value) for p in env.kube.list_pods() if p.name not in placed for key, value in p.metadata.labels.items()}
    zones = set(zone_of.values())
    for (key, value), where in cohorts.items():
        if key == "anti":
            hosts = [name for name, _zone in where]
            assert len(hosts) == len(set(hosts)), f"anti-affinity cohort {value} shares a node"
        elif key == "affinity":
            assert len({zone for _name, zone in where}) == 1, f"self-affinity cohort {value} spans zones"
        elif key == "spread" and (key, value) not in short:
            counts = collections.Counter(zone for _name, zone in where)
            assert max(counts.values()) - min(counts.get(z, 0) for z in zones) <= 1, f"spread cohort {value}: {counts}"


@pytest.mark.parametrize("mode", MODES)
def test_ice_mask_round_never_selects_a_quarantined_offering(mode):
    """bench.py's ice_mask smoke shape through one provisioning round."""

    def scenario(k):
        types = k.fake.instance_types(100)
        for it in types[:25]:
            it._offerings = tuple(dataclasses.replace(o, available=False) for o in it._offerings)
        masked = {it.name() for it in types[:25]}
        env = k.env(instance_types=types)
        pods = bench.build_workload(500, seed=9) if k.side == "ref" else testing.build_workload(500, seed=9)
        for i, pod in enumerate(pods):
            pod.metadata.name = f"ice-{i:04d}"
            env.kube.create(pod)
        results = env.provision()
        assert not results.unschedulable
        assert sum(len(n.pods) for n in results.new_nodes) == len(pods)
        for node in results.new_nodes:
            assert not masked & {it.name() for it in node.instance_type_options}, "a masked type survived into a launch"
        for node in env.kube.list_nodes():
            assert node.metadata.labels[k.lbl.LABEL_INSTANCE_TYPE] not in masked
        if mode == "dense":
            stats = env.provisioner_controller.dense_solver.stats
            assert stats.masked_offerings > 0, "the availability mask never engaged"
            assert stats.pods_committed > 0
        return [round_outcome(results), outcome(env, k)]

    both(scenario, mode)


# -- the port's own ------------------------------------------------------------


def test_raising_solve_ends_the_batch_loop_and_stop_reraises():
    from karpenter_tpu_torch.solver import DenseSolver

    class DeviceLost(DenseSolver):
        def presolve(self, scheduler, pods):
            raise RuntimeError("device lost mid-solve")

    env = testing.Environment(dense_solver=DeviceLost(min_batch=1, device="cpu"))
    env.kube.create(testing.make_provisioner())
    controller = env.provisioner_controller
    controller.start()
    env.kube.create(testing.make_pod(requests={"cpu": "1"}))  # the pod event triggers the batcher
    controller.thread.join(timeout=30)
    assert not controller.thread.is_alive(), "the loop went on after a failed round"
    assert isinstance(controller.error, RuntimeError) and "device lost" in str(controller.error)
    assert env.kube.list_nodes() == []
    with pytest.raises(RuntimeError, match="device lost mid-solve"):
        controller.stop()


def test_a_state_cache_behind_the_api_holds_the_round_and_the_loop_goes_on():
    """The cluster state behind the API past the round's 10 s sync deadline
    (a watch lagging a scale-up over HTTP) holds the round: nothing
    launches, the loop goes on, and the batch is provisioned once the cache
    has caught up (on the FakeClock, each 0.05 s poll of the wait steps it)."""
    env = testing.Environment()
    controller = env.provisioner_controller
    controller.wait_for_cluster_sync = True
    checks, synced = [], env.cluster.synchronized

    def lagging():
        checks.append((env.clock.now(), len(env.kube.list_nodes())))
        return len(checks) > 250 and synced()

    env.cluster.synchronized = lagging
    env.kube.create(testing.make_provisioner())
    controller.start()
    try:
        env.kube.create(testing.make_pod(requests={"cpu": "1"}))  # the pod event triggers the batcher
        deadline = time.monotonic() + 30
        while not env.kube.list_nodes() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(env.kube.list_nodes()) == 1, "the held batch was never provisioned"
        assert controller.error is None and controller.thread.is_alive()
        waited = [t for t, _ in checks]
        assert waited[201] - waited[0] > 10.0, "the first round did not wait out its sync deadline"
        assert all(nodes == 0 for _, nodes in checks[:251]), "a round launched before the cache caught up"
    finally:
        controller.stop()
    assert controller.error is None and not controller.thread.is_alive()


def test_a_stop_during_the_sync_wait_ends_the_loop_with_no_error():
    """stop() while a round waits for a cache that never catches up ends
    the batch loop at the next poll, not at the 10 s deadline, and keeps no
    error."""
    from karpenter_tpu_torch.utils.clock import Clock

    env = testing.Environment(clock=Clock())
    controller = env.provisioner_controller
    controller.wait_for_cluster_sync = True
    waiting = threading.Event()

    def never():
        waiting.set()
        return False

    env.cluster.synchronized = never
    env.kube.create(testing.make_provisioner())
    controller.start()
    env.kube.create(testing.make_pod(requests={"cpu": "1"}))
    assert waiting.wait(30), "no round reached the sync wait"
    t0 = time.monotonic()
    controller.stop()
    assert time.monotonic() - t0 < 2.0
    assert controller.error is None and not controller.thread.is_alive()
    assert env.kube.list_nodes() == []


def test_clean_stop_raises_nothing():
    env = testing.Environment()
    controller = env.provisioner_controller
    controller.start()
    controller.stop()
    assert controller.error is None and not controller.thread.is_alive()


def test_remote_solver_is_not_ported():
    """The JAX package's fallback from a failed remote solve to the local
    scheduler is not ported: the RemoteSchedulingError leaves the round and
    nothing launches. A batch below the crossover never reaches the
    sidecar."""
    from karpenter_tpu_torch.controllers.provisioning import ProvisionerController
    from karpenter_tpu_torch.service.client import RemoteSchedulingError
    from karpenter_tpu_torch.solver import DenseSolver

    class FailingSidecar:
        calls = 0

        def solve(self, *args, **kwargs):
            FailingSidecar.calls += 1
            raise RemoteSchedulingError("solver service unreachable: refused")

    env = testing.Environment()
    env.kube.create(testing.make_provisioner())
    env.kube.create(testing.make_pod(requests={"cpu": 0.5}))
    controller = ProvisionerController(
        env.kube, env.cluster, env.provider, remote_solver=FailingSidecar(),
        dense_solver=DenseSolver(min_batch=2, device="cpu"), clock=env.clock,
    )
    results = controller.provision()  # 1 pod < min_batch 2: solved locally
    assert FailingSidecar.calls == 0 and sum(len(n.pods) for n in results.new_nodes) == 1
    nodes = len(env.kube.list_nodes())
    env.kube.create(testing.make_pod(requests={"cpu": 0.5}))
    env.kube.create(testing.make_pod(requests={"cpu": 0.5}))
    with pytest.raises(RemoteSchedulingError, match="unreachable"):
        controller.provision()
    assert FailingSidecar.calls == 1 and len(env.kube.list_nodes()) == nodes


class _ScriptedClock:
    """A FakeClock of either package whose sleep fires the batcher trigger
    at scripted instants (seconds after the window opened)."""

    def __init__(self, fake_clock, triggers):
        self.clock = fake_clock
        self.start = fake_clock.now()
        self.pending = sorted(triggers)
        self.batcher = None

    def now(self):
        return self.clock.now()

    def sleep(self, seconds):
        self.clock.step(seconds)
        while self.pending and self.now() - self.start >= self.pending[0]:
            self.pending.pop(0)
            self.batcher.trigger()


@pytest.mark.parametrize("case", ["opens", "extends", "caps", "immediate"])
def test_batcher_window_matches_the_reference(case):
    from karpenter_tpu.config import Config as RefConfig
    from karpenter_tpu.controllers.provisioning.batcher import Batcher as RefBatcher
    from karpenter_tpu.utils.clock import FakeClock as RefFakeClock
    from karpenter_tpu_torch.config import Config
    from karpenter_tpu_torch.controllers.provisioning.batcher import Batcher
    from karpenter_tpu_torch.utils.clock import FakeClock

    # extra triggers, in seconds after the first; idle 1 s, max 10 s
    triggers = {"opens": [], "extends": [0.5, 1.2, 2.0], "caps": [0.5 * i for i in range(1, 60)], "immediate": []}[case]
    windows = []
    for batcher_class, config_class, clock_class in ((RefBatcher, RefConfig, RefFakeClock), (Batcher, Config, FakeClock)):
        clock = _ScriptedClock(clock_class(), triggers)
        batcher = batcher_class(config_class(batch_max_duration=10.0, batch_idle_duration=1.0), clock)
        clock.batcher = batcher
        if case == "immediate":
            batcher.trigger_immediate()
        else:
            batcher.trigger()
        assert batcher.wait() is True
        windows.append(round(clock.now() - clock.start, 6))
        # the window closed: a second wait blocks until the next trigger
        done = threading.Event()
        waiter = threading.Thread(target=lambda: (batcher.wait(), done.set()), daemon=True)
        waiter.start()
        assert not done.wait(0.2), "a closed window reopened without a trigger"
        batcher.trigger_immediate()
        assert done.wait(5)
    # the window closes at the first poll (0.05 s steps) past its bound; a
    # trigger lands at the end of the step that crossed its instant
    expected = {"opens": 1.0, "extends": 3.0, "caps": 10.0, "immediate": 0.0}[case]
    assert windows[0] == windows[1] == pytest.approx(expected, abs=0.11)
