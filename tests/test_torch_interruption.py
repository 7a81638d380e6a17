"""The port's interruption controller and its queue held against the JAX package.

Every case of tests/test_interruption_catalog.py runs here on both
packages, written once against an `SKit` (a DKit with the simulated cloud,
the interruption controller and the gc sweep of one package). The
reference's side builds that file's InterruptionEnv (a Runtime over the
simulated cloud, the dense solver off), the port's
karpenter_tpu_torch/testing.py's InterruptionEnv (the controllers the
Runtime wires, without it); the reference's rig is given the port's
attribute names (`sim_rig`). The case's own assertions run on both sides,
and the two records must be equal: the nodes, pods, events, cloud
instances, quarantined pools and queue depths (`sim_record`), and the
controller's tallies taken as deltas (the reference's registry is
process-wide).

The catalog cases run with the exact host loop and with the dense solve at
min_batch=1, so every proactive re-solve goes dense. Instance ids (and so
node names) count from 1 per backend, and nodes launch one at a time, so
both sides name them alike.

Left for ROADMAP A9b: the `http` transport of the end-to-end drill
(`test_spot_interruption_drill_end_to_end[http]`, CloudAPIService and
CloudAPIClient). The reference's
test_transient_solve_failure_retries_on_redelivery holds the port's one
deliberate difference: a re-solve's exception leaves poll_once() (the
reference logs it), and in both the redelivered notice retries the solve.
A port-only case makes K1's or K2's wrapper raise inside the proactive
re-solve (TestReSolveFaults).

The helpers of this module (SKit, sim_rig, sim_record, sboth) serve
tests/test_torch_gc.py, _simulated_provider.py and _interruption_wave.py.
"""

from __future__ import annotations

import logging

import pytest

from karpenter_tpu_torch.solver.faults import SolverDeviceLostError
from tests.test_torch_consolidation import DKit, reference_auditor_off  # noqa: F401
from tests.test_torch_provisioning import MODES, _unnamed, reference_singletons, run_both  # noqa: F401

KINDS = ("spot_interruption", "rebalance_recommendation", "scheduled_maintenance", "instance_stopped", "instance_terminated", "malformed")
ACTIONS = ("cordon_and_drain", "cordon", "garbage_collect", "no_op")


@pytest.fixture(autouse=True)
def leader_cleared():
    """The reference's Runtime rigs register a process-wide leader; their
    close() clears it, and so does this after every test."""
    yield
    from karpenter_tpu.runtime import LeaderElector

    LeaderElector._leader = None


def sim_rig(env):
    """The reference's Runtime-backed rig under the port rig's attribute
    names (the objects are the Runtime's own)."""
    rt = env.runtime
    env.provisioner_controller, env.node_controller = rt.provisioner, rt.node_controller
    env.termination_controller, env.counter_controller = rt.termination, rt.counter
    env.recorder, env.cluster, env.gc = rt.recorder, rt.cluster, rt.gc
    env.provision = rt.provision_once
    return env


class RefSimulatedEnv:
    """A Runtime over the reference's simulated cloud, the dense solver off
    (tests/test_simulated_provider.py's end-to-end rig; with
    `interruption_queue` set, the interruption controller too), under the
    port rig's attribute names."""

    def __init__(self, **options):
        from karpenter_tpu.cloudprovider.simulated import CloudBackend, SimulatedCloudProvider
        from karpenter_tpu.kube.cluster import KubeCluster
        from karpenter_tpu.runtime import Runtime
        from karpenter_tpu.utils.clock import FakeClock
        from karpenter_tpu.utils.options import Options

        self.clock = FakeClock()
        self.kube = KubeCluster(clock=self.clock)
        self.backend = CloudBackend(clock=self.clock)
        self.provider = SimulatedCloudProvider(backend=self.backend, kube=self.kube, clock=self.clock)
        self.runtime = Runtime(
            kube=self.kube, cloud_provider=self.provider,
            options=Options(leader_elect=False, dense_solver_enabled=False, **options),
        )
        self.interruption = self.runtime.interruption
        sim_rig(self)

    def instance_id(self, node) -> str:
        return node.spec.provider_id.split("///", 1)[1]


class SKit(DKit):
    """DKit with the simulated cloud of one package: its backend, queue,
    provider, fleet batcher, interruption messages and controllers, and the
    interruption and gc rigs."""

    def __init__(self, side: str, mode: str):
        super().__init__(side, mode)
        if side == "ref":
            from karpenter_tpu import webhooks
            from karpenter_tpu.cloudprovider.simulated import backend, catalog, fleet, launchtemplate, notifications, provider
            from karpenter_tpu.controllers.gc import GarbageCollectionController
            from karpenter_tpu.controllers.interruption import InterruptionController, messages
            from tests.test_gc import GCEnv
            from tests.test_interruption_catalog import InterruptionEnv
        else:
            from karpenter_tpu_torch import webhooks
            from karpenter_tpu_torch.cloudprovider.simulated import backend, catalog, fleet, launchtemplate, notifications, provider
            from karpenter_tpu_torch.controllers.gc import GarbageCollectionController
            from karpenter_tpu_torch.controllers.interruption import InterruptionController, messages
            from karpenter_tpu_torch.testing import GCEnv, InterruptionEnv
        self.webhooks, self.backend, self.catalog, self.fleet = webhooks, backend, catalog, fleet
        self.launchtemplate, self.notifications, self.provider = launchtemplate, notifications, provider
        self.GarbageCollectionController, self.InterruptionController, self.messages = (
            GarbageCollectionController, InterruptionController, messages,
        )
        self.GCEnv, self.InterruptionEnv = GCEnv, InterruptionEnv

    def _sim(self, env):
        if self.side == "ref":
            sim_rig(env)
        env = self._routed(env, self.mode_solver())
        env.tallies_baseline = tallies(env)
        return env

    def interruption_env(self):
        return self._sim(self.InterruptionEnv())

    def gc_env(self):
        return self._sim(self.GCEnv())

    def dead_letter_gauge(self, controller) -> float:
        """The dead-letter depth the last poll saw (each package's gauge)."""
        return controller.dead_letter_depth.value()


def controller_tallies(interruption) -> dict:
    """An interruption controller's counts."""
    out = {f"received/{kind}": interruption.messages_received.value(kind=kind) for kind in KINDS}
    out.update({f"action/{a}": interruption.actions_performed.value(action=a) for a in ACTIONS})
    out["deleted"] = interruption.messages_deleted.value()
    out["parse_errors"] = interruption.message_parse_errors.value()
    return out


def tallies(env) -> dict:
    """The interruption controller's (where the rig has one) and the gc
    sweep's counts."""
    interruption = getattr(env, "interruption", None)
    out = controller_tallies(interruption) if interruption is not None else {}
    out.update({f"gc/{d}": env.gc.collected.value(direction=d) for d in ("orphaned-instance", "ghost-node")})
    out["gc/sweeps"] = env.gc.sweeps.value()
    return out


def tallies_delta(env) -> dict:
    now = tallies(env)
    return {key: value - env.tallies_baseline[key] for key, value in now.items() if value != env.tallies_baseline[key]}


def sim_record(env, k) -> dict:
    """What a simulated-cloud environment shows: nodes (name, type, zone,
    capacity type, initialized, cordoned, deleting, taint keys), pods (node,
    phase, deleting; pod names come from each package's own counter),
    events (pod names left out), the cloud's instances, the quarantined
    pools, the queue's depths, the tally deltas and the pods the dense
    solver committed (host mode: None)."""
    lbl = k.lbl
    nodes = []
    for node in env.kube.list_nodes():
        labels = node.metadata.labels
        nodes.append((
            node.name,
            labels.get(lbl.LABEL_INSTANCE_TYPE),
            labels.get(lbl.LABEL_TOPOLOGY_ZONE),
            labels.get(lbl.LABEL_CAPACITY_TYPE),
            labels.get(lbl.LABEL_NODE_INITIALIZED),
            bool(node.spec.unschedulable),
            node.metadata.deletion_timestamp is not None,
            sorted(t.key for t in node.spec.taints),
        ))
    pods = sorted(
        (p.spec.node_name, p.status.phase, p.metadata.deletion_timestamp is not None) for p in env.kube.list_pods()
    )
    events = sorted(
        (e.kind, e.reason, e.object_name if e.kind == "Node" else "", _unnamed(e.message)) for e in env.recorder.events
    )
    queue = env.backend.notifications
    solver = env.provisioner_controller.dense_solver
    return {
        "nodes": nodes,
        "pods": pods,
        "events": events,
        "instances": sorted((i.instance_id, i.instance_type, i.zone, i.capacity_type) for i in env.backend.list_instances()),
        "quarantined": sorted(env.provider.unavailable.snapshot()),
        "queue": (queue.depth(), queue.in_flight(), queue.dead_letter_depth()),
        "tallies": tallies_delta(env),
        "dense_committed": None if solver is None else (solver.stats.pods_committed, solver.stats.pods_on_existing),
    }


def sboth(scenario, mode: str):
    """run_both with an SKit on each side; the two records must be equal.
    Returns the port's record."""
    ref, port = run_both(lambda k: scenario(SKit(k.side, k.mode)), mode)
    assert port == ref
    return port


class _Handled(logging.Handler):
    """The names of the loggers that logged an exception as handled."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.names = []

    def emit(self, record):
        if record.exc_info:
            self.names.append(record.name)


def count_solves(env) -> list:
    """Count the provisioning controller's schedule calls from now on, in
    the one-element list returned."""
    solves = [0]
    schedule = env.provisioner_controller.schedule

    def counted(*args, **kwargs):
        solves[0] += 1
        return schedule(*args, **kwargs)

    env.provisioner_controller.schedule = counted
    return solves


def _interruption_tainted(k, node) -> bool:
    return node.spec.unschedulable and any(t.key == k.lbl.TAINT_INTERRUPTION for t in node.spec.taints)


def _recreate(env, k, count: int) -> list:
    pods = [k.owned(requests={"cpu": "1", "memory": "1Gi"}) for _ in range(count)]
    for pod in pods:
        env.kube.create(pod)
    return pods


# -- queue semantics (no solve: once on each package) -------------------------


class TestNotificationQueue:
    def test_at_least_once_visibility_redelivery(self):
        def scenario(k):
            clock = k.clock.FakeClock()
            queue = k.notifications.NotificationQueue(clock=clock, visibility_timeout=30.0)
            queue.send({"kind": "rebalance_recommendation", "instance_id": "i-1"})
            first = queue.receive_messages()
            assert len(first) == 1 and first[0].receive_count == 1
            assert queue.receive_messages() == []
            clock.step(31)
            second = queue.receive_messages()
            assert len(second) == 1 and second[0].receive_count == 2
            assert second[0].message_id == first[0].message_id
            return [(m.message_id, m.receipt_handle, m.receive_count, m.body) for m in first + second]

        sboth(scenario, "host")

    def test_stale_receipt_handle_does_not_delete(self):
        def scenario(k):
            clock = k.clock.FakeClock()
            queue = k.notifications.NotificationQueue(clock=clock, visibility_timeout=30.0)
            queue.send({"kind": "rebalance_recommendation", "instance_id": "i-1"})
            first = queue.receive_messages()
            clock.step(31)
            second = queue.receive_messages()
            stale = queue.delete_message(first[0].receipt_handle)
            assert stale is False
            depth = queue.depth()
            assert depth == 1
            fresh = queue.delete_message(second[0].receipt_handle)
            assert fresh is True
            assert queue.depth() == 0
            return [stale, depth, fresh, queue.depth(), queue.deleted_total, queue.redelivered_total]

        sboth(scenario, "host")

    def test_dead_letter_after_max_receives(self):
        def scenario(k):
            clock = k.clock.FakeClock()
            queue = k.notifications.NotificationQueue(clock=clock, visibility_timeout=10.0, max_receive_count=3)
            queue.send({"poison": True})
            received = []
            for _ in range(3):
                received.append(len(queue.receive_messages()))
                clock.step(11)
            assert received == [1, 1, 1]
            assert queue.receive_messages() == []
            assert queue.depth() == 0
            assert queue.dead_letter_depth() == 1
            assert queue.dead_letters()[0].body == {"poison": True}
            return [received, queue.depth(), queue.dead_letter_depth(), [m.body for m in queue.dead_letters()]]

        sboth(scenario, "host")

    def test_long_poll_returns_on_arrival(self):
        def scenario(k):
            import threading
            import time

            queue = k.notifications.NotificationQueue()
            result = {}

            def recv():
                t0 = time.monotonic()
                result["messages"] = queue.receive_messages(wait_seconds=5.0)
                result["elapsed"] = time.monotonic() - t0

            thread = threading.Thread(target=recv)
            thread.start()
            time.sleep(0.1)
            queue.send({"kind": "instance_stopped", "instance_id": "i-9"})
            thread.join(timeout=5)
            assert result["messages"], "long poll must deliver the arrival"
            assert result["elapsed"] < 4.0, "arrival must wake the waiter before the deadline"
            return [[m.body for m in result["messages"]], result["elapsed"] < 4.0]

        sboth(scenario, "host")


# -- message taxonomy -----------------------------------------------------------


class TestMessageParsing:
    def test_parses_every_kind(self):
        def scenario(k):
            parsed = []
            for body, kind in [
                ({"kind": "spot_interruption", "instance_id": "i-1", "deadline": 100.0}, "spot_interruption"),
                ({"kind": "rebalance_recommendation", "instance_id": "i-1"}, "rebalance_recommendation"),
                ({"kind": "scheduled_maintenance", "instance_id": "i-1", "not_before": 5.0}, "scheduled_maintenance"),
                ({"kind": "instance_stopped", "instance_id": "i-1"}, "instance_stopped"),
                ({"kind": "instance_terminated", "instance_id": "i-1"}, "instance_terminated"),
            ]:
                msg = k.messages.parse(body)
                assert msg.kind == kind
                parsed.append((msg.kind, msg.instance_id, msg.deadline, msg.action()))
            return parsed

        sboth(scenario, "host")

    @pytest.mark.parametrize(
        "body",
        [
            "not a dict",
            {},
            {"kind": "unheard_of", "instance_id": "i-1"},
            {"kind": "spot_interruption", "instance_id": "i-1"},  # no deadline
            {"kind": "spot_interruption", "instance_id": "", "deadline": 1.0},
            {"kind": "scheduled_maintenance", "instance_id": "i-1", "not_before": "soon"},
        ],
    )
    def test_rejects_malformed(self, body):
        def scenario(k):
            with pytest.raises(k.messages.MessageParseError) as raised:
                k.messages.parse(body)
            return str(raised.value)

        sboth(scenario, "host")


# -- controller catalog -----------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
class TestInterruptionCatalog:
    def test_spot_interruption_drill_end_to_end(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(3)
            deadline = env.backend.interrupt_spot_instance(env.instance_id(node))
            assert deadline == env.clock.now() + 120.0
            env.interruption.poll_once()
            replacements = [n for n in env.kube.list_nodes() if n.name != node.name]
            assert replacements, "proactive solve must launch replacement capacity"
            after_poll = sim_record(env, k)
            env.converge()
            assert env.kube.get_node(node.name) is None
            live = env.kube.list_nodes()
            assert live and all(env.backend.instance_exists(env.instance_id(n)) for n in live)
            _recreate(env, k, 3)
            results = env.provision()
            placed_existing = sum(len(v.pods) for v in results.existing_nodes)
            launched_new = len([n for n in results.new_nodes if n.pods])
            assert placed_existing == 3 and launched_new == 0
            assert env.clock.now() < deadline
            assert env.backend.notifications.depth() == 0, "no message may leak undeleted"
            assert env.interruption.actions_performed.value(action="cordon_and_drain") >= 1
            reasons = {e.reason for e in env.recorder.events}
            assert "SpotInterrupted" in reasons and "InterruptionReplacement" in reasons
            return [after_poll, placed_existing, launched_new, sim_record(env, k)]

        sboth(scenario, mode)

    def test_rebalance_recommendation_cordons_only(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(2)
            env.backend.recommend_rebalance(env.instance_id(node))
            env.interruption.poll_once()
            refreshed = env.kube.get_node(node.name)
            assert _interruption_tainted(k, refreshed)
            assert refreshed.metadata.deletion_timestamp is None, "rebalance must not drain"
            assert len(env.kube.list_nodes()) == 1, "rebalance must not launch capacity"
            assert env.backend.notifications.depth() == 0
            assert env.interruption.actions_performed.value(action="cordon") >= 1
            return [sim_record(env, k)]

        sboth(scenario, mode)

    def test_scheduled_maintenance_drains_with_replacement(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(2)
            env.backend.schedule_maintenance(env.instance_id(node), not_before_seconds=600.0)
            env.interruption.poll_once()
            replacements = [n for n in env.kube.list_nodes() if n.name != node.name]
            assert replacements, "maintenance is a drain: replacement capacity launches"
            after_poll = sim_record(env, k)
            env.converge()
            assert env.kube.get_node(node.name) is None
            assert env.backend.notifications.depth() == 0
            return [after_poll, sim_record(env, k)]

        sboth(scenario, mode)

    def test_instance_stopped_garbage_collects(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(2)
            env.backend.stop_instance(env.instance_id(node))
            env.interruption.poll_once()
            env.converge()
            assert env.kube.get_node(node.name) is None, "stopped instance's node is garbage-collected"
            assert env.backend.notifications.depth() == 0
            assert env.interruption.actions_performed.value(action="garbage_collect") >= 1
            return [sim_record(env, k)]

        sboth(scenario, mode)

    def test_instance_terminated_garbage_collects(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(2)
            env.backend.terminate_instance(env.instance_id(node))
            env.interruption.poll_once()
            env.converge()
            assert env.kube.get_node(node.name) is None
            assert env.backend.notifications.depth() == 0
            return [sim_record(env, k)]

        sboth(scenario, mode)

    def test_duplicate_delivery_is_idempotent(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(2)
            deadline = env.clock.now() + 120.0
            body = {"kind": "spot_interruption", "instance_id": env.instance_id(node), "deadline": deadline}
            env.backend.notifications.send(body)
            env.backend.notifications.send(body)  # duplicate send (distinct ids)
            solves = count_solves(env)
            env.interruption.poll_once()
            replacements = [n for n in env.kube.list_nodes() if n.name != node.name]
            assert solves == [1], "one victim -> exactly one proactive solve"
            if k.mode == "host":  # the dense solve may launch two smaller nodes
                assert len(replacements) == 1
            env.converge()
            assert env.backend.notifications.depth() == 0, "both copies deleted"
            return [sim_record(env, k)]

        sboth(scenario, mode)

    def test_redelivered_message_short_circuits(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(2)
            queue = env.backend.notifications
            queue.send({"kind": "spot_interruption", "instance_id": env.instance_id(node), "deadline": env.clock.now() + 120.0})
            first = queue.receive_messages()
            env.interruption._handle(first[0])
            queue_nodes = len(env.kube.list_nodes())
            env.clock.step(31)
            env.interruption.poll_once()
            assert len(env.kube.list_nodes()) == queue_nodes, "redelivery must not double-provision"
            assert queue.depth() == 0, "the redelivered copy is deleted by its fresh handle"
            return [queue_nodes, sim_record(env, k)]

        sboth(scenario, mode)

    def test_receiver_crash_redelivery_new_controller_is_idempotent(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(2)
            queue = env.backend.notifications
            queue.send({"kind": "spot_interruption", "instance_id": env.instance_id(node), "deadline": env.clock.now() + 120.0})
            original_delete = queue.delete_message
            queue.delete_message = lambda handle: (_ for _ in ()).throw(ConnectionError("receiver died before delete"))
            solves = count_solves(env)
            try:
                env.interruption.poll_once()
            finally:
                queue.delete_message = original_delete
            assert queue.in_flight() == 1, "the crash left the handled message undeleted"
            replacements = [n.name for n in env.kube.list_nodes() if n.name != node.name]
            assert solves == [1] and replacements, "the first delivery provisioned the replacement"
            if k.mode == "host":  # the dense solve may launch two smaller nodes
                assert len(replacements) == 1
            instances_after_crash = set(env.backend.instances)
            crashed = sim_record(env, k)
            restarted = k.InterruptionController(
                env.kube, env.cluster, env.provisioner_controller, env.interruption.queue,
                termination=env.termination_controller, clock=env.clock,
            )
            env.clock.step(31)
            for _ in range(4):
                restarted.poll_once()
                env.termination_controller.reconcile_all()
            assert queue.depth() == 0, "the restarted controller deleted the redelivered copy"
            assert set(env.backend.instances) == instances_after_crash, "replay must not double-launch"
            assert [n.name for n in env.kube.list_nodes() if n.name != node.name] == replacements, (
                "replay must not re-provision a second replacement"
            )
            assert solves == [1]
            fresh = env.kube.get_node(node.name)
            assert fresh is None or fresh.metadata.deletion_timestamp is not None
            final = sim_record(env, k)
            return [crashed, sorted(instances_after_crash), final]

        sboth(scenario, mode)

    def test_unknown_instance_tolerated(self, mode):
        def scenario(k):
            env = k.interruption_env()
            env.backend.notifications.send(
                {"kind": "spot_interruption", "instance_id": "i-never-existed", "deadline": env.clock.now() + 120.0}
            )
            env.interruption.poll_once()
            assert env.backend.notifications.depth() == 0, "moot notice deleted cleanly"
            assert env.interruption.actions_performed.value(action="no_op") >= 1
            return [sim_record(env, k)]

        sboth(scenario, mode)

    def test_malformed_payload_dead_letters(self, mode):
        def scenario(k):
            env = k.interruption_env()
            parse_errors_before = env.interruption.message_parse_errors.value()
            env.backend.notifications.send({"kind": "spot_interruption"})  # no instance_id
            for _ in range(4):
                env.interruption.poll_once()
                env.clock.step(31)
            assert env.backend.notifications.depth() == 0
            assert env.backend.notifications.dead_letter_depth() == 1, "poison payload must dead-letter"
            assert env.interruption.message_parse_errors.value() >= parse_errors_before + 3
            env.interruption.poll_once()
            gauge = k.dead_letter_gauge(env.interruption)
            assert gauge == 1.0, "dead-letter depth visible"
            return [gauge, sim_record(env, k)]

        sboth(scenario, mode)

    def test_deadline_race_drain_beats_the_warning_window(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(3)
            victim_id = env.instance_id(node)
            deadline = env.backend.interrupt_spot_instance(victim_id)
            env.interruption.poll_once()
            env.converge()
            assert env.kube.get_node(node.name) is None
            assert env.clock.now() < deadline, "drain must finish inside the warning window"
            env.clock.step(121)
            reclaimed = env.backend.reclaim_due_instances()
            assert reclaimed == []
            survivors = env.kube.list_nodes()
            assert survivors and all(env.backend.instance_exists(env.instance_id(n)) for n in survivors)
            return [reclaimed, sim_record(env, k)]

        sboth(scenario, mode)

    def test_transient_solve_failure_retries_on_redelivery(self, mode):
        """The one deliberate difference: the reference logs the failed
        solve inside poll_once(); the port lets it leave poll_once(). In
        both, the message stays on the queue, the node is not drained, and
        the redelivered notice retries the solve."""

        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(2)
            env.backend.interrupt_spot_instance(env.instance_id(node))
            real_schedule = env.provisioner_controller.schedule
            calls = {"n": 0}

            def flaky_schedule(*args, **kwargs):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise RuntimeError("transient cloud hiccup")
                return real_schedule(*args, **kwargs)

            env.provisioner_controller.schedule = flaky_schedule
            logged = _Handled()
            package = logging.getLogger("karpenter_tpu" if k.side == "ref" else "karpenter_tpu_torch")
            package.addHandler(logged)
            try:
                if k.side == "port":
                    with pytest.raises(RuntimeError, match="transient cloud hiccup"):
                        env.interruption.poll_once()
                else:
                    env.interruption.poll_once()
            finally:
                package.removeHandler(logged)
            assert env.kube.get_node(node.name).metadata.deletion_timestamp is None, (
                "drain must not start without a replacement attempt"
            )
            assert env.backend.notifications.depth() == 1, "failed handling leaves the message for redelivery"
            failed = sim_record(env, k)
            env.clock.step(31)
            env.interruption.poll_once()
            assert calls["n"] == 2, "redelivery must retry the proactive solve"
            replacements = [n for n in env.kube.list_nodes() if n.name != node.name]
            assert replacements, "retried solve launches the replacement"
            env.converge()
            assert env.kube.get_node(node.name) is None
            assert env.backend.notifications.depth() == 0
            return [logged.names, failed, calls["n"], sim_record(env, k)]

        ref, port = run_both(lambda k: scenario(SKit(k.side, k.mode)), mode)
        assert ref[0] == ["karpenter_tpu.interruption"], "the reference logs the failed solve and swallows it"
        assert port[0] == [], "the port's failed solve was logged as handled"
        assert port[1:] == ref[1:]

    def test_events_deduped_within_ttl(self, mode):
        def scenario(k):
            env = k.interruption_env()
            node, pods = env.launch_node_with_pods(2)
            env.backend.recommend_rebalance(env.instance_id(node))
            env.interruption.poll_once()
            env.backend.recommend_rebalance(env.instance_id(node))
            env.interruption.poll_once()
            events = [e for e in env.recorder.events if e.reason == "RebalanceRecommended" and e.object_name == node.name]
            assert len(events) == 1, "identical notices within the TTL emit one event"
            return [len(events), sim_record(env, k)]

        sboth(scenario, mode)


class TestReSolveFaults:
    """A kernel fault raised inside the proactive re-solve (classified: a
    SolverFault) is held: poll_once() logs it, not as handled, leaves the
    notice on the queue and the victim undrained, and clears the victim's
    one-solve claim so the redelivered notice solves again on the card. An
    exception classify() has no name for, and a device-lost the card raised
    (its context stays broken), leave poll_once() the same way."""

    @pytest.mark.parametrize("seam", ["bucket_cost_packed", "warm_fill_counts_device"])
    def test_kernel_fault_leaves_poll_once(self, seam, monkeypatch, caplog):
        from karpenter_tpu_torch.solver import dense as dense_module
        from karpenter_tpu_torch.solver import warmfill as fill_module

        k = SKit("port", "dense")
        env = k.interruption_env()
        node, pods = env.launch_node_with_pods(3)
        if seam == "warm_fill_counts_device":
            # a second node standing: the re-solve fills it first (K2)
            big = k.owned(requests={"cpu": "3", "memory": "1Gi"})
            env.kube.create(big)
            env.provision()
            env.bind_nominated()
        nodes = {n.name for n in env.kube.list_nodes()}
        assert len(nodes) == (1 if seam == "bucket_cost_packed" else 2)
        env.backend.interrupt_spot_instance(env.instance_id(node))
        calls = []

        def fault(*args, **kwargs):
            calls.append(seam)
            raise RuntimeError("bucket_cost kernel launch failed: cudaErrorInvalidValue: invalid argument (CUDA error 1)")

        monkeypatch.setattr(dense_module if seam == "bucket_cost_packed" else fill_module, seam, fault)
        caplog.set_level(logging.DEBUG, logger="karpenter_tpu_torch")
        assert env.interruption.poll_once() == 1  # held, left for redelivery
        assert calls == [seam]
        assert any("held by a kernel fault" in r.getMessage() for r in caplog.records)
        assert not [r for r in caplog.records if r.exc_info], "the fault was logged as handled"
        assert {n.name for n in env.kube.list_nodes()} == nodes, "no replacement launched"
        victim = env.kube.get_node(node.name)
        assert victim.metadata.deletion_timestamp is None, "the victim is not drained"
        queue = env.backend.notifications
        assert queue.depth() == 1 and queue.in_flight() == 1, "the notice stays on the queue"
        assert not env.interruption._replaced, "the one-solve claim is cleared"

        def novel(*args, **kwargs):
            calls.append(seam)
            raise ValueError("a failure classify has no name for")

        monkeypatch.setattr(dense_module if seam == "bucket_cost_packed" else fill_module, seam, novel)
        env.clock.step(31)
        with pytest.raises(ValueError, match="no name for"):
            env.interruption.poll_once()
        assert calls == [seam, seam], "the redelivered notice solved again"
        assert queue.depth() == 1 and not env.interruption._replaced
        monkeypatch.undo()
        env.clock.step(31)
        env.converge()
        assert env.kube.get_node(node.name) is None, "the redelivered notice drains the victim"
        assert queue.depth() == 0

    @pytest.mark.parametrize("seam", ["bucket_cost_packed", "warm_fill_counts_device"])
    def test_device_lost_the_card_raised_leaves_poll_once(self, seam, monkeypatch):
        """A device-lost the card raised leaves the CUDA context broken: no
        redelivery can succeed in this process, so it is not held."""
        from karpenter_tpu_torch.solver import dense as dense_module
        from karpenter_tpu_torch.solver import warmfill as fill_module

        k = SKit("port", "dense")
        env = k.interruption_env()
        node, _pods = env.launch_node_with_pods(3)
        if seam == "warm_fill_counts_device":
            env.kube.create(k.owned(requests={"cpu": "3", "memory": "1Gi"}))
            env.provision()
            env.bind_nominated()
        env.backend.interrupt_spot_instance(env.instance_id(node))

        def lost(*args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(dense_module if seam == "bucket_cost_packed" else fill_module, seam, lost)
        with pytest.raises(SolverDeviceLostError, match="illegal memory access") as raised:
            env.interruption.poll_once()
        assert not raised.value.injected
        queue = env.backend.notifications
        assert queue.depth() == 1 and not env.interruption._replaced, "the notice stays for the restarted process"
        assert env.kube.get_node(node.name).metadata.deletion_timestamp is None
