"""The port's consolidation controller held against the JAX package, case by case.

Every case of tests/test_consolidation_catalog.py and of
tests/test_deprovisioning.py's TestConsolidation, TestReplacementReadiness,
TestConsolidationDepth and TestConsolidationRobustness runs here on both
packages: the reference through tests/test_deprovisioning.py's DeprovEnv
and owned_pod, the port through karpenter_tpu_torch/testing.py's. A
scenario is written once against a `DKit` (one package's classes and
builders, with deterministic pod names) and driven on each side with the
same inputs. The case's own assertions run on both sides, and the two
records must be equal: each consolidation action (type, nodes, replacement
name and instance types, reason), then the final nodes (name, type, zone,
capacity type, initialized, cordoned, deleting, annotations), pods (node,
phase), events and the provider's create and delete calls
(`cluster_record`).

Each case runs with the exact host loop and with the dense solve at
min_batch=1 (the reference's DenseSolver on JAX's CPU with its residency
auditor disabled, the port's on device="cpu", the kernels' plain
versions), except the pure disruption-cost cases, which solve nothing and
run once on each package. Two cases of this file route at the crossover
measured on the H100 instead (min_batch 64): a candidate holding at least
that many pods, whose what-if goes dense on both packages
(TestDenseWhatIf). A port-only case
makes a kernel wrapper raise inside a what-if: the exception leaves
process_cluster() (TestWhatIfFaults; the orchestrator's counterpart is in
tests/test_torch_disruption.py).

The helpers of this module (DKit, action_record, cluster_record) serve
tests/test_torch_lifecycle.py and tests/test_torch_disruption.py too.
"""

from __future__ import annotations

import logging

import pytest

from tests.test_torch_provisioning import MODES, Kit, both, reference_singletons, run_both  # noqa: F401

ALL_OUTCOMES = ("disrupted", "invalidated", "launch-failed", "replacement-timed-out", "replacement-vanished")


@pytest.fixture(autouse=True)
def reference_auditor_off(reference_singletons):  # noqa: F811
    """The reference's residency auditor seeds random.Random with a tuple,
    which Python 3.12 rejects, so its dense solves would fall back to the
    host loop; it is disabled here and restored by reference_singletons."""
    from karpenter_tpu.solver.audit import AUDITOR

    AUDITOR.disable()
    yield


class DKit(Kit):
    """Kit with the disruption side of one package: the consolidation,
    disruption, node, termination and counter controllers, the reference's
    DeprovEnv/DisruptionEnv or the port's counterparts, and owned pods."""

    def __init__(self, side: str, mode: str):
        super().__init__(side, mode)
        if side == "ref":
            from karpenter_tpu.api.provisioner import Budget, Disruption, validate_disruption
            from karpenter_tpu.controllers import disruption
            from karpenter_tpu.controllers.consolidation import ConsolidationController, helpers
            from karpenter_tpu.controllers.consolidation.controller import ActionType
            from karpenter_tpu.controllers.disruption import eligibility
            from karpenter_tpu.scheduling.nodetemplate import NodeTemplate
            from karpenter_tpu.utils import clock, cron
            from tests.test_deprovisioning import DeprovEnv, owned_pod
            from tests.test_disruption import DisruptionEnv
        else:
            from karpenter_tpu_torch.api.provisioner import Budget, Disruption, validate_disruption
            from karpenter_tpu_torch.controllers import disruption
            from karpenter_tpu_torch.controllers.consolidation import ConsolidationController, helpers
            from karpenter_tpu_torch.controllers.consolidation.controller import ActionType
            from karpenter_tpu_torch.controllers.disruption import eligibility
            from karpenter_tpu_torch.scheduling.nodetemplate import NodeTemplate
            from karpenter_tpu_torch.testing import DeprovEnv, DisruptionEnv, owned_pod
            from karpenter_tpu_torch.utils import clock, cron
        self.Budget, self.Disruption, self.validate_disruption = Budget, Disruption, validate_disruption
        self.disruption, self.eligibility, self.helpers = disruption, eligibility, helpers
        self.ConsolidationController, self.ActionType = ConsolidationController, ActionType
        self.NodeTemplate, self.clock, self.cron = NodeTemplate, clock, cron
        self.DeprovEnv, self.DisruptionEnv, self.owned_pod = DeprovEnv, DisruptionEnv, owned_pod

    def crossover_solver(self):
        """A DenseSolver routed at the crossover floor, CROSSOVER_FLOOR = 64
        in both packages: the min_batch measured on the H100, which
        chip_smoke.py's crossover phase passes to its controllers."""
        module = __import__(self.solver_class.__module__, fromlist=["CROSSOVER_FLOOR"])
        return self.solver(min_batch=module.CROSSOVER_FLOOR)

    def owned(self, **kwargs):
        kwargs.setdefault("name", f"p{next(self._pods):04d}")
        return self.owned_pod(**kwargs)

    def consolidatable(self, **kwargs):
        return self.make_provisioner(consolidation_enabled=True, **kwargs)

    def od(self, zone: str = "test-zone-1"):
        return [self.cloud_types.Offering(capacity_type="on-demand", zone=zone)]

    def big_small(self):
        """The reference's replace catalog: big (16 CPU, $10) and small (2 CPU, $1)."""
        return [
            self.fake.instance_type("big", cpu=16, memory="32Gi", price=10.0, offerings=self.od()),
            self.fake.instance_type("small", cpu=2, memory="4Gi", price=1.0, offerings=self.od()),
        ]

    def _routed(self, env, solver):
        """This mode's solver in the provisioning controller (which the
        what-ifs call); nodes launch one at a time, so the provider names
        them in one order on both packages."""
        env.provisioner_controller.dense_solver = solver
        env.provisioner_controller.LAUNCH_WORKERS = 1
        return env

    def deprov(self, provisioners=None, instance_types=None, solver=None):
        env = self.DeprovEnv(provisioners=provisioners, instance_types_list=instance_types)
        return self._routed(env, solver if solver is not None else self.mode_solver())

    def disrupt_env(self, provisioners=None, instance_types=None, solver=None):
        env = self.DisruptionEnv(provisioners=provisioners, instance_types_list=instance_types)
        env = self._routed(env, solver if solver is not None else self.mode_solver())
        # the reference's command counter is process-wide: records take deltas
        env.commands_baseline = commands_of(env)
        return env


def commands_of(env) -> dict:
    """The orchestrator's finished-command counts by (method, outcome)."""
    methods = ("emptiness", "expiration", "drift", "consolidation")
    return {(m, o): env.disruption.commands.value(method=m, outcome=o) for m in methods for o in ALL_OUTCOMES}


def commands_delta(env) -> dict:
    now = commands_of(env)
    return {f"{m}/{o}": v - env.commands_baseline[(m, o)] for (m, o), v in now.items() if v != env.commands_baseline[(m, o)]}


def action_record(action) -> dict:
    replacement = action.replacement
    return {
        "type": action.type.value,
        "nodes": [n.name for n in action.nodes],
        "replacement_name": action.replacement_name,
        "replacement_types": [it.name() for it in replacement.instance_type_options] if replacement is not None else None,
        "reason": action.reason,
    }


def cluster_record(env, k) -> dict:
    """What the environment shows: nodes, pods, events, provider calls, the
    consolidation controller's tallies (ConsolidationMetrics) and the pods
    the dense solver committed (host mode: None)."""
    from tests.test_torch_provisioning import _unnamed

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
            sorted(node.metadata.annotations.items()),
        ))
    pods = sorted(
        (p.name, p.spec.node_name, p.status.phase, p.metadata.deletion_timestamp is not None) for p in env.kube.list_pods()
    )
    events = sorted((e.kind, e.reason, e.object_name, _unnamed(e.message)) for e in env.recorder.events)
    solver = env.provisioner_controller.dense_solver
    tallies = env.consolidation.metrics
    return {
        "nodes": sorted(nodes),
        "pods": pods,
        "events": events,
        "created": len(env.provider.create_calls),
        "deleted": sorted(n.name for n in env.provider.delete_calls),
        "consolidation": (tallies.evaluations, tallies.nodes_terminated, tallies.nodes_created, list(tallies.actions)),
        "dense_committed": None if solver is None else (solver.stats.pods_committed, solver.stats.pods_on_existing),
    }


def dboth(scenario, mode: str):
    """`both` with a DKit on each side."""
    ref, port = run_dboth(scenario, mode)
    assert port == ref
    return port


def run_dboth(scenario, mode: str):
    return run_both(lambda k: scenario(DKit(k.side, k.mode)), mode)


def launch_pair(k, env, *sizes):
    """One owned pod of each cpu size, each launched onto its own node."""
    pods = [k.owned(requests={"cpu": size}) for size in sizes]
    for pod in pods:
        env.launch_node_with_pods(pod)
    return pods


# -- tests/test_consolidation_catalog.py ------------------------------------------


class TestDisruptionCost:
    """The disruption-cost model solves nothing: each case runs once on each
    package and the costs must be equal."""

    def test_standard_cost_without_priority_or_deletion_cost(self):
        def scenario(k):
            cost = k.helpers.pod_cost(k.pod())
            assert cost == 1.0
            return cost

        dboth(scenario, "host")

    def test_positive_deletion_cost_raises_cost(self):
        def scenario(k):
            expensive = k.helpers.pod_cost(k.pod(annotations={k.helpers.POD_DELETION_COST_ANNOTATION: "100"}))
            plain = k.helpers.pod_cost(k.pod())
            assert expensive > plain
            return [expensive, plain]

        dboth(scenario, "host")

    def test_negative_deletion_cost_lowers_cost(self):
        def scenario(k):
            cheap = k.helpers.pod_cost(k.pod(annotations={k.helpers.POD_DELETION_COST_ANNOTATION: "-100"}))
            plain = k.helpers.pod_cost(k.pod())
            assert cheap < plain
            return [cheap, plain]

        dboth(scenario, "host")

    def test_higher_deletion_costs_rank_higher(self):
        def scenario(k):
            costs = [
                k.helpers.pod_cost(k.pod(annotations={k.helpers.POD_DELETION_COST_ANNOTATION: str(c)}))
                for c in (-500, -10, 0, 10, 500)
            ]
            assert costs == sorted(costs)
            assert costs[0] < costs[-1]
            return costs

        dboth(scenario, "host")

    def test_higher_priority_raises_cost(self):
        def scenario(k):
            high, zero = k.helpers.pod_cost(k.pod(priority=1_000_000)), k.helpers.pod_cost(k.pod(priority=0))
            assert high > zero
            return [high, zero]

        dboth(scenario, "host")

    def test_lower_priority_lowers_cost(self):
        def scenario(k):
            low, zero = k.helpers.pod_cost(k.pod(priority=-1_000_000)), k.helpers.pod_cost(k.pod(priority=0))
            assert low < zero
            return [low, zero]

        dboth(scenario, "host")

    def test_invalid_deletion_cost_ignored(self):
        def scenario(k):
            cost = k.helpers.pod_cost(k.pod(annotations={k.helpers.POD_DELETION_COST_ANNOTATION: "not-a-number"}))
            assert cost == 1.0
            return cost

        dboth(scenario, "host")

    def test_lifetime_remaining_scales_node_cost(self):
        def scenario(k):
            clock = k.clock.FakeClock()
            fresh = k.node(allocatable={"cpu": 4})
            fresh.metadata.creation_timestamp = clock.now()
            old = k.node(allocatable={"cpu": 4})
            old.metadata.creation_timestamp = clock.now() - 90
            pods = [k.pod(), k.pod()]
            ttl = 100.0
            cost_fresh = k.helpers.disruption_cost(pods, k.helpers.lifetime_remaining(clock, fresh, ttl))
            cost_old = k.helpers.disruption_cost(pods, k.helpers.lifetime_remaining(clock, old, ttl))
            assert cost_old < cost_fresh
            assert k.helpers.lifetime_remaining(clock, old, None) == 1.0
            return [cost_fresh, cost_old]

        dboth(scenario, "host")


@pytest.mark.parametrize("mode", MODES)
class TestConsolidationGuards:
    def test_wont_delete_node_violating_anti_affinity(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(10))
            anti = dict(
                pod_anti_requirements=[
                    k.obj.PodAffinityTerm(
                        topology_key=k.lbl.LABEL_HOSTNAME,
                        label_selector=k.obj.LabelSelector(match_labels={"app": "anti"}),
                    )
                ],
                labels={"app": "anti"},
            )
            env.launch_node_with_pods(k.owned(requests={"cpu": "0.5"}, **anti))
            env.launch_node_with_pods(k.owned(requests={"cpu": "0.5"}, **anti))
            assert len(env.kube.list_nodes()) == 2
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.NO_ACTION
            assert len(env.kube.list_nodes()) == 2
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_deletes_multiple_empty_nodes_in_one_pass(self, mode):
        def scenario(k):
            env = k.deprov(
                provisioners=[k.consolidatable()],
                instance_types=[k.fake.instance_type("only", cpu=4, memory="8Gi", price=1.0, offerings=k.od())],
            )
            pods = [k.owned(requests={"cpu": "3"}) for _ in range(2)]
            for pod in pods:
                env.launch_node_with_pods(pod)
            assert len(env.kube.list_nodes()) == 2
            for pod in pods:
                env.kube.delete(pod, grace=False)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.DELETE_EMPTY
            assert len(action.nodes) == 2
            env.termination_controller.reconcile_all()
            assert env.kube.list_nodes() == []
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def _warming(self, k, env):
        pod = k.owned(requests={"cpu": "1"})
        env.launch_node_with_pods(pod)
        env.kube.delete(pod, grace=False)
        warming = k.node(labels={k.lbl.PROVISIONER_NAME_LABEL: "default"}, allocatable={"cpu": 4}, ready=False)
        warming.metadata.creation_timestamp = env.clock.now()
        env.kube.create(warming)
        return warming

    def test_uninitialized_node_blocks_entire_pass(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()])
            warming = self._warming(k, env)
            blocked = env.consolidation.process_cluster()
            assert blocked.type == k.ActionType.NO_ACTION
            assert "uninitialized" in blocked.reason
            warming.status.conditions[0].status = "True"
            env.kube.update(warming)
            env.node_controller.reconcile_all()
            assert env.kube.get_node(warming.name).metadata.labels.get(k.lbl.LABEL_NODE_INITIALIZED) == "true"
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.DELETE_EMPTY
            return [action_record(blocked), action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_stuck_uninitialized_node_stops_blocking_after_window(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()])
            self._warming(k, env)
            blocked = env.consolidation.process_cluster()
            assert blocked.type == k.ActionType.NO_ACTION
            env.clock.step(env.consolidation.REPLACE_READY_TIMEOUT + 1)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.DELETE_EMPTY, "stuck node must stop blocking"
            return [action_record(blocked), action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_slow_booting_live_instance_blocks_past_window(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()])
            warming = self._warming(k, env)
            env.provider.live_instances.add(warming.name)
            env.clock.step(env.consolidation.REPLACE_READY_TIMEOUT + 1)
            blocked = env.consolidation.process_cluster()
            assert blocked.type == k.ActionType.NO_ACTION, "live instance still warming must block"
            assert "uninitialized" in blocked.reason
            env.provider.live_instances.discard(warming.name)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.DELETE_EMPTY, "dead launch must stop blocking"
            return [action_record(blocked), action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_replace_maintains_zonal_topology_spread(self, mode):
        def scenario(k):
            env = k.deprov(
                provisioners=[k.consolidatable()],
                instance_types=[
                    k.fake.instance_type(f"t-{z}", cpu=4, memory="8Gi", price=2.0, offerings=k.od(z))
                    for z in ("test-zone-1", "test-zone-2", "test-zone-3")
                ],
            )
            spread = dict(
                labels={"app": "spread"},
                topology_spread_constraints=[
                    k.obj.TopologySpreadConstraint(
                        max_skew=1,
                        topology_key=k.lbl.LABEL_TOPOLOGY_ZONE,
                        label_selector=k.obj.LabelSelector(match_labels={"app": "spread"}),
                    )
                ],
            )
            env.launch_node_with_pods(*[k.owned(requests={"cpu": "1"}, **spread) for _ in range(3)])
            zones = {n.metadata.labels.get(k.lbl.LABEL_TOPOLOGY_ZONE) for n in env.kube.list_nodes()}
            assert len(zones) == 3
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.NO_ACTION
            assert len(env.kube.list_nodes()) == 3
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)


# -- tests/test_deprovisioning.py: TestConsolidation -------------------------------


@pytest.mark.parametrize("mode", MODES)
class TestConsolidation:
    def test_empty_nodes_deleted(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()])
            pod = k.owned(requests={"cpu": "1"})
            env.launch_node_with_pods(pod)
            env.kube.delete(pod, grace=False)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.DELETE_EMPTY
            env.termination_controller.reconcile_all()
            assert env.kube.list_nodes() == []
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_delete_when_pods_fit_elsewhere(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(20))
            p1, p2 = launch_pair(k, env, "2", "2")
            assert len(env.kube.list_nodes()) == 2
            p2.spec.containers[0].resources.requests["cpu"] = 0.5
            env.kube.update(p2)
            action = env.consolidation.process_cluster()
            assert action.type in (k.ActionType.DELETE, k.ActionType.REPLACE)
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_replace_with_cheaper(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.big_small())
            pod = k.owned(requests={"cpu": "8"})
            env.launch_node_with_pods(pod)
            pod.spec.containers[0].resources.requests["cpu"] = 0.5
            env.kube.update(pod)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.REPLACE
            assert action.replacement_name is not None
            assert action.replacement_name in [n.name for n in env.kube.list_nodes()]
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_do_not_consolidate_annotation(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()])
            pod = k.owned(requests={"cpu": "1"})
            nodes = env.launch_node_with_pods(pod)
            env.kube.delete(pod, grace=False)
            nodes[0].metadata.annotations[k.lbl.DO_NOT_CONSOLIDATE_ANNOTATION] = "true"
            env.kube.update(nodes[0])
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.NO_ACTION
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_not_enabled_no_action(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.make_provisioner()])
            pod = k.owned(requests={"cpu": "1"})
            env.launch_node_with_pods(pod)
            env.kube.delete(pod, grace=False)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.NO_ACTION
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_ownerless_pod_blocks(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(20))
            naked = k.pod(requests={"cpu": "0.5"})
            env.launch_node_with_pods(naked)
            env.launch_node_with_pods(k.owned(requests={"cpu": "0.5"}))
            action = env.consolidation.process_cluster()
            if action.type != k.ActionType.NO_ACTION:
                assert all(naked.name not in [p.name for p in env.kube.pods_on_node(n.name)] for n in action.nodes)
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_pdb_blocks_consolidation(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(20))
            env.launch_node_with_pods(k.owned(labels={"app": "db"}, requests={"cpu": "0.5"}))
            env.kube.create(
                k.obj.PodDisruptionBudget(
                    metadata=k.obj.ObjectMeta(name="db-pdb", namespace="default"),
                    selector=k.obj.LabelSelector(match_labels={"app": "db"}),
                    disruptions_allowed=0,
                )
            )
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.NO_ACTION
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_spot_to_spot_blocked(self, mode):
        def scenario(k):
            spot = [k.cloud_types.Offering(capacity_type="spot", zone="test-zone-1")]
            env = k.deprov(
                provisioners=[k.consolidatable()],
                instance_types=[
                    k.fake.instance_type("spot-big", cpu=16, memory="32Gi", price=5.0, offerings=spot),
                    k.fake.instance_type("spot-small", cpu=2, memory="4Gi", price=0.5, offerings=spot),
                ],
            )
            pod = k.owned(requests={"cpu": "8"})
            env.launch_node_with_pods(pod)
            pod.spec.containers[0].resources.requests["cpu"] = 0.5
            env.kube.update(pod)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.NO_ACTION
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_epoch_gating(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()])
            env.clock.step(400)
            runs = [env.consolidation.should_run(), env.consolidation.should_run()]
            assert runs == [True, False]
            env.kube.create(k.pod(node_name="x", unschedulable=False))
            runs.append(env.consolidation.should_run())
            assert runs[-1]
            return [runs, cluster_record(env, k)]

        dboth(scenario, mode)


# -- tests/test_deprovisioning.py: TestReplacementReadiness ------------------------


def not_ready_launches(env, k):
    """The provider's launched nodes come up NotReady (a real provider's
    behaviour) until the test marks them Ready."""
    original = env.provider.create

    def create_not_ready(request):
        node = original(request)
        node.status.conditions = []
        return node

    env.provider.create = create_not_ready


@pytest.mark.parametrize("mode", MODES)
class TestReplacementReadiness:
    def test_replace_waits_for_replacement_ready(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.big_small())
            pod = k.owned(requests={"cpu": "8"})
            old_nodes = env.launch_node_with_pods(pod)
            pod.spec.containers[0].resources.requests["cpu"] = 0.5
            env.kube.update(pod)
            not_ready_launches(env, k)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.REPLACE
            assert old_nodes[0].name in [n.name for n in env.kube.list_nodes()]
            replacement = env.kube.get_node(action.replacement_name)
            assert replacement is not None
            assert env.cluster.is_node_nominated(replacement.name)
            waiting = env.consolidation.process_cluster()
            assert waiting.type == k.ActionType.NO_ACTION
            replacement.status.conditions = [k.obj.NodeCondition(type="Ready", status="True")]
            env.kube.update(replacement)
            done = env.consolidation.process_cluster()
            assert done.type == k.ActionType.REPLACE
            env.termination_controller.reconcile_all()
            assert old_nodes[0].name not in [n.name for n in env.kube.list_nodes()]
            return [action_record(a) for a in (action, waiting, done)] + [cluster_record(env, k)]

        dboth(scenario, mode)


# -- tests/test_deprovisioning.py: TestConsolidationDepth --------------------------


@pytest.mark.parametrize("mode", MODES)
class TestConsolidationDepth:
    def test_disruption_cost_ranks_deletion_cost(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(10))
            cheap = k.owned(requests={"cpu": 4}, annotations={"controller.kubernetes.io/pod-deletion-cost": "-5"})
            costly = k.owned(requests={"cpu": 4}, annotations={"controller.kubernetes.io/pod-deletion-cost": "9"})
            env.launch_node_with_pods(cheap)
            env.launch_node_with_pods(costly)
            cost_of = {}
            for c in env.consolidation.candidate_nodes():
                names = {p.name for p in env.kube.pods_on_node(c.name)}
                if cheap.name in names:
                    cost_of["cheap"] = env.consolidation._disruption_cost(c)
                if costly.name in names:
                    cost_of["costly"] = env.consolidation._disruption_cost(c)
            assert set(cost_of) == {"cheap", "costly"}, cost_of
            assert cost_of["cheap"] < cost_of["costly"]
            return [sorted(cost_of.items()), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_nominated_node_not_a_candidate(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(10))
            env.launch_node_with_pods(k.owned(requests={"cpu": 0.5}))
            node = env.kube.list_nodes()[0]
            env.cluster.nominate_node_for_pod(node.name)
            assert env.consolidation.candidate_nodes() == []
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_uninitialized_node_not_a_candidate(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(10))
            env.kube.create(k.owned(requests={"cpu": 0.5}))
            env.provision()
            env.bind_nominated()
            env.clock.step(env.cluster.nomination_ttl + 1)
            assert env.consolidation.candidate_nodes() == []
            return [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_multiple_replacements_refused(self, mode):
        def scenario(k):
            lab = {"anti": "q"}
            term = k.obj.PodAffinityTerm(topology_key=k.lbl.LABEL_HOSTNAME, label_selector=k.obj.LabelSelector(match_labels=lab))
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(12))
            env.launch_node_with_pods(*[k.owned(labels=lab, requests={"cpu": 3}, pod_anti_requirements=[term]) for _ in range(2)])
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.NO_ACTION
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_do_not_evict_pod_blocks_consolidation(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(10))
            env.launch_node_with_pods(k.owned(requests={"cpu": 0.2}, annotations={k.lbl.DO_NOT_EVICT_ANNOTATION: "true"}))
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.NO_ACTION
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_topology_spread_respected_in_simulation(self, mode):
        def scenario(k):
            lab = {"app": "spread-consol"}
            constraint = k.obj.TopologySpreadConstraint(
                max_skew=1, topology_key=k.lbl.LABEL_TOPOLOGY_ZONE, label_selector=k.obj.LabelSelector(match_labels=lab)
            )
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(8))
            env.launch_node_with_pods(
                *[k.owned(labels=lab, requests={"cpu": 0.5}, topology_spread_constraints=[constraint]) for _ in range(6)]
            )
            action = env.consolidation.process_cluster()
            zones = None
            if action.replacement is not None:
                zones = sorted(action.replacement.requirements.get(k.lbl.LABEL_TOPOLOGY_ZONE).values)
                assert zones
            return [action_record(action), zones, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_daemonset_only_node_is_empty(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.fake.instance_types(10))
            env.launch_node_with_pods(k.owned(requests={"cpu": 0.5}))
            node = env.kube.list_nodes()[0]
            for pod in env.kube.pods_on_node(node.name):
                env.kube.delete(pod)
            ds_pod = k.pod(requests={"cpu": 0.1}, node_name=node.name, phase="Running", unschedulable=False)
            ds_pod.metadata.owner_references.append(k.obj.OwnerReference(kind="DaemonSet", name="ds"))
            env.kube.create(ds_pod)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.DELETE_EMPTY
            assert [n.metadata.name for n in action.nodes] == [node.metadata.name]
            return [action_record(action), cluster_record(env, k)]

        dboth(scenario, mode)


# -- tests/test_deprovisioning.py: TestConsolidationRobustness ---------------------


@pytest.mark.parametrize("mode", MODES)
class TestConsolidationRobustness:
    def test_stuck_replacement_times_out_and_uncordons(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.big_small())
            pod = k.owned(requests={"cpu": "8"})
            old_nodes = env.launch_node_with_pods(pod)
            pod.spec.containers[0].resources.requests["cpu"] = 0.5
            env.kube.update(pod)
            not_ready_launches(env, k)
            action = env.consolidation.process_cluster()
            assert action.type == k.ActionType.REPLACE
            assert env.kube.get_node(old_nodes[0].name).spec.unschedulable
            env.clock.step(k.ConsolidationController.REPLACE_READY_TIMEOUT + 1)
            timed_out = env.consolidation.process_cluster()
            assert timed_out.type == k.ActionType.NO_ACTION
            assert "timed out" in timed_out.reason
            old = env.kube.get_node(old_nodes[0].name)
            assert old is not None and not old.spec.unschedulable
            assert env.consolidation._pending_replace is None
            replacement = env.kube.get_node(action.replacement_name)
            assert replacement is None or replacement.metadata.deletion_timestamp is not None
            again = env.consolidation.process_cluster()
            assert again.type != k.ActionType.NO_ACTION
            return [action_record(a) for a in (action, timed_out, again)] + [cluster_record(env, k)]

        dboth(scenario, mode)

    def test_settled_cluster_consolidates_immediately(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()])
            env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))
            window = env.consolidation.stabilization_window()
            assert window == 0.0
            assert env.consolidation.should_run()
            return [window, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_unsettled_cluster_waits_full_window(self, mode):
        def scenario(k):
            env = k.deprov(provisioners=[k.consolidatable()])
            env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))
            env.kube.create(k.pod(requests={"cpu": "100"}, node_name=None))
            window = env.consolidation.stabilization_window()
            assert window == k.ConsolidationController.STABILIZATION_WINDOW
            assert not env.consolidation.should_run()
            env.clock.step(k.ConsolidationController.STABILIZATION_WINDOW + 1)
            assert env.consolidation.should_run()
            return [window, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_pdb_blocked_pod_does_not_stall_other_evictions(self, mode):
        def scenario(k):
            env = k.deprov()
            guarded = k.owned(labels={"app": "guarded"}, requests={"cpu": "1"})
            free = k.owned(requests={"cpu": "1"})
            # the case needs both pods on one node, as the host loop packs
            # them; the dense solve at min_batch=1 opens one node each, so
            # the launch round runs on the host loop in both modes (nothing
            # else here solves)
            solver, env.provisioner_controller.dense_solver = env.provisioner_controller.dense_solver, None
            nodes = env.launch_node_with_pods(guarded, free)
            env.provisioner_controller.dense_solver = solver
            assert len(nodes) == 1
            env.kube.create(
                k.obj.PodDisruptionBudget(
                    metadata=k.obj.ObjectMeta(name="guard", namespace="default"),
                    selector=k.obj.LabelSelector(match_labels={"app": "guarded"}),
                    disruptions_allowed=0,
                )
            )
            env.kube.delete(nodes[0])
            env.termination_controller.reconcile_all()
            assert env.kube.get("Pod", free.name, free.namespace) is None
            assert env.kube.get("Pod", guarded.name, guarded.namespace) is not None
            return [cluster_record(env, k)]

        dboth(scenario, mode)


# -- what-ifs at the default routing: a candidate of at least min_batch pods ------


def standing_node(k, env, name: str, type_name: str, allocatable: dict, pods: int, requests: dict):
    """A node of the consolidation-enabled default provisioner, created in
    the store (Ready, labelled as the fake provider labels its launches) and
    holding `pods` running owned pods bound to it; the node controller
    initializes it."""
    lbl = k.lbl
    labels = {
        lbl.PROVISIONER_NAME_LABEL: "default",
        lbl.LABEL_INSTANCE_TYPE: type_name,
        lbl.LABEL_TOPOLOGY_ZONE: "test-zone-1",
        lbl.LABEL_CAPACITY_TYPE: "on-demand",
        lbl.LABEL_HOSTNAME: name,
    }
    env.kube.create(k.node(name=name, labels=labels, allocatable=allocatable))
    for _ in range(pods):
        env.kube.create(k.owned(requests=requests, node_name=name, phase="Running", unschedulable=False))


class TestDenseWhatIf:
    """The what-if goes dense at the measured crossover (min_batch 64 on
    both packages) because the candidate holds that many pods: no forced
    min_batch=1. The nodes are made in the store, as chip_smoke.py's
    consolidation phases make theirs."""

    def test_candidate_at_min_batch_deletes_through_the_dense_fill(self):
        def scenario(k):
            solver = k.crossover_solver()
            wide = k.fake.instance_type("wide", cpu=32, memory="64Gi", pods=200, price=4.0, offerings=k.od())
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=[wide], solver=solver)
            for name in ("a", "b"):
                standing_node(k, env, name, "wide", {"cpu": 32, "memory": "64Gi", "pods": 200}, solver.min_batch, {"cpu": "0.1", "memory": "64Mi"})
            env.node_controller.reconcile_all()
            before = (solver.stats.batches, solver.stats.pods_to_host, solver.stats.pods_on_existing)
            action = env.consolidation.process_cluster()
            after = (solver.stats.batches, solver.stats.pods_to_host, solver.stats.pods_on_existing)
            assert action.type == k.ActionType.DELETE
            assert after[0] > before[0], "the what-if did not run dense"
            assert after[1] == before[1], "the what-if sent pods to the host loop"
            assert after[2] - before[2] == solver.min_batch, "the what-if did not fill the other node"
            env.termination_controller.reconcile_all()
            return [solver.min_batch, action_record(action), cluster_record(env, k)]

        record = dboth(scenario, "dense")
        assert record[0] >= 64

    def test_candidate_at_min_batch_replaces_through_the_dense_new_node_solve(self):
        def scenario(k):
            solver = k.crossover_solver()
            catalog = [
                k.fake.instance_type("huge", cpu=64, memory="128Gi", pods=200, price=16.0, offerings=k.od()),
                k.fake.instance_type("large", cpu=48, memory="96Gi", pods=200, price=8.0, offerings=k.od()),
            ]
            env = k.deprov(provisioners=[k.consolidatable()], instance_types=catalog, solver=solver)
            pods = solver.min_batch + 8
            standing_node(k, env, "a", "huge", {"cpu": 64, "memory": "128Gi", "pods": 200}, pods, {"cpu": "0.5", "memory": "256Mi"})
            env.node_controller.reconcile_all()
            before = (solver.stats.batches, solver.stats.pods_to_host, solver.stats.pods_committed)
            action = env.consolidation.process_cluster()
            after = (solver.stats.batches, solver.stats.pods_to_host, solver.stats.pods_committed)
            assert action.type == k.ActionType.REPLACE
            assert [it.name() for it in action.replacement.instance_type_options] == ["large"]
            assert after[0] > before[0] and after[1] == before[1], "the what-if did not run dense"
            assert after[2] - before[2] == pods
            return [solver.min_batch, action_record(action), cluster_record(env, k)]

        dboth(scenario, "dense")


# -- a kernel fault inside a what-if (the port only) --------------------------------


class TestWhatIfFaults:
    """A kernel or device exception raised inside a what-if solve leaves
    process_cluster() and is not logged as handled."""

    @pytest.mark.parametrize("seam", ["bucket_cost_packed", "warm_fill_counts_device"])
    def test_kernel_fault_leaves_process_cluster(self, seam, monkeypatch, caplog):
        from karpenter_tpu_torch.solver import dense as dense_module
        from karpenter_tpu_torch.solver import warmfill as fill_module

        k = DKit("port", "dense")
        env = k.deprov(provisioners=[k.consolidatable()], instance_types=k.big_small())
        # K1: the one node's what-if needs a new node; K2: two nodes, and
        # each what-if fills the other
        pods = [k.owned(requests={"cpu": "8"}) for _ in range(1 if seam == "bucket_cost_packed" else 2)]
        for pod in pods:
            env.launch_node_with_pods(pod)
        for pod in pods:
            pod.spec.containers[0].resources.requests["cpu"] = 0.5
            env.kube.update(pod)
        nodes = len(env.kube.list_nodes())
        assert nodes == len(pods)
        calls = []

        def fault(*args, **kwargs):
            calls.append(seam)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(dense_module if seam == "bucket_cost_packed" else fill_module, seam, fault)
        caplog.set_level(logging.DEBUG, logger="karpenter_tpu_torch")
        with pytest.raises(RuntimeError, match="illegal memory access"):
            env.consolidation.process_cluster()
        assert calls == [seam]
        assert not [r for r in caplog.records if r.exc_info], "the fault was logged as handled"
        assert len(env.kube.list_nodes()) == nodes and not any(n.spec.unschedulable for n in env.kube.list_nodes())
