"""The port's disruption orchestrator held against the JAX package, case by case.

Every class of tests/test_disruption.py runs here on both packages, written
once against a DKit (tests/test_torch_consolidation.py) and driven through
each package's DisruptionEnv with the same inputs: the budget math and the
budget ledger, cron windows, budget validation, the spec-hash drift seam,
the emptiness, expiration, drift and consolidation sources through the
validated command queue, budgets, post-wait re-validation and the eviction
queue's veto. The case's own assertions run on both sides, and the two
records must be equal: the finished commands by method and outcome (a
delta: the reference's counter is process-wide), the final nodes, pods,
events and provider calls (`cluster_record`), and what the case reads on
the way.

Each case that drives a cluster runs with the exact host loop and with the
dense solve at min_batch=1 (the reference's DenseSolver on JAX's CPU with
its residency auditor disabled, the port's on device="cpu", the kernels'
plain versions). The budget math, cron, validation and hash cases solve
nothing and run once on each package, as do the six cases of
tests/test_crash_recovery.py's TestRecoverLedgerReconstruction
(DisruptionController.recover() over hand-made marked nodes).

Left out of tests/test_disruption.py:
- TestTraceChain (test_drift_chain_is_one_trace): the port has no tracer
  yet (ROADMAP A8).

A port-only case makes a kernel wrapper raise inside a what-if: the
exception leaves DisruptionController.reconcile() and is not logged as
handled (TestWhatIfFaults).
"""

from __future__ import annotations

import logging

import pytest

from karpenter_tpu_torch.solver.faults import SolverDeviceLostError
from tests.test_torch_consolidation import (  # noqa: F401
    MODES,
    DKit,
    cluster_record,
    commands_delta,
    dboth,
    reference_auditor_off,
    reference_singletons,
)


def drift(env):
    prov = env.kube.list_provisioners()[0]
    prov.spec.labels["fleet-generation"] = "v2"
    env.kube.update(prov)


def queued(env):
    return [(c.method, c.node_names(), c.require_empty, bool(c.replacements)) for c in env.disruption._queue]


class TestBudgetMath:
    def test_budget_limit_percent_floors(self):
        def scenario(k):
            got = [k.disruption.budget_limit(k.Budget(nodes="10%"), n) for n in (100, 19, 5)]
            assert got == [10, 1, 0]
            return got

        dboth(scenario, "host")

    def test_budget_limit_count(self):
        def scenario(k):
            got = [
                k.disruption.budget_limit(k.Budget(nodes="5"), 100),
                k.disruption.budget_limit(k.Budget(nodes="0", schedule="* * * * *", duration=60.0), 100),
            ]
            assert got == [5, 0]
            return got

        dboth(scenario, "host")

    def test_allowed_is_min_across_active_budgets(self):
        def scenario(k):
            prov = k.make_provisioner(budgets=[k.Budget(nodes="50%"), k.Budget(nodes="3")])
            got = k.disruption.allowed_disruptions(prov, 100, now=1000.0)
            assert got == 3
            return got

        dboth(scenario, "host")

    def test_no_budgets_is_unlimited(self):
        def scenario(k):
            got = [
                k.disruption.allowed_disruptions(k.make_provisioner(), 100, now=1000.0),
                k.disruption.allowed_disruptions(k.make_provisioner(budgets=[]), 100, now=1000.0),
            ]
            assert got == [None, None]
            return got

        dboth(scenario, "host")

    def test_inactive_window_does_not_apply(self):
        def scenario(k):
            prov = k.make_provisioner(budgets=[k.Budget(nodes="0", schedule="0 9 * * *", duration=3600.0)])
            got = [
                k.disruption.allowed_disruptions(prov, 100, now=1000.0),
                k.disruption.allowed_disruptions(prov, 100, now=9.5 * 3600),
            ]
            assert got == [None, 0]
            return got

        dboth(scenario, "host")

    def test_tracker_atomic_charge_release(self):
        def scenario(k):
            tracker = k.disruption.BudgetTracker()
            got = [
                tracker.try_charge("default", "n1", 2),
                tracker.try_charge("default", "n1", 2),
                tracker.try_charge("default", "n2", 2),
                tracker.try_charge("default", "n3", 2),
            ]
            assert got == [True, True, True, False]
            tracker.release("default", "n1")
            got.append(tracker.try_charge("default", "n3", 2))
            assert got[-1]
            assert tracker.in_flight("default") == 2
            return [got, sorted(tracker.charged_nodes("default")), tracker.total_in_flight()]

        dboth(scenario, "host")


class TestCron:
    def test_cron_errors(self):
        def scenario(k):
            specs = ("* * * * *", "*/15 9-17 * * 1-5", "0 9 * *", "61 * * * *", "x * * * *")
            got = [k.cron.cron_errors(spec) for spec in specs]
            assert got[0] == [] and got[1] == []
            assert all(errors != [] for errors in got[2:])
            return got

        dboth(scenario, "host")

    def test_dom_dow_or_semantics(self):
        from datetime import datetime, timezone

        def scenario(k):
            monday_not_15th = datetime(2026, 8, 3, 0, 0, tzinfo=timezone.utc)
            the_15th_not_monday = datetime(2026, 8, 15, 0, 0, tzinfo=timezone.utc)
            neither = datetime(2026, 8, 4, 0, 0, tzinfo=timezone.utc)
            got = [
                k.cron.matches("0 0 15 * 1", monday_not_15th),
                k.cron.matches("0 0 15 * 1", the_15th_not_monday),
                k.cron.matches("0 0 15 * 1", neither),
                k.cron.matches("0 0 15 * *", the_15th_not_monday),
                k.cron.matches("0 0 15 * *", monday_not_15th),
            ]
            assert got == [True, True, False, True, False]
            return got

        dboth(scenario, "host")

    def test_window_active(self):
        def scenario(k):
            got = [
                k.cron.window_active("* * * * *", 60.0, 1000.0),
                k.cron.window_active("0 9 * * *", 3600.0, 9.5 * 3600),
                k.cron.window_active("0 9 * * *", 3600.0, 11 * 3600),
            ]
            assert got == [True, True, False]
            return got

        dboth(scenario, "host")


class TestBudgetValidation:
    def test_valid_budgets_pass(self):
        def scenario(k):
            budgets = [k.Budget(nodes="10%"), k.Budget(nodes="5"), k.Budget(nodes="0", schedule="0 9 * * 1-5", duration=3600.0)]
            errs = k.validate_disruption(k.Disruption(budgets=budgets))
            assert errs == []
            return errs

        dboth(scenario, "host")

    def test_malformed_nodes_rejected(self):
        def scenario(k):
            got = []
            for nodes in ("ten", "-1", "10 %", "%", ""):
                errs = k.validate_disruption(k.Disruption(budgets=[k.Budget(nodes=nodes)]))
                assert errs and "budget nodes" in errs[0], nodes
                got.append(errs)
            return got

        dboth(scenario, "host")

    def test_over_100_percent_rejected(self):
        def scenario(k):
            errs = k.validate_disruption(k.Disruption(budgets=[k.Budget(nodes="150%")]))
            assert any("exceeds 100%" in e for e in errs)
            return errs

        dboth(scenario, "host")

    def test_schedule_and_duration_must_pair(self):
        def scenario(k):
            first = k.validate_disruption(k.Disruption(budgets=[k.Budget(nodes="10%", schedule="0 9 * * *")]))
            assert any("set together" in e for e in first)
            second = k.validate_disruption(k.Disruption(budgets=[k.Budget(nodes="10%", duration=3600.0)]))
            assert any("set together" in e for e in second)
            return [first, second]

        dboth(scenario, "host")

    def test_bad_cron_rejected(self):
        def scenario(k):
            errs = k.validate_disruption(k.Disruption(budgets=[k.Budget(nodes="10%", schedule="99 9 * * *", duration=60.0)]))
            assert any("invalid minute field" in e for e in errs)
            return errs

        dboth(scenario, "host")

    def test_zero_length_window_rejected(self):
        def scenario(k):
            errs = k.validate_disruption(k.Disruption(budgets=[k.Budget(nodes="10%", schedule="0 9 * * *", duration=0.0)]))
            assert any("zero-length window" in e for e in errs)
            return errs

        dboth(scenario, "host")

    def test_permanent_zero_budget_rejected(self):
        def scenario(k):
            got = []
            for nodes in ("0", "0%"):
                errs = k.validate_disruption(k.Disruption(budgets=[k.Budget(nodes=nodes)]))
                assert any("blocks all voluntary disruption permanently" in e for e in errs), nodes
                got.append(errs)
            return got

        dboth(scenario, "host")

    def test_webhook_rejects_invalid_budgets(self):
        def scenario(k):
            import importlib

            webhooks = importlib.import_module("karpenter_tpu.webhooks" if k.side == "ref" else "karpenter_tpu_torch.webhooks")
            kube = k.kube_module.KubeCluster()
            webhooks.register(kube)
            with pytest.raises(webhooks.AdmissionError, match="budget nodes") as err:
                kube.create(k.make_provisioner(budgets=[k.Budget(nodes="lots")]))
            kube.create(k.make_provisioner(name="ok", budgets=[k.Budget(nodes="10%")]))
            return str(err.value), [p.name for p in kube.list_provisioners()]

        dboth(scenario, "host")


class TestSpecHashSeam:
    @pytest.mark.parametrize("mode", MODES)
    def test_launched_nodes_carry_provisioner_hash(self, mode):
        def scenario(k):
            env = k.disrupt_env()
            nodes = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))
            expected = k.NodeTemplate.from_provisioner(env.kube.list_provisioners()[0]).spec_hash()
            assert nodes[0].metadata.annotations.get(k.lbl.PROVISIONER_HASH_ANNOTATION) == expected
            return [expected, cluster_record(env, k)]

        dboth(scenario, mode)

    def test_hash_is_stable_and_spec_sensitive(self):
        def scenario(k):
            prov = k.make_provisioner()
            h1 = k.NodeTemplate.from_provisioner(prov).spec_hash()
            assert h1 == k.NodeTemplate.from_provisioner(prov).spec_hash()
            prov.spec.labels["team"] = "search"
            h2 = k.NodeTemplate.from_provisioner(prov).spec_hash()
            assert h2 != h1
            return [h1, h2]

        dboth(scenario, "host")

    @pytest.mark.parametrize("mode", MODES)
    def test_hash_survives_scheduler_tightening(self, mode):
        def scenario(k):
            env = k.disrupt_env(instance_types=k.fake.instance_types(5))
            nodes = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))
            expected = k.NodeTemplate.from_provisioner(env.kube.list_provisioners()[0]).spec_hash()
            assert nodes[0].metadata.annotations[k.lbl.PROVISIONER_HASH_ANNOTATION] == expected
            return [expected, cluster_record(env, k)]

        dboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestEmptinessMethod:
    def test_empty_past_ttl_disrupted_through_queue(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.make_provisioner(ttl_seconds_after_empty=30)])
            pod = k.owned(requests={"cpu": "1"})
            env.launch_node_with_pods(pod)
            env.kube.delete(pod, grace=False)
            env.node_controller.reconcile_all()
            env.clock.step(31)
            env.node_controller.reconcile_all()
            assert len(env.kube.list_nodes()) == 1
            env.tick()
            assert env.kube.list_nodes() == []
            assert env.disruption.commands.value(method="emptiness", outcome="disrupted") >= 1
            return [commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_command_invalidated_when_node_repopulates(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.make_provisioner(ttl_seconds_after_empty=30)])
            pod = k.owned(requests={"cpu": "1"})
            nodes = env.launch_node_with_pods(pod)
            env.kube.delete(pod, grace=False)
            env.node_controller.reconcile_all()
            env.clock.step(31)
            env.disruption._propose(k.eligibility.PDBLimits(env.kube))
            assert len(env.disruption._queue) == 1
            proposed = queued(env)
            env.kube.create(k.owned(node_name=nodes[0].name, unschedulable=False, phase="Running"))
            env.disruption._drain_queue(k.eligibility.PDBLimits(env.kube))
            assert env.disruption.commands.value(method="emptiness", outcome="invalidated") >= 1
            assert len(env.kube.list_nodes()) == 1
            return [proposed, commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestExpirationMethod:
    def test_expired_node_replaced_before_drain(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.make_provisioner(ttl_seconds_until_expired=3600)])
            old = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))[0]
            env.clock.step(3601)
            env.disruption.reconcile()
            names = [n.name for n in env.kube.list_nodes()]
            assert old.name in names and len(names) == 2, "replacement launched BEFORE the old node is drained"
            assert not env.kube.get_node(old.name).spec.unschedulable, "no cordon until the replacement initializes"
            parked = cluster_record(env, k)
            env.tick()
            names = [n.name for n in env.kube.list_nodes()]
            assert old.name not in names and len(names) == 1
            assert env.disruption.commands.value(method="expiration", outcome="disrupted") >= 1
            return [parked, commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestDriftMethod:
    def test_drifted_node_flagged_and_replaced_after_replacement_initialized(self, mode):
        def scenario(k):
            env = k.disrupt_env()
            old = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))[0]
            drift(env)
            env.disruption.reconcile()
            assert env.kube.get_node(old.name).metadata.annotations.get(k.lbl.DRIFTED_ANNOTATION) == "true"
            assert len(env.kube.list_nodes()) == 2
            assert not env.kube.get_node(old.name).spec.unschedulable
            parked = cluster_record(env, k)
            env.tick()
            assert env.kube.get_node(old.name) is None
            survivors = env.kube.list_nodes()
            assert len(survivors) == 1
            prov = env.kube.list_provisioners()[0]
            expected = k.NodeTemplate.from_provisioner(prov).spec_hash()
            assert survivors[0].metadata.annotations[k.lbl.PROVISIONER_HASH_ANNOTATION] == expected
            assert env.disruption.commands.value(method="drift", outcome="disrupted") >= 1
            return [parked, commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_unhashed_node_never_flagged(self, mode):
        def scenario(k):
            env = k.disrupt_env()
            old = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))[0]
            del old.metadata.annotations[k.lbl.PROVISIONER_HASH_ANNOTATION]
            env.kube.update(old)
            drift(env)
            env.tick()
            node = env.kube.get_node(old.name)
            assert node is not None and k.lbl.DRIFTED_ANNOTATION not in node.metadata.annotations
            return [commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_reverted_provisioner_clears_drift_flag(self, mode):
        def scenario(k):
            budgets = [k.Budget(nodes="0", schedule="* * * * *", duration=3600.0)]
            env = k.disrupt_env(provisioners=[k.make_provisioner(budgets=budgets)])
            old = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))[0]
            drift(env)
            env.disruption.reconcile()
            assert env.kube.get_node(old.name).metadata.annotations.get(k.lbl.DRIFTED_ANNOTATION) == "true"
            blocked = [env.disruption.budget_blocked.value(provisioner="default") > 0, cluster_record(env, k)]
            prov = env.kube.list_provisioners()[0]
            del prov.spec.labels["fleet-generation"]
            env.kube.update(prov)
            env.disruption.reconcile()
            assert k.lbl.DRIFTED_ANNOTATION not in env.kube.get_node(old.name).metadata.annotations
            return [blocked, commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestBudgets:
    def test_budget_serializes_disruption(self, mode):
        def scenario(k):
            prov = k.make_provisioner(ttl_seconds_after_empty=30, budgets=[k.Budget(nodes="1")])
            env = k.disrupt_env(provisioners=[prov])
            p1, p2 = k.owned(requests={"cpu": "12"}), k.owned(requests={"cpu": "12"})
            env.launch_node_with_pods(p1)
            env.launch_node_with_pods(p2)
            assert len(env.kube.list_nodes()) == 2
            for pod in (p1, p2):
                env.kube.delete(pod, grace=False)
            env.node_controller.reconcile_all()
            env.clock.step(31)
            env.disruption.reconcile()
            env.termination_controller.reconcile_all()
            assert len(env.kube.list_nodes()) == 1
            blocked = env.disruption.budget_blocked.value(provisioner="default")
            assert blocked >= 1
            first = cluster_record(env, k)
            env.clock.step(k.disruption.DisruptionController.BUDGET_RETRY_PERIOD + 1)
            env.tick()
            assert env.kube.list_nodes() == []
            return [first, commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_do_not_disrupt_pod_makes_node_ineligible(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.make_provisioner(ttl_seconds_until_expired=3600)])
            pod = k.owned(requests={"cpu": "1"}, annotations={k.lbl.DO_NOT_DISRUPT_ANNOTATION: "true"})
            old = env.launch_node_with_pods(pod)[0]
            before = env.disruption.commands.value(method="expiration", outcome="disrupted")
            env.clock.step(3601)
            for _ in range(3):
                env.tick()
            assert env.kube.get_node(old.name) is not None
            assert env.disruption.commands.value(method="expiration", outcome="disrupted") == before
            return [commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_legacy_do_not_evict_spelling_honored(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.make_provisioner(ttl_seconds_until_expired=3600)])
            pod = k.owned(requests={"cpu": "1"}, annotations={k.lbl.DO_NOT_EVICT_ANNOTATION: "true"})
            old = env.launch_node_with_pods(pod)[0]
            env.clock.step(3601)
            env.tick()
            assert env.kube.get_node(old.name) is not None
            return [commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestConsolidationSource:
    def test_orchestrator_consolidates_empty_node(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.consolidatable()])
            pod = k.owned(requests={"cpu": "1"})
            env.launch_node_with_pods(pod)
            env.kube.delete(pod, grace=False)
            env.clock.step(400)
            env.tick()
            assert env.kube.list_nodes() == []
            assert env.disruption.commands.value(method="consolidation", outcome="disrupted") >= 1
            return [commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_empty_fleet_larger_than_budget_drains_without_livelock(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.consolidatable(budgets=[k.Budget(nodes="1")])])
            pods = [k.owned(requests={"cpu": "12"}) for _ in range(3)]
            for pod in pods:
                env.launch_node_with_pods(pod)
            assert len(env.kube.list_nodes()) == 3
            for pod in pods:
                env.kube.delete(pod, grace=False)
            env.clock.step(400)
            ticks = 0
            for _ in range(8):
                env.tick()
                ticks += 1
                env.clock.step(k.disruption.DisruptionController.BUDGET_RETRY_PERIOD + 1)
                if not env.kube.list_nodes():
                    break
            assert env.kube.list_nodes() == [], "every empty node must drain through the budget"
            return [ticks, commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_expired_uninitialized_node_is_reclaimed(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.make_provisioner(ttl_seconds_until_expired=3600)])
            env.kube.create(k.owned(requests={"cpu": "1"}))
            env.provision()
            node = env.kube.list_nodes()[0]
            assert node.metadata.labels.get(k.lbl.LABEL_NODE_INITIALIZED) != "true"
            env.clock.step(3601 + env.cluster.nomination_ttl)
            env.disruption.reconcile()
            env.termination_controller.reconcile_all()
            assert env.kube.get_node(node.name) is None
            return [commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_replace_price_revalidated_non_increasing(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.consolidatable()], instance_types=k.big_small())
            pod = k.owned(requests={"cpu": "8"})
            env.launch_node_with_pods(pod)
            pod.spec.containers[0].resources.requests["cpu"] = 0.5
            env.kube.update(pod)
            env.clock.step(400)
            env.disruption._propose(k.eligibility.PDBLimits(env.kube))
            commands = list(env.disruption._queue)
            assert len(commands) == 1 and commands[0].replacements
            proposed = [queued(env), [it.name() for it in commands[0].replacements[0].instance_type_options], commands[0].candidate_price]
            commands[0].candidate_price = 0.01
            env.disruption._drain_queue(k.eligibility.PDBLimits(env.kube))
            assert env.disruption.commands.value(method="consolidation", outcome="invalidated") >= 1
            assert len(env.kube.list_nodes()) == 1
            return [proposed, commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestPostWaitRevalidation:
    def test_veto_arriving_during_replacement_wait_voids_the_command(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.make_provisioner(ttl_seconds_until_expired=3600)])
            old = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))[0]
            env.clock.step(3601)
            env.disruption.reconcile()
            assert env.disruption._pending is not None
            replacement_names = list(env.disruption._pending.launched)
            env.kube.create(
                k.owned(
                    node_name=old.name, unschedulable=False, phase="Running",
                    annotations={k.lbl.DO_NOT_DISRUPT_ANNOTATION: "true"},
                )
            )
            before = env.disruption.commands.value(method="expiration", outcome="invalidated")
            env.tick()
            env.termination_controller.reconcile_all()
            assert env.kube.get_node(old.name) is not None
            assert not env.kube.get_node(old.name).spec.unschedulable
            assert env.disruption.commands.value(method="expiration", outcome="invalidated") == before + 1
            for name in replacement_names:
                assert env.kube.get_node(name) is None
            assert env.disruption.tracker.total_in_flight() == 0
            return [replacement_names, commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)

    def test_consolidation_empty_command_rechecks_emptiness(self, mode):
        def scenario(k):
            env = k.disrupt_env(provisioners=[k.consolidatable()])
            pod = k.owned(requests={"cpu": "1"})
            nodes = env.launch_node_with_pods(pod)
            env.kube.delete(pod, grace=False)
            env.clock.step(400)
            env.disruption._propose(k.eligibility.PDBLimits(env.kube))
            commands = list(env.disruption._queue)
            assert len(commands) == 1 and commands[0].method == "consolidation" and commands[0].require_empty
            proposed = queued(env)
            env.kube.create(k.owned(node_name=nodes[0].name, unschedulable=False, phase="Running"))
            before = env.disruption.commands.value(method="consolidation", outcome="invalidated")
            env.disruption._drain_queue(k.eligibility.PDBLimits(env.kube))
            assert env.disruption.commands.value(method="consolidation", outcome="invalidated") == before + 1
            assert env.kube.get_node(nodes[0].name) is not None
            return [proposed, commands_delta(env), cluster_record(env, k)]

        dboth(scenario, mode)


@pytest.mark.parametrize("mode", MODES)
class TestEvictionVetoSurfacing:
    @pytest.mark.parametrize("annotation", ["DO_NOT_DISRUPT_ANNOTATION", "DO_NOT_EVICT_ANNOTATION"])
    def test_veto_surfaces_blocked_eviction(self, mode, annotation):
        """test_do_not_disrupt_surfaces_blocked_eviction and, with the legacy
        spelling, test_legacy_spelling_surfaces_too."""

        def scenario(k):
            env = k.disrupt_env()
            nodes = env.launch_node_with_pods(k.owned(requests={"cpu": "1"}))
            blocked = k.owned(
                node_name=nodes[0].name, unschedulable=False, phase="Running",
                annotations={getattr(k.lbl, annotation): "true"},
            )
            env.kube.create(blocked)
            queue = env.termination_controller.eviction_queue
            queue.add(blocked)
            evicted = queue.drain_once()
            assert evicted == 0
            assert env.recorder.of("EvictionBlocked"), "veto must surface, not silently retry"
            assert env.kube.get("Pod", blocked.name, blocked.namespace) is not None
            return [evicted, len(queue), cluster_record(env, k)]

        dboth(scenario, mode)


class TestRecoverLedgerReconstruction:
    """tests/test_crash_recovery.py's TestRecoverLedgerReconstruction: one
    DisruptionController.recover() over hand-made nodes carrying the durable
    DISRUPTING and REPLACEMENT_FOR markers (the reference builds an
    un-started Runtime; the orchestrator here is DisruptionEnv's). Each
    record holds the summary, the budget ledger, which nodes stay nominated
    and the cluster afterwards."""

    @staticmethod
    def owned_node(k, env, name, annotations=None, initialized=True, unschedulable=False):
        labels = {k.lbl.PROVISIONER_NAME_LABEL: "default"}
        if initialized:
            labels[k.lbl.LABEL_NODE_INITIALIZED] = "true"
        node = k.make_node(name=name, labels=labels, allocatable={"cpu": "4"})
        node.metadata.annotations.update(annotations or {})
        node.metadata.finalizers.append(k.lbl.TERMINATION_FINALIZER)
        node.spec.unschedulable = unschedulable
        env.kube.create(node)
        return node

    @staticmethod
    def recovered(k, env):
        summary = env.disruption.recover()
        tracker = env.disruption.tracker
        nodes = sorted(n.name for n in env.kube.list_nodes())
        return [
            summary,
            sorted(tracker.charged_nodes("default")),
            tracker.total_in_flight(),
            [name for name in nodes if env.cluster.is_node_nominated(name)],
            cluster_record(env, k),
        ]

    def test_mid_drain_node_recharges_the_ledger(self):
        def scenario(k):
            env = k.disrupt_env()
            node = self.owned_node(k, env, "mid-drain", annotations={k.lbl.DISRUPTING_ANNOTATION: "drift"})
            env.kube.delete(node)  # deletion timestamp set; the finalizer holds it
            record = self.recovered(k, env)
            assert record[0]["recharged"] == [node.name]
            assert env.disruption.tracker.is_charged("default", node.name)
            assert record[2] == 1
            return record

        dboth(scenario, "host")

    def test_stranded_pre_drain_node_is_released_and_uncordoned(self):
        def scenario(k):
            env = k.disrupt_env()
            node = self.owned_node(
                k, env, "stranded", annotations={k.lbl.DISRUPTING_ANNOTATION: "consolidation"}, unschedulable=True
            )
            record = self.recovered(k, env)
            assert record[0]["released"] == [node.name]
            fresh = env.kube.get_node(node.name)
            assert k.lbl.DISRUPTING_ANNOTATION not in fresh.metadata.annotations
            assert not fresh.spec.unschedulable, "a stranded cordon must not outlive the crash"
            assert record[2] == 0
            return record

        dboth(scenario, "host")

    def test_uninitialized_replacement_with_live_candidate_is_reaped(self):
        def scenario(k):
            env = k.disrupt_env()
            candidate = self.owned_node(k, env, "candidate")
            replacement = self.owned_node(
                k, env, "replacement", annotations={k.lbl.REPLACEMENT_FOR_ANNOTATION: candidate.name}, initialized=False
            )
            record = self.recovered(k, env)
            assert record[0]["reaped"] == [replacement.name]
            reaped = env.kube.get_node(replacement.name)
            assert reaped is None or reaped.metadata.deletion_timestamp is not None
            assert env.kube.get_node(candidate.name).metadata.deletion_timestamp is None
            return record

        dboth(scenario, "host")

    def test_replacement_whose_candidate_is_gone_is_adopted(self):
        def scenario(k):
            env = k.disrupt_env()
            replacement = self.owned_node(
                k, env, "replacement", annotations={k.lbl.REPLACEMENT_FOR_ANNOTATION: "node-that-drained-away"},
                initialized=False,
            )
            record = self.recovered(k, env)
            assert record[0]["adopted"] == [replacement.name]
            fresh = env.kube.get_node(replacement.name)
            assert fresh is not None and k.lbl.REPLACEMENT_FOR_ANNOTATION not in fresh.metadata.annotations
            assert record[3] == [replacement.name], "adopted capacity stays protected briefly"
            return record

        dboth(scenario, "host")

    def test_initialized_replacement_is_adopted_even_with_live_candidate(self):
        def scenario(k):
            env = k.disrupt_env()
            candidate = self.owned_node(k, env, "candidate")
            replacement = self.owned_node(
                k, env, "replacement", annotations={k.lbl.REPLACEMENT_FOR_ANNOTATION: candidate.name}, initialized=True
            )
            record = self.recovered(k, env)
            assert record[0]["adopted"] == [replacement.name]
            assert env.kube.get_node(replacement.name) is not None
            return record

        dboth(scenario, "host")

    def test_clean_cluster_recovers_nothing(self):
        def scenario(k):
            env = k.disrupt_env()
            self.owned_node(k, env, "clean")
            record = self.recovered(k, env)
            assert record[0] == {"recharged": [], "released": [], "reaped": [], "adopted": []}
            return record

        dboth(scenario, "host")


# -- the orchestrator on the crossover routing, and a kernel fault in a what-if ----


class TestDenseOrchestratorPass:
    """One orchestrator pass over a candidate of at least min_batch pods at
    the crossover measured on the H100 (min_batch 64, not a forced 1): the
    consolidation what-if runs dense on both packages and the DELETE command
    is validated and handed to the termination controller."""

    def test_consolidation_delete_through_the_dense_fill(self):
        from tests.test_torch_consolidation import standing_node

        def scenario(k):
            solver = k.crossover_solver()
            wide = k.fake.instance_type("wide", cpu=32, memory="64Gi", pods=200, price=4.0, offerings=k.od())
            env = k.disrupt_env(provisioners=[k.consolidatable()], instance_types=[wide], solver=solver)
            for name in ("a", "b"):
                standing_node(k, env, name, "wide", {"cpu": 32, "memory": "64Gi", "pods": 200}, solver.min_batch, {"cpu": "0.1", "memory": "64Mi"})
            env.node_controller.reconcile_all()
            env.clock.step(400)
            before = (solver.stats.batches, solver.stats.pods_to_host, solver.stats.pods_on_existing)
            env.tick()
            after = (solver.stats.batches, solver.stats.pods_to_host, solver.stats.pods_on_existing)
            assert after[0] > before[0] and after[1] == before[1], "the what-if did not run dense"
            assert after[2] - before[2] == solver.min_batch
            assert len(env.kube.list_nodes()) == 1
            assert env.disruption.commands.value(method="consolidation", outcome="disrupted") == (
                env.commands_baseline[("consolidation", "disrupted")] + 1
            )
            return [solver.min_batch, commands_delta(env), cluster_record(env, k)]

        record = dboth(scenario, "dense")
        assert record[1] == {"consolidation/disrupted": 1}


class TestWhatIfFaults:
    """A kernel fault raised inside a what-if (classified: a SolverFault)
    ends that source's pass with no action, is not logged as handled, and
    the next pass retries; an exception classify() has no name for, and a
    device-lost the card raised (its context stays broken), leave
    DisruptionController.reconcile() (the reference logs any failed
    propose() and goes on; the port does not copy that)."""

    @pytest.mark.parametrize("source", ["consolidation", "expiration"])
    @pytest.mark.parametrize("seam", ["bucket_cost_packed", "warm_fill_counts_device"])
    def test_kernel_fault_leaves_reconcile(self, seam, source, monkeypatch, caplog):
        from karpenter_tpu_torch.solver import dense as dense_module
        from karpenter_tpu_torch.solver import warmfill as fill_module

        k = DKit("port", "dense")
        if source == "consolidation":
            prov = k.consolidatable()
        else:
            prov = k.make_provisioner(ttl_seconds_until_expired=3600)
        env = k.disrupt_env(provisioners=[prov], instance_types=k.big_small())
        # K1: the one node's what-if needs a new node; K2: two nodes, and
        # each what-if fills the other
        pods = [k.owned(requests={"cpu": "8"}) for _ in range(1 if seam == "bucket_cost_packed" else 2)]
        for pod in pods:
            env.launch_node_with_pods(pod)
        for pod in pods:
            pod.spec.containers[0].resources.requests["cpu"] = 0.5
            env.kube.update(pod)
        env.clock.step(3601 if source == "expiration" else 400)
        nodes = sorted(n.name for n in env.kube.list_nodes())
        calls = []

        def fault(*args, **kwargs):
            calls.append(seam)
            raise RuntimeError("bucket_cost kernel launch failed: cudaErrorInvalidValue: invalid argument (CUDA error 1)")

        monkeypatch.setattr(dense_module if seam == "bucket_cost_packed" else fill_module, seam, fault)
        caplog.set_level(logging.DEBUG, logger="karpenter_tpu_torch")
        env.disruption.reconcile()  # held: the source's pass ends with no action
        assert calls == [seam]
        assert not [r for r in caplog.records if r.exc_info], "the fault was logged as handled"
        assert any("held by a kernel fault" in r.getMessage() for r in caplog.records)
        assert sorted(n.name for n in env.kube.list_nodes()) == nodes
        assert not env.disruption._queue and env.disruption.tracker.total_in_flight() == 0

        def novel(*args, **kwargs):
            calls.append(seam)
            raise ValueError("a failure classify has no name for")

        monkeypatch.setattr(dense_module if seam == "bucket_cost_packed" else fill_module, seam, novel)
        with pytest.raises(ValueError, match="no name for"):
            env.disruption.reconcile()
        assert calls == [seam, seam], "the next pass retried the what-if"
        assert sorted(n.name for n in env.kube.list_nodes()) == nodes

    @pytest.mark.parametrize("source", ["consolidation", "expiration"])
    @pytest.mark.parametrize("seam", ["bucket_cost_packed", "warm_fill_counts_device"])
    def test_device_lost_the_card_raised_leaves_reconcile(self, seam, source, monkeypatch):
        """A device-lost the card raised leaves the CUDA context broken: no
        later pass can succeed in this process, so it is not held."""
        from karpenter_tpu_torch.solver import dense as dense_module
        from karpenter_tpu_torch.solver import warmfill as fill_module

        k = DKit("port", "dense")
        prov = k.consolidatable() if source == "consolidation" else k.make_provisioner(ttl_seconds_until_expired=3600)
        env = k.disrupt_env(provisioners=[prov], instance_types=k.big_small())
        pods = [k.owned(requests={"cpu": "8"}) for _ in range(1 if seam == "bucket_cost_packed" else 2)]
        for pod in pods:
            env.launch_node_with_pods(pod)
        for pod in pods:
            pod.spec.containers[0].resources.requests["cpu"] = 0.5
            env.kube.update(pod)
        env.clock.step(3601 if source == "expiration" else 400)
        nodes = sorted(n.name for n in env.kube.list_nodes())

        def lost(*args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(dense_module if seam == "bucket_cost_packed" else fill_module, seam, lost)
        with pytest.raises(SolverDeviceLostError, match="illegal memory access") as raised:
            env.disruption.reconcile()
        assert not raised.value.injected
        assert sorted(n.name for n in env.kube.list_nodes()) == nodes
        assert not env.disruption._queue and env.disruption.tracker.total_in_flight() == 0
