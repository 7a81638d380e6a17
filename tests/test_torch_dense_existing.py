"""The dense solve over existing nodes, held on both packages.

Every case of tests/test_dense_existing_nodes.py (the warm fill before new
bins, taints, selectors, excluded nodes, zonal spread, the host-parity mix,
anti-affinity, the encode cache, consolidation-style simulations,
populated affinity domains, single-bin components and a dropped spill
receiver) runs through `build_scheduler(...).solve` with the reference's
DenseSolver (JAX on the CPU, no mesh) and with the port's (device="cpu"),
on the same inputs. The case's own assertions run on both sides, and the
two solves must agree placement for placement: new nodes (first option's
type and pods), existing-node placements, unschedulable pods and the dense
solver's committed, on-existing and host-routed pod counts.
"""

from __future__ import annotations

import numpy as np

from tests.test_torch_provisioning import Kit, reference_singletons, round_outcome  # noqa: F401
from tests.test_torch_provisioning import both as both_modes


def base_labels(k, **extra):
    labels = {
        k.lbl.PROVISIONER_NAME_LABEL: "default",
        k.lbl.LABEL_INSTANCE_TYPE: "default-instance-type",
        k.lbl.LABEL_TOPOLOGY_ZONE: "test-zone-1",
        k.lbl.LABEL_CAPACITY_TYPE: "on-demand",
    }
    labels.update(extra)
    return labels


def warm(k, labels=None, **kwargs):
    """An existing node view with the case's labels (base_labels by default)."""
    return k.make_state_node(node=k.node(labels=labels or base_labels(k), **kwargs))


def solve_dense(k, pods, state_nodes=(), opts=None, solver=None, kube=None):
    solver = solver or k.solver()
    provider = k.fake.FakeCloudProvider(k.fake.instance_types(20))
    scheduler = k.build_scheduler([k.make_provisioner()], provider, pods, kube=kube, state_nodes=state_nodes, opts=opts, dense_solver=solver)
    return scheduler.solve(pods), solver


def solve_host(k, pods, state_nodes=()):
    provider = k.fake.FakeCloudProvider(k.fake.instance_types(20))
    return k.build_scheduler([k.make_provisioner()], provider, pods, state_nodes=state_nodes).solve(pods)


def record(results, solver=None) -> dict:
    got = round_outcome(results)
    if solver is not None:
        st = solver.stats
        got["stats"] = (st.pods_committed, st.pods_on_existing, st.pods_to_host)
    return got


def both(scenario):
    return both_modes(scenario, "dense")


def all_scheduled_names(results):
    names = {p.name for n in results.new_nodes for p in n.pods}
    names.update(p.name for v in results.existing_nodes for p in v.pods)
    return names


def audit_existing_capacity(k, results):
    """No existing node may be filled beyond its available resources."""
    for view in results.existing_nodes:
        assert k.res.fits(view.requests, view.available), f"existing node {view.node.name} overflows"


class TestDenseExistingFill:
    def test_plain_pods_fill_existing_before_new_nodes(self):
        def scenario(k):
            state = warm(k, allocatable={"cpu": "16", "memory": "64Gi", "pods": "110"})
            pods = k.pods(10, requests={"cpu": "1", "memory": "1Gi"})
            results, solver = solve_dense(k, pods, [state])
            assert all_scheduled_names(results) == {p.name for p in pods}
            assert not results.new_nodes
            assert solver.stats.pods_on_existing == 10
            assert solver.stats.pods_committed == 10
            audit_existing_capacity(k, results)
            return record(results, solver)

        both(scenario)

    def test_overflow_opens_new_nodes(self):
        def scenario(k):
            alloc = {"cpu": "4", "memory": "16Gi", "pods": "110"}
            pods = k.pods(20, requests={"cpu": "1", "memory": "1Gi"})
            results, solver = solve_dense(k, pods, [warm(k, allocatable=alloc)])
            assert all_scheduled_names(results) == {p.name for p in pods}
            assert results.new_nodes, "overflow must open new nodes"
            assert solver.stats.pods_on_existing >= 1
            audit_existing_capacity(k, results)
            host = solve_host(k, pods, [warm(k, allocatable=alloc)])
            assert all_scheduled_names(results) == all_scheduled_names(host)
            return [record(results, solver), record(host)]

        both(scenario)

    def test_incompatible_taint_not_filled(self):
        def scenario(k):
            taint = k.obj.Taint(key="team", value="infra", effect="NoSchedule")
            state = warm(k, taints=[taint], allocatable={"cpu": "16", "memory": "64Gi", "pods": "110"})
            pods = k.pods(5, requests={"cpu": "1"})
            results, solver = solve_dense(k, pods, [state])
            assert solver.stats.pods_on_existing == 0
            assert not results.existing_nodes[0].pods
            assert all_scheduled_names(results) == {p.name for p in pods}
            return record(results, solver)

        both(scenario)

    def test_tolerated_taint_filled(self):
        def scenario(k):
            taint = k.obj.Taint(key="team", value="infra", effect="NoSchedule")
            state = warm(k, taints=[taint], allocatable={"cpu": "16", "memory": "64Gi", "pods": "110"})
            pods = k.pods(5, requests={"cpu": "1"}, tolerations=[k.obj.Toleration(key="team", operator="Exists")])
            results, solver = solve_dense(k, pods, [state])
            assert solver.stats.pods_on_existing == 5
            assert not results.new_nodes
            return record(results, solver)

        both(scenario)

    def test_node_selector_respected(self):
        def scenario(k):
            zone = k.lbl.LABEL_TOPOLOGY_ZONE
            state = warm(k, allocatable={"cpu": "16", "memory": "64Gi", "pods": "110"})
            matching = k.pods(3, requests={"cpu": "1"}, node_selector={zone: "test-zone-1"})
            mismatching = k.pods(3, requests={"cpu": "1"}, node_selector={zone: "test-zone-2"})
            results, solver = solve_dense(k, matching + mismatching, [state])
            assert {p.name for p in results.existing_nodes[0].pods} == {p.name for p in matching}
            assert all_scheduled_names(results) == {p.name for p in matching + mismatching}
            for node in results.new_nodes:
                assert node.requirements.get(zone).has("test-zone-2")
            return record(results, solver)

        both(scenario)

    def test_excluded_node_not_filled(self):
        def scenario(k):
            state = warm(k, allocatable={"cpu": "16", "memory": "64Gi", "pods": "110"})
            pods = k.pods(4, requests={"cpu": "1"})
            opts = k.SchedulerOptions(simulation_mode=True, exclude_nodes=[state.node.name])
            results, solver = solve_dense(k, pods, [state], opts=opts)
            assert not results.existing_nodes
            assert solver.stats.pods_on_existing == 0
            assert all_scheduled_names(results) == {p.name for p in pods}
            return record(results, solver)

        both(scenario)

    def test_zonal_spread_warm_cluster(self):
        def scenario(k):
            zone = k.lbl.LABEL_TOPOLOGY_ZONE
            states = [
                warm(k, labels=base_labels(k, **{zone: z}), allocatable={"cpu": "8", "memory": "32Gi", "pods": "110"})
                for z in ("test-zone-1", "test-zone-2", "test-zone-3")
            ]
            constraint = k.obj.TopologySpreadConstraint(
                max_skew=1, topology_key=zone, label_selector=k.obj.LabelSelector(match_labels={"app": "web"})
            )
            pods = k.pods(9, labels={"app": "web"}, requests={"cpu": "1"}, topology_spread_constraints=[constraint])
            results, solver = solve_dense(k, pods, states)
            assert all_scheduled_names(results) == {p.name for p in pods}
            audit_existing_capacity(k, results)
            counts = {}
            for view in results.existing_nodes:
                z = view.node.metadata.labels[zone]
                counts[z] = counts.get(z, 0) + len(view.pods)
            for node in results.new_nodes:
                z = node.requirements.get(zone).any_value()
                counts[z] = counts.get(z, 0) + len(node.pods)
            assert max(counts.values()) - min(counts.values()) <= 1
            assert solver.stats.pods_on_existing >= 3
            return record(results, solver)

        both(scenario)

    def test_mixed_warm_cluster_parity_with_host(self):
        def scenario(k):
            rng = np.random.default_rng(3)
            cpus = [0.25, 0.5, 1.0, 2.0]
            zone = k.lbl.LABEL_TOPOLOGY_ZONE

            def build_states():
                return [
                    warm(k, labels=base_labels(k, **{zone: f"test-zone-{1 + i % 3}"}), allocatable={"cpu": "8", "memory": "32Gi", "pods": "110"})
                    for i in range(6)
                ]

            pods = [k.pod(requests={"cpu": cpus[rng.integers(len(cpus))], "memory": "512Mi"}) for _ in range(60)]
            dense_results, solver = solve_dense(k, pods, build_states())
            host_results = solve_host(k, pods, build_states())
            assert all_scheduled_names(dense_results) == all_scheduled_names(host_results)
            audit_existing_capacity(k, dense_results)
            assert solver.stats.pods_on_existing > 0
            dense_cost = sum(n.instance_type_options[0].price() for n in dense_results.new_nodes)
            host_cost = sum(n.instance_type_options[0].price() for n in host_results.new_nodes)
            assert dense_cost <= host_cost * 1.3 + 1e-6
            # the views are rebuilt per solve, so their names differ between
            # the dense and the host solve but not between the packages
            return [record(dense_results, solver), record(host_results), dense_cost, host_cost]

        both(scenario)


class TestDedicatedShapesWarmCluster:
    def test_anti_affinity_pods_use_existing_nodes(self):
        def scenario(k):
            states = [warm(k, allocatable={"cpu": "16", "memory": "64Gi", "pods": "110"}) for _ in range(3)]
            anti = k.obj.PodAffinityTerm(
                topology_key=k.lbl.LABEL_HOSTNAME, label_selector=k.obj.LabelSelector(match_labels={"app": "anti"})
            )
            pods = k.pods(3, labels={"app": "anti"}, requests={"cpu": "1"}, pod_anti_requirements=[anti])
            results, solver = solve_dense(k, pods, states)
            assert all_scheduled_names(results) == {p.name for p in pods}
            assert not results.new_nodes, "three idle existing nodes can host one anti pod each"
            assert sorted(len(v.pods) for v in results.existing_nodes) == [1, 1, 1]
            return record(results, solver)

        both(scenario)


class TestEncodeCacheInvalidation:
    def test_mutated_pod_reencodes(self):
        def scenario(k):
            small = warm(k, allocatable={"cpu": "1", "memory": "4Gi", "pods": "10"})
            pod = k.pod(requests={"cpu": "2", "memory": "1Gi"})
            first, solver = solve_dense(k, [pod], [warm(k, allocatable={"cpu": "16", "memory": "64Gi", "pods": "110"})])
            assert solver.stats.pods_on_existing == 1  # the first solve caches cpu=2
            # the pod shrinks (a kube update bumps resource_version)
            pod.spec.containers[0].resources.requests["cpu"] = 0.5
            pod.metadata.resource_version += 1
            second, solver2 = solve_dense(k, [pod], [small])
            assert solver2.stats.pods_on_existing == 1, "stale encode cache: pod solved at old size"
            return [record(first, solver), record(second, solver2)]

        both(scenario)


class TestConsolidationUsesDensePath:
    def test_simulation_commits_pods_densely(self):
        def scenario(k):
            survivors = [warm(k, allocatable={"cpu": "16", "memory": "64Gi", "pods": "110"}) for _ in range(3)]
            doomed = warm(k, allocatable={"cpu": "4", "memory": "16Gi", "pods": "110"})
            pods = k.pods(12, requests={"cpu": "1", "memory": "1Gi"})
            opts = k.SchedulerOptions(simulation_mode=True, exclude_nodes=[doomed.node.name])
            results, solver = solve_dense(k, pods, survivors + [doomed], opts=opts)
            assert solver.stats.pods_committed == 12
            assert solver.stats.pods_on_existing == 12
            assert not results.new_nodes, "pods fit on surviving capacity -> delete candidate"
            assert all_scheduled_names(results) == {p.name for p in pods}
            return record(results, solver)

        both(scenario)


class TestPopulatedAffinityDomain:
    """Required hostname self-affinity with an already-populated domain
    never dense-packs onto a fresh host."""

    @staticmethod
    def _run(allocatable, expect_placed, unschedulable):
        def scenario(k):
            kube = k.kube_module.KubeCluster()
            label = {"app": "aff-cohort"}
            term = k.obj.PodAffinityTerm(topology_key=k.lbl.LABEL_HOSTNAME, label_selector=k.obj.LabelSelector(match_labels=label))
            node = k.node(name="host-a", labels=base_labels(k), allocatable=allocatable)
            kube.create(node)
            # a running cohort member bound to host-a populates the domain
            kube.create(k.pod(labels=label, requests={"cpu": 0.5}, node_name="host-a", phase="Running", unschedulable=False))
            pods = [k.pod(labels=label, requests={"cpu": 0.5, "memory": "256Mi"}, pod_requirements=[term]) for _ in range(3)]
            view = k.make_state_node(node=node, available=allocatable)
            results, solver = solve_dense(k, pods, [view], kube=kube)
            assert sum(len(n.pods) for n in results.new_nodes) == 0, "fresh node violates populated required affinity"
            assert sum(len(v.pods) for v in results.existing_nodes) == expect_placed
            assert len(results.unschedulable) == unschedulable
            return record(results, solver)

        both(scenario)

    def test_cohort_joins_populated_host(self):
        self._run({"cpu": 16, "memory": "32Gi", "pods": 110}, expect_placed=3, unschedulable=0)

    def test_cohort_unschedulable_when_populated_host_full(self):
        self._run({"cpu": 0.9, "memory": "32Gi", "pods": 110}, expect_placed=1, unschedulable=2)


class TestSingleBinExistingFill:
    """Bootstrap hostname-affinity components fill an existing view when its
    free capacity swallows the whole component."""

    @staticmethod
    def _cohort(k, n, cpu):
        label = {"app": "bootstrap-aff"}
        term = k.obj.PodAffinityTerm(topology_key=k.lbl.LABEL_HOSTNAME, label_selector=k.obj.LabelSelector(match_labels=label))
        return [k.pod(labels=label, requests={"cpu": cpu, "memory": "256Mi"}, pod_requirements=[term]) for _ in range(n)]

    def test_whole_component_fills_one_existing_view(self):
        def scenario(k):
            view = warm(k, allocatable={"cpu": 8, "memory": "16Gi", "pods": 50})
            results, solver = solve_dense(k, self._cohort(k, 4, 0.5), [view])
            assert sum(len(v.pods) for v in results.existing_nodes) == 4
            assert sum(len(n.pods) for n in results.new_nodes) == 0
            assert solver.stats.pods_on_existing == 4
            assert len({id(v) for v in results.existing_nodes if v.pods}) == 1
            return record(results, solver)

        both(scenario)

    def test_component_too_big_for_any_view_takes_fresh_host(self):
        def scenario(k):
            view = warm(k, allocatable={"cpu": 2, "memory": "16Gi", "pods": 50})
            results, solver = solve_dense(k, self._cohort(k, 8, 0.5), [view])
            assert sum(len(v.pods) for v in results.existing_nodes) == 0
            new_with_pods = [n for n in results.new_nodes if n.pods]
            assert len(new_with_pods) == 1 and len(new_with_pods[0].pods) == 8
            return record(results, solver)

        both(scenario)


class TestSpillReceiverDropped:
    """A spill donor whose nominated receiver never commits falls back to
    the host loop, never vanishes."""

    def test_bogus_receiver_routes_donor_to_host_loop(self):
        def scenario(k):
            # nominate a receiver bin id that no record will ever have, in a
            # subclass of each package's solver (no module is patched). The
            # donor map holds (receiver, whole bin) pairs: the JAX package's
            # own case returns a bare id, which _prepare_commit cannot
            # unpack, so it passes there only by its fail-open host fallback
            class BogusReceiver(k.solver_class):
                def _select_spill_donors(self, problem, buckets, sol):
                    return {0: (10**6, True)}

            solver = BogusReceiver(min_batch=1, **k.solver_kwargs)
            pods = k.pods(10, requests={"cpu": 0.5, "memory": "512Mi"})
            results, solver = solve_dense(k, pods, solver=solver)
            placed = sum(len(n.pods) for n in results.new_nodes) + sum(len(v.pods) for v in results.existing_nodes)
            assert placed == 10, "donor pods of a dropped receiver must reach the host loop"
            assert not results.unschedulable
            return record(results, solver)

        both(scenario)
