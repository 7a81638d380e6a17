"""The reference's dense-vs-oracle differential suites, held on both packages.

Every case of tests/test_dense_solver.py and of
tests/test_differential_campaign.py runs here on the JAX package and on
the port, written once against a Kit (tests/test_torch_provisioning.py)
with deterministic pod names. On each package the case solves its batch
with the exact host loop and with the dense solve at min_batch=1 (the
reference's DenseSolver on JAX's CPU, the port's on device="cpu", the
kernels' plain versions), and the case's own assertions run on both:
feasibility, schedulability parity with the host loop, spread, affinity
and anti-affinity, limits, and the cost bounds (1.25x, 1.3x, and the
campaign's +5 cheapest nodes). Then the two packages' records must be
equal: each path's new nodes (first option, provisioner, pods), existing
placements, unschedulable pods and the dense solver's counts.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_provisioning import Kit, reference_singletons, run_both  # noqa: F401

ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")
CAMPAIGN_SEEDS = range(6)


class DiffKit(Kit):
    """Kit with the campaign's builders of one package."""

    def __init__(self, side: str, mode: str):
        super().__init__(side, mode)
        if side == "ref":
            import bench
            from tests import test_differential_campaign as campaign

            self.random_workload, self.random_states = campaign._random_workload, campaign._random_states
            self.campaign_provisioners, self.rename = campaign._provisioners, campaign._rename
            self.build_workload, self.build_spot_od_types = bench.build_workload, bench.build_spot_od_types
        else:
            from karpenter_tpu_torch import testing

            self.random_workload, self.random_states = testing.random_workload, testing.random_states
            self.campaign_provisioners = testing.campaign_provisioners
            self.rename = testing.rename
            self.build_workload, self.build_spot_od_types = testing.build_workload, testing.build_spot_od_types

    def solve(self, pods, provisioners=None, provider=None, dense=True, **kwargs):
        provisioners = provisioners or [self.make_provisioner()]
        provider = provider or self.fake.FakeCloudProvider(self.fake.instance_types(50))
        solver = self.solver() if dense else None
        results = self.build_scheduler(provisioners, provider, pods, dense_solver=solver, **kwargs).solve(pods)
        return results, solver

    def solve_both(self, pods, provisioners=None, provider=None):
        host, _ = self.solve(pods, provisioners, provider, dense=False)
        dense, solver = self.solve(pods, provisioners, provider, dense=True)
        return host, dense, solver

    def random_pods(self, count, seed=0):
        rng = np.random.default_rng(seed)
        cpus = [0.1, 0.25, 0.5, 1.0, 1.5]
        mems = [100, 256, 512, 1024, 2048, 4096]
        return [
            self.pod(
                requests={"cpu": cpus[rng.integers(len(cpus))], "memory": f"{mems[rng.integers(len(mems))]}Mi"},
                labels={"my-label": "abcdefg"[rng.integers(7)]},
            )
            for _ in range(count)
        ]


def solve_record(results, solver=None, states=()) -> dict:
    """One solve's outcome: new nodes (first option, provisioner, zone, pods),
    existing placements (the warm nodes by their index in `states`: their
    names come from each package's own counter), unschedulable pods, and
    the dense solver's counts."""
    index = {state.node.name: i for i, state in enumerate(states)}

    def zone(node):
        req = node.requirements.get("topology.kubernetes.io/zone")
        return tuple(sorted(req.values)) if req is not None and not req.complement else ()

    return {
        "new": sorted(
            (
                n.instance_type_options[0].name() if n.instance_type_options else "",
                n.template.provisioner_name,
                zone(n),
                tuple(sorted(p.name for p in n.pods)),
            )
            for n in results.new_nodes
            if n.pods
        ),
        "existing": sorted(
            (index.get(v.node.name, v.node.name), tuple(sorted(p.name for p in v.pods))) for v in results.existing_nodes if v.pods
        ),
        "unschedulable": sorted(p.name for p in results.unschedulable),
        "dense": None if solver is None else (solver.stats.batches, solver.stats.pods_committed, solver.stats.pods_to_host),
    }


def total_cost(results):
    return sum(n.instance_type_options[0].price() for n in results.new_nodes)


def scheduled_names(results):
    return {p.name for n in results.new_nodes for p in n.pods}


def audit_feasible(k, results):
    """Independent audit: per-node resource sums within every option."""
    for node in results.new_nodes:
        assert node.instance_type_options, "node with no type options"
        for it in node.instance_type_options:
            need = k.res.merge(node.requests, it.overhead())
            assert k.res.fits(need, it.resources()), f"node overflows {it.name()}: need={need} cap={it.resources()}"


def differential(scenario):
    """The scenario on each package; records equal. Returns the port's."""
    ref, port = run_both(lambda k: scenario(DiffKit(k.side, k.mode)), "dense")
    assert port == ref
    return port


def parity(k, pods, provisioners=None, provider=None, cost_factor=None):
    """The reference's common body: host and dense, feasible, the same pods
    scheduled, the cost bound; returns both records."""
    host, dense, solver = k.solve_both(pods, provisioners, provider)
    audit_feasible(k, dense)
    assert scheduled_names(dense) == scheduled_names(host)
    if cost_factor is not None:
        assert total_cost(dense) <= total_cost(host) * cost_factor + 1e-6
    return host, dense, [solve_record(host), solve_record(dense, solver)]


def spread(k, key, app, max_skew=1):
    return k.obj.TopologySpreadConstraint(
        max_skew=max_skew, topology_key=key, label_selector=k.obj.LabelSelector(match_labels={"app": app})
    )


def term(k, key, app):
    return k.obj.PodAffinityTerm(topology_key=key, label_selector=k.obj.LabelSelector(match_labels={"app": app}))


class TestDenseVsOracle:
    def test_homogeneous_batch(self):
        differential(lambda k: parity(k, k.pods(40, requests={"cpu": "1", "memory": "1Gi"}), cost_factor=1.25)[2])

    def test_mixed_sizes(self):
        differential(lambda k: parity(k, k.random_pods(200, seed=1), cost_factor=1.25)[2])

    def test_selectors_and_taints(self):
        def scenario(k):
            prov = k.make_provisioner(taints=[k.obj.Taint(key="team", value="infra", effect="NoSchedule")])
            toleration = k.obj.Toleration(key="team", operator="Exists")
            pods = [
                k.pod(
                    requests={"cpu": "0.5"},
                    tolerations=[toleration],
                    node_selector={k.lbl.LABEL_TOPOLOGY_ZONE: ["test-zone-1", "test-zone-2"][i % 2]},
                )
                for i in range(60)
            ]
            host, dense, record = parity(k, pods, provisioners=[prov])
            for node in dense.new_nodes:
                assert len(node.requirements.get(k.lbl.LABEL_TOPOLOGY_ZONE).values) == 1
            return record

        differential(scenario)

    def test_hostname_negative_requirement_goes_to_host_loop(self):
        def scenario(k):
            pods = [
                k.pod(
                    requests={"cpu": "0.5"},
                    node_requirements=[k.obj.NodeSelectorRequirement(key=k.lbl.LABEL_HOSTNAME, operator=k.obj.OP_DOES_NOT_EXIST)],
                )
                for _ in range(40)
            ]
            return parity(k, pods)[2]

        differential(scenario)

    def test_zonal_spread(self):
        def scenario(k):
            constraint = spread(k, k.lbl.LABEL_TOPOLOGY_ZONE, "web")
            pods = k.pods(30, labels={"app": "web"}, topology_spread_constraints=[constraint], requests={"cpu": "0.5"})
            host, dense, record = parity(k, pods)
            zone_counts = {}
            for node in dense.new_nodes:
                zone = node.requirements.get(k.lbl.LABEL_TOPOLOGY_ZONE).any_value()
                zone_counts[zone] = zone_counts.get(zone, 0) + len(node.pods)
            assert max(zone_counts.values()) - min(zone_counts.values()) <= 1
            assert len(zone_counts) == 3
            return record

        differential(scenario)

    def test_hostname_spread_dedicated(self):
        def scenario(k):
            constraint = spread(k, k.lbl.LABEL_HOSTNAME, "web")
            pods = k.pods(12, labels={"app": "web"}, topology_spread_constraints=[constraint], requests={"cpu": "0.5"})
            host, dense, record = parity(k, pods)
            assert all(len(n.pods) == 1 for n in dense.new_nodes if n.pods and n.pods[0].metadata.labels.get("app") == "web")
            return record

        differential(scenario)

    def test_capacity_type_spread(self):
        def scenario(k):
            constraint = spread(k, k.lbl.LABEL_CAPACITY_TYPE, "web")
            pods = k.pods(20, labels={"app": "web"}, topology_spread_constraints=[constraint], requests={"cpu": "0.5"})
            host, dense, record = parity(k, pods)
            ct_counts = {}
            for node in dense.new_nodes:
                ct = node.requirements.get(k.lbl.LABEL_CAPACITY_TYPE).any_value()
                ct_counts[ct] = ct_counts.get(ct, 0) + len(node.pods)
            assert abs(ct_counts.get("spot", 0) - ct_counts.get("on-demand", 0)) <= 1
            return record

        differential(scenario)

    def test_zonal_self_affinity(self):
        def scenario(k):
            pods = k.pods(15, labels={"app": "db"}, pod_requirements=[term(k, k.lbl.LABEL_TOPOLOGY_ZONE, "db")], requests={"cpu": "0.5"})
            host, dense, record = parity(k, pods)
            zones = {n.requirements.get(k.lbl.LABEL_TOPOLOGY_ZONE).any_value() for n in dense.new_nodes if n.pods}
            assert len(zones) == 1
            return record

        differential(scenario)

    def test_hostname_self_affinity_single_node(self):
        def scenario(k):
            pods = k.pods(5, labels={"app": "db"}, pod_requirements=[term(k, k.lbl.LABEL_HOSTNAME, "db")], requests={"cpu": "0.5"})
            host, dense, record = parity(k, pods)
            assert len([n for n in dense.new_nodes if n.pods]) == 1
            return record

        differential(scenario)

    def test_hostname_anti_affinity(self):
        def scenario(k):
            pods = k.pods(6, labels={"app": "web"}, pod_anti_requirements=[term(k, k.lbl.LABEL_HOSTNAME, "web")], requests={"cpu": "0.5"})
            host, dense, record = parity(k, pods)
            assert all(len(n.pods) == 1 for n in dense.new_nodes if n.pods)
            return record

        differential(scenario)

    def test_unschedulable_pods_agree(self):
        def scenario(k):
            pods = k.pods(10, requests={"cpu": "0.5"}) + [k.pod(name="monster", requests={"cpu": "5000"})]
            host, dense, record = parity(k, pods)
            assert "monster" in {p.name for p in dense.unschedulable}
            return record

        differential(scenario)

    def test_mixed_workload_cost_parity(self):
        def scenario(k):
            pods = (
                k.random_pods(100, seed=7)
                + k.pods(20, labels={"app": "spread"}, topology_spread_constraints=[spread(k, k.lbl.LABEL_TOPOLOGY_ZONE, "spread")], requests={"cpu": "0.5"})
                + k.pods(8, labels={"app": "anti"}, pod_anti_requirements=[term(k, k.lbl.LABEL_HOSTNAME, "anti")], requests={"cpu": "0.5"})
            )
            host, dense, record = parity(k, pods, cost_factor=1.3)
            return record + [round(total_cost(dense) / total_cost(host), 9)]

        differential(scenario)

    def test_weighted_multi_provisioner(self):
        def scenario(k):
            heavy = k.make_provisioner(name="heavy", weight=100, labels={"tier": "gold"})
            light = k.make_provisioner(name="light", weight=1, labels={"tier": "bronze"})
            host, dense, record = parity(k, k.pods(30, requests={"cpu": "1", "memory": "1Gi"}), provisioners=[heavy, light])
            assert all(node.template.provisioner_name == "heavy" for node in dense.new_nodes)
            return record

        differential(scenario)

    def test_multi_provisioner_taint_routing(self):
        def scenario(k):
            tainted = k.make_provisioner(name="infra", weight=100, taints=[k.obj.Taint(key="team", value="infra", effect="NoSchedule")])
            general = k.make_provisioner(name="general", weight=1)
            plain = k.pods(20, requests={"cpu": "0.5"})
            tolerating = k.pods(10, requests={"cpu": "0.5"}, tolerations=[k.obj.Toleration(key="team", operator="Exists")])
            pods = plain + tolerating
            results, solver = k.solve(pods, [tainted, general], k.fake.FakeCloudProvider(k.fake.instance_types(20)))
            assert scheduled_names(results) == {p.name for p in pods}
            assert solver.stats.pods_committed == 30
            plain_names = {p.name for p in plain}
            for node in results.new_nodes:
                on_node = {p.name for p in node.pods}
                assert node.template.provisioner_name == ("general" if on_node & plain_names else "infra")
            return solve_record(results, solver)

        differential(scenario)

    def test_provisioner_limits_respected_densely(self):
        def scenario(k):
            pods = k.pods(60, requests={"cpu": "1", "memory": "1Gi"})
            provider = k.fake.FakeCloudProvider(k.fake.instance_types(20))
            results, solver = k.solve(pods, [k.make_provisioner(limits={"cpu": "20"})], provider)
            assert solver.stats.batches == 1, "limits must not bail the dense path"
            assert solver.stats.pods_committed > 0
            total = sum(max(it.resources().get("cpu", 0.0) for it in node.instance_type_options) for node in results.new_nodes)
            assert total <= 20 + 1e-6, f"over-provisioned: {total} cpu of capacity vs limit 20"
            host, _ = k.solve(pods, [k.make_provisioner(limits={"cpu": "20"})], k.fake.FakeCloudProvider(k.fake.instance_types(20)), dense=False)
            assert len(scheduled_names(results)) == len(scheduled_names(host))
            return [solve_record(results, solver), solve_record(host), total]

        differential(scenario)

    def test_limits_not_binding_stay_dense(self):
        def scenario(k):
            pods = k.pods(40, requests={"cpu": "1"})
            results, solver = k.solve(pods, [k.make_provisioner(limits={"cpu": "10000"})], k.fake.FakeCloudProvider(k.fake.instance_types(20)))
            assert solver.stats.pods_committed == 40
            assert solver.stats.pods_to_host == 0
            assert scheduled_names(results) == {p.name for p in pods}
            return solve_record(results, solver)

        differential(scenario)

    def test_dense_stats_report_usage(self):
        def scenario(k):
            pods = k.pods(50, requests={"cpu": "1"})
            results, solver = k.solve(pods, [k.make_provisioner()], k.fake.FakeCloudProvider(k.fake.instance_types(50)))
            assert solver.stats.pods_committed == 50
            assert solver.stats.pods_to_host == 0
            assert solver.stats.nodes_created >= 0
            return [solve_record(results, solver), solver.stats.nodes_created]

        differential(scenario)


class TestMaxSkewGreaterThanOne:
    """maxSkew > 1 on the dense path: the committed layout satisfies the
    skew bound and agrees with the host loop on the scheduled-pod count."""

    @staticmethod
    def _spread_pods(k, n, max_skew):
        label = {"app": "skewed"}
        constraint = spread(k, k.lbl.LABEL_TOPOLOGY_ZONE, "skewed", max_skew=max_skew)
        return [k.pod(labels=label, requests={"cpu": 0.5, "memory": "256Mi"}, topology_spread_constraints=[constraint]) for _ in range(n)]

    @staticmethod
    def _zone_counts(k, results):
        counts = {}
        for node in results.new_nodes:
            zone = next(iter(node.requirements.get(k.lbl.LABEL_TOPOLOGY_ZONE).values))
            counts[zone] = counts.get(zone, 0) + len(node.pods)
        return counts

    @pytest.mark.parametrize("max_skew", [2, 3, 5])
    def test_skew_bound_holds_and_matches_host(self, max_skew):
        def scenario(k):
            pods = self._spread_pods(k, 20, max_skew)
            provider = k.fake.FakeCloudProvider(k.fake.instance_types(10))
            dense, solver = k.solve(pods, [k.make_provisioner()], provider)
            host, _ = k.solve(pods, [k.make_provisioner()], provider, dense=False)
            assert sum(len(n.pods) for n in dense.new_nodes) == 20
            assert solver.stats.pods_committed == 20
            counts = self._zone_counts(k, dense)
            assert max(counts.values()) - min(counts.values()) <= max_skew, counts
            assert sum(len(n.pods) for n in host.new_nodes) == 20
            return [solve_record(dense, solver), solve_record(host), sorted(counts.items())]

        differential(scenario)

    def test_uneven_existing_counts_respected(self):
        def scenario(k):
            lbl = k.lbl
            kube = k.kube_module.KubeCluster()
            labels = {
                lbl.PROVISIONER_NAME_LABEL: "default",
                lbl.LABEL_INSTANCE_TYPE: "fake-it-5",
                lbl.LABEL_TOPOLOGY_ZONE: "test-zone-1",
                lbl.LABEL_CAPACITY_TYPE: "on-demand",
            }
            kube.create(k.make_node(name="warm-a", labels=labels, allocatable={"cpu": 8, "memory": "16Gi", "pods": 50}))
            for _ in range(2):  # two running cohort pods in zone-1
                kube.create(k.pod(labels={"app": "skewed"}, requests={"cpu": 0.5}, node_name="warm-a", phase="Running", unschedulable=False))
            pods = self._spread_pods(k, 10, 2)
            results, solver = k.solve(pods, [k.make_provisioner()], k.fake.FakeCloudProvider(k.fake.instance_types(10)), kube=kube)
            assert sum(len(n.pods) for n in results.new_nodes) == 10
            counts = self._zone_counts(k, results)
            counts["test-zone-1"] = counts.get("test-zone-1", 0) + 2  # existing pods count
            assert max(counts.values()) - min(counts.values()) <= 2, counts
            return [solve_record(results, solver), sorted(counts.items())]

        differential(scenario)


# -- tests/test_differential_campaign.py ----------------------------------------


def test_spot_od_node_count_pinned_vs_host():
    """The spot/on-demand mixed-pricing shape: the dense path's node count
    within 1.1x the host loop's and its cost within 1.05x."""

    def scenario(k):
        def solve(dense: bool):
            pods = k.rename(k.build_workload(2000, seed=5), "sod")
            provider = k.fake.FakeCloudProvider(k.build_spot_od_types(200))
            provisioners = [k.make_provisioner(name="spot", weight=10), k.make_provisioner(name="on-demand", weight=1)]
            results, solver = k.solve(pods, provisioners, provider, dense=dense)
            nodes = [n for n in results.new_nodes if n.pods]
            cost = sum(min(it.price() for it in n.instance_type_options) for n in nodes)
            placed = sum(len(n.pods) for n in nodes) + sum(len(v.pods) for v in results.existing_nodes)
            return len(nodes), cost, placed, len(pods), solve_record(results, solver)

        dense_nodes, dense_cost, dense_placed, total, dense_record = solve(True)
        host_nodes, host_cost, host_placed, _, host_record = solve(False)
        assert dense_placed == total and host_placed == total, "both paths must schedule everything"
        assert dense_nodes <= 1.1 * host_nodes
        assert dense_cost <= host_cost * 1.05 + 1e-6
        return [dense_record, host_record, dense_nodes, host_nodes, round(dense_cost, 9), round(host_cost, 9)]

    differential(scenario)


def _invariants(k, results, pods):
    """tests/test_differential_campaign.py's _assert_invariants on either
    package: warm capacity, final zonal skew per spread cohort, taint safety
    on the dedicated pool, distinct hosts per anti-affinity cohort."""
    lbl = k.lbl
    for view in results.existing_nodes:
        assert k.res.fits(view.requests, view.available), f"{view.node.name} overflows"
    placements = {}
    for node in results.new_nodes:
        for pod in node.pods:
            placements[pod.name] = ("new", node)
    for view in results.existing_nodes:
        for pod in view.pods:
            placements[pod.name] = ("existing", view)

    def zone_of_new_node(node):
        req = node.requirements.get(lbl.LABEL_TOPOLOGY_ZONE)
        return next(iter(req.values)) if req is not None and len(req.values) == 1 and not req.complement else None

    spread_groups = {}
    for pod in pods:
        for c in pod.spec.topology_spread_constraints:
            if c.topology_key != lbl.LABEL_TOPOLOGY_ZONE:
                continue
            label = tuple(sorted(c.label_selector.match_labels.items()))
            spread_groups.setdefault(label, {"selector": c.label_selector, "max_skew": 0})
            spread_groups[label]["max_skew"] = max(spread_groups[label]["max_skew"], c.max_skew)
    for label, info in spread_groups.items():
        counts = dict.fromkeys(ZONES, 0)
        incomplete = False
        for pod in pods:
            if not info["selector"].matches(pod.metadata.labels):
                continue
            placed = placements.get(pod.name)
            if placed is None:
                continue
            kind, node = placed
            zone = node.node.metadata.labels.get(lbl.LABEL_TOPOLOGY_ZONE) if kind == "existing" else zone_of_new_node(node)
            if zone is None:
                incomplete = True
                break
            counts[zone] += 1
        if not incomplete and sum(counts.values()):
            assert max(counts.values()) - min(counts.values()) <= info["max_skew"], (label, counts)
    for node in results.new_nodes:
        prov = node.requirements.get(lbl.PROVISIONER_NAME_LABEL)
        if prov is None or "dedicated" not in prov.values:
            continue
        for pod in node.pods:
            assert any(t.key == "dedicated" for t in pod.spec.tolerations), f"{pod.name} on a dedicated-pool node"
    anti_groups = {}
    for pod in pods:
        aff = pod.spec.affinity
        if aff and aff.pod_anti_affinity and aff.pod_anti_affinity.required:
            required = aff.pod_anti_affinity.required[0]
            if required.topology_key == lbl.LABEL_HOSTNAME:
                anti_groups.setdefault(tuple(sorted(required.label_selector.match_labels.items())), []).append(pod)
    for label, members in anti_groups.items():
        hosts = [id(placements[p.name][1]) for p in members if p.name in placements]
        assert len(hosts) == len(set(hosts)), f"anti cohort {label} shares a host"


@pytest.mark.parametrize("seed", CAMPAIGN_SEEDS)
def test_randomized_differential_campaign(seed):
    def scenario(k):
        def inputs():
            rng = np.random.default_rng(1000 + seed)
            provider = k.fake.FakeCloudProvider(k.fake.instance_types(int(rng.integers(20, 120))))
            pods = k.rename(k.random_workload(rng, int(rng.integers(40, 140))), seed)
            return provider, pods, k.random_states(rng)

        provider, pods_dense, states_dense = inputs()
        provider2, pods_host, states_host = inputs()  # solves mutate their inputs
        dense, solver = k.solve(pods_dense, k.campaign_provisioners(), provider, state_nodes=states_dense)
        host, _ = k.solve(pods_host, k.campaign_provisioners(), provider2, dense=False, state_nodes=states_host)

        def names(results):
            return {p.name for n in results.new_nodes for p in n.pods} | {p.name for v in results.existing_nodes for p in v.pods}

        assert names(dense) == names(host), f"seed {seed}: dense/host disagree on schedulability"
        _invariants(k, dense, pods_dense)
        _invariants(k, host, pods_host)
        dense_cost = sum(n.instance_type_options[0].price() for n in dense.new_nodes if n.pods)
        host_cost = sum(n.instance_type_options[0].price() for n in host.new_nodes if n.pods)
        if host_cost > 0:
            cheapest = min(it.price() for it in provider.get_instance_types(k.make_provisioner()))
            assert dense_cost <= host_cost + 5 * cheapest + 1e-6
        return [solve_record(dense, solver, states_dense), solve_record(host, states=states_host), round(dense_cost, 9), round(host_cost, 9)]

    differential(scenario)
