"""The port's cloud API pair held against the JAX package, case by case.

Each case runs on both packages, written once against a `CKit` (one
package's CloudBackend, CloudAPIService, CloudAPIClient, provider and
rigs). The case's own assertions run on both sides and the two records
must be equal: what each side saw (the retry schedule, which the client
draws from a seeded stream, the instances, nodes and errors).

- every case of tests/test_cloud_api_transport.py (auth and the dry run,
  pagination, retry and backoff, the typed errors, idempotent CreateFleet,
  the in-process idempotency cases and the provider over sockets);
- the `http` params of tests/test_interruption_catalog.py:192 (the spot
  interruption drill), tests/test_provider_catalog.py's fallback case and
  tests/test_capacity_resilience.py's in-round re-solve, and
  tests/test_capacity_resilience.py's TestHttpFleetSchema;
- tests/test_runtime_stress.py:167, the writer churn against a Runtime
  over the HTTP kube backend.

The http params of tests/test_simulated_provider.py:33 and
tests/test_crash_recovery.py:62 are in test_torch_simulated_provider.py
and test_torch_runtime.py. The port's Runtimes run on the CPU. Every
service, client and Runtime a case starts is stopped by the `stops`
fixture's finalizer.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.request

import pytest

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_interruption import SKit, leader_cleared, sim_record  # noqa: F401
from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_runtime import _process_state  # noqa: F401

SIDES = ("ref", "port")


class CKit:
    """One package's simulated cloud, its HTTP pair and what runs on it."""

    def __init__(self, side: str):
        self.side = side
        if side == "ref":
            from karpenter_tpu import runtime
            from karpenter_tpu.api import labels, objects
            from karpenter_tpu.cloudprovider import errors, fake, simulated, types
            from karpenter_tpu.cloudprovider.simulated import backend, fleet
            from karpenter_tpu.kube import apiserver, client, cluster
            from karpenter_tpu.scheduling.nodetemplate import NodeTemplate
            from karpenter_tpu.utils import clock, options
            from tests.helpers import make_pod, make_provisioner
        else:
            from karpenter_tpu_torch import runtime
            from karpenter_tpu_torch.api import labels, objects
            from karpenter_tpu_torch.cloudprovider import errors, fake, simulated, types
            from karpenter_tpu_torch.cloudprovider.simulated import backend, fleet
            from karpenter_tpu_torch.kube import apiserver, client, cluster
            from karpenter_tpu_torch.scheduling.nodetemplate import NodeTemplate
            from karpenter_tpu_torch.testing import make_pod, make_provisioner
            from karpenter_tpu_torch.utils import clock, options
        self.runtime, self.lbl, self.obj, self.errors, self.fake = runtime, labels, objects, errors, fake
        self.simulated, self.types, self.backend, self.fleet = simulated, types, backend, fleet
        self.apiserver, self.client, self.cluster, self.NodeTemplate = apiserver, client, cluster, NodeTemplate
        self.clock, self.options, self.make_pod, self.make_provisioner = clock, options, make_pod, make_provisioner

    def Runtime(self, kube, provider, **options):
        """A Runtime of this package; the port's runs on the CPU."""
        extra = {"device": "cpu"} if self.side == "port" else {}
        return self.runtime.Runtime(kube=kube, cloud_provider=provider, options=self.options.Options(**options), **extra)


class Stops:
    """Collects stop callables; runs them all, last first, at the end."""

    def __init__(self):
        self._stops = []

    def add(self, stop):
        self._stops.append(stop)

    def close(self):
        while self._stops:
            self._stops.pop()()


@pytest.fixture
def stops():
    s = Stops()
    yield s
    s.close()


def both(scenario, stops):
    ref, port = (scenario(CKit(side), stops) for side in SIDES)
    assert port == ref
    return port


class Cloud:
    """tests/test_cloud_api_transport.py's fixtures: a FakeClock, a backend,
    its service and a client that collects its backoff schedule instead of
    sleeping."""

    def __init__(self, k: CKit, stops: Stops):
        self.k = k
        self.clock = k.clock.FakeClock()
        self.backend = k.backend.CloudBackend(clock=self.clock)
        self.service = k.simulated.CloudAPIService(backend=self.backend).start()
        stops.add(self.service.stop)
        self.delays = []
        self.client = k.simulated.CloudAPIClient(self.service.url, clock=self.clock, sleep=self.delays.append)

    def fleet_request(self):
        k, backend = self.k, self.backend
        template = backend.launch_templates.get("t") or backend.ensure_launch_template("t", "img-1", ["sg-default"], "")
        spec = k.backend.FleetInstanceSpec(
            instance_type="general-2x4", zone="zone-a", capacity_type="on-demand",
            launch_template_id=template.template_id, subnet_id="subnet-zone-a",
        )
        return k.backend.FleetRequest(specs=[spec], capacity_type="on-demand")


# -- tests/test_cloud_api_transport.py -------------------------------------------


class TestAuthAndDryRun:
    def test_verify_dry_run_succeeds(self, stops):
        both(lambda k, s: Cloud(k, s).client.verify(), stops)

    def test_bad_token_is_typed_and_unretried(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            delays = []
            bad = k.simulated.CloudAPIClient(cloud.service.url, token="wrong", clock=cloud.clock, sleep=delays.append)
            with pytest.raises(k.simulated.AuthError) as err:
                bad.verify()
            assert delays == [], "auth failures must not burn the retry budget"
            return [err.value.status, err.value.code]

        both(scenario, stops)


class TestPagination:
    def test_catalog_spans_pages(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            cloud.backend.catalog = cloud.backend.catalog + [
                k.backend.InstanceTypeInfo(name=f"padded-{i}", cpu=2.0, memory_bytes=2**31, pods=20.0) for i in range(150)
            ]
            names = {t.name for t in cloud.client.describe_instance_types()}
            assert {t.name for t in cloud.backend.catalog} == names
            return sorted(names)

        both(scenario, stops)


class TestRetryBackoff:
    def test_throttle_storm_backs_off_then_succeeds(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            cloud.service.throttle_next(3)
            subnets = cloud.client.describe_subnets()
            assert len(subnets) == 3
            assert cloud.client.retries == 3
            assert len(cloud.delays) == 3
            return [sorted(sn.subnet_id for sn in subnets), cloud.delays]

        both(scenario, stops)

    def test_5xx_backoff_grows_exponentially(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            cloud.service.fail_next(4)
            cloud.client.describe_subnets()
            assert len(cloud.delays) == 4
            assert cloud.delays[3] > cloud.delays[0]
            return cloud.delays

        both(scenario, stops)

    def test_retry_budget_exhausts_into_typed_error(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            cloud.service.fail_next(100)
            with pytest.raises(k.simulated.CloudAPIError) as err:
                cloud.client.describe_subnets()
            assert err.value.code in ("internal", "exhausted")
            return [err.value.code, cloud.client.retries, cloud.delays]

        both(scenario, stops)


class TestTypedErrorTaxonomy:
    def test_insufficient_capacity_pools_extracted(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            cloud.backend.insufficient_capacity_pools.add(("general-2x4", "zone-a", "on-demand"))
            with pytest.raises(k.backend.InsufficientCapacityError) as err:
                cloud.client.create_fleet(cloud.fleet_request())
            assert ("general-2x4", "zone-a", "on-demand") in err.value.pools
            return sorted(err.value.pools)

        both(scenario, stops)

    def test_stale_launch_template_ids_extracted(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            request = cloud.fleet_request()
            cloud.backend.delete_launch_template("t")
            with pytest.raises(k.backend.LaunchTemplateNotFoundError) as err:
                cloud.client.create_fleet(request)
            assert err.value.template_ids == {request.specs[0].launch_template_id}
            return sorted(err.value.template_ids)

        both(scenario, stops)


class TestIdempotentCreateFleet:
    def test_dropped_response_retry_launches_exactly_once(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            cloud.service.drop_response_next(1)
            result = cloud.client.create_fleet(cloud.fleet_request())
            assert cloud.client.retries >= 1
            assert len(cloud.backend.instances) == 1, "a lost response must never double-launch"
            assert result.instance.instance_id in cloud.backend.instances
            return [cloud.client.retries, result.instance.instance_id]

        both(scenario, stops)

    def test_client_token_rides_the_fleet_request(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            request = cloud.fleet_request()
            request.client_token = "tok-app-level"
            first = cloud.client.create_fleet(request)
            second = cloud.client.create_fleet(request)  # a fresh call, same token
            assert first.instance.instance_id == second.instance.instance_id
            assert len(cloud.backend.instances) == 1
            return first.instance.instance_id

        both(scenario, stops)

    def test_request_deadline_bounds_the_retry_budget(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            c = k.simulated.CloudAPIClient(cloud.service.url, clock=cloud.clock, max_attempts=100, request_deadline=0.2)
            cloud.service.fail_next(100)
            with pytest.raises(k.simulated.CloudAPIError) as err:
                c.describe_subnets()
            assert err.value.code == "deadline_exceeded"
            assert c.retries < 99, "the deadline, not the attempt cap, must stop the retry loop"
            return [err.value.code, c.retries]

        both(scenario, stops)

    def test_concurrent_same_token_launches_once(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            backend = cloud.backend
            request = cloud.fleet_request()
            gate = threading.Event()
            original = backend.create_fleet

            def slow_create(req):
                gate.wait(timeout=5)
                return original(req)

            backend.create_fleet = slow_create
            body = json.dumps({
                "idempotency_token": "tok-race",
                "capacity_type": "on-demand",
                "specs": [
                    {"instance_type": sp.instance_type, "zone": sp.zone, "capacity_type": sp.capacity_type,
                     "launch_template_id": sp.launch_template_id, "subnet_id": sp.subnet_id}
                    for sp in request.specs
                ],
            }).encode()
            results = []

            def post():
                req = urllib.request.Request(
                    cloud.service.url + "/v1/fleet", data=body,
                    headers={"Authorization": f"Bearer {cloud.service.token}", "Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=30) as response:
                    results.append(json.loads(response.read()))

            threads = [threading.Thread(target=post) for _ in range(2)]
            for t in threads:
                t.start()
            gate.set()
            for t in threads:
                t.join(timeout=10)
            backend.create_fleet = original
            assert len(results) == 2
            assert results[0] == results[1], "both racers must see the one launch"
            assert len(backend.instances) == 1
            return results[0]

        both(scenario, stops)

    def test_distinct_calls_launch_distinct_instances(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            a = cloud.client.create_fleet(cloud.fleet_request())
            b = cloud.client.create_fleet(cloud.fleet_request())
            assert a.instance.instance_id != b.instance.instance_id
            assert len(cloud.backend.instances) == 2
            return sorted(cloud.backend.instances)

        both(scenario, stops)


class TestInProcessIdempotency:
    def test_backend_replays_settled_token(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            request = cloud.fleet_request()
            request.client_token = "tok-1"
            first = cloud.backend.create_fleet(request)
            second = cloud.backend.create_fleet(request)
            assert first is second
            assert len(cloud.backend.instances) == 1
            return first.instance.instance_id

        both(scenario, stops)

    def test_tokenless_requests_never_dedupe(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            a = cloud.backend.create_fleet(cloud.fleet_request())
            b = cloud.backend.create_fleet(cloud.fleet_request())
            assert a.instance.instance_id != b.instance.instance_id
            return [a.instance.instance_id, b.instance.instance_id]

        both(scenario, stops)

    def test_backend_drop_response_executes_then_raises(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            request = cloud.fleet_request()
            request.client_token = "tok-lost"
            cloud.backend.drop_response_next(1)
            with pytest.raises(k.backend.ResponseLostError):
                cloud.backend.create_fleet(request)
            assert len(cloud.backend.instances) == 1, "the operation executed; only the response was lost"
            replay = cloud.backend.create_fleet(request)
            assert len(cloud.backend.instances) == 1
            assert replay.instance.instance_id in cloud.backend.instances
            return replay.instance.instance_id

        both(scenario, stops)

    def test_fleet_batcher_retries_lost_response_with_same_token(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            batcher = k.fleet.CreateFleetBatcher(cloud.backend, window=0.0)
            cloud.backend.drop_response_next(1)
            instance = batcher.create_fleet(cloud.fleet_request())
            assert len(cloud.backend.instances) == 1
            assert instance.instance_id in cloud.backend.instances
            return instance.instance_id

        both(scenario, stops)

    def test_provider_create_survives_lost_response(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            kube = k.cluster.KubeCluster()
            provider = k.simulated.SimulatedCloudProvider(backend=cloud.backend, kube=kube, clock=cloud.clock)
            provisioner = k.make_provisioner()
            kube.create(provisioner)
            template = k.NodeTemplate.from_provisioner(provisioner)
            options = provider.get_instance_types(provisioner)[:3]
            cloud.backend.drop_response_next(1)
            node = provider.create(k.types.NodeRequest(template=template, instance_type_options=options))
            assert len(cloud.backend.instances) == 1
            assert node.spec.provider_id.split("///", 1)[1] in cloud.backend.instances
            return [node.name, node.metadata.labels[k.lbl.LABEL_INSTANCE_TYPE]]

        both(scenario, stops)


class TestProviderOverSockets:
    def test_provisioning_and_consolidation_rounds(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            kube = k.cluster.KubeCluster(clock=cloud.clock)
            provider = k.simulated.SimulatedCloudProvider(backend=cloud.client, kube=kube, clock=cloud.clock)
            runtime = k.Runtime(kube, provider, leader_elect=False, dense_solver_enabled=False)
            kube.create(k.make_provisioner(consolidation_enabled=True))
            pod = k.make_pod(name="sock-pod", requests={"cpu": "1", "memory": "1Gi"})
            kube.create(pod)
            runtime.provision_once()
            nodes = kube.list_nodes()
            assert len(nodes) == 1 and len(cloud.backend.instances) == 1
            assert provider.instance_exists(nodes[0]) is True
            kube.delete(pod)
            provider.delete(nodes[0])
            assert len(cloud.backend.instances) == 0
            assert provider.instance_exists(nodes[0]) is False
            return [nodes[0].name, nodes[0].metadata.labels[k.lbl.LABEL_INSTANCE_TYPE]]

        both(scenario, stops)

    def test_end_to_end_create_with_faults(self, stops):
        def scenario(k, s):
            cloud = Cloud(k, s)
            kube = k.cluster.KubeCluster(clock=cloud.clock)
            provider = k.simulated.SimulatedCloudProvider(backend=cloud.client, kube=kube, clock=cloud.clock)
            provisioner = k.make_provisioner()
            provider.default_provisioner(provisioner)
            types = provider.get_instance_types(provisioner)
            assert types
            template = k.NodeTemplate.from_provisioner(provisioner)
            cloud.service.throttle_next(2)
            node = provider.create(k.types.NodeRequest(template=template, instance_type_options=types[:5]))
            assert node.spec.provider_id.startswith("sim:///")
            assert len(cloud.backend.instances) == 1
            assert provider.instance_exists(node) is True
            provider.delete(node)
            assert provider.instance_exists(node) is False
            return [node.name, node.metadata.labels[k.lbl.LABEL_INSTANCE_TYPE], cloud.delays]

        both(scenario, stops)


# -- tests/test_interruption_catalog.py:192[http]: the drill over sockets -------


def test_spot_interruption_drill_end_to_end_over_http():
    """The drill of tests/test_torch_interruption.py, its cloud behind each
    package's CloudAPIService: the reference's InterruptionEnv(transport=
    "http") under the port rig's names, the port's testing.InterruptionEnv
    (transport="http"); the exact host loop on both."""
    from tests.test_torch_interruption import _recreate

    def scenario(k):
        if k.side == "ref":
            from tests.test_interruption_catalog import InterruptionEnv

            env = k._sim(InterruptionEnv(transport="http"))
        else:
            env = k._sim(k.InterruptionEnv(transport="http"))
        try:
            node, pods = env.launch_node_with_pods(3)
            deadline = env.backend.interrupt_spot_instance(env.instance_id(node))
            assert deadline == env.clock.now() + 120.0
            env.interruption.poll_once()
            replacements = [n for n in env.kube.list_nodes() if n.name != node.name]
            assert replacements, "proactive solve must launch replacement capacity"
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
            reasons = {e.reason for e in env.recorder.events}
            assert "SpotInterrupted" in reasons and "InterruptionReplacement" in reasons
            return [placed_existing, launched_new, sim_record(env, k)]
        finally:
            env.close()

    ref, port = (scenario(SKit(side, "host")) for side in SIDES)
    assert port == ref


# -- tests/test_provider_catalog.py:82[http] ------------------------------------


def test_ice_fallback_launches_different_type_on_second_attempt_over_http(stops):
    """IceEnv(transport="http"): the cheapest type exhausted in every pool;
    the first round fails against it, the retry round launches another
    type."""

    def scenario(k, s):
        clock = k.clock.FakeClock()
        kube = k.cluster.KubeCluster(clock=clock)
        backend = k.backend.CloudBackend(clock=clock)
        service = k.simulated.CloudAPIService(backend=backend).start()
        s.add(service.stop)
        provider = k.simulated.SimulatedCloudProvider(backend=k.simulated.CloudAPIClient(service.url, clock=clock), kube=kube, clock=clock)
        runtime = k.Runtime(kube, provider, leader_elect=False, dense_solver_enabled=False)
        kube.create(k.make_provisioner())
        cheapest = min(provider.get_instance_types(k.make_provisioner()), key=lambda t: t.price()).name()
        for zone in ("zone-a", "zone-b", "zone-c"):
            for ct in ("spot", "on-demand"):
                backend.insufficient_capacity_pools.add((cheapest, zone, ct))
        kube.create(k.make_pod(name="ice-pod", requests={"cpu": "1", "memory": "1Gi"}))
        runtime.provision_once()
        runtime.provision_once()
        nodes = kube.list_nodes()
        assert nodes, "second reconciliation attempt must launch"
        assert all(n.metadata.labels[k.lbl.LABEL_INSTANCE_TYPE] != cheapest for n in nodes)
        return [cheapest, sorted(n.metadata.labels[k.lbl.LABEL_INSTANCE_TYPE] for n in nodes), sorted(provider.unavailable.snapshot())]

    both(scenario, stops)


# -- tests/test_capacity_resilience.py:323[http] and :539 ------------------------


def test_typed_ice_triggers_in_round_resolve_onto_next_types_over_http(stops):
    """CrunchEnv(transport="http") with the full catalog: every pool of the
    20 cheapest amd64 types exhausted; the launch's typed ICE quarantines
    them and the in-round re-solve launches from the pricier rest. (The
    reference's tracing flag is off on both sides: the port's tracing waits
    for ROADMAP A8a, and with it the launch-failure counter the reference
    case reads.)"""

    def scenario(k, s):
        lbl = k.lbl
        clock = k.clock.FakeClock()
        kube = k.cluster.KubeCluster(clock=clock)
        backend = k.backend.CloudBackend(clock=clock)
        service = k.simulated.CloudAPIService(backend=backend).start()
        s.add(service.stop)
        provider = k.simulated.SimulatedCloudProvider(backend=k.simulated.CloudAPIClient(service.url, clock=clock), kube=kube, clock=clock)
        runtime = k.Runtime(kube, provider, leader_elect=False, dense_solver_enabled=False)
        kube.create(k.make_provisioner(requirements=[
            k.obj.NodeSelectorRequirement(key=lbl.LABEL_CAPACITY_TYPE, operator=k.obj.OP_IN, values=[lbl.CAPACITY_TYPE_SPOT, lbl.CAPACITY_TYPE_ON_DEMAND])
        ]))
        universe = sorted(
            (it for it in provider.get_instance_types(kube.get("Provisioner", "default", namespace="")) if it.info.architecture == lbl.ARCHITECTURE_AMD64),
            key=lambda it: it.price(),
        )
        cheapest20 = {it.name() for it in universe[:20]}
        for name in cheapest20:
            for zone in ("zone-a", "zone-b", "zone-c"):
                for ct in ("spot", "on-demand"):
                    backend.set_pool_capacity(name, zone, ct, 0)
        kube.create(k.make_pod(name="crunch-pod", requests={"cpu": "1", "memory": "1Gi"}))
        runtime.provision_once()
        nodes = kube.list_nodes()
        assert nodes, "the in-round re-solve never launched replacement capacity"
        assert all(n.metadata.labels[lbl.LABEL_INSTANCE_TYPE] not in cheapest20 for n in nodes)
        assert provider.unavailable.snapshot(), "exhausted pools were not quarantined"
        return [sorted(n.metadata.labels[lbl.LABEL_INSTANCE_TYPE] for n in nodes), sorted(provider.unavailable.snapshot())]

    both(scenario, stops)


def test_partial_fleet_response_carries_per_item_errors(stops):
    def scenario(k, s):
        clock = k.clock.FakeClock()
        backend = k.backend.CloudBackend(clock=clock)
        service = k.simulated.CloudAPIService(backend=backend).start()
        s.add(service.stop)
        client = k.simulated.CloudAPIClient(service.url, clock=clock)
        lt = backend.ensure_launch_template("lt-cap", "img-1", ["sg-1"], "")
        spec = k.backend.FleetInstanceSpec(
            instance_type=backend.catalog[0].name, zone="zone-a", capacity_type="on-demand",
            launch_template_id=lt.template_id, subnet_id="subnet-zone-a",
        )
        pool = (spec.instance_type, spec.zone, spec.capacity_type)
        backend.set_pool_capacity(*pool, 1)
        result = client.create_fleet(k.backend.FleetRequest(specs=[spec], capacity_type="on-demand", count=3))
        assert len(result.instances) == 1
        assert len(result.errors) == 2
        assert all(isinstance(e, k.errors.InsufficientCapacityError) for e in result.errors)
        assert all(pool in e.pools for e in result.errors)
        assert pool in result.unavailable_pools
        return [[i.instance_id for i in result.instances], [sorted(e.pools) for e in result.errors], sorted(result.unavailable_pools)]

    both(scenario, stops)


# -- tests/test_runtime_stress.py:167 ---------------------------------------------


def test_churn_over_http_backend(stops):
    """Three writers churn pods through one client while a Runtime over its
    own HTTP kube client provisions; every verb crosses real sockets. The
    writers' timing varies, so each side is held to the case's own checks."""

    def scenario(k, s):
        srv = k.apiserver.APIServer().start()
        s.add(srv.stop)
        kube = k.client.HttpKubeClient(srv.url, clock=k.clock.Clock())
        s.add(kube.stop)
        rt = k.Runtime(
            kube, k.fake.FakeCloudProvider(k.fake.instance_types(6)),
            batch_max_duration=0.3, batch_idle_duration=0.05, leader_elect=True, dense_solver_enabled=False,
        )
        s.add(lambda: rt._stop.is_set() or rt.stop())
        driver = k.client.HttpKubeClient(srv.url)
        s.add(driver.stop)
        errors: list = []
        driver.create(k.make_provisioner())
        rt.start()
        assert rt.elector.wait_for_leadership(timeout=15)

        def writer(wid: int):
            rng = random.Random(wid)
            try:
                for i in range(10):
                    pod = k.make_pod(name=f"http-churn-{wid}-{i}", requests={"cpu": rng.choice([0.25, 0.5])})
                    driver.create(pod)
                    time.sleep(rng.uniform(0, 0.003))
                    if rng.random() < 0.2:
                        driver.delete(pod, grace=False)
            except Exception as exc:  # noqa: BLE001 - surfaced in the main thread
                errors.append(exc)

        threads = [threading.Thread(target=writer, args=(w,)) for w in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if driver.list_nodes() and not driver.pending_pods():
                break
            rt.provision_once()
            time.sleep(0.1)
        assert driver.list_nodes(), "no nodes over the HTTP backend"
        assert rt.healthy()
        rt.stop()
        return sorted(p.name for p in driver.list_pods())

    both(scenario, stops)
