"""The port's simulated cloud held against the JAX package, case by case.

Every case of tests/test_simulated_provider.py runs here on both packages,
written once against an SKit (tests/test_torch_interruption.py): each
side builds its own FakeClock, CloudBackend, KubeCluster and
SimulatedCloudProvider, and the case's own assertions run on both. The two
records must be equal: the catalogs (types, prices, offerings), the
launched nodes, the backend's captured calls and what each case reads.
The end-to-end case runs the reference's Runtime against the port's
SimulatedEnv (the controllers a Runtime wires), with the exact host loop
and with the dense solve at min_batch=1.

Every case that the reference runs on its `provider` fixture runs on the
`http` transport too, as there: the *OverHttp classes at the end repeat
their classes with each side's provider talking to its cloud only through
sockets (that package's CloudAPIService on the backend, its CloudAPIClient
in the provider; the cases keep reading the backend, the service's own
state). The `http_transport` fixture stops the services.
"""

from __future__ import annotations

import importlib
import threading

import pytest

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_interruption import RefSimulatedEnv, SKit, leader_cleared  # noqa: F401
from tests.test_torch_provisioning import MODES, reference_singletons, run_both  # noqa: F401


_transport = {"name": "inprocess", "stops": []}


@pytest.fixture
def http_transport():
    """Sim builds its provider over the cloud API's sockets for the test;
    every service it started is stopped after it."""
    _transport["name"] = "http"
    yield
    _transport["name"] = "inprocess"
    while _transport["stops"]:
        _transport["stops"].pop()()


class Sim:
    """One side's cloud: clock, backend, store and provider, the provider
    over the current transport."""

    def __init__(self, k):
        self.k = k
        self.clock = k.clock.FakeClock()
        self.backend = k.backend.CloudBackend(clock=self.clock)
        self.kube = k.kube_module.KubeCluster(clock=self.clock)
        cloud = self.backend
        if _transport["name"] == "http":
            package = "karpenter_tpu" if k.side == "ref" else "karpenter_tpu_torch"
            simulated = importlib.import_module(f"{package}.cloudprovider.simulated")
            service = simulated.CloudAPIService(backend=self.backend).start()
            _transport["stops"].append(service.stop)
            cloud = simulated.CloudAPIClient(service.url, clock=self.clock)
        self.provider = k.provider.SimulatedCloudProvider(backend=cloud, kube=self.kube, clock=self.clock)

    def request(self, provisioner, options=None):
        k = self.k
        template = k.NodeTemplate.from_provisioner(provisioner)
        if options is None:
            options = sorted(self.provider.get_instance_types(provisioner), key=lambda t: t.price())
        return k.cloud_types.NodeRequest(template=template, instance_type_options=options)


def catalog_record(types) -> list:
    return [
        (t.name(), t.price(), sorted((o.zone, o.capacity_type, o.price, o.available) for o in t.offerings()))
        for t in types
    ]


def node_record(node) -> tuple:
    return (
        node.name,
        node.spec.provider_id,
        sorted(node.metadata.labels.items()),
        sorted(node.status.capacity.items()),
        sorted(node.status.allocatable.items()),
        node.ready(),
    )


def both_once(scenario):
    """The case on each package, once (no solve); records equal."""
    ref, port = run_both(lambda k: scenario(SKit(k.side, k.mode)), "host")
    assert port == ref
    return port


class TestCatalog:
    def test_catalog_cached(self):
        def scenario(k):
            sim = Sim(k)
            provisioner = k.make_provisioner()
            sim.provider.get_instance_types(provisioner)
            calls = sim.backend.describe_calls
            sim.provider.get_instance_types(provisioner)
            assert sim.backend.describe_calls == calls  # served from cache
            sim.clock.step(61)
            types = sim.provider.get_instance_types(provisioner)
            assert sim.backend.describe_calls > calls
            return [calls, sim.backend.describe_calls, catalog_record(types)]

        both_once(scenario)

    def test_previous_generation_filtered(self):
        def scenario(k):
            sim = Sim(k)
            types = sim.provider.get_instance_types(k.make_provisioner())
            assert all(t.name() != "legacy-2x4" for t in types)
            permissive = k.make_provisioner(provider={"include_previous_generation": True})
            wider = sim.provider.get_instance_types(permissive)
            assert any(t.name() == "legacy-2x4" for t in wider)
            return [[t.name() for t in types], [t.name() for t in wider]]

        both_once(scenario)

    def test_offerings_priced_spot_cheaper(self):
        def scenario(k):
            sim = Sim(k)
            types = sim.provider.get_instance_types(k.make_provisioner())
            it = types[0]
            spot = [o for o in it.offerings() if o.capacity_type == "spot"]
            od = [o for o in it.offerings() if o.capacity_type == "on-demand"]
            assert spot and od
            assert min(o.price for o in spot) < min(o.price for o in od)
            return catalog_record(types)

        both_once(scenario)

    def test_zone_universe_from_subnets(self):
        def scenario(k):
            sim = Sim(k)
            types = sim.provider.get_instance_types(k.make_provisioner())
            zones = {o.zone for t in types for o in t.offerings()}
            assert zones == {"zone-a", "zone-b", "zone-c"}
            return sorted(zones)

        both_once(scenario)


class TestCreate:
    def test_create_launches_cheapest(self):
        def scenario(k):
            sim = Sim(k)
            provisioner = k.make_provisioner()
            sim.kube.create(provisioner)
            node = sim.provider.create(sim.request(provisioner))
            assert node.spec.provider_id.startswith("sim:///")
            assert node.metadata.labels[k.lbl.LABEL_CAPACITY_TYPE] == "spot"  # cheapest
            assert node.status.capacity["cpu"] > 0
            assert not node.ready()  # joins NotReady until kubelet reports
            return node_record(node)

        both_once(scenario)

    def test_fleet_cap_twenty_types(self):
        def scenario(k):
            sim = Sim(k)
            provisioner = k.make_provisioner()
            sim.kube.create(provisioner)
            sim.provider.create(sim.request(provisioner))
            request = sim.backend.create_fleet_calls[-1]
            assert len({s.instance_type for s in request.specs}) <= 20
            return [(s.instance_type, s.zone, s.capacity_type, s.subnet_id) for s in request.specs]

        both_once(scenario)

    def test_insufficient_capacity_marks_unavailable(self):
        def scenario(k):
            sim = Sim(k)
            provisioner = k.make_provisioner()
            sim.kube.create(provisioner)
            for info in sim.backend.catalog:
                for zone in ("zone-a", "zone-b", "zone-c"):
                    for ct in ("spot", "on-demand"):
                        sim.backend.insufficient_capacity_pools.add((info.name, zone, ct))
            attempted = {t.name() for t in sim.request(provisioner).instance_type_options[:20]}
            with pytest.raises(k.backend.InsufficientCapacityError):
                sim.provider.create(sim.request(provisioner))
            sim.backend.reset()
            sim.provider.catalog.invalidate()
            remaining = {t.name() for t in sim.provider.get_instance_types(provisioner)}
            assert not (attempted & remaining)
            quarantined = sorted(sim.provider.unavailable.snapshot())
            sim.provider.clock.step(200)
            sim.provider.catalog.invalidate()
            restored = {t.name() for t in sim.provider.get_instance_types(provisioner)}
            assert attempted & restored
            return [sorted(attempted), sorted(remaining), quarantined, sorted(restored)]

        both_once(scenario)

    def test_launch_template_cached_per_family(self):
        def scenario(k):
            sim = Sim(k)
            provisioner = k.make_provisioner()
            sim.kube.create(provisioner)
            sim.provider.create(sim.request(provisioner))
            count = len(sim.backend.launch_templates)
            sim.provider.create(sim.request(provisioner))
            assert len(sim.backend.launch_templates) == count  # reused
            return sorted((t.name, t.image_id, t.user_data) for t in sim.backend.launch_templates.values())

        both_once(scenario)

    def test_delete_terminates_instance(self):
        def scenario(k):
            sim = Sim(k)
            provisioner = k.make_provisioner()
            sim.kube.create(provisioner)
            node = sim.provider.create(sim.request(provisioner))
            sim.provider.delete(node)
            assert sim.backend.terminate_calls == [node.name]
            return list(sim.backend.terminate_calls)

        both_once(scenario)


class TestFleetBatcher:
    def test_concurrent_identical_requests_coalesce(self):
        def scenario(k):
            backend = k.backend.CloudBackend(clock=k.clock.FakeClock())
            batcher = k.fleet.CreateFleetBatcher(backend, window=0.05)
            lt = backend.ensure_launch_template("lt-batch", "img-1", ["sg-1"], "")
            request_specs = [
                k.backend.FleetInstanceSpec(
                    instance_type="general-2x4", zone="zone-a", capacity_type="on-demand", launch_template_id=lt.template_id
                )
            ]
            results, errors = [], []

            def worker():
                try:
                    results.append(batcher.create_fleet(k.backend.FleetRequest(specs=list(request_specs), capacity_type="on-demand")))
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=worker) for _ in range(5)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors
            assert len(results) == 5
            assert len({r.instance_id for r in results}) == 5  # distinct instances
            assert len(backend.create_fleet_calls) == 5  # one call per instance, one burst
            return [sorted(r.instance_id for r in results), sorted((r.instance_type, r.zone, r.capacity_type) for r in results)]

        both_once(scenario)


@pytest.mark.parametrize("mode", MODES)
class TestEndToEndWithRuntime:
    def test_provision_through_simulated_provider(self, mode):
        def scenario(k):
            if k.side == "ref":
                env = RefSimulatedEnv()
            else:
                from karpenter_tpu_torch.testing import SimulatedEnv

                env = SimulatedEnv()
            k._routed(env, k.mode_solver())
            env.kube.create(k.make_provisioner())
            env.kube.create(k.pod(requests={"cpu": "2", "memory": "4Gi"}))
            env.provision()
            assert len(env.kube.list_nodes()) == 1
            node = env.kube.list_nodes()[0]
            assert node.metadata.labels[k.lbl.LABEL_INSTANCE_TYPE] in {i.name for i in env.backend.catalog}
            node.status.conditions = [k.obj.NodeCondition(type="Ready", status="True")]
            env.kube.update(node)
            env.node_controller.reconcile_all()
            assert node.metadata.labels.get(k.lbl.LABEL_NODE_INITIALIZED) == "true"
            provisioner = env.kube.list_provisioners()[0]
            requirements = sorted((r.key, r.operator, tuple(r.values)) for r in provisioner.spec.requirements)
            return [node_record(node), requirements]

        ref, port = run_both(lambda k: scenario(SKit(k.side, k.mode)), mode)
        assert port == ref


class TestNodeClass:
    def test_provider_ref_resolved(self):
        def scenario(k):
            sim = Sim(k)
            sim.kube.create(k.provider.NodeClass(metadata=k.obj.ObjectMeta(name="special", namespace=""), image_family="minimal"))
            provisioner = k.make_provisioner()
            provisioner.spec.provider_ref = "special"
            node_class = sim.provider._node_class(provisioner)
            assert node_class.image_family == "minimal"
            return node_class.image_family

        both_once(scenario)

    def test_subnet_selector_restricts_zones(self):
        def scenario(k):
            sim = Sim(k)
            for subnet in sim.backend.subnets:
                subnet.tags = {"ring": "prod"} if subnet.zone == "zone-a" else {}
            provisioner = k.make_provisioner(provider={"subnet_selector": {"ring": "prod"}})
            types = sim.provider.get_instance_types(provisioner)
            zones = {o.zone for t in types for o in t.offerings()}
            assert zones == {"zone-a"}
            return catalog_record(types)

        both_once(scenario)

    def test_deterministic_spot_prices(self):
        def scenario(k):
            clock = k.clock.FakeClock()
            a = k.backend.CloudBackend(clock=clock)
            b = k.backend.CloudBackend(clock=clock)
            assert a.spot_prices == b.spot_prices
            return sorted(a.spot_prices.items())

        both_once(scenario)


class TestImageFamilies:
    """Per-family bootstrap payloads (AL2-shell / Bottlerocket-TOML / GPU /
    Custom pass-through)."""

    @staticmethod
    def _resolve(k, sim, family, **kwargs):
        return sim.provider.launch_templates.resolve(
            family, "amd64", ["sg-default"], {"team": "a"}, [k.obj.Taint(key="d", value="x", effect="NoSchedule")], **kwargs
        )

    @staticmethod
    def _template(t) -> tuple:
        return (t.name, t.image_id, t.user_data, tuple(t.security_group_ids))

    def test_standard_family_shell_bootstrap_with_kubelet_flags(self):
        def scenario(k):
            sim = Sim(k)
            t = self._resolve(k, sim, "standard", kubelet=k.launchtemplate.KubeletArgs(max_pods=58, cluster_dns=["10.0.0.10"]))
            assert t.user_data.startswith("#!/bin/sh")
            assert "--max-pods=58" in t.user_data
            assert "--cluster-dns=10.0.0.10" in t.user_data
            assert "team=a" in t.user_data and "d=x:NoSchedule" in t.user_data
            return self._template(t)

        both_once(scenario)

    def test_minimal_family_declarative_settings(self):
        def scenario(k):
            t = self._resolve(k, Sim(k), "minimal")
            assert t.user_data.startswith("[settings.kubernetes]")
            assert '"team" = "a"' in t.user_data
            assert '"d" = "x:NoSchedule"' in t.user_data
            assert "#!/bin/sh" not in t.user_data
            return self._template(t)

        both_once(scenario)

    def test_gpu_family_enables_device_plugin(self):
        def scenario(k):
            t = self._resolve(k, Sim(k), "gpu")
            assert "enable-device-plugin" in t.user_data
            return self._template(t)

        both_once(scenario)

    def test_custom_family_passes_userdata_through(self):
        def scenario(k):
            t = self._resolve(k, Sim(k), "custom", image_id="img-mine", custom_user_data="my-exact-payload")
            assert t.image_id == "img-mine"
            assert t.user_data == "my-exact-payload"
            return self._template(t)

        both_once(scenario)

    def test_custom_family_requires_image(self):
        def scenario(k):
            with pytest.raises(ValueError, match="requires an explicit imageId") as raised:
                self._resolve(k, Sim(k), "custom")
            return str(raised.value)

        both_once(scenario)

    def test_image_discovery_versioned_per_arch(self):
        def scenario(k):
            fam = k.launchtemplate.get_image_family("standard")
            assert fam.image_id("amd64") != fam.image_id("arm64")
            assert fam.image_id("amd64", "1.29") != fam.image_id("amd64", "1.30")
            assert fam.image_id("amd64") == fam.image_id("amd64")  # deterministic
            return [fam.image_id("amd64"), fam.image_id("arm64"), fam.image_id("amd64", "1.29"), fam.image_id("amd64", "1.30")]

        both_once(scenario)


class TestNetworkProviders:
    def test_security_group_discovery_by_selector(self):
        def scenario(k):
            ids = Sim(k).provider.security_groups.resolve({"role": "node"})
            assert ids == ["sg-nodes"]
            return ids

        both_once(scenario)

    def test_explicit_security_group_ids_win(self):
        def scenario(k):
            ids = Sim(k).provider.security_groups.resolve({"role": "node"}, ["sg-x"])
            assert ids == ["sg-x"]
            return ids

        both_once(scenario)

    def test_no_selector_no_ids_defaults(self):
        def scenario(k):
            ids = Sim(k).provider.security_groups.resolve(None, [])
            assert ids == ["sg-default"]
            return ids

        both_once(scenario)

    def test_node_class_cr_admission(self):
        def scenario(k):
            sim = Sim(k)
            k.webhooks.register(sim.kube, sim.provider)
            with pytest.raises(k.webhooks.AdmissionError, match="requires image_id") as raised:
                sim.kube.create(k.provider.NodeClass(image_family="custom"))
            sim.kube.create(k.provider.NodeClass(image_family="minimal"))  # valid CR admitted
            return [str(raised.value), len(sim.kube.list("NodeClass"))]

        both_once(scenario)

    def test_security_group_cache_ttl(self):
        def scenario(k):
            sim = Sim(k)
            first = sim.provider.security_groups.resolve({"role": "node"})
            sim.backend.security_groups[1].tags["role"] = "other"
            cached = sim.provider.security_groups.resolve({"role": "node"})
            assert cached == ["sg-nodes"]
            sim.clock.step(61)
            with pytest.raises(RuntimeError, match="no security groups matched") as raised:
                sim.provider.security_groups.resolve({"role": "node"})  # refreshed: fail loud
            return [first, cached, str(raised.value)]

        both_once(scenario)

    def test_best_subnet_most_available_ips(self):
        def scenario(k):
            sim = Sim(k)
            sim.backend.subnets.append(
                k.backend.Subnet(subnet_id="subnet-big", zone="zone-a", available_ip_count=9999, tags={"discovery": "cluster"})
            )
            sim.provider.subnets.invalidate()
            best = sim.provider.subnets.best_for_zone("zone-a").subnet_id
            assert best == "subnet-big"
            return best

        both_once(scenario)


class TestNodeClassValidation:
    def test_valid_default(self):
        def scenario(k):
            errs = k.provider.validate_node_class(k.provider.NodeClass())
            assert errs == []
            return errs

        both_once(scenario)

    def test_bad_family(self):
        def scenario(k):
            errs = k.provider.validate_node_class(k.provider.NodeClass(image_family="alpine"))
            assert any("invalid image family" in e for e in errs)
            return errs

        both_once(scenario)

    def test_custom_contract(self):
        def scenario(k):
            NodeClass, validate = k.provider.NodeClass, k.provider.validate_node_class
            errs = [
                validate(NodeClass(image_family="custom")),
                validate(NodeClass(image_id="img-x")),
                validate(NodeClass(user_data="x")),
            ]
            assert any("requires image_id" in e for e in errs[0])
            assert any("only valid with the custom" in e for e in errs[1])
            assert any("only valid with the custom" in e for e in errs[2])
            return errs

        both_once(scenario)

    def test_selector_id_exclusivity(self):
        def scenario(k):
            nc = k.provider.NodeClass(security_group_ids=["sg-1"], security_group_selector={"role": "node"})
            errs = k.provider.validate_node_class(nc)
            assert any("mutually exclusive" in e for e in errs)
            return errs

        both_once(scenario)


class TestProviderAdmissionHooks:
    def test_defaulting_adds_capacity_type_and_arch(self):
        def scenario(k):
            sim = Sim(k)
            k.webhooks.register(sim.kube, sim.provider)
            p = k.make_provisioner()
            sim.kube.create(p)
            keys = {r.key: r.values for r in p.spec.requirements}
            assert keys[k.lbl.LABEL_CAPACITY_TYPE] == [k.lbl.CAPACITY_TYPE_ON_DEMAND]
            assert keys[k.lbl.LABEL_ARCH] == [k.lbl.ARCHITECTURE_AMD64]
            return sorted((key, list(values)) for key, values in keys.items())

        both_once(scenario)

    def test_user_requirements_not_overridden(self):
        def scenario(k):
            sim = Sim(k)
            k.webhooks.register(sim.kube, sim.provider)
            p = k.make_provisioner(
                requirements=[k.obj.NodeSelectorRequirement(key=k.lbl.LABEL_CAPACITY_TYPE, operator=k.obj.OP_IN, values=["spot"])]
            )
            sim.kube.create(p)
            values = [r.values for r in p.spec.requirements if r.key == k.lbl.LABEL_CAPACITY_TYPE]
            assert values == [["spot"]]
            return values

        both_once(scenario)

    def test_invalid_provider_config_rejected(self):
        def scenario(k):
            sim = Sim(k)
            k.webhooks.register(sim.kube, sim.provider)
            with pytest.raises(k.webhooks.AdmissionError, match="unknown provider config key") as first:
                sim.kube.create(k.make_provisioner(provider={"amiFamily": "AL2"}))
            with pytest.raises(k.webhooks.AdmissionError, match="invalid image family") as second:
                sim.kube.create(k.make_provisioner(name="p2", provider={"image_family": "alpine"}))
            return [str(first.value), str(second.value)]

        both_once(scenario)


class TestKubeletConfigFlow:
    def test_kubelet_args_reach_userdata(self):
        def scenario(k):
            sim = Sim(k)
            prov = k.make_provisioner()
            prov.spec.kubelet_configuration = k.api_provisioner.KubeletConfiguration(max_pods=42, cluster_dns=["10.1.0.10"])
            sim.kube.create(prov)
            types = sim.provider.get_instance_types(prov)
            sim.provider.create(sim.request(prov, types[:1]))
            payloads = [t.user_data for t in sim.backend.launch_templates.values()]
            assert any("--max-pods=42" in p and "--cluster-dns=10.1.0.10" in p for p in payloads)
            return sorted(payloads)

        both_once(scenario)

    def test_max_pods_wrapped_types_keep_arch_os_labels(self):
        def scenario(k):
            package = "karpenter_tpu" if k.side == "ref" else "karpenter_tpu_torch"
            builder = importlib.import_module(f"{package}.scheduler.builder")
            sim = Sim(k)
            prov = k.make_provisioner()
            prov.spec.kubelet_configuration = k.api_provisioner.KubeletConfiguration(max_pods=17)
            sim.kube.create(prov)
            types = builder.apply_kubelet_max_pods(prov, sim.provider.get_instance_types(prov))
            assert all(t.resources()["pods"] <= 17 for t in types)
            node = sim.provider.create(sim.request(prov, types[:1]))
            assert node.metadata.labels[k.lbl.LABEL_ARCH] in ("amd64", "arm64")
            assert node.metadata.labels[k.lbl.LABEL_OS] == k.lbl.OS_LINUX
            assert node.status.capacity["pods"] == 17
            return node_record(node)

        both_once(scenario)


# -- the `http` transport: tests/test_simulated_provider.py:33's second param --
# Each class again, every case that builds a Sim over the cloud API's
# sockets; the cases that build none are left out (set to None).


@pytest.mark.usefixtures("http_transport")
class TestCatalogOverHttp(TestCatalog):
    pass


@pytest.mark.usefixtures("http_transport")
class TestCreateOverHttp(TestCreate):
    pass


@pytest.mark.usefixtures("http_transport")
class TestNodeClassOverHttp(TestNodeClass):
    test_deterministic_spot_prices = None


@pytest.mark.usefixtures("http_transport")
class TestImageFamiliesOverHttp(TestImageFamilies):
    test_image_discovery_versioned_per_arch = None


@pytest.mark.usefixtures("http_transport")
class TestNetworkProvidersOverHttp(TestNetworkProviders):
    pass


@pytest.mark.usefixtures("http_transport")
class TestProviderAdmissionHooksOverHttp(TestProviderAdmissionHooks):
    pass


@pytest.mark.usefixtures("http_transport")
class TestKubeletConfigFlowOverHttp(TestKubeletConfigFlow):
    pass
