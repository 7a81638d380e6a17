"""The controller process's Runtime, held on both packages.

Every case runs on the JAX package's Runtime and on the port's (on the CPU,
`device="cpu"`) with the same inputs and the same checks:

- the two Runtime cases of tests/test_crossover.py: the auto-measured
  crossover patches the port's measure_dense_crossover only (the JAX
  package's side runs its explicit-value case with the same number), and
  an explicit dense_min_batch pins the routing;
- tests/test_runtime_stress.py's in-process cases: concurrent pod churn
  against a started Runtime, clean repeatable start/stop, and lifecycle
  churn with deprovisioning (three seeds);
- tests/test_leader_flap.py's steal and held-batch cases on the simulated
  cloud (the coherence witness off on both sides: the port has none yet);
- tests/test_kube_backend.py's TestInMemoryLeaseCAS;
- tests/test_crash_recovery.py's crash-and-restart smoke, in process;
- tests/test_pricing_refresh.py but the metrics decorator's case;
- all six cases of tests/test_logging.py, tests/test_validation.py's
  TestLiveConfig and tests/test_observability.py's probe cases;
- Options' environment fallback and validation.

The port's own: each option whose feature is not ported raises, naming its
ROADMAP item; the default device is the card, and without one the Runtime
raises; a loop, the post-election recovery or the batch loop that raises
makes healthy() false and stop() re-raise (the JAX package logs and goes
on: ROADMAP C).

Every wait has a deadline; every Runtime a test builds is stopped by the
`runtimes` fixture's finalizer; the JAX package's LeaderElector._leader is
reset and both packages' logging is put back after each test; the JAX package's
singletons are restored (reference_singletons), the residency auditor off.
"""

from __future__ import annotations

import copy
import logging
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.test_torch_provisioning import reference_singletons  # noqa: F401

SIDES = ("ref", "port")


@pytest.fixture(autouse=True)
def reference_auditor_off(reference_singletons):  # noqa: F811
    """The reference's residency auditor seeds random.Random with a tuple,
    which Python 3.12 rejects, so its dense solves would fall back to the
    host loop; it is disabled here and restored by reference_singletons."""
    from karpenter_tpu.solver.audit import AUDITOR

    AUDITOR.disable()
    yield


def _wait(predicate, timeout=8.0, period=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(period)
    return False


class RKit:
    """The Runtime-level classes and builders of one package."""

    def __init__(self, side: str):
        self.side = side
        if side == "ref":
            from karpenter_tpu import logsetup, runtime
            from karpenter_tpu.api import labels, objects
            from karpenter_tpu.cloudprovider import fake
            from karpenter_tpu.cloudprovider.simulated import backend, provider
            from karpenter_tpu.config import CONFIGMAP_NAME, Config, parse_duration, watch_config
            from karpenter_tpu.controllers.termination import TerminationController
            from karpenter_tpu.kube import cluster, leaderelection
            from karpenter_tpu.solver import dense
            from karpenter_tpu.utils import clock, options
            from tests import helpers
            from tests.env import Environment

            self.make_pod, self.make_provisioner, self.make_node = helpers.make_pod, helpers.make_provisioner, helpers.make_node
            self.root = "karpenter_tpu"
        else:
            from karpenter_tpu_torch import logsetup, runtime, testing
            from karpenter_tpu_torch.api import labels, objects
            from karpenter_tpu_torch.cloudprovider import fake
            from karpenter_tpu_torch.cloudprovider.simulated import backend, provider
            from karpenter_tpu_torch.config import CONFIGMAP_NAME, Config, parse_duration, watch_config
            from karpenter_tpu_torch.controllers.termination import TerminationController
            from karpenter_tpu_torch.kube import cluster, leaderelection
            from karpenter_tpu_torch.solver import dense
            from karpenter_tpu_torch.testing import Environment
            from karpenter_tpu_torch.utils import clock, options

            self.make_pod, self.make_provisioner, self.make_node = testing.make_pod, testing.make_provisioner, testing.make_node
            self.root = "karpenter_tpu_torch"
        self.logsetup, self.runtime, self.labels, self.objects = logsetup, runtime, labels, objects
        self.fake, self.backend, self.provider, self.cluster = fake, backend, provider, cluster
        self.leaderelection, self.dense, self.clock, self.options = leaderelection, dense, clock, options
        self.CONFIGMAP_NAME, self.Config, self.parse_duration, self.watch_config = CONFIGMAP_NAME, Config, parse_duration, watch_config
        self.TerminationController, self.Environment = TerminationController, Environment

    def Options(self, **kw):
        return self.options.Options(**kw)

    def KubeCluster(self, clock=None):
        return self.cluster.KubeCluster(clock=clock)

    def fake_provider(self, n: int):
        return self.fake.FakeCloudProvider(self.fake.instance_types(n))

    def simulated(self, kube, clock=None):
        """(backend, provider) of the simulated cloud on `kube`."""
        clock = clock or kube.clock
        backend = self.backend.CloudBackend(clock=clock)
        return backend, self.provider.SimulatedCloudProvider(backend=backend, kube=kube, clock=clock)

    def build(self, kube, provider, **options):
        """A Runtime of this package; the port's runs on the CPU."""
        extra = {"device": "cpu"} if self.side == "port" else {}
        return self.runtime.Runtime(kube=kube, cloud_provider=provider, options=self.Options(**options), **extra)

    def configmap(self, namespace="karpenter", name=None, **data):
        objects = self.objects
        return objects.ConfigMap(metadata=objects.ObjectMeta(name=name or self.CONFIGMAP_NAME, namespace=namespace), data=data)


@pytest.fixture(autouse=True)
def _process_state():
    """Put back what a Runtime leaves process-wide: the JAX package's
    in-process leader and both packages' log handler and level."""
    yield
    from karpenter_tpu.runtime import LeaderElector

    LeaderElector._leader = None
    for side in SIDES:
        kit = RKit(side)
        kit.logsetup.reset_for_tests()
        kit.logsetup.set_level("info")


@pytest.fixture
def runtimes():
    """`make(kit, kube, provider, **options)` builds a Runtime; every one
    still running at the end is stopped."""
    made = []

    def make(kit, kube, provider, **options):
        rt = kit.build(kube, provider, **options)
        made.append(rt)
        return rt

    yield make
    for rt in made:
        if not rt._stop.is_set():
            rt.stop()


@pytest.fixture(params=SIDES)
def kit(request):
    return RKit(request.param)


# -- tests/test_crossover.py:63, :81 ------------------------------------------


def test_runtime_auto_measures_when_unset(kit, monkeypatch):
    """Port: dense_min_batch=0 reaches the port's measure_dense_crossover,
    on the Runtime's device. JAX package: its explicit-value case with the
    same number (its auto-measure is tests/test_crossover.py's own)."""
    clock = kit.clock.FakeClock()
    if kit.side == "port":
        seen = {}

        def measured(**kw):
            seen.update(kw)
            return 512

        monkeypatch.setattr(kit.dense, "measure_dense_crossover", measured)
        rt = kit.build(kit.KubeCluster(clock=clock), kit.fake_provider(3), leader_elect=False, dense_min_batch=0)
        assert seen == {"device": "cpu"}
    else:
        rt = kit.build(kit.KubeCluster(clock=clock), kit.fake_provider(3), leader_elect=False, dense_min_batch=512)
    assert rt.dense_solver.min_batch == 512


def test_runtime_explicit_value_pins_routing(kit):
    clock = kit.clock.FakeClock()
    rt = kit.build(kit.KubeCluster(clock=clock), kit.fake_provider(3), leader_elect=False, dense_min_batch=77)
    assert rt.dense_solver.min_batch == 77


def test_port_runtime_measures_with_k1_probe_on_its_device():
    """Unpatched: the probe is K1's wrapper on the CPU (its plain version),
    far below the floor's worth of host time, so the floor."""
    kit = RKit("port")
    rt = kit.build(kit.KubeCluster(clock=kit.clock.FakeClock()), kit.fake_provider(3), leader_elect=False, dense_min_batch=0)
    assert rt.dense_solver.min_batch == kit.dense.CROSSOVER_FLOOR
    assert rt.dense_solver.device.type == "cpu"


@pytest.mark.parametrize("min_batch", [0, 77])
def test_port_runtime_defaults_to_the_card(monkeypatch, min_batch):
    import torch

    from karpenter_tpu_torch.runtime import Runtime

    kit = RKit("port")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runtime(kube=kit.KubeCluster(), cloud_provider=kit.fake_provider(3), options=kit.Options(leader_elect=False, dense_min_batch=min_batch))


# -- tests/test_runtime_stress.py:47, :109, :132 ------------------------------

POD_WRITERS = 4
PODS_PER_WRITER = 25


def _jitter():
    time.sleep(random.uniform(0, 0.002))


def test_runtime_converges_under_concurrent_pod_churn(kit, runtimes, caplog):
    kube = kit.KubeCluster()
    runtime = runtimes(kit, kube, kit.fake_provider(10), batch_max_duration=0.3, batch_idle_duration=0.05, leader_elect=True)
    kube.create(kit.make_provisioner())
    runtime.start()
    errors: list = []
    deleted_uids: set = set()
    lock = threading.Lock()

    def writer(wid: int):
        rng = random.Random(wid)
        try:
            created = []
            for i in range(PODS_PER_WRITER):
                _jitter()
                pod = kit.make_pod(name=f"churn-{wid}-{i}", requests={"cpu": rng.choice([0.25, 0.5, 1.0])})
                kube.create(pod)
                created.append(pod)
                # a fraction of pods is deleted mid-flight (churn)
                if rng.random() < 0.2:
                    _jitter()
                    victim = created.pop(rng.randrange(len(created)))
                    kube.delete(victim)
                    with lock:
                        deleted_uids.add(victim.uid)
        except Exception as exc:  # noqa: BLE001 - surfaced by the assertion below
            errors.append(exc)

    with caplog.at_level(logging.ERROR, logger=kit.root):
        threads = [threading.Thread(target=writer, args=(w,)) for w in range(POD_WRITERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads), "writer thread hung"
        assert not errors, errors

        def converged():
            pending = [p for p in kube.list_pods() if p.uid not in deleted_uids and not p.spec.node_name]
            nominated = {e.object_name for e in runtime.recorder.of("NominatePod")}
            return all(p.name in nominated for p in pending)

        assert _wait(converged, timeout=30, period=0.05), "stress run did not converge"
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR]
    assert runtime.healthy()
    assert all(t.is_alive() for t in runtime._threads)


def test_runtime_start_stop_is_clean_and_repeatable(kit, runtimes):
    for _ in range(2):
        kube = kit.KubeCluster()
        rt = runtimes(kit, kube, kit.fake_provider(4), batch_max_duration=0.2, batch_idle_duration=0.05)
        kube.create(kit.make_provisioner())
        rt.start()
        kube.create(kit.make_pod(requests={"cpu": 0.5}))
        time.sleep(0.5)
        rt.stop()
        assert not rt.healthy()  # stopped runtimes report unhealthy
        assert all(not t.is_alive() for t in rt._threads)
        if kit.side == "ref":
            kit.runtime.LeaderElector._leader = None


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_lifecycle_churn_with_deprovisioning(kit, runtimes, seed):
    kube = kit.KubeCluster()
    rt = runtimes(
        kit, kube, kit.fake_provider(6),
        batch_max_duration=0.2, batch_idle_duration=0.05, leader_elect=False, dense_solver_enabled=False,
    )
    kube.create(kit.make_provisioner(consolidation_enabled=True))
    rt.start()
    rng = random.Random(seed)
    pods = []
    for i in range(40):
        pod = kit.make_pod(name=f"life-{seed}-{i}", requests={"cpu": rng.choice([0.25, 0.5])})
        kube.create(pod)
        pods.append(pod)
        if rng.random() < 0.3:
            time.sleep(rng.uniform(0, 0.003))
    # let provisioning land, then delete most pods so emptiness +
    # consolidation + termination all get real work mid-churn
    assert _wait(lambda: bool(kube.list_nodes()), timeout=20, period=0.05), "no nodes provisioned under churn"
    for pod in pods[: len(pods) * 3 // 4]:
        kube.delete(pod, grace=False)
        if rng.random() < 0.2:
            time.sleep(rng.uniform(0, 0.002))
    for _ in range(40):
        rt.reconcile_once()
        time.sleep(0.05)
    assert rt.healthy()
    assert all(t.is_alive() for t in rt._threads)


# -- tests/test_leader_flap.py:68, :86 ----------------------------------------


@pytest.fixture
def flap_stack(kit, runtimes):
    kube = kit.KubeCluster()
    backend, provider = kit.simulated(kube)
    runtime = runtimes(
        kit, kube, provider,
        leader_elect=True, lease_duration=1.0, lease_renew_period=0.05,
        batch_max_duration=0.2, batch_idle_duration=0.05, dense_solver_enabled=False,
        gc_interval=0.5, gc_registration_grace=2.0, coherence_interval=0.0,
    )
    return kit, kube, backend, runtime


class TestLeaderFlap:
    def test_steal_pauses_gate_then_recovery_reopens(self, flap_stack):
        kit, kube, backend, runtime = flap_stack
        runtime.start()
        assert runtime._may_act()
        assert kit.leaderelection.steal_lease(kube, identity="thief")
        assert _wait(lambda: not runtime._may_act()), "the gate must close on the lost transition"
        assert not runtime.elector.is_leader()
        assert _wait(lambda: runtime._may_act(), timeout=10.0), "re-election must re-open the gate"
        assert runtime.elector.is_leader()
        lease = kube.get("Lease", runtime.elector.name, runtime.elector.namespace)
        assert lease.spec.holder_identity == runtime.elector.identity
        assert lease.spec.lease_transitions >= 2  # the steal + the re-acquisition
        if kit.side == "port":
            assert runtime.elector.flaps == 1

    def test_deposed_provisioner_holds_batch_until_reelected(self, flap_stack):
        kit, kube, backend, runtime = flap_stack
        kube.create(kit.make_provisioner("default"))
        runtime.start()
        assert kit.leaderelection.steal_lease(kube, identity="thief")
        assert _wait(lambda: not runtime._may_act())
        instances_at_depose = len(backend.instances)
        for i in range(3):
            kube.create(kit.make_pod(f"flap-pod-{i}", requests={"cpu": 0.5}))
        time.sleep(0.5)
        assert len(backend.instances) == instances_at_depose, "a deposed leader must not launch"
        assert _wait(lambda: runtime._may_act(), timeout=10.0)
        assert _wait(lambda: len(backend.instances) > instances_at_depose, timeout=15.0), (
            "the held batch must launch once re-elected"
        )
        assert backend.double_launches() == 0


# -- tests/test_kube_backend.py:384 -------------------------------------------


def test_in_memory_backend_preserves_mutual_exclusion(kit):
    kube = kit.KubeCluster()
    a = kit.leaderelection.LeaseElector(kube, "a", lease_duration=60.0)
    b = kit.leaderelection.LeaseElector(kube, "b", lease_duration=60.0)
    assert a.try_acquire_or_renew()
    assert not b.try_acquire_or_renew()  # held and unexpired
    # stale-write race: both read, then both write — exactly one lands
    lease_a = copy.deepcopy(kube.get("Lease", a.name, a.namespace))
    lease_b = copy.deepcopy(kube.get("Lease", b.name, b.namespace))
    lease_a.spec.renew_time = 1.0
    kube.update_no_retry(lease_a)
    lease_b.spec.holder_identity = "b"
    with pytest.raises(kit.cluster.Conflict):
        kube.update_no_retry(lease_b)


# -- tests/test_crash_recovery.py:63[inprocess] -------------------------------


def _rs_pod(kit):
    pod = kit.make_pod(requests={"cpu": "1", "memory": "1Gi"})
    pod.metadata.owner_references.append(kit.objects.OwnerReference(kind="ReplicaSet", name="rs"))
    return pod


def _leak_instance(kit, backend) -> str:
    template = backend.ensure_launch_template("crash-leak", "img", [], "")
    spec = kit.backend.FleetInstanceSpec(
        instance_type=backend.catalog[0].name, zone="zone-a", capacity_type="on-demand", launch_template_id=template.template_id
    )
    return backend.create_fleet(kit.backend.FleetRequest(specs=[spec], capacity_type="on-demand")).instance.instance_id


def test_crash_restart_reconciles_leak_and_ghost(kit, runtimes):
    objects, lbl = kit.objects, kit.labels
    kube = kit.KubeCluster()
    backend, provider = kit.simulated(kube)
    options = dict(
        leader_elect=False, dense_solver_enabled=False, batch_max_duration=0.3, batch_idle_duration=0.05,
        gc_interval=0.3, gc_registration_grace=0.8,
    )
    kube.create(kit.make_provisioner(requirements=[
        objects.NodeSelectorRequirement(key=lbl.LABEL_CAPACITY_TYPE, operator=objects.OP_IN, values=["spot", "on-demand"])
    ]))
    runtime = runtimes(kit, kube, provider, **options)
    runtime.start()
    pod = _rs_pod(kit)
    kube.create(pod)
    runtime.provision_once()
    node = kube.list_nodes()[0]
    node.status.conditions = [objects.NodeCondition(type="Ready", status="True")]
    kube.update(node)
    kube.bind_pod(pod, node.name)
    healthy_instance = node.spec.provider_id.split("///", 1)[1]
    # a second node that will go ghost: provision for a throwaway pod
    pod2 = _rs_pod(kit)
    kube.create(pod2)
    runtime.provision_once()
    ghost = next(n for n in kube.list_nodes() if n.name != node.name)
    kube.delete(pod2, grace=False)
    # mid-provision crash artifacts: an instance launched with no node, and
    # the ghost's instance dying out-of-band
    leaked = _leak_instance(kit, backend)
    backend.terminate_instance(ghost.spec.provider_id.split("///", 1)[1])
    time.sleep(0.9)  # age the leak past the registration grace
    runtime.crash()  # kill -9: no graceful cleanup, loops just stop

    successor = runtimes(kit, kube, provider, **options)
    successor.start()  # startup reconstruction: resync + recovery + GC sweep

    def registered():
        return {n.spec.provider_id.split("///", 1)[1] for n in kube.list_nodes() if n.spec.provider_id}

    _wait(
        lambda: not backend.instance_exists(leaked) and kube.get_node(ghost.name) is None and set(backend.instances) == registered(),
        timeout=10.0, period=0.1,
    )
    assert not backend.instance_exists(leaked), "the mid-provision leak must be terminated"
    assert kube.get_node(ghost.name) is None, "the ghost node must be finalized"
    assert set(backend.instances) == registered()
    survivor = kube.get_node(node.name)
    assert survivor is not None and survivor.metadata.deletion_timestamp is None
    assert backend.instance_exists(healthy_instance)
    fresh_pod = kube.get("Pod", pod.metadata.name, namespace=pod.metadata.namespace)
    assert fresh_pod is not None and fresh_pod.spec.node_name == node.name
    assert successor.ready()


# -- tests/test_pricing_refresh.py:48, :57, :75, :86, :91 ---------------------


def _pricing_runtime(kit, runtimes, **opts):
    clock = kit.clock.FakeClock()
    kube = kit.KubeCluster(clock=clock)
    backend, provider = kit.simulated(kube, clock)
    return runtimes(kit, kube, provider, leader_elect=False, dense_solver_enabled=False, **opts), backend, provider


def _od_price_of(kit, provider, type_name):
    types = provider.get_instance_types(kit.make_provisioner())
    it = next(t for t in types if t.name() == type_name)
    return min(o.price for o in it.offerings() if o.capacity_type == "on-demand")


class TestPricingRefresh:
    def test_backend_price_change_propagates_on_tick(self, kit, runtimes):
        runtime, backend, provider = _pricing_runtime(kit, runtimes)
        name = backend.catalog[0].name
        before = _od_price_of(kit, provider, name)
        backend.od_prices[name] = before * 10
        assert runtime.refresh_pricing_once() is True
        assert _od_price_of(kit, provider, name) == pytest.approx(before * 10)

    def test_unchanged_books_do_not_invalidate_catalog(self, kit, runtimes):
        runtime, backend, provider = _pricing_runtime(kit, runtimes)
        provider.get_instance_types(kit.make_provisioner())  # populate cache
        catalog_builds = provider.catalog.builds if hasattr(provider.catalog, "builds") else None
        assert runtime.refresh_pricing_once() is False
        if catalog_builds is not None:
            provider.get_instance_types(kit.make_provisioner())
            assert provider.catalog.builds == catalog_builds

    def test_provider_without_price_books_is_noop(self, kit, runtimes):
        runtime = runtimes(kit, kit.KubeCluster(clock=kit.clock.FakeClock()), kit.fake_provider(5), leader_elect=False, dense_solver_enabled=False)
        assert runtime.refresh_pricing_once() is False

    def test_refresh_error_is_contained(self, kit, runtimes, monkeypatch):
        runtime, backend, provider = _pricing_runtime(kit, runtimes)
        monkeypatch.setattr(provider.pricing, "refresh", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
        assert runtime.refresh_pricing_once() is False  # logged, loop survives

    def test_follower_never_refreshes(self, kit, runtimes):
        """Two runtimes against one kube backend: only the one holding the
        Lease starts its loops; the follower's start() blocks on election."""
        clock = kit.clock.FakeClock()
        kube = kit.KubeCluster(clock=clock)
        backend = kit.backend.CloudBackend(clock=clock)
        leader_provider = kit.provider.SimulatedCloudProvider(backend=backend, kube=kube, clock=clock)
        follower_provider = kit.provider.SimulatedCloudProvider(backend=backend, kube=kube, clock=clock)
        opts = dict(dense_solver_enabled=False, pricing_refresh_period=0.05, leader_elect=True)
        leader = runtimes(kit, kube, leader_provider, **opts)
        follower = runtimes(kit, kube, follower_provider, **opts)
        leader.start()
        follower_thread = threading.Thread(target=follower.start, daemon=True)
        follower_thread.start()
        try:
            baseline_follower = follower_provider.pricing.refreshes
            baseline_leader = leader_provider.pricing.refreshes
            assert _wait(lambda: leader_provider.pricing.refreshes > baseline_leader, timeout=3.0), "the leader's loop must tick"
            assert follower_provider.pricing.refreshes == baseline_follower, "a follower must never refresh"
        finally:
            follower.stop()
            leader.stop()
            follower_thread.join(timeout=5)
        assert not follower_thread.is_alive()


# -- tests/test_logging.py ----------------------------------------------------


class TestLogging:
    def test_configure_is_idempotent_and_scoped(self, kit):
        root = kit.logsetup.configure("info")
        kit.logsetup.configure("info")
        assert len(root.handlers) == 1
        assert root.propagate is False  # embedding apps keep their own topology
        assert logging.getLogger().handlers == [] or root not in logging.getLogger().handlers

    def test_get_logger_namespaces_short_names(self, kit):
        assert kit.logsetup.get_logger("provisioning").name == f"{kit.root}.provisioning"
        assert kit.logsetup.get_logger(f"{kit.root}.solver").name == f"{kit.root}.solver"

    def test_set_level_relevels_the_tree(self, kit):
        kit.logsetup.configure("info")
        child = kit.logsetup.get_logger("provisioning")
        assert not child.isEnabledFor(logging.DEBUG)
        kit.logsetup.set_level("debug")
        assert child.isEnabledFor(logging.DEBUG)
        kit.logsetup.set_level("bogus")  # bad value falls back to info, never raises
        assert kit.logsetup.current_level() == "info"

    def test_config_live_reload_drives_log_level(self, kit):
        kit.logsetup.configure("info")
        config = kit.Config()
        config.on_change(lambda cfg: kit.logsetup.set_level(cfg.log_level))
        config.update(log_level="debug")
        assert kit.logsetup.current_level() == "debug"
        config.update(log_level="warning")
        assert kit.logsetup.current_level() == "warning"

    def test_provisioning_round_logs_summary(self, kit, caplog):
        env = kit.Environment()
        env.kube.create(kit.make_provisioner())
        env.kube.create(kit.make_pod(requests={"cpu": 1}))
        with caplog.at_level(logging.INFO, logger=kit.root):
            env.provision()
        assert any("provisioned batch" in r.getMessage() for r in caplog.records)

    def test_termination_logs_node_teardown(self, kit, caplog):
        env = kit.Environment()
        env.kube.create(kit.make_provisioner())
        env.kube.create(kit.make_pod(requests={"cpu": 1}))
        env.provision()
        termination = kit.TerminationController(env.kube, env.provider, env.recorder, clock=env.clock)
        node = env.kube.list_nodes()[0]
        env.kube.delete(node)
        with caplog.at_level(logging.INFO, logger=kit.root):
            termination.reconcile_all()
        assert any("terminated node" in r.getMessage() for r in caplog.records)


# -- tests/test_validation.py TestLiveConfig, test_observability.py -----------


class TestLiveConfig:
    def test_parse_duration(self, kit):
        assert kit.parse_duration("10s") == 10.0
        assert kit.parse_duration("500ms") == 0.5
        assert kit.parse_duration("1.5m") == 90.0
        assert kit.parse_duration("2") == 2.0
        with pytest.raises(ValueError):
            kit.parse_duration("nope")

    def _watched(self, kit, **config):
        kube, cfg = kit.KubeCluster(), kit.Config(**config)
        kit.watch_config(kube, cfg)
        return kube, cfg

    def test_configmap_drives_config(self, kit):
        kube, config = self._watched(kit)
        kube.create(kit.configmap(batchMaxDuration="5s", batchIdleDuration="200ms", logLevel="debug"))
        assert (config.batch_max_duration, config.batch_idle_duration, config.log_level) == (5.0, 0.2, "debug")

    def test_missing_keys_fall_back_to_launch_config(self, kit):
        kube, config = self._watched(kit, batch_max_duration=99.0)
        kube.create(kit.configmap(batchIdleDuration="2s"))
        assert (config.batch_max_duration, config.batch_idle_duration) == (99.0, 2.0)

    def test_nonpositive_and_inverted_durations_rejected(self, kit):
        kube, config = self._watched(kit)
        cm = kit.configmap(batchMaxDuration="-5s")
        kube.create(cm)
        assert config.batch_max_duration == 10.0  # negative rejected
        cm.data = {"batchIdleDuration": "30s", "batchMaxDuration": "5s"}
        kube.update(cm)
        assert (config.batch_idle_duration, config.batch_max_duration) == (1.0, 10.0)  # idle > max rejected as a pair

    def test_hash_dedupe_suppresses_redundant_notifications(self, kit):
        kube, config = self._watched(kit)
        changes = []
        config.on_change(lambda c: changes.append(c.batch_max_duration))
        cm = kit.configmap(batchMaxDuration="5s")
        kube.create(cm)
        kube.update(cm)  # identical content: suppressed by the content hash
        cm.data["batchMaxDuration"] = "7s"
        kube.update(cm)
        assert changes == [5.0, 7.0]

    def test_invalid_value_keeps_previous(self, kit):
        kube, config = self._watched(kit)
        cm = kit.configmap(batchMaxDuration="5s")
        kube.create(cm)
        cm.data["batchMaxDuration"] = "garbage"
        cm.data["batchIdleDuration"] = "300ms"
        kube.update(cm)
        assert (config.batch_max_duration, config.batch_idle_duration) == (5.0, 0.3)

    @pytest.mark.parametrize("namespace,name", [("x", "unrelated"), ("attacker", None)])
    def test_other_configmaps_ignored(self, kit, namespace, name):
        kube, config = self._watched(kit)
        kube.create(kit.configmap(namespace=namespace, name=name, batchMaxDuration="1s"))
        assert config.batch_max_duration == 10.0

    def test_invalid_log_level_keeps_previous(self, kit):
        kube, config = self._watched(kit, log_level="debug")
        kube.create(kit.configmap(logLevel="trace"))
        assert config.log_level == "debug"

    def test_deletion_restores_defaults(self, kit):
        kube, config = self._watched(kit)
        cm = kit.configmap(batchMaxDuration="5s")
        kube.create(cm)
        assert config.batch_max_duration == 5.0
        kube.delete(cm)
        assert config.batch_max_duration == 10.0  # launch-time value restored

    def test_configmap_namespace_follows_env(self, kit, monkeypatch):
        monkeypatch.setenv("SYSTEM_NAMESPACE", "my-system")
        kube, config = self._watched(kit)
        kube.create(kit.configmap(namespace="my-system", batchIdleDuration="3s"))
        assert config.batch_idle_duration == 3.0
        kube.create(kit.configmap(batchIdleDuration="9s"))
        assert config.batch_idle_duration == 3.0

    def test_runtime_relevels_logs_from_the_configmap(self, kit, runtimes):
        kube = kit.KubeCluster(clock=kit.clock.FakeClock())
        runtimes(kit, kube, kit.fake_provider(3), leader_elect=False, dense_solver_enabled=False)
        assert kit.logsetup.current_level() == "info"
        kube.create(kit.configmap(logLevel="debug"))
        assert kit.logsetup.current_level() == "debug"


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


class TestProbes:
    def _server(self, side, state):
        if side == "ref":
            from karpenter_tpu.observability import ObservabilityServer

            return ObservabilityServer(healthy=lambda: state["healthy"], ready=lambda: state["ready"], health_port=0, metrics_port=None, host="127.0.0.1")
        from karpenter_tpu_torch.observability import ObservabilityServer

        return ObservabilityServer(healthy=lambda: state["healthy"], ready=lambda: state["ready"], health_port=0, host="127.0.0.1")

    @pytest.mark.parametrize("side", SIDES)
    def test_probes(self, side):
        state = {"healthy": True, "ready": False}
        server = self._server(side, state)
        server.start()
        (port,) = server.ports
        try:
            got = [_get(port, "/healthz"), _get(port, "/readyz")[0]]
            state["ready"] = True
            got.append(_get(port, "/readyz"))
            state["healthy"] = False
            got += [_get(port, "/healthz")[0], _get(port, "/nope")[0]]
        finally:
            server.stop()
        assert got == [(200, "ok\n"), 503, (200, "ok\n"), 503, 404]

    def test_disabled_port_binds_nothing(self):
        from karpenter_tpu_torch.observability import ObservabilityServer

        server = ObservabilityServer(healthy=lambda: True, ready=lambda: True, health_port=None)
        assert server.ports == []
        server.start()
        server.stop()


# -- Options ------------------------------------------------------------------


def _fields(options) -> dict:
    return dict(vars(options))


def test_options_defaults_and_flags_match(monkeypatch):
    ref, port = RKit("ref"), RKit("port")
    assert _fields(ref.options.Options()) == _fields(port.options.Options())
    argv = ["--batch-idle-duration", "0.5", "--no-leader-elect", "--dense-min-batch", "64", "--solver-incremental", "--gc-interval", "3"]
    assert _fields(ref.options.parse(argv)) == _fields(port.options.parse(argv))


@pytest.mark.parametrize("env,value,field", [
    ("BATCH_IDLE_DURATION", "0.25", "batch_idle_duration"),
    ("LEADER_ELECT", "false", "leader_elect"),
    ("DENSE_MIN_BATCH", "128", "dense_min_batch"),
    ("SOLVER_SERVICE_ADDRESS", "127.0.0.1:7473", "solver_service_address"),
    ("LOG_LEVEL", "debug", "log_level"),
])
def test_options_env_fallback(monkeypatch, env, value, field):
    monkeypatch.setenv(env, value)
    ref, port = (getattr(RKit(side).options.parse([]), field) for side in SIDES)
    assert ref == port != getattr(RKit("port").Options(), field)


@pytest.mark.parametrize("bad", [
    {"batch_idle_duration": 20.0},
    {"lease_renew_period": 30.0},
    {"log_level": "trace"},
    {"ice_backoff_seconds": 0.0},
    {"solver_hbm_budget_bytes": -1},
    {"health_probe_port": 0, "metrics_port": 70000},
])
def test_options_validation_rejects(bad):
    ref, port = (RKit(side).Options(**bad).validate() for side in SIDES)
    assert ref == port and port


@pytest.mark.parametrize("side", SIDES)
def test_options_parse_exits_on_invalid_flags(side, capsys):
    with pytest.raises(SystemExit):
        RKit(side).options.parse(["--batch-idle-duration", "20"])
    assert "batch durations must satisfy" in capsys.readouterr().err


def test_options_bad_env_value_exits(monkeypatch):
    monkeypatch.setenv("DENSE_MIN_BATCH", "lots")
    for side in SIDES:
        with pytest.raises(SystemExit, match="DENSE_MIN_BATCH"):
            RKit(side).options.parse([])


# -- the port's own -----------------------------------------------------------


@pytest.mark.parametrize("option,value,item", [
    ("enable_tracing", True, "A8"),
    ("enable_solver_telemetry", True, "A8"),
    ("enable_journal", True, "A8"),
    ("enable_capsules", True, "A8"),
    ("enable_slo", True, "A8"),
    ("enable_lock_witness", True, "A8"),
    ("enable_profiling", True, "A8"),
    ("invariants_interval", 1.0, "A8"),
    ("coherence_interval", 1.0, "A7"),
    ("solver_hbm_budget_bytes", 1 << 30, "A7"),
    ("solver_breaker_threshold", 5, "A7"),
    ("solver_breaker_backoff", 60.0, "A7"),
])
def test_unported_option_raises_naming_its_item(option, value, item):
    kit = RKit("port")
    with pytest.raises(NotImplementedError, match=f"{option}: .*ROADMAP {item}"):
        kit.build(kit.KubeCluster(), kit.fake_provider(3), leader_elect=False, dense_solver_enabled=False, **{option: value})


class TestNoHiddenFailure:
    """A loop that raises ends; healthy() turns false and stop() re-raises
    the first such exception (the JAX package logs it and loops on)."""

    def test_a_loop_that_raises_fails_health_and_stop(self, runtimes):
        kit = RKit("port")
        kube = kit.KubeCluster()
        rt = runtimes(kit, kube, kit.fake_provider(3), leader_elect=False, dense_solver_enabled=False)

        def boom():
            raise RuntimeError("node pass failed")

        rt.node_controller.reconcile_all = boom
        rt.start()
        assert rt.healthy()
        assert _wait(lambda: not rt.healthy(), timeout=5.0), "a dead loop must fail the liveness probe"
        assert not [t for t in rt._threads if t.name == "node-lifecycle" and t.is_alive()]
        with pytest.raises(RuntimeError, match="node pass failed"):
            rt.stop()
        assert not [t for t in rt.threads() if t.is_alive()]

    def test_a_failed_recovery_is_not_swallowed(self, runtimes):
        kit = RKit("port")
        kube = kit.KubeCluster()
        rt = runtimes(kit, kube, kit.fake_provider(3), leader_elect=True, lease_renew_period=0.05, dense_solver_enabled=False)

        def boom():
            raise RuntimeError("gc sweep failed")

        rt.gc.reconcile = boom
        rt.start()  # returns: elected, but the recovery raised
        assert not rt.healthy() and not rt._may_act(), "the gate stays closed"
        assert rt.provisioner.thread is None, "no loop starts after a failed recovery"
        with pytest.raises(RuntimeError, match="gc sweep failed"):
            rt.stop()
        lease = kube.get("Lease", rt.elector.name, rt.elector.namespace)
        assert lease.spec.renew_time == 0.0, "the lease is released"

    def test_a_failed_recovery_without_election_raises_from_start(self, runtimes):
        kit = RKit("port")
        rt = runtimes(kit, kit.KubeCluster(), kit.fake_provider(3), leader_elect=False, dense_solver_enabled=False)

        def boom():
            raise RuntimeError("gc sweep failed")

        rt.gc.reconcile = boom
        with pytest.raises(RuntimeError, match="gc sweep failed"):
            rt.start()

    def test_a_failed_round_fails_health_and_stop(self, runtimes, monkeypatch):
        """A solve that raises inside the batch loop (a kernel wrapper made
        to raise) ends the loop; the runtime reports it."""
        import karpenter_tpu_torch.solver.dense as dense

        kit = RKit("port")
        kube = kit.KubeCluster()
        rt = runtimes(kit, kube, kit.fake_provider(6), leader_elect=False, dense_min_batch=1, batch_idle_duration=0.05, batch_max_duration=0.2)

        def failing(*args, **kwargs):
            raise RuntimeError("K1 launch failed")

        monkeypatch.setattr(dense, "bucket_cost_packed", failing)
        kube.create(kit.make_provisioner())
        rt.start()
        for _ in range(3):
            kube.create(kit.make_pod(requests={"cpu": 0.5}))
        assert _wait(lambda: not rt.healthy(), timeout=5.0)
        with pytest.raises(RuntimeError, match="K1 launch failed"):
            rt.stop()
        assert not kube.list_nodes()


def test_stop_joins_every_thread_and_releases_the_lease(runtimes):
    kit = RKit("port")
    kube = kit.KubeCluster()
    rt = runtimes(kit, kube, kit.fake_provider(3), leader_elect=True, lease_renew_period=0.05, dense_solver_enabled=False, gc_interval=0.2)
    rt.start()
    names = {t.name for t in rt.threads()}
    assert {"provisioner", "node-lifecycle", "gc", "disruption", "pricing-refresh", "leader-recovery"} <= names
    assert _wait(lambda: rt.passes.get("gc", 0) >= 2, timeout=5.0), "the gc loop sweeps after the startup sweep"
    rt.stop()
    assert not [t.name for t in rt.threads() if t.is_alive()]
    lease = kube.get("Lease", rt.elector.name, rt.elector.namespace)
    assert lease.spec.holder_identity == rt.elector.identity and lease.spec.renew_time == 0.0
