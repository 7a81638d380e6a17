"""The metrics registry, the scrapers and the provider decorator on the port.

- tests/test_runtime_metrics.py as written on the port (a port copy of the
  module through `port_copy`; TestProfilingSeam's Runtime on the CPU), but
  for test_leader_election_exclusive, which tests the JAX package's
  in-process LeaderElector, which the port's Runtime does not have (it
  elects through the Lease only);
- tests/test_pricing_refresh.py's refresh through the metrics-decorated
  provider (`test_refresh_counts_via_metrics_decorated_provider`).
"""

from __future__ import annotations

from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_scheduler_catalog import port_copy
from tests.test_torch_tracing import port_telemetry, without  # noqa: F401

_METRICS = port_copy(
    "test_runtime_metrics",
    extra=(
        ("from tests.test_deprovisioning import DeprovEnv, owned_pod", "from karpenter_tpu_torch.testing import DeprovEnv, owned_pod"),
        ("from tests.env import Environment", "from karpenter_tpu_torch.testing import Environment"),
        ("from karpenter_tpu_torch.runtime import LeaderElector, Runtime", "from karpenter_tpu_torch.runtime import Runtime"),
        ("            options=Options(enable_profiling=True),\n", '            options=Options(enable_profiling=True),\n            device="cpu",\n'),
        ("            LeaderElector._leader = None\n", ""),
    ),
)
TestRuntime = without(_METRICS.TestRuntime, "test_leader_election_exclusive")
TestMetricsRegistry = _METRICS.TestMetricsRegistry
TestScrapers = _METRICS.TestScrapers
TestOptions = _METRICS.TestOptions
TestDeprovisioningMetricFamilies = _METRICS.TestDeprovisioningMetricFamilies
TestProfilingSeam = _METRICS.TestProfilingSeam

_PRICING = port_copy("test_pricing_refresh")
clock = _PRICING.clock
backend = _PRICING.backend


class TestPricingRefresh:
    test_refresh_counts_via_metrics_decorated_provider = _PRICING.TestPricingRefresh.test_refresh_counts_via_metrics_decorated_provider


def test_traced_witnessed_runtime_runs_a_round():
    """Runtime(options=Options(enable_tracing=True, enable_lock_witness=True),
    device="cpu") constructs and runs a dense round: one trace from the
    provision root to its launch, witnessed locks, no lock-order cycle."""
    from karpenter_tpu_torch.analysis.witness import WITNESS
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.testing import make_pod, make_provisioner
    from karpenter_tpu_torch.tracing import TRACER
    from karpenter_tpu_torch.utils.options import Options

    options = Options(enable_tracing=True, enable_lock_witness=True, leader_elect=False, dense_min_batch=1)
    rt = Runtime(kube=KubeCluster(), cloud_provider=FakeCloudProvider(instance_types(8)), options=options, device="cpu")
    try:
        rt.kube.create(make_provisioner())
        for i in range(6):
            rt.kube.create(make_pod(name=f"traced-{i}", requests={"cpu": "1"}))
        rt.provision_once()
        tree = TRACER.span_tree(rt.provisioner.last_trace_id)
        solve = next(c for c in tree["children"] if c["name"] == "solve")
        assert [c["name"] for c in solve["children"]] == ["encode", "fill", "device", "commit"]
        assert rt.kube.list_nodes(), "the round launched nothing"
        # the store was built before the Runtime enabled the witness, so its
        # lock stays plain (the entry point enables it before the backend)
        locks = set(WITNESS.locks())
        assert {"state.cluster", "runtime.leader-gate", "provisioning.batcher"} <= locks and "kube.store" not in locks
        assert WITNESS.cycles() == []
    finally:
        rt.stop()
