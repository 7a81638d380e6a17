"""SLO accounting and the cost scraper's ideal repack on the port.

- tests/test_slo.py as written on the port (a port copy of the module
  through `port_copy`): pending latency, time to ready, churn, cost drift on
  the host loop, disabled-is-free, the snapshot and /debug/slo, and the
  Runtime's wiring behind --enable-slo;
- `compute_drift` through the dense solver on both packages: the same
  seeded workload provisioned, bound and thinned out, then the scraper's
  ideal repack of every bound pod onto an empty cluster, in simulation
  mode. The ideal cost and the drift ratio must be equal, exactly, and the
  port's repack must reach K1's seam (its plain version, on the CPU);
- the port's scraper lets a failed ideal solve out of `scrape()` (ROADMAP
  C: no fail-open around the card), where the reference logs it and keeps
  its gauges.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.test_torch_consolidation import reference_auditor_off  # noqa: F401
from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_journal import recorder_copy

_SLO = recorder_copy("test_slo")
accountant = _SLO.accountant
TestPendingLatency = _SLO.TestPendingLatency
TestNodeReadyLatency = _SLO.TestNodeReadyLatency
TestChurnCounters = _SLO.TestChurnCounters
TestCostDrift = _SLO.TestCostDrift
TestDisabledIsFree = _SLO.TestDisabledIsFree
TestSnapshotAndRoute = _SLO.TestSnapshotAndRoute

DRIFT_PODS = 240
DRIFT_TYPES = 40
DRIFT_KEEP = 0.55  # the share of bound pods left standing before the repack


def _package(side: str):
    if side == "ref":
        from karpenter_tpu import slo
        from karpenter_tpu.cloudprovider.fake import instance_types
        from karpenter_tpu.controllers.metrics.slo import SLOScraper
        from karpenter_tpu.solver import DenseSolver, dense
        from tests.env import Environment
        from tests.helpers import make_pod, make_provisioner

        solver = DenseSolver(min_batch=1)
    else:
        from karpenter_tpu_torch import slo
        from karpenter_tpu_torch.cloudprovider.fake import instance_types
        from karpenter_tpu_torch.controllers.metrics.slo import SLOScraper
        from karpenter_tpu_torch.solver import DenseSolver, dense
        from karpenter_tpu_torch.testing import Environment, make_pod, make_provisioner

        solver = DenseSolver(min_batch=1, device="cpu")
    return slo, instance_types, SLOScraper, solver, dense, Environment, make_pod, make_provisioner


def drift_run(side: str, monkeypatch=None) -> dict:
    """The seeded workload on one package: provision and bind it, delete a
    seeded share of the pods, then one SLO scrape (the cluster's $/hour and
    the ideal repack). Returns the gauges and, on the port, the K1 seam's
    calls during the repack."""
    slo, instance_types, SLOScraper, solver, dense, Environment, make_pod, make_provisioner = _package(side)
    rng = np.random.default_rng(20261017)
    env = Environment(instance_types=instance_types(DRIFT_TYPES), dense_solver=solver)
    env.kube.create(make_provisioner())
    for i in range(DRIFT_PODS):
        cpu = float(rng.choice([0.25, 0.5, 1.0, 2.0, 3.5]))
        memory = f"{int(rng.choice([256, 512, 1024, 4096]))}Mi"
        env.kube.create(make_pod(name=f"drift-{i}", requests={"cpu": cpu, "memory": memory}))
    env.provision()
    env.bind_nominated()
    keep = rng.random(DRIFT_PODS) < DRIFT_KEEP
    for i in np.nonzero(~keep)[0]:
        env.kube.delete(env.kube.get("Pod", f"drift-{i}", "default"))
    calls = []
    if side == "port":
        seam = dense.bucket_cost_packed

        def counted(*args):
            calls.append(args[0].shape[1])
            return seam(*args)

        monkeypatch.setattr(dense, "bucket_cost_packed", counted)
    scraper = slo.SLO
    scraper.enable()
    scraper.reset()
    try:
        SLOScraper(env.kube, env.cluster, env.provider, provisioner_controller=env.provisioner_controller).scrape()
        return {
            "cluster": slo.CLUSTER_COST.value(),
            "ideal": slo.IDEAL_COST.value(),
            "ratio": slo.COST_DRIFT.value(),
            "bound": int(keep.sum()),
            "k1_calls": calls,
        }
    finally:
        scraper.disable()
        scraper.reset()


def test_compute_drift_on_both_packages(monkeypatch):
    ref, port = drift_run("ref"), drift_run("port", monkeypatch)
    assert port["ideal"] > 0 and port["cluster"] > 0
    assert port["ratio"] >= 1.0, port
    assert port["k1_calls"], "the port's ideal repack never reached K1's seam"
    assert {k: port[k] for k in ("cluster", "ideal", "ratio", "bound")} == {k: ref[k] for k in ("cluster", "ideal", "ratio", "bound")}


def test_failed_ideal_solve_leaves_the_scrape(monkeypatch):
    from karpenter_tpu_torch import slo
    from karpenter_tpu_torch.controllers.metrics.slo import SLOScraper
    from karpenter_tpu_torch.testing import Environment, make_pod, make_provisioner

    env = Environment()
    env.kube.create(make_provisioner())
    env.kube.create(make_pod(requests={"cpu": 1, "memory": "1Gi"}))
    env.provision()
    env.bind_nominated()

    def fails(*args, **kwargs):
        raise RuntimeError("the card went away")

    monkeypatch.setattr(env.provisioner_controller, "schedule", fails)
    slo.SLO.enable()
    slo.SLO.reset()
    try:
        with pytest.raises(RuntimeError, match="the card went away"):
            SLOScraper(env.kube, env.cluster, env.provider, provisioner_controller=env.provisioner_controller).scrape()
    finally:
        slo.SLO.disable()
        slo.SLO.reset()
