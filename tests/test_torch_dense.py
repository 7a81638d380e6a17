"""The port's cold-path provisioning solve held against the JAX package.

The same seeded workloads go through `build_scheduler(...).solve(pods)` with
the reference DenseSolver (karpenter_tpu, jnp path on the CPU) and with the
port's DenseSolver on device="cpu" (karpenter_tpu_torch, the kernel's plain
torch version). Both sides build their own pods and catalogs from the same
seeds: bench.py's builders and tests/helpers.py on the reference side,
karpenter_tpu_torch/testing.py on the port side. Placements must be
identical: per new node, its instance type and the sorted input indices of
its pods; so must the unschedulable set, the node count, the total cost and
the dense solver's committed/host-routed pod counts.

The reference runs with use_mesh=False: conftest.py forces 8 virtual CPU
devices, which would otherwise put it on its sharded flavor.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

import bench
from karpenter_tpu.api.objects import Taint as RefTaint
from karpenter_tpu.cloudprovider.fake import FakeCloudProvider as RefProvider
from karpenter_tpu.cloudprovider.fake import instance_types as ref_instance_types
from karpenter_tpu.scheduler import build_scheduler as ref_build_scheduler
from karpenter_tpu.solver import DenseSolver as RefDenseSolver
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.api.objects import Taint
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.solver import DenseSolver
from tests.helpers import make_pod as ref_make_pod
from tests.helpers import make_provisioner as ref_make_provisioner

REPO = Path(__file__).resolve().parent.parent


def _ref_case(name):
    """(pods, provider, provisioners) of bench.py --smoke's cold shapes."""
    if name == "anti_spread":
        return bench.build_workload(700, seed=42), RefProvider(ref_instance_types(100)), [ref_make_provisioner()]
    if name == "ffd_parity":
        pods = [ref_make_pod(requests={"cpu": 1, "memory": "1Gi"}) for _ in range(300)]
        return pods, RefProvider(ref_instance_types(50)), [ref_make_provisioner()]
    if name == "selectors_taints":
        tainted = ref_make_provisioner(taints=[RefTaint(key="dedicated", value="batch", effect="NoSchedule")])
        return bench.build_selectors_taints_workload(400), RefProvider(ref_instance_types(100)), [tainted]
    if name == "spot_od":
        provisioners = [ref_make_provisioner(name="spot", weight=10), ref_make_provisioner(name="on-demand", weight=1)]
        return bench.build_workload(500, seed=5), RefProvider(bench.build_spot_od_types(100)), provisioners
    raise KeyError(name)


def _port_case(name):
    if name == "anti_spread":
        return testing.build_workload(700, seed=42), FakeCloudProvider(instance_types(100)), [testing.make_provisioner()]
    if name == "ffd_parity":
        pods = [testing.make_pod(requests={"cpu": 1, "memory": "1Gi"}) for _ in range(300)]
        return pods, FakeCloudProvider(instance_types(50)), [testing.make_provisioner()]
    if name == "selectors_taints":
        tainted = testing.make_provisioner(taints=[Taint(key="dedicated", value="batch", effect="NoSchedule")])
        return testing.build_selectors_taints_workload(400), FakeCloudProvider(instance_types(100)), [tainted]
    if name == "spot_od":
        provisioners = [testing.make_provisioner(name="spot", weight=10), testing.make_provisioner(name="on-demand", weight=1)]
        return testing.build_workload(500, seed=5), FakeCloudProvider(testing.build_spot_od_types(100)), provisioners
    raise KeyError(name)


def _outcome(results, pods, stats):
    index = {p.uid: i for i, p in enumerate(pods)}
    nodes = sorted(
        (n.instance_type_options[0].name(), tuple(sorted(index[p.uid] for p in n.pods)))
        for n in results.new_nodes
        if n.pods
    )
    return {
        "nodes": nodes,
        "node_count": len(nodes),
        "cost": round(sum(n.instance_type_options[0].price() for n in results.new_nodes if n.pods), 9),
        "unschedulable": sorted(index[p.uid] for p in results.unschedulable),
        "pods_committed": stats.pods_committed,
        "pods_to_host": stats.pods_to_host,
    }


@pytest.mark.parametrize("case", ["anti_spread", "ffd_parity", "selectors_taints", "spot_od"])
def test_cold_solve_matches_reference(case):
    pods, provider, provisioners = _ref_case(case)
    ref_solver = RefDenseSolver(min_batch=1, use_mesh=False)
    ref = ref_build_scheduler(provisioners, provider, pods, dense_solver=ref_solver).solve(pods)
    want = _outcome(ref, pods, ref_solver.stats)

    pods, provider, provisioners = _port_case(case)
    solver = DenseSolver(min_batch=1, device="cpu")
    got = _outcome(build_scheduler(provisioners, provider, pods, dense_solver=solver).solve(pods), pods, solver.stats)

    assert want["pods_committed"] > 0, "the reference solve never took the dense path"
    assert got == want


def _port_sources():
    yield from sorted((REPO / "karpenter_tpu_torch").rglob("*.py"))
    yield REPO / "chip_smoke.py"
    yield REPO / "chip_sweep.py"
    yield REPO / "chip_campaign.py"
    yield REPO / "chip_process_http.py"
    yield REPO / "chip_process_http.py"


def test_port_imports_neither_jax_nor_the_reference():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "karpenter_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
    assert offenders == []


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseSolver()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseSolver(device="cuda")

