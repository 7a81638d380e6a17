"""The port's warm-cluster solve held against the JAX package.

The same seeded batches and warm clusters go through
`build_scheduler(..., state_nodes=...).solve(pods)` with the reference
DenseSolver (karpenter_tpu, jnp path on the CPU, use_mesh=False and no
incremental engine) and with the port's DenseSolver on device="cpu" (the
warm-fill kernel's plain torch version). Both sides build their inputs from
the same seeds: bench.py's and the reference tests' builders on one side,
karpenter_tpu_torch/testing.py on the other. The fingerprint is the
reference's warm-fill parity fingerprint (tests/test_warm_fill_vectorized.py):
per existing node the pods it took in commit order and its residual request
map, the topology domain counts, and the new nodes, here each with its
instance type. The solver's fill routing and commit counters must agree too.
"""

from __future__ import annotations

import enum

import numpy as np
import pytest

import bench
from karpenter_tpu.cloudprovider.fake import FakeCloudProvider as RefProvider
from karpenter_tpu.cloudprovider.fake import instance_types as ref_instance_types
from karpenter_tpu.scheduler import build_scheduler as ref_build_scheduler
from karpenter_tpu.solver import DenseSolver as RefDenseSolver
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.solver import DenseSolver
from karpenter_tpu_torch.solver import warmfill as port_warmfill
from tests.helpers import make_provisioner as ref_make_provisioner
from tests.test_differential_campaign import _provisioners as ref_provisioners
from tests.test_differential_campaign import _random_workload as ref_random_workload
from tests.test_differential_campaign import _rename as ref_rename
from tests.test_warm_fill_vectorized import _warm_states as ref_warm_states

STATS = (
    "pods_on_existing",
    "fills_vectorized",
    "fills_host",
    "fill_pods_vectorized",
    "fill_pods_host",
    "pods_committed",
    "pods_to_host",
)
SEEDS = range(10)


def _plain(x):
    """A topology group's hash key with enums as values and sets sorted, so
    the two packages' keys compare as data."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (frozenset, set)):
        return tuple(sorted((_plain(v) for v in x), key=repr))
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    return x


def _fingerprint(results, scheduler, stats):
    views = [(v.node.name, tuple(p.name for p in v.pods), dict(v.requests)) for v in results.existing_nodes]

    def norm(domains):
        # new nodes' placeholder hostnames come from a process-global
        # counter; rank them so two runs compare equal
        placeholders = sorted(d for d in domains if d.startswith("hostname-placeholder-"))
        ren = {d: f"placeholder-{i}" for i, d in enumerate(placeholders)}
        return {ren.get(d, d): c for d, c in domains.items()}

    topo = {}
    for store in (scheduler.topology.topologies, scheduler.topology.inverse_topologies):
        for hk, group in store.items():
            topo[repr(_plain(hk))] = norm(group.domains)
    new_nodes = sorted(
        (n.instance_type_options[0].name() if n.instance_type_options else "", tuple(sorted(p.name for p in n.pods)))
        for n in results.new_nodes
    )
    return {
        "views": views,
        "topology": topo,
        "new_nodes": new_nodes,
        "unschedulable": sorted(p.name for p in results.unschedulable),
        "stats": {k: getattr(stats, k) for k in STATS},
    }


def _ref_solve(pods, states, provider, provisioners):
    solver = RefDenseSolver(min_batch=1, use_mesh=False)
    scheduler = ref_build_scheduler(provisioners, provider, pods, state_nodes=states, dense_solver=solver)
    return _fingerprint(scheduler.solve(pods), scheduler, solver.stats)


def _port_solve(pods, states, provider, provisioners):
    solver = DenseSolver(min_batch=1, device="cpu")
    scheduler = build_scheduler(provisioners, provider, pods, state_nodes=states, dense_solver=solver)
    return _fingerprint(scheduler.solve(pods), scheduler, solver.stats)


def _name_nodes(states, tag):
    # node names come from a process-global counter; the hostname falls
    # back to the node name, so both sides get the same deterministic names
    for i, s in enumerate(states):
        s.node.metadata.name = f"wfnode-{tag}-{i:03d}"
    return states


def _repack_case(pods, types, nodes, seed):
    ref = (
        ref_rename(bench.build_workload(pods, seed=seed), f"rp{seed}"),
        _name_nodes(bench.build_repack_state(nodes), f"rp{seed}"),
        RefProvider(ref_instance_types(types)),
        [ref_make_provisioner()],
    )
    port = (
        testing.rename(testing.build_workload(pods, seed=seed), f"rp{seed}"),
        _name_nodes(testing.build_repack_state(nodes), f"rp{seed}"),
        FakeCloudProvider(instance_types(types)),
        [testing.make_provisioner()],
    )
    return _ref_solve(*ref), _port_solve(*port)


def test_repack_smoke_matches_reference():
    """bench.py --smoke's repack shape: the fill places every pod warm."""
    want, got = _repack_case(600, 60, 90, seed=3)
    assert want["stats"]["fills_vectorized"] == 1 and want["stats"]["fill_pods_host"] == 0
    assert want["stats"]["pods_on_existing"] == 600
    assert got == want


def test_overflow_commits_new_nodes_after_the_fill():
    """A warm cluster too small for the batch: dense opens new nodes for
    what the fill leaves over, through the warm -> cold handoff (deferred
    spread water-filled with post-fill counts, the node guard over the
    un-taken rows)."""
    want, got = _repack_case(700, 100, 20, seed=42)
    s = want["stats"]
    assert 0 < s["pods_on_existing"] < s["pods_committed"], "the dense solve should commit new nodes after the fill"
    assert want["new_nodes"]
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_randomized_warm_clusters_match_reference(seed):
    """tests/test_warm_fill_vectorized.py's seeds: even seeds are the
    certified common case and take the vectorized fill; odd seeds mix in
    host ports, selectors and preferences, so the plan fails open and both
    sides take the host-loop fill."""
    rng = np.random.default_rng(7000 + seed)
    types = int(rng.integers(20, 120))
    if seed % 2:
        pods = ref_rename(ref_random_workload(rng, int(rng.integers(60, 200))), f"wf{seed}")
    else:
        pods = ref_rename(bench.build_workload(int(rng.integers(120, 400)), seed=seed), f"wf{seed}")
    states = _name_nodes(ref_warm_states(rng), seed)
    want = _ref_solve(pods, states, RefProvider(ref_instance_types(types)), ref_provisioners())

    rng = np.random.default_rng(7000 + seed)
    types = int(rng.integers(20, 120))
    if seed % 2:
        pods = testing.rename(testing.random_workload(rng, int(rng.integers(60, 200))), f"wf{seed}")
    else:
        pods = testing.rename(testing.build_workload(int(rng.integers(120, 400)), seed=seed), f"wf{seed}")
    states = _name_nodes(testing.warm_states(rng), seed)
    got = _port_solve(pods, states, FakeCloudProvider(instance_types(types)), testing.campaign_provisioners())

    route = ("fills_host", "fills_vectorized") if seed % 2 else ("fills_vectorized", "fills_host")
    assert want["stats"][route[0]] == 1 and want["stats"][route[1]] == 0
    assert got == want


def test_warm_solve_computes_the_surface_through_the_kernel_wrapper(monkeypatch):
    calls = []
    wrapper = port_warmfill.warm_fill_counts_device

    def recording(sizes, head):
        calls.append((tuple(sizes.shape), tuple(head.shape)))
        return wrapper(sizes, head)

    monkeypatch.setattr(port_warmfill, "warm_fill_counts_device", recording)
    pods = testing.build_workload(300, seed=3)
    states = testing.build_repack_state(40)
    solver = DenseSolver(min_batch=1, device="cpu")
    build_scheduler([testing.make_provisioner()], FakeCloudProvider(instance_types(40)), pods, state_nodes=states, dense_solver=solver).solve(pods)
    assert solver.stats.fills_vectorized == 1
    assert len(calls) == 1 and calls[0][1][0] == 40
    assert solver.stats.fill_device_seconds > 0


def test_a_kernel_failure_propagates_out_of_the_solve(monkeypatch):
    def broken(sizes, head):
        raise RuntimeError("warm_fill kernel launch failed: CUDA error 700")

    monkeypatch.setattr(port_warmfill, "warm_fill_counts_device", broken)
    pods = testing.build_workload(300, seed=3)
    states = testing.build_repack_state(40)
    scheduler = build_scheduler(
        [testing.make_provisioner()],
        FakeCloudProvider(instance_types(40)),
        pods,
        state_nodes=states,
        dense_solver=DenseSolver(min_batch=1, device="cpu"),
    )
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        scheduler.solve(pods)
