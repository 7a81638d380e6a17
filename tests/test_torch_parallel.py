"""The solver mesh (parallel/) and ops/packing.py on the port, held against the JAX package.

tests/test_parallel.py's twelve cases on the port, each against the JAX
package where it has a counterpart: the port's 8-block CPU mesh
(`[torch.device("cpu")] * 8`) beside the reference's mesh over the 8 virtual
CPU devices tests/conftest.py gives JAX. The same numpy inputs from the same
seeds go to both.

- the toy solve step: integers equal to the reference's, floats to its own
  tolerance (rtol 1e-5, atol 1e-6: the segment sums add in another order);
- make_sharded_bucket_cost: bit-equal to the port's unsharded plain
  version (K1's plain version on the CPU) across padded shapes, ties
  planted across the two type blocks and all-infeasible rows; equal to the
  reference's sharded program on t* and feasible, and on bins where the
  bucket is feasible (the reference's jnp bins is not masked on infeasible
  rows: it is ceil(frac) at t* = 0 there, where the port's is 0, as K1's);
- the mesh shapes, host_mesh_axes, initialize's no-op and a one-process
  distributed mesh, the auto-detected mesh (over stand-in CUDA devices: it
  is built from the visible cards only) and its refusals;
- the production DenseSolver with the mesh against the port without it and
  against the reference with its mesh, on _mixed_workload()'s layout;
- the budget split under a mesh (the reference's `mesh = None` for a solve
  over --solver-hbm-budget): K1 on each half of the bucket axis on the
  solver's device, no sharded dispatch, the mesh kept for the next solve,
  the peak read and reset on every card of the mesh (stood in), and under
  a two-process gloo fabric no broadcast for the split solve;
- the counterpart of test_graft_dryrun_multichip: the toy step and a
  production solve on the 8-block mesh;
- segment_usage and audit_layout against the reference's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from karpenter_tpu.ops.packing import audit_layout as ref_audit_layout
from karpenter_tpu.ops.packing import segment_usage as ref_segment_usage
from karpenter_tpu.parallel.mesh import solver_mesh as ref_solver_mesh
from karpenter_tpu.parallel.sharded import make_sharded_bucket_cost as ref_make_sharded_bucket_cost
from karpenter_tpu.parallel.sharded import sharded_solve_step as ref_sharded_solve_step
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
from karpenter_tpu_torch.ops.packing import audit_layout, segment_usage
from karpenter_tpu_torch.parallel import multihost
from karpenter_tpu_torch.parallel.mesh import solver_mesh
from karpenter_tpu_torch.parallel.multihost import distributed_solver_mesh, host_mesh_axes
from karpenter_tpu_torch.parallel.sharded import make_sharded_bucket_cost, pad_batch, pad_catalog, sharded_solve_step
from karpenter_tpu_torch.solver.dense import resolve_mesh

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return solver_mesh(8, types_parallel=2, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def ref_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return ref_solver_mesh(8, types_parallel=2)


def _problem(P=128, T=32, G=3, R=8, B=4, seed=3):
    """tests/test_parallel.py's generator."""
    rng = np.random.default_rng(seed)
    requests = (rng.random((P, R)) * 0.5).astype(np.float32)
    group_ids = rng.integers(0, G, size=(P,)).astype(np.int32)
    compat = rng.random((G, T)) > 0.3
    caps = (rng.random((T, R)) * 8 + 8).astype(np.float32)
    prices = (caps[:, 0] * 0.1).astype(np.float32)
    allowed = rng.random((B, T)) > 0.3
    bucket_sum = (rng.random((B, R)) * 30).astype(np.float32)
    bucket_max = (rng.random((B, R)) * 1.0).astype(np.float32)
    bin_ids = rng.integers(-1, 16, size=(P,)).astype(np.int32)
    return requests, group_ids, compat, caps, prices, allowed, bucket_sum, bucket_max, bin_ids


def _assert_step_equal(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        if np.issubdtype(b.dtype, np.floating):
            # the segment sums add in another order; f32 eps
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(a.astype(b.dtype), b)


def test_sharded_matches_single_device(mesh, ref_mesh):
    args = _problem()
    got = sharded_solve_step(mesh, *args, num_bins=16)
    single = sharded_solve_step(solver_mesh(1, devices=[CPU]), *args, num_bins=16)
    want = ref_sharded_solve_step(ref_mesh, *[jnp.asarray(a) for a in args], num_bins=16)
    _assert_step_equal(got, single)
    _assert_step_equal(got, want)


def test_sharded_feasibility_semantics(mesh):
    requests, group_ids, compat, caps, prices, allowed, bsum, bmax, bin_ids = _problem()
    feasible_any, best_type, tstar, bins, usage, counts = [
        np.asarray(o) for o in sharded_solve_step(mesh, requests, group_ids, compat, caps, prices, allowed, bsum, bmax, bin_ids, num_bins=16)
    ]
    fit = np.all(requests[:, None, :] <= caps[None, :, :] + 1e-6, axis=-1)
    feas = fit & compat[group_ids]
    np.testing.assert_array_equal(feasible_any, feas.any(axis=1))
    np.testing.assert_array_equal(best_type, np.argmin(np.where(feas, prices[None, :], np.inf), axis=1))
    expect = np.zeros((16, requests.shape[1]), np.float32)
    for i, b in enumerate(bin_ids):
        if 0 <= b < 16:
            np.add.at(expect, b, requests[i])
    np.testing.assert_allclose(usage, expect, rtol=1e-5)
    np.testing.assert_array_equal(counts, np.bincount(bin_ids[bin_ids >= 0], minlength=16)[:16])


def test_mesh_shapes():
    mesh = solver_mesh(8, types_parallel=4, devices=[CPU] * 8)
    assert mesh.shape == {"pods": 2, "types": 4}
    with pytest.raises(ValueError):
        solver_mesh(6, types_parallel=4, devices=[CPU] * 8)


def test_mesh_asks_for_no_more_devices_than_it_has():
    """No swap to another backend: 8 blocks need 8 entries in the list, and
    the default list is the visible cards (none here)."""
    with pytest.raises(ValueError, match="need 8 devices"):
        solver_mesh(8)
    with pytest.raises(ValueError, match="need 8 devices"):
        solver_mesh(8, devices=[CPU] * 4)


# -- make_sharded_bucket_cost -----------------------------------------------------

BUCKET_COST_CASES = [
    (30, 500, 8, "random"),  # the headline's (B, T, R)
    (29, 501, 8, "random"),  # padded on both axes
    (29, 501, 8, "unrequested"),
    (5, 3, 2, "random"),  # fewer buckets than pod blocks, a type block of padding
    (64, 2000, 8, "ties"),
    (12, 200, 3, "infeasible"),
]


def _case(seed, B, T, R, kind):
    return testing.bucket_cost_problem(np.random.default_rng(seed * 1000 + B), B, T, R, kind)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", BUCKET_COST_CASES + [(16, 200, 4, "cross_block_ties"), (24, 300, 8, "all_infeasible")], ids=lambda c: "x".join(map(str, c)))
def test_sharded_bucket_cost_is_bit_equal_to_one_launch(mesh, case, seed):
    B, T, R, kind = case
    stats, caps, prices, allowed = _case(seed, B, T, R, kind)
    got = make_sharded_bucket_cost(mesh)(stats, caps, prices, allowed)
    want = bucket_type_cost_packed(*[torch.from_numpy(a) for a in (stats, caps, prices, allowed)]).numpy()
    assert got.dtype == np.int32 and got.shape == (3, B)
    np.testing.assert_array_equal(got, want)
    if kind == "cross_block_ties":
        assert (got[0][got[2] == 1] < T // 2).all(), "a tie across type blocks must go to the first block"
    if kind == "all_infeasible":
        dead = slice(B // 2, None)
        assert (got[:, dead] == 0).all(), "a row with no feasible type is t* 0, bins 0, infeasible"


@pytest.mark.parametrize("case", BUCKET_COST_CASES, ids=lambda c: "x".join(map(str, c)))
def test_sharded_bucket_cost_matches_the_reference(mesh, ref_mesh, case):
    B, T, R, kind = case
    stats, caps, prices, allowed = _case(7, B, T, R, kind)
    got = make_sharded_bucket_cost(mesh)(stats, caps, prices, allowed)
    caps_p, prices_p = pad_catalog(mesh, caps, prices)
    stats_p, allowed_p = pad_batch(mesh, stats, allowed, caps_p.shape[0])
    want = np.asarray(ref_make_sharded_bucket_cost(ref_mesh)(stats_p, caps_p, prices_p, allowed_p))[:, :B]
    np.testing.assert_array_equal(got[2], want[2])
    feasible = want[2].astype(bool)
    np.testing.assert_array_equal(got[0][feasible], want[0][feasible])
    np.testing.assert_array_equal(got[0][~feasible], 0)
    # the reference's bins is unmasked where the bucket is infeasible
    np.testing.assert_array_equal(got[1][feasible], want[1][feasible])


# -- the production DenseSolver --------------------------------------------------------


def _mixed_workload(make_pod, objects, labels, count=200, seed=7):
    """tests/test_parallel.py's mixed batch, with names, from either package."""
    rng = np.random.default_rng(seed)
    cpus = [0.1, 0.25, 0.5, 1.0]
    pods = []
    for _ in range(count // 4):
        label = {"spread": "ab"[int(rng.integers(2))]}
        pods.append(
            make_pod(
                name=f"mixed-{len(pods):04d}",
                labels=label,
                requests={"cpu": cpus[int(rng.integers(4))], "memory": "128Mi"},
                topology_spread_constraints=[
                    objects.TopologySpreadConstraint(
                        max_skew=1, topology_key=labels.LABEL_TOPOLOGY_ZONE, label_selector=objects.LabelSelector(match_labels=label)
                    )
                ],
            )
        )
    for _ in range(count // 8):
        label = {"anti": "x"}
        pods.append(
            make_pod(
                name=f"mixed-{len(pods):04d}",
                labels=label,
                requests={"cpu": 0.25, "memory": "64Mi"},
                pod_anti_requirements=[
                    objects.PodAffinityTerm(topology_key=labels.LABEL_HOSTNAME, label_selector=objects.LabelSelector(match_labels=label))
                ],
            )
        )
    while len(pods) < count:
        pods.append(make_pod(name=f"mixed-{len(pods):04d}", requests={"cpu": cpus[int(rng.integers(4))], "memory": "256Mi"}))
    return pods


def _layout(results):
    return sorted((n.instance_type_options[0].name(), tuple(sorted(p.metadata.name for p in n.pods))) for n in results.new_nodes)


def _port_layout(mesh_arg, pods=None, types=20, hbm_budget_bytes=0, solver=None):
    from karpenter_tpu_torch.api import labels, objects
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver

    pods = pods if pods is not None else _mixed_workload(testing.make_pod, objects, labels)
    if solver is None:
        solver = DenseSolver(min_batch=1, device="cpu", mesh=mesh_arg, use_mesh=mesh_arg is not None, hbm_budget_bytes=hbm_budget_bytes)
    results = build_scheduler([testing.make_provisioner()], FakeCloudProvider(instance_types(types)), pods, dense_solver=solver).solve(pods)
    return _layout(results), solver.stats, results


def _ref_layout(mesh_arg, monkeypatch):
    from karpenter_tpu.api import labels, objects
    from karpenter_tpu.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu.scheduler import build_scheduler
    from karpenter_tpu.solver import DenseSolver
    from tests.helpers import make_pod, make_provisioner

    monkeypatch.delenv("KARPENTER_TPU_MESH", raising=False)
    pods = _mixed_workload(make_pod, objects, labels)
    solver = DenseSolver(min_batch=1, mesh=mesh_arg)
    results = build_scheduler([make_provisioner()], FakeCloudProvider(instance_types(20)), pods, dense_solver=solver).solve(pods)
    return _layout(results), solver.stats


def test_production_solver_sharded_matches_single_device(mesh, ref_mesh, monkeypatch):
    """The PRODUCTION DenseSolver dispatched over the mesh gives the layout
    of the single-device solve and of the reference's solve on its mesh."""
    layout_mesh, stats_mesh, _ = _port_layout(mesh)
    layout_single, stats_single, _ = _port_layout(None)
    layout_ref, stats_ref = _ref_layout(ref_mesh, monkeypatch)
    assert stats_mesh.sharded_batches >= 1 and stats_ref.sharded_batches >= 1
    assert stats_single.sharded_batches == 0
    assert stats_mesh.pods_committed == stats_single.pods_committed == stats_ref.pods_committed > 0
    assert layout_mesh == layout_single == layout_ref


def test_flight_record_names_the_sharded_flavor(mesh):
    """A solve over the mesh is recorded as the "sharded" flavor with its
    surface padded to the mesh, as the reference records it."""
    from karpenter_tpu_torch import flight

    was_enabled = flight.FLIGHT.enabled
    flight.FLIGHT.enable()
    try:
        pods = testing.make_pods(30, requests={"cpu": 0.5, "memory": "512Mi"})
        _, stats, _ = _port_layout(mesh, pods=pods, types=21)
        record = flight.FLIGHT.records()[-1]
    finally:
        if not was_enabled:
            flight.FLIGHT.disable()
    assert stats.sharded_batches == 1 and record.dispatch == "sharded"
    assert record.padding_waste_pct > 0  # 21 types padded to 22, the buckets to 4


def _stand_in_cards(monkeypatch, n):
    """torch.cuda reporting n cards, for the auto-detection's logic only:
    the mesh holds device objects and nothing is launched."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


_CARD = torch.device("cuda", 0)


def test_dense_solver_autodetects_mesh(monkeypatch):
    """With more than one card visible and no override, a CUDA solver runs
    sharded over every card; KARPENTER_TPU_MESH=0 disables it; a CPU solver
    takes a mesh only when it is given one. The mesh is resolved when the
    solver is built (solver/dense.py:resolve_mesh, called with a card's
    device here: there is none)."""
    from karpenter_tpu_torch.solver import DenseSolver

    monkeypatch.delenv("KARPENTER_TPU_MESH", raising=False)
    _stand_in_cards(monkeypatch, 4)
    m = resolve_mesh(_CARD)
    assert m is not None and m.shape["pods"] * m.shape["types"] == 4
    assert [d for _, _, d in m.blocks()] == [torch.device("cuda", i) for i in range(4)]
    assert resolve_mesh(_CARD, use_mesh=False) is None
    assert DenseSolver(min_batch=1, device="cpu")._active_mesh() is None
    monkeypatch.setenv("KARPENTER_TPU_MESH", "0")
    assert resolve_mesh(_CARD) is None
    _stand_in_cards(monkeypatch, 1)
    monkeypatch.delenv("KARPENTER_TPU_MESH")
    assert resolve_mesh(_CARD) is None, "one card: no mesh"


def test_mesh_setting_beyond_the_visible_cards_raises(monkeypatch):
    _stand_in_cards(monkeypatch, 2)
    monkeypatch.setenv("KARPENTER_TPU_MESH", "8")
    with pytest.raises(ValueError, match="need 8 devices"):
        resolve_mesh(_CARD)


# -- the budget split under a mesh --------------------------------------------------------


@pytest.fixture
def stand_in_peak(monkeypatch):
    """The flight recorder on, with the memory peak it reads on each device
    stood in (`peaks[device]`, or `peaks[None]` for any other) and the
    devices whose peak it resets recorded in `resets`."""
    from karpenter_tpu_torch import flight

    peaks, resets = {None: 0}, []
    monkeypatch.setattr(flight.FlightRecorder, "hbm_snapshot", staticmethod(lambda device=None: (peaks.get(device, peaks[None]), 0)))
    monkeypatch.setattr(flight.FlightRecorder, "reset_hbm_peak", staticmethod(lambda device=None: resets.append(device)))
    was_enabled = flight.FLIGHT.enabled
    flight.FLIGHT.enable()
    yield peaks, resets
    if not was_enabled:
        flight.FLIGHT.disable()
    flight.FLIGHT.reset()


def _counted_launches(monkeypatch) -> tuple:
    """K1's unkeyed calls from the solver (their bucket counts) and the
    sharded dispatches."""
    from karpenter_tpu_torch.parallel.sharded import ShardedBucketCost
    from karpenter_tpu_torch.solver import dense as dense_module

    launches, dispatches = [], []
    plain, dispatch = dense_module.bucket_cost_packed, ShardedBucketCost.dispatch

    def counted(stats, caps, prices, allowed):
        launches.append(int(stats.shape[1]))
        return plain(stats, caps, prices, allowed)

    def counted_dispatch(self, *args, **kwargs):
        dispatches.append(1)
        return dispatch(self, *args, **kwargs)

    monkeypatch.setattr(dense_module, "bucket_cost_packed", counted)
    monkeypatch.setattr(ShardedBucketCost, "dispatch", counted_dispatch)
    return launches, dispatches


def test_over_budget_solve_under_a_mesh_splits_on_the_solver_device(mesh, ref_mesh, stand_in_peak, monkeypatch):
    """A solve whose peak is over --solver-hbm-budget under the 8-block mesh
    launches K1 on each half of the bucket axis on the solver's device and
    dispatches nothing over the mesh, as the reference sets `mesh = None`
    for that solve (karpenter_tpu/solver/dense.py:1941-1946). It places as
    the unsplit solve, as the sharded one and as the reference's solve of
    the same batch, counts one chunked rung, and keeps the mesh."""
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver.faults import DEGRADED_SOLVES, FAULTS, RUNG_CHUNKED, FaultPlan, FaultSpec

    peaks, _ = stand_in_peak
    peaks[None] = 1 << 20
    launches, dispatches = _counted_launches(monkeypatch)
    single, stats_single, _ = _port_layout(None)
    B = launches[0]
    launches.clear()
    base = DEGRADED_SOLVES.value(rung=RUNG_CHUNKED)
    solver = DenseSolver(min_batch=1, device="cpu", mesh=mesh, hbm_budget_bytes=1 << 19)
    # no sharded dispatch, so the "sharded" seam is never consulted
    FAULTS.install(FaultPlan([FaultSpec(kind="kernel", entry="sharded", nth=1)]))
    try:
        split, stats_split, _ = _port_layout(mesh, solver=solver)
        assert FAULTS.fired() == 0
    finally:
        FAULTS.clear()
    assert launches == [-(-B // 2), B - -(-B // 2)], "two launches, one per half of the bucket axis"
    assert dispatches == [] and stats_split.sharded_batches == 0
    assert solver._solve_rungs == [RUNG_CHUNKED] and DEGRADED_SOLVES.value(rung=RUNG_CHUNKED) == base + 1
    assert solver._active_mesh() is mesh
    sharded, stats_sharded, _ = _port_layout(mesh)
    ref, _ = _ref_layout(ref_mesh, monkeypatch)
    assert split == single == sharded == ref
    assert stats_split.pods_committed == stats_single.pods_committed == stats_sharded.pods_committed > 0


def test_the_next_solve_under_the_peak_takes_the_mesh_again(mesh, stand_in_peak, monkeypatch):
    """The split is for that solve only: with the peak back under the
    budget, the same solver's next solve dispatches over the mesh. Its
    flight records name the flavor the unsplit route names ('plain' on the
    CPU, the split) and then 'sharded'."""
    from karpenter_tpu_torch import flight
    from karpenter_tpu_torch.solver import DenseSolver

    peaks, _ = stand_in_peak
    launches, dispatches = _counted_launches(monkeypatch)
    solver = DenseSolver(min_batch=1, device="cpu", mesh=mesh, hbm_budget_bytes=1 << 19)
    layouts = []
    for peak in (1 << 20, 0):
        peaks[None] = peak
        layouts.append(_port_layout(mesh, solver=solver)[0])
    records = flight.FLIGHT.records()[-2:]
    assert len(launches) == 2 and len(dispatches) == 1 and solver.stats.sharded_batches == 1
    assert [r.dispatch for r in records] == ["plain", "sharded"]
    assert [r.rungs for r in records] == [["chunked"], []]
    assert solver._active_mesh() is mesh
    assert layouts[0] == layouts[1]


@pytest.mark.parametrize("setting", ["", "2"])
def test_auto_mesh_with_an_hbm_budget_builds_and_keeps_the_budget(monkeypatch, setting):
    """Two stand-in cards and --solver-hbm-budget: the auto-detected mesh
    turns on and the solver builds, keeping its budget; the cards its
    budget reads are the solver's and its blocks' (nothing touches a card:
    there is none here)."""
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver import dense as dense_module

    monkeypatch.setenv("KARPENTER_TPU_MESH", setting)
    _stand_in_cards(monkeypatch, 2)
    monkeypatch.setattr(dense_module, "resolve_device", lambda device: _CARD)
    monkeypatch.setattr(dense_module, "AdmissionSurface", lambda device: None)
    solver = DenseSolver(min_batch=1, device="cuda", hbm_budget_bytes=1024)
    assert solver.hbm_budget_bytes == 1024
    assert [d for _, _, d in solver._active_mesh().blocks()] == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert solver._memory_devices == (torch.device("cuda", 0), torch.device("cuda", 1))


def test_the_budget_reads_and_resets_every_card_of_the_mesh(monkeypatch, stand_in_peak):
    """Under a mesh over two stand-in cards the pre-solve check reads the
    largest peak over the solver's card and its blocks' cards, and a solve's
    record restarts the peak on each of them."""
    from karpenter_tpu_torch import flight
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver import dense as dense_module

    peaks, resets = stand_in_peak
    monkeypatch.delenv("KARPENTER_TPU_MESH", raising=False)
    _stand_in_cards(monkeypatch, 2)
    monkeypatch.setattr(dense_module, "resolve_device", lambda device: _CARD)
    monkeypatch.setattr(dense_module, "AdmissionSurface", lambda device: None)
    solver = DenseSolver(min_batch=1, device="cuda", hbm_budget_bytes=1024)
    assert not solver._hbm_over_budget()
    peaks[torch.device("cuda", 1)] = 2048  # the second card's block only
    assert solver._hbm_over_budget()
    peaks[torch.device("cuda", 1)] = 1024
    assert not solver._hbm_over_budget(), "at the budget is not over it"
    token = flight.FLIGHT.begin_solve()
    flight.FLIGHT.complete_solve(
        token=token, signature={}, dispatch={}, phases={}, fill_routing={}, pods_committed=0, pods_to_host=0,
        duration=0.0, device=solver.device, peak_devices=solver._memory_devices,
    )
    assert resets == [torch.device("cuda", 0), torch.device("cuda", 1)]


_BUDGET_FABRIC = """
import json, sys
import torch.distributed as dist
from karpenter_tpu_torch import flight
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.parallel import multihost, peers
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.solver import DenseSolver

rank, coordinator = int(sys.argv[1]), sys.argv[2]
multihost.initialize(coordinator, 2, rank, backend="gloo", device="cpu")
fabric = peers.PeerFabric(device="cpu", blocks=4)
out = {"rank": rank}
try:
    if rank:
        out["served"] = fabric.serve()
    else:
        peak = [0]
        flight.FlightRecorder.hbm_snapshot = staticmethod(lambda device=None: (peak[0], 0))
        flight.FLIGHT.enable()
        provider = FakeCloudProvider(instance_types(64))
        dense = DenseSolver(min_batch=1, device="cpu", peer_fabric=fabric, hbm_budget_bytes=1 << 19)
        out["solves"] = []
        try:
            for stand_in in (1 << 20, 0):
                peak[0] = stand_in
                pods = peers._demo_pods(48)
                results = build_scheduler([Provisioner()], provider, pods, dense_solver=dense).solve(pods)
                out["solves"].append({
                    "layout": peers.demo_layout(results),
                    "rungs": list(dense._solve_rungs),
                    "sharded_batches": dense.stats.sharded_batches,
                    "catalog_broadcasts": fabric.catalog_broadcasts,
                    "mesh_kept": dense._active_mesh() is fabric.mesh,
                })
        finally:
            fabric.shutdown(best_effort=True)
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_over_budget_solve_under_a_peer_fabric_broadcasts_nothing():
    """A two-process gloo PeerFabric (4 CPU blocks each): the coordinator's
    first solve is over the budget and splits on its own device, so nothing
    is broadcast and the peer stays at its barrier; the second is under it
    and dispatches over the fabric. The peer serves that one solve, and both
    solves place as the in-process solve with no mesh."""
    import json
    import socket
    import subprocess
    import sys

    from tests.test_torch_multihost_peers import REPO, _in_process_layout

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUDGET_FABRIC, str(rank), coordinator],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(2)
    ]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
    coord, peer = (json.loads(out.strip().splitlines()[-1]) for out, _ in outs)
    first, second = coord["solves"]
    assert first["rungs"] == ["chunked"] and first["sharded_batches"] == 0 and first["catalog_broadcasts"] == 0
    assert second["rungs"] == [] and second["sharded_batches"] == 1 and second["catalog_broadcasts"] == 1
    assert first["mesh_kept"] and second["mesh_kept"]
    assert peer["served"] == 1, "the peer served the one solve dispatched over the fabric"
    want = _in_process_layout(48)
    assert first["layout"] == second["layout"] == want


def test_graft_dryrun_multichip(mesh):
    """__graft_entry__.dryrun_multichip(8)'s two stages on the port's 8-block
    mesh: the toy step at its shapes, then a production solve of its
    mixed batch dispatched over the mesh."""
    from __graft_entry__ import _example_problem
    from karpenter_tpu_torch.api.labels import LABEL_HOSTNAME, LABEL_TOPOLOGY_ZONE
    from karpenter_tpu_torch.api.objects import LabelSelector, PodAffinityTerm, TopologySpreadConstraint

    P, T = 64 * mesh.shape["pods"], 16 * mesh.shape["types"]
    feasible_any = sharded_solve_step(mesh, *_example_problem(P=P, T=T), num_bins=32)[0]
    assert feasible_any.shape == (P,) and bool(feasible_any.any())

    pods = [testing.make_pod(requests={"cpu": 0.25 + (i % 4) * 0.25, "memory": "256Mi"}) for i in range(48)]
    spread = TopologySpreadConstraint(max_skew=1, topology_key=LABEL_TOPOLOGY_ZONE, label_selector=LabelSelector(match_labels={"spread": "a"}))
    pods += [testing.make_pod(labels={"spread": "a"}, requests={"cpu": 0.5, "memory": "128Mi"}, topology_spread_constraints=[spread]) for _ in range(16)]
    anti = PodAffinityTerm(topology_key=LABEL_HOSTNAME, label_selector=LabelSelector(match_labels={"anti": "b"}))
    pods += [testing.make_pod(labels={"anti": "b"}, requests={"cpu": 0.25, "memory": "64Mi"}, pod_anti_requirements=[anti]) for _ in range(8)]
    _, stats, results = _port_layout(mesh, pods=pods, types=24)
    assert stats.sharded_batches >= 1 and stats.pods_committed > 0
    assert sum(len(n.pods) for n in results.new_nodes) == len(pods)


class TestMultihost:
    """parallel/multihost.py: env-driven torch.distributed wiring with a
    one-process no-op, and the (pods x types) axis factorization."""

    def test_initialize_noop_without_coordinator(self, monkeypatch):
        monkeypatch.delenv(multihost.ENV_COORDINATOR, raising=False)
        assert multihost.initialize(device="cpu") is False
        assert not torch.distributed.is_initialized()

    def test_host_mesh_axes_keep_types_on_ici(self):
        from karpenter_tpu.parallel.multihost import host_mesh_axes as ref_host_mesh_axes

        for n_global, n_local in ((8, 4), (32, 8), (4, 4), (16, 4)):
            pods, types = host_mesh_axes(n_global, n_local)
            assert pods * types == n_global
            assert n_local % types == 0, "types axis must not span hosts"
            assert types <= 4
            assert (pods, types) == ref_host_mesh_axes(n_global, n_local)

    def test_host_mesh_axes_degenerate(self):
        assert host_mesh_axes(1, 1) == (1, 1)
        assert host_mesh_axes(6, 4) == (6, 1)  # non-dividing: pods-only

    def test_distributed_solver_mesh_single_process(self):
        """One process, no group: the mesh is the local blocks', and the
        sharded production solve runs on it."""
        mesh = distributed_solver_mesh(device="cpu", blocks=8)
        assert set(mesh.shape) == {"pods", "types"} and mesh.size == 8 and mesh.group is None
        pods = testing.make_pods(40, requests={"cpu": 0.5, "memory": "512Mi"})
        _, stats, results = _port_layout(mesh, pods=pods, types=12)
        assert sum(len(n.pods) for n in results.new_nodes) == 40
        assert stats.sharded_batches >= 1

    def test_host_mesh_axes_types_divide_local(self):
        assert host_mesh_axes(6, 6) == (3, 2)
        assert host_mesh_axes(12, 6) == (6, 2)
        for n_global, n_local in ((6, 6), (12, 6), (8, 4), (32, 8), (4, 4)):
            pods, types = host_mesh_axes(n_global, n_local)
            assert pods * types == n_global and n_local % types == 0

    def test_auto_mesh_uses_only_the_visible_cards(self, monkeypatch):
        """The auto mesh is built from this process's cards exclusively."""
        import karpenter_tpu_torch.parallel.mesh as mesh_mod

        captured = {}
        orig = mesh_mod.solver_mesh

        def spy(n_devices=None, types_parallel=1, devices=None):
            captured["devices"] = devices
            return orig(n_devices, types_parallel=types_parallel, devices=devices)

        monkeypatch.delenv("KARPENTER_TPU_MESH", raising=False)
        monkeypatch.setattr(mesh_mod, "solver_mesh", spy)
        _stand_in_cards(monkeypatch, 2)
        resolve_mesh(_CARD)
        assert captured["devices"] == [torch.device("cuda", 0), torch.device("cuda", 1)]


# -- ops/packing.py ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_segment_usage_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    requests = (rng.random((300, 5)) * 2).astype(np.float32)
    bin_ids = rng.integers(-1, 20, size=(300,)).astype(np.int32)
    got_usage, got_counts = segment_usage(torch.from_numpy(requests), torch.from_numpy(bin_ids), 21)
    want_usage, want_counts = ref_segment_usage(jnp.asarray(requests), jnp.asarray(bin_ids), num_segments=21)
    np.testing.assert_allclose(got_usage.numpy(), np.asarray(want_usage), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    assert got_counts.dtype == torch.int32 and int(got_counts.sum()) == 300


def test_audit_layout_matches_the_reference():
    rng = np.random.default_rng(5)
    usage = (rng.random((40, 4)) * 10).astype(np.float32)
    caps = (rng.random((40, 4)) * 10).astype(np.float32)
    caps[:5] = usage[:5] - 5e-7  # within the tolerance
    got = audit_layout(torch.from_numpy(usage), torch.from_numpy(caps)).numpy()
    want = np.asarray(ref_audit_layout(jnp.asarray(usage), jnp.asarray(caps)))
    np.testing.assert_array_equal(got, want)
    assert got[:5].all() and not got.all()
