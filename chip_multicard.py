"""The port's solver mesh over several CUDA cards of one host.

    python3 chip_multicard.py

Run from the repository root on a machine with two or more CUDA cards (four
H100s joined by NVLink is the shape it was written for). It builds both
kernels from karpenter_tpu_torch/csrc/, then:

  - nccl_fleet: parallel/peers.py's demo fleet over NCCL, one process per
    card, each process's one block on its own card (chip_smoke.py's
    solver_mesh phase runs the same fleet where it sees several cards);
  - auto_mesh: the headline batch (10,000 pods x 500 instance types)
    through DenseSolver(min_batch=1) with no mesh given, which builds one
    over every visible card (solver/dense.py:resolve_mesh). Its placements,
    node count and $/hour are held against the unsharded solve
    (use_mesh=False), and every block's keyed K1 call against its plain
    version on the same card tensors;
  - budget: the same solve over that mesh with --solver-hbm-budget 1
    (chip_smoke.py's mesh_budget_case): two unkeyed K1 launches on the
    solver's card, one per half of the bucket axis, no keyed launch, the
    unsharded outcome, the mesh kept, the memory peak read on every card.

It prints one JSON object per phase, then the card's name and power limit,
then {"ok": ...}. It exits 1 if a phase failed or fewer than two cards are
visible, 2 without a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from chip_smoke import (
    FLEET,
    FLEET_TIMEOUT_S,
    HEADLINE_PODS,
    HEADLINE_TYPES,
    PhaseFailed,
    build_kernels,
    card,
    check,
    mesh_budget_case,
    outcome,
    read_launches,
)


def nccl_fleet(cards: int) -> dict:
    from karpenter_tpu_torch.parallel.peers import run_demo_fleet

    t0 = time.perf_counter()
    outs = run_demo_fleet(
        n_processes=cards, devices_per_process=1, pod_count=FLEET["pod_count"], solves=FLEET["solves"],
        timeout=FLEET_TIMEOUT_S, device="cuda", backend="nccl",
    )
    coord = outs[0]
    line = {
        "phase": "nccl_fleet",
        "startup_and_solves_s": time.perf_counter() - t0,
        "devices": [o["device"] for o in outs],
        "backend": coord["backend"],
        "mesh": coord["mesh"],
        "scheduled": coord["scheduled"],
        "requested": coord["requested"],
        "catalog_broadcasts": coord["catalog_broadcasts"],
        "sharded_batches": coord["sharded_batches"],
        "served": [o.get("served") for o in outs[1:]],
        "coordinator_solve_ms_runs": coord["solve_ms"],
        "k1_launches": [o["k1_launches"] for o in outs],
    }
    check(coord["backend"] == "nccl", f"the fleet ran over {coord['backend']}")
    check(line["devices"] == [f"cuda:{i}" for i in range(cards)], f"the fleet ran on {line['devices']}")
    check(coord["scheduled"] == coord["requested"] and coord["unschedulable"] == 0, f"the fleet scheduled {coord['scheduled']} of {coord['requested']} pods")
    check(coord["catalog_broadcasts"] == 1, f"the fleet broadcast the catalog {coord['catalog_broadcasts']} times")
    check(all(o["k1_launches"] > 0 for o in outs), f"a fleet process launched no keyed K1: {line['k1_launches']}")
    return line


def auto_mesh(cards: int, pods, provider, provisioners) -> tuple:
    """The headline through the auto-detected mesh beside the unsharded
    solve; returns (line, the mesh, the unsharded outcome)."""
    from karpenter_tpu_torch.ops import bucket_cost
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_keyed
    from karpenter_tpu_torch.parallel import sharded as sharded_module
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver

    def solve(solver):
        scheduler = build_scheduler(provisioners, provider, pods, dense_solver=solver)
        t0 = time.perf_counter()
        results = scheduler.solve(pods)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, outcome(results, pods)

    unsharded = DenseSolver(min_batch=1, use_mesh=False)
    solve(unsharded)  # warm
    unsharded_ms, want = solve(unsharded)
    solver = DenseSolver(min_batch=1)
    mesh = solver._active_mesh()
    check(mesh is not None and mesh.size == cards, f"the auto-detected mesh: {None if mesh is None else mesh.shape}")
    solve(solver)  # warm: each card places the catalog's type block
    keyed, calls = sharded_module.bucket_cost_keyed, []

    def recording(*operands):
        packed, key = keyed(*operands)
        calls.append((operands, packed, key))
        return packed, key

    sharded_module.bucket_cost_keyed = recording
    try:
        read_launches()
        keyed_before = bucket_cost.KEYED_LAUNCHES
        mesh_ms, got = solve(solver)
        keyed_launches = bucket_cost.KEYED_LAUNCHES - keyed_before
        launches = read_launches()
    finally:
        sharded_module.bucket_cost_keyed = keyed
    held = []
    for operands, packed, key in calls:
        want_packed, want_key = bucket_type_cost_keyed(*operands)
        held.append(bool(torch.equal(packed, want_packed)) and bool(torch.equal(key, want_key)))
    line = {
        "phase": "auto_mesh",
        "pods": len(pods),
        "mesh": {"blocks": mesh.size, **mesh.shape, "devices": sorted({str(d) for _, _, d in mesh.blocks()})},
        "wall_ms": mesh_ms,
        "unsharded_wall_ms": unsharded_ms,
        "keyed_launches": keyed_launches,
        "unkeyed_launches": launches["bucket_type_cost"],
        "sharded_batches": solver.stats.sharded_batches,
        "kernel_holds": {"calls": len(calls), "identical": held.count(True), "devices": sorted({str(c[0][0].device) for c in calls})},
        "nodes": len(got["nodes"]),
        "cost": got["cost"],
        "unsharded_nodes": len(want["nodes"]),
        "unsharded_cost": want["cost"],
        "placements_identical": got["nodes"] == want["nodes"],
    }
    check(keyed_launches == mesh.size and launches["bucket_type_cost"] == 0, f"the mesh solve launched keyed K1 {keyed_launches} times and K1 {launches['bucket_type_cost']}")
    check(len(held) == mesh.size and all(held), f"the mesh solve's K1 calls: {len(held)} captured, {held.count(False)} disagree with the plain version")
    check(line["placements_identical"] and got["cost"] == want["cost"], "the mesh solve placed pods differently from the unsharded solve")
    check(got["scheduled"] == len(pods) and got["unschedulable"] == 0, "the mesh solve left pods unscheduled")
    return line, mesh, want


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_multicard: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from karpenter_tpu_torch import testing
        from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
        from karpenter_tpu_torch.ops import bucket_cost, warmfill
    except ImportError as exc:
        print(f"chip_multicard: the karpenter_tpu_torch package is not importable here: {exc}", file=sys.stderr)
        return 2
    card_name = card()
    cards = torch.cuda.device_count()
    failed = None
    try:
        check(cards > 1, f"{cards} card visible: the mesh over cards needs several")
        build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])
        print(json.dumps(nccl_fleet(cards)), flush=True)
        pods = testing.build_workload(HEADLINE_PODS)
        provider = FakeCloudProvider(instance_types(HEADLINE_TYPES))
        provisioners = [testing.make_provisioner()]
        line, mesh, want = auto_mesh(cards, pods, provider, provisioners)
        print(json.dumps(line), flush=True)
        budget = mesh_budget_case(torch.device("cuda"), mesh, pods, provider, provisioners, want)
        print(json.dumps({"phase": "budget", "mesh_devices": line["mesh"]["devices"], **budget}), flush=True)
    except PhaseFailed as exc:
        failed = str(exc)
        print(json.dumps({"phase": "failed", "error": failed}), flush=True)
    print(card_name, flush=True)
    print(json.dumps({"ok": failed is None, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cards}}), flush=True)
    return 0 if failed is None else 1


if __name__ == "__main__":
    sys.exit(main())
