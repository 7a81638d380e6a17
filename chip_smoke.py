"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. It builds both kernels of the port from
karpenter_tpu_torch/csrc/ (the bucket -> instance-type cost kernel K1 and
the warm-fill admission kernel K2, one nvcc each, started together), holds
each against its plain PyTorch version bit for bit, and runs the
provisioning solve through the port's build_scheduler(...).solve(pods):

  - headline_10k_x_500: 10,000 pending pods x 500 instance types on an
    empty cluster (K1), also solved with K1's plain version and through the
    exact host loop;
  - selectors_taints_5k_x_500 (K1);
  - repack_16k_x_2400: 16,000 pods x 100 types onto a warm cluster of
    2,400 nodes that takes every pod (K2, never K1), also solved with K2's
    plain version;
  - warm_overflow_10k_x_500: the headline batch on a warm cluster of 300
    nodes that cannot hold it, so K1 runs after K2 in the same solve; also
    solved with both plain versions and through the exact host loop.

Each solve checks that its kernels launched (counts zeroed just before the
timed solves, read just after), that every pod was scheduled, and that the
placements equal the plain versions' solve. It times the kernels and prints
one JSON object per phase. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed phase exits non-zero. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import torch

PARITY_SHAPES = [(1, 1, 1), (3, 7, 2), (16, 100, 4), (53, 500, 8), (64, 512, 8)]
WARM_PARITY_SHAPES = [(1, 1, 2), (5, 17, 3), (8, 128, 3), (32, 200, 4), (64, 512, 3), (30, 2400, 8)]
PARITY_SEEDS = range(8)
HEADLINE_PODS, HEADLINE_TYPES = 10_000, 500
# (name, pods, workload seed, types, warm nodes): bench.py's repack config
# (BASELINE config 4 at 16k)
REPACK = ("repack_16k_x_2400", 16_000, 5, 100, 2400)
# (name, warm nodes): the headline batch on a cluster too small for it
OVERFLOW = ("warm_overflow_10k_x_500", 300)
SOLVE_TRIALS = 3
KERNEL_ITERS, PLAIN_ITERS, SCALING_ITERS = 200, 20, 50
# the host loop may cost at most this much more than dense, as
# tests/test_dense_solver.py:test_mixed_workload_cost_parity allows
HOST_COST_SLACK = 1.3
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def scaling_shapes(B, T):
    """(buckets, types) for K1's scaling phase around the headline's (B, T)."""
    return [(1, T), (B, T), (256, T), (2048, T), (B, 32)]


def random_problem(rng, B, T, R):
    """tests/test_pallas.py's generator."""
    import numpy as np

    sum_req = (rng.random((B, R)) * 20).astype(np.float32)
    max_req = (sum_req * rng.random((B, R))).astype(np.float32)
    caps = (rng.random((T, R)) * 16).astype(np.float32)
    caps[rng.random((T, R)) < 0.1] = 0.0
    prices = (rng.random((T,)) * 4 + 0.1).astype(np.float32)
    allowed = rng.random((B, T)) > 0.3
    return np.stack([sum_req, max_req]), caps, prices, allowed


def random_surface(rng, S, V, R):
    """tests/test_warm_fill_vectorized.py's _random_surface generator."""
    import numpy as np

    sizes = (rng.random((S, R)) * 4).astype(np.float64)
    sizes[rng.random((S, R)) < 0.2] = 0.0
    head = (rng.random((V, R)) * 32).astype(np.float64)
    head[rng.random((V,)) < 0.1] = -1.0
    return sizes, head


def compare(kernel_fn, plain_fn, inputs):
    """Kernel vs plain version on the same device tensors: (equal, max |diff|)."""
    got = kernel_fn(*inputs)
    want = plain_fn(*inputs)
    torch.cuda.synchronize()
    diff = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
    return bool(torch.equal(got, want)), diff


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, iters: int, match: str = ""):
    """Device time per call from torch.profiler's CUDA trace: the summed
    time of the kernels whose name contains `match` (every kernel when
    empty). Returns (ms or None, why None)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:  # the profiler could not trace this card
        return None, f"profiler failed: {exc}"
    total_us = sum(evt.self_device_time_total for evt in prof.key_averages() if match in evt.key)
    if total_us <= 0:
        return None, "the profiler showed no device time"
    return total_us / iters / 1e3, ""


def outcome(results, pods):
    """Placements of one solve: per new node its instance type and the sorted
    input indices of its pods; per existing node (by name) the input indices
    of the pods it took, in commit order."""
    index = {p.uid: i for i, p in enumerate(pods)}
    nodes = sorted(
        (n.instance_type_options[0].name(), tuple(sorted(index[p.uid] for p in n.pods)))
        for n in results.new_nodes
        if n.pods
    )
    views = [(v.node.name, tuple(index[p.uid] for p in v.pods)) for v in results.existing_nodes if v.pods]
    on_existing = sum(len(v[1]) for v in views)
    return {
        "nodes": nodes,
        "views": views,
        "on_existing": on_existing,
        "scheduled": sum(len(n.pods) for n in results.new_nodes) + on_existing,
        "unschedulable": len(results.unschedulable),
        "cost": sum(n.instance_type_options[0].price() for n in results.new_nodes if n.pods),
    }


def build_kernels(libraries):
    """One nvcc per kernel source, all started together."""
    results = {}

    def run(lib):
        try:
            results[lib.name] = lib.build(verbose=True)
        except Exception as exc:  # reported below as a failed phase
            results[lib.name] = exc

    threads = [threading.Thread(target=run, args=(lib,)) for lib in libraries]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for lib in libraries:
        built = results[lib.name]
        if isinstance(built, Exception):
            raise PhaseFailed(f"building {lib.source.name} failed: {built}")
        ptxas = [line.strip() for line in built["log"].splitlines() if "registers" in line or "spill" in line]
        emit({"phase": "build", "source": str(lib.source.relative_to(lib.source.parents[2])), "seconds": built["seconds"], "built": built["built"], "ptxas": ptxas})
    emit({"phase": "build_all", "wall_seconds": wall, "sources": len(libraries)})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from karpenter_tpu_torch import testing
        from karpenter_tpu_torch.api.objects import Taint
        from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
        from karpenter_tpu_torch.ops import bucket_cost, warmfill
        from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
        from karpenter_tpu_torch.ops.warmfill import warm_fill_counts, warm_fill_counts_np
        from karpenter_tpu_torch.scheduler import build_scheduler
        from karpenter_tpu_torch.solver import DenseSolver, DenseSolveStats
        from karpenter_tpu_torch.solver import dense as dense_module
        from karpenter_tpu_torch.solver import warmfill as fill_module
    except ImportError as exc:
        print(f"chip_smoke: the karpenter_tpu_torch package is not importable here: {exc}", file=sys.stderr)
        return 2
    import numpy as np

    dev = torch.device("cuda")
    kernel = bucket_cost.bucket_cost_packed
    k2 = warmfill.warm_fill_counts_device
    solve_lines = {}

    # 1. build both kernels from the checkout's sources
    build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])

    # 2. K1 against its plain version on the card, test_pallas.py's shapes
    mismatches, max_err = [], 0
    for B, T, R in PARITY_SHAPES:
        for seed in PARITY_SEEDS:
            stats, caps, prices, allowed = random_problem(np.random.default_rng(seed * 1000 + B), B, T, R)
            inputs = [torch.from_numpy(a).to(dev) for a in (stats, caps, prices, allowed)]
            equal, diff = compare(kernel, bucket_type_cost_packed, inputs)
            max_err = max(max_err, diff)
            if not equal:
                mismatches.append([B, T, R, seed])
    emit({"phase": "kernel_parity", "kernel": "bucket_type_cost", "shapes": [list(s) for s in PARITY_SHAPES], "seeds": len(PARITY_SEEDS), "tolerance": "exact", "mismatches": mismatches, "max_abs_err": max_err})
    check(not mismatches, f"K1 disagrees with its plain version at {mismatches}")

    # 3. K2 against its plain version on the card (exact), and the counts an
    # upper bound on the exact f64 closed form
    def k2_parity(sizes, head):
        """sizes/head as f32 CUDA tensors; returns (equal, max |diff|, upper bound holds)."""
        equal, diff = compare(k2, warm_fill_counts, [sizes, head])
        got = k2(sizes, head).cpu().numpy()
        exact = warm_fill_counts_np(sizes.double().cpu().numpy(), head.double().cpu().numpy())
        return equal, diff, bool((got >= np.minimum(exact, 1 << 30)).all())

    mismatches, under, k2_err = [], [], 0
    for S, V, R in WARM_PARITY_SHAPES:
        for seed in PARITY_SEEDS:
            sizes, head = random_surface(np.random.default_rng(seed * 101 + S), S, V, R)
            equal, diff, bound = k2_parity(
                torch.from_numpy(sizes.astype(np.float32)).to(dev), torch.from_numpy(head.astype(np.float32)).to(dev)
            )
            k2_err = max(k2_err, diff)
            if not equal:
                mismatches.append([S, V, R, seed])
            if not bound:
                under.append([S, V, R, seed])
    emit({"phase": "kernel_parity", "kernel": "warm_fill_counts", "shapes": [list(s) for s in WARM_PARITY_SHAPES], "seeds": len(PARITY_SEEDS), "tolerance": "exact", "mismatches": mismatches, "upper_bound_violations": under, "max_abs_err": k2_err})
    check(not mismatches, f"K2 disagrees with its plain version at {mismatches}")
    check(not under, f"K2 under-counts the exact closed form at {under}")

    def solve(pods, provider, provisioners, solver, state_nodes=()):
        if solver is not None:
            solver.stats = DenseSolveStats()
        scheduler = build_scheduler(provisioners, provider, pods, state_nodes=state_nodes, dense_solver=solver)
        t0 = time.perf_counter()
        results = scheduler.solve(pods)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, results, solver.stats if solver is not None else None

    def timed_solves(name, pods, provider, provisioners, state_nodes=(), kernels=("bucket_type_cost",)):
        """One warm-up solve, then SOLVE_TRIALS timed ones by the same solver
        (its catalog stays resident), with both kernels' launch counts zeroed
        just before and read just after. The views copy what they take from
        the state nodes, so every solve starts from the same cluster."""
        solver = DenseSolver(min_batch=1)
        solve(pods, provider, provisioners, solver, state_nodes)
        bucket_cost.LAUNCHES = 0
        warmfill.LAUNCHES = 0
        runs = [solve(pods, provider, provisioners, solver, state_nodes) for _ in range(SOLVE_TRIALS)]
        launches = {"bucket_type_cost": bucket_cost.LAUNCHES, "warm_fill_counts": warmfill.LAUNCHES}
        ms, results, s = runs[-1]
        got = outcome(results, pods)
        line = {
            "phase": "solve",
            "config": name,
            "pods": len(pods),
            "types": len(provider.get_instance_types(provisioners[0])),
            "warm_nodes": len(state_nodes),
            "wall_ms": statistics.median(r[0] for r in runs),
            "wall_ms_runs": [r[0] for r in runs],
            "kernel_launches": launches,
            "pods_committed": s.pods_committed,
            "pods_on_existing": s.pods_on_existing,
            "pods_to_host": s.pods_to_host,
            "fills_vectorized": sum(r[2].fills_vectorized for r in runs),
            "fills_host": sum(r[2].fills_host for r in runs),
            "fill_pods_vectorized": s.fill_pods_vectorized,
            "fill_pods_host": s.fill_pods_host,
            "nodes": len(got["nodes"]),
            "cost": got["cost"],
            "scheduled": got["scheduled"],
            "unschedulable": got["unschedulable"],
            "phases_ms": {
                k: getattr(s, f"{k}_seconds") * 1e3
                for k in ("encode", "fill", "fill_device", "device", "mask", "assemble", "device_wait", "commit")
            },
        }
        emit(line)
        solve_lines[name] = line
        for k in kernels:
            check(launches[k] >= SOLVE_TRIALS, f"{name}: {k} launched {launches[k]} times in {SOLVE_TRIALS} solves")
        check(got["scheduled"] == len(pods) and got["unschedulable"] == 0, f"{name}: not every pod scheduled")
        return got

    def plain_versions(k1: bool, k2_plain: bool):
        """Swap the solver's kernel wrappers for their plain versions (on the
        card); returns the undo."""
        saved = (dense_module.bucket_cost_packed, fill_module.warm_fill_counts_device)
        if k1:
            dense_module.bucket_cost_packed = bucket_type_cost_packed
        if k2_plain:
            fill_module.warm_fill_counts_device = warm_fill_counts

        def undo():
            dense_module.bucket_cost_packed, fill_module.warm_fill_counts_device = saved

        return undo

    # 4. the headline solve through K1; the warm-up run records K1's inputs
    # for the timing and parity at the main path's shapes
    pods = testing.build_workload(HEADLINE_PODS)
    provider = FakeCloudProvider(instance_types(HEADLINE_TYPES))
    provisioners = [testing.make_provisioner()]
    captured = []

    def recording(*args):
        captured.append([a.clone() for a in args])
        return kernel(*args)

    dense_module.bucket_cost_packed = recording
    try:
        solve(pods, provider, provisioners, DenseSolver(min_batch=1))
    finally:
        dense_module.bucket_cost_packed = kernel
    check(len(captured) == 1, f"the headline solve called K1 {len(captured)} times, expected 1")
    headline_inputs = captured[0]
    B, T, R = headline_inputs[3].shape[0], headline_inputs[3].shape[1], headline_inputs[0].shape[2]
    dense_out = timed_solves("headline_10k_x_500", pods, provider, provisioners)

    equal, diff = compare(kernel, bucket_type_cost_packed, headline_inputs)
    emit({"phase": "kernel_parity", "kernel": "bucket_type_cost", "shapes": [[B, T, R]], "source": "headline solve inputs", "tolerance": "exact", "mismatches": [] if equal else [[B, T, R]], "max_abs_err": diff})
    check(equal, f"K1 disagrees with its plain version at the headline shape ({B}, {T}, {R})")
    max_err = max(max_err, diff)

    # 5. the same solve with K1's plain version on the card: same placements
    undo = plain_versions(k1=True, k2_plain=False)
    try:
        plain_ms, plain_results, _ = solve(pods, provider, provisioners, DenseSolver(min_batch=1))
    finally:
        undo()
    plain_out = outcome(plain_results, pods)
    same = plain_out["nodes"] == dense_out["nodes"]
    emit({"phase": "plain_solve", "config": "headline_10k_x_500", "wall_ms": plain_ms, "nodes": len(plain_out["nodes"]), "cost": plain_out["cost"], "placements_identical": same})
    check(same, "K1's and its plain version's solves placed pods differently")

    # 6. the exact host loop on the same batch
    host_ms, host_results, _ = solve(pods, provider, provisioners, None)
    host_out = outcome(host_results, pods)
    within = dense_out["cost"] <= host_out["cost"] * HOST_COST_SLACK + 1e-6
    emit({"phase": "host_solve", "config": "headline_10k_x_500", "wall_ms": host_ms, "nodes": len(host_out["nodes"]), "cost": host_out["cost"], "scheduled": host_out["scheduled"], "dense_cost": dense_out["cost"], "cost_within_slack": within})
    check(host_out["scheduled"] == len(pods) and host_out["unschedulable"] == 0, "host loop left pods unscheduled")
    check(within, f"dense cost {dense_out['cost']} exceeds {HOST_COST_SLACK} x host cost {host_out['cost']}")
    del host_results, plain_results

    # 7. the selectors + taints configuration
    tainted = testing.make_provisioner(taints=[Taint(key="dedicated", value="batch", effect="NoSchedule")])
    timed_solves(
        "selectors_taints_5k_x_500",
        testing.build_selectors_taints_workload(5000),
        FakeCloudProvider(instance_types(500)),
        [tainted],
    )

    # 8. the warm repack: every pod fits the existing nodes, so the fill
    # takes the batch through K2 and K1 never runs. The warm-up solve
    # records K2's inputs.
    name, n_pods, seed, n_types, n_nodes = REPACK
    repack_pods = testing.build_workload(n_pods, seed=seed)
    repack_provider = FakeCloudProvider(instance_types(n_types))
    repack_nodes = testing.build_repack_state(n_nodes)
    k2_captured = []

    def k2_recording(sizes, head):
        k2_captured.append([sizes.clone(), head.clone()])
        return k2(sizes, head)

    fill_module.warm_fill_counts_device = k2_recording
    try:
        solve(repack_pods, repack_provider, provisioners, DenseSolver(min_batch=1), repack_nodes)
    finally:
        fill_module.warm_fill_counts_device = k2
    check(len(k2_captured) == 1, f"the repack solve called K2 {len(k2_captured)} times, expected 1")
    repack_inputs = k2_captured[0]
    S, V, R2 = repack_inputs[0].shape[0], repack_inputs[1].shape[0], repack_inputs[0].shape[1]
    equal, diff, bound = k2_parity(*repack_inputs)
    emit({"phase": "kernel_parity", "kernel": "warm_fill_counts", "shapes": [[S, V, R2]], "source": "repack solve inputs", "tolerance": "exact", "mismatches": [] if equal else [[S, V, R2]], "upper_bound_holds": bound, "max_abs_err": diff})
    check(equal, f"K2 disagrees with its plain version at the repack shape ({S}, {V}, {R2})")
    check(bound, "K2 under-counts the exact closed form at the repack solve's inputs")
    k2_err = max(k2_err, diff)

    repack_out = timed_solves(name, repack_pods, repack_provider, provisioners, repack_nodes, kernels=("warm_fill_counts",))
    line = solve_lines[name]
    check(line["fills_vectorized"] == SOLVE_TRIALS, f"{name}: {line['fills_vectorized']} vectorized fills in {SOLVE_TRIALS} solves")
    check(line["fill_pods_host"] == 0, f"{name}: {line['fill_pods_host']} pods took the host-loop fill")
    check(line["kernel_launches"]["bucket_type_cost"] == 0, f"{name}: K1 launched though the fill took every pod")

    undo = plain_versions(k1=True, k2_plain=True)
    try:
        plain_ms, plain_results, _ = solve(repack_pods, repack_provider, provisioners, DenseSolver(min_batch=1), repack_nodes)
    finally:
        undo()
    plain_out = outcome(plain_results, repack_pods)
    same = plain_out["views"] == repack_out["views"] and plain_out["nodes"] == repack_out["nodes"]
    emit({"phase": "plain_solve", "config": name, "wall_ms": plain_ms, "on_existing": plain_out["on_existing"], "nodes": len(plain_out["nodes"]), "placements_identical": same})
    check(same, f"{name}: K2's and its plain version's solves placed pods differently")
    del plain_results, repack_pods

    # 9. the headline batch on a warm cluster too small for it: K2 fills the
    # existing nodes, then K1 prices new nodes for the rest in the same solve
    name, n_nodes = OVERFLOW
    warm_nodes = testing.build_repack_state(n_nodes)
    overflow_out = timed_solves(name, pods, provider, provisioners, warm_nodes, kernels=("bucket_type_cost", "warm_fill_counts"))
    check(overflow_out["on_existing"] > 0 and overflow_out["nodes"], f"{name}: the fill or the new-node solve placed nothing")
    undo = plain_versions(k1=True, k2_plain=True)
    try:
        plain_ms, plain_results, _ = solve(pods, provider, provisioners, DenseSolver(min_batch=1), warm_nodes)
    finally:
        undo()
    plain_out = outcome(plain_results, pods)
    same = plain_out["views"] == overflow_out["views"] and plain_out["nodes"] == overflow_out["nodes"]
    emit({"phase": "plain_solve", "config": name, "wall_ms": plain_ms, "on_existing": plain_out["on_existing"], "nodes": len(plain_out["nodes"]), "cost": plain_out["cost"], "placements_identical": same})
    check(same, f"{name}: the kernels' and the plain versions' solves placed pods differently")
    host_ms, host_results, _ = solve(pods, provider, provisioners, None, warm_nodes)
    host_out = outcome(host_results, pods)
    within = overflow_out["cost"] <= host_out["cost"] * HOST_COST_SLACK + 1e-6
    emit({"phase": "host_solve", "config": name, "wall_ms": host_ms, "on_existing": host_out["on_existing"], "nodes": len(host_out["nodes"]), "cost": host_out["cost"], "scheduled": host_out["scheduled"], "dense_cost": overflow_out["cost"], "cost_within_slack": within})
    check(host_out["scheduled"] == len(pods) and host_out["unschedulable"] == 0, f"{name}: host loop left pods unscheduled")
    check(within, f"{name}: dense cost {overflow_out['cost']} exceeds {HOST_COST_SLACK} x host cost {host_out['cost']}")
    del pods, host_results, plain_results

    # 10. each kernel's time at its main path's shape beside its bound and
    # its plain version
    kernel_ms = cuda_ms(lambda: kernel(*headline_inputs), KERNEL_ITERS)
    plain_ms_k = cuda_ms(lambda: bucket_type_cost_packed(*headline_inputs), PLAIN_ITERS)
    kernel_device_ms, kernel_why = profiled_device_ms(lambda: kernel(*headline_inputs), KERNEL_ITERS, "bucket_cost_kernel")
    plain_device_ms, plain_why = profiled_device_ms(lambda: bucket_type_cost_packed(*headline_inputs), PLAIN_ITERS)
    in_bytes = sum(t.numel() * t.element_size() for t in headline_inputs)
    out_bytes = 3 * B * 4
    # per (b, t, r): divide, max, add, compare; per (b, t): ceil, max, 3 mul, 2 add, select
    ops = B * T * (4 * R + 8)
    bytes_ms = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3

    k2_ms = cuda_ms(lambda: k2(*repack_inputs), KERNEL_ITERS)
    k2_plain_ms = cuda_ms(lambda: warm_fill_counts(*repack_inputs), PLAIN_ITERS)
    k2_device_ms, k2_why = profiled_device_ms(lambda: k2(*repack_inputs), KERNEL_ITERS, "warm_fill_kernel")
    k2_plain_device_ms, k2_plain_why = profiled_device_ms(lambda: warm_fill_counts(*repack_inputs), PLAIN_ITERS)
    k2_bytes_ms = ((S + V) * R2 * 4 + S * V * 4) / H100_BYTES_PER_S * 1e3
    # per (s, v, r): compare, mul, add, select, mul, divide, min; per (s, v):
    # floor, max, min, select
    k2_ops_ms = S * V * (7 * R2 + 4) / H100_F32_OPS_PER_S * 1e3

    # how K1's own device time scales with the buckets (rows, one warp each)
    # and the types (the loop each lane runs)
    scaling = []
    for sB, sT in scaling_shapes(B, T):
        stats, caps, prices, allowed = random_problem(np.random.default_rng(sB * 7 + sT), sB, sT, R)
        inputs = [torch.from_numpy(a).to(dev) for a in (stats, caps, prices, allowed)]
        ms, why = profiled_device_ms(lambda: kernel(*inputs), SCALING_ITERS, "bucket_cost_kernel")
        scaling.append({"shape": [sB, sT, R], "device_ms": ms, "device_ms_missing": why or None})
    emit({"phase": "kernel_scaling", "kernel": "bucket_type_cost", "runs": scaling})
    emit({
        "kernels": [
            {
                "name": "bucket_type_cost",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/bucket_cost.cu",
                "replaces": "karpenter_tpu/ops/pallas_kernels.py:35",
                "launches": solve_lines["headline_10k_x_500"]["kernel_launches"]["bucket_type_cost"],
                "max_abs_err": max_err,
                "ms": kernel_ms,
                "kernel_ms": kernel_ms,
                "plain_ms": plain_ms_k,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None,
                "parity": True,
                "shape": [B, T, R],
                "device_ms": kernel_device_ms,
                "plain_device_ms": plain_device_ms,
                "device_ms_missing": kernel_why or plain_why or None,
                "note": "ms and plain_ms are CUDA-event times per call of the wrapper, back to back; "
                "device_ms is the kernel's own time in the profiler's trace. The bound is far below "
                "both: launch latency and each warp's serial loop over the types set the kernel's time "
                "(see the kernel_scaling phase)",
            },
            {
                "name": "warm_fill_counts",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/warm_fill.cu",
                "replaces": "karpenter_tpu/ops/warmfill.py:89",
                "launches": solve_lines[REPACK[0]]["kernel_launches"]["warm_fill_counts"],
                "max_abs_err": k2_err,
                "ms": k2_ms,
                "kernel_ms": k2_ms,
                "plain_ms": k2_plain_ms,
                "bound_ms": max(k2_bytes_ms, k2_ops_ms),
                "bound_by": "bytes" if k2_bytes_ms >= k2_ops_ms else "operations",
                "library_ms": None,
                "parity": True,
                "shape": [S, V, R2],
                "device_ms": k2_device_ms,
                "plain_device_ms": k2_plain_device_ms,
                "device_ms_missing": k2_why or k2_plain_why or None,
                "note": "launches are those of the repack solve's 3 timed solves; the overflow solve's are in "
                "its solve line. No single PyTorch call computes the surface",
            },
        ]
    })

    # 11. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
