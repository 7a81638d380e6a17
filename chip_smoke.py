"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. It builds the bucket -> instance-type cost kernel from
karpenter_tpu_torch/csrc/, holds it against its plain PyTorch version bit
for bit, runs the provisioning solve at the headline size (10,000 pending
pods x 500 instance types, empty cluster) through the port's
build_scheduler(...).solve(pods), checks that the solve went through the
kernel and agrees with the plain version and the exact host loop, times the
kernel, and prints one JSON object per phase. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed phase exits non-zero. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

PARITY_SHAPES = [(1, 1, 1), (3, 7, 2), (16, 100, 4), (53, 500, 8), (64, 512, 8)]
PARITY_SEEDS = range(8)
HEADLINE_PODS, HEADLINE_TYPES = 10_000, 500
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
    """(buckets, types) for the kernel's scaling phase around the headline's (B, T)."""
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
    index = {p.uid: i for i, p in enumerate(pods)}
    nodes = sorted(
        (n.instance_type_options[0].name(), tuple(sorted(index[p.uid] for p in n.pods)))
        for n in results.new_nodes
        if n.pods
    )
    return {
        "nodes": nodes,
        "scheduled": sum(len(n.pods) for n in results.new_nodes),
        "unschedulable": len(results.unschedulable),
        "cost": sum(n.instance_type_options[0].price() for n in results.new_nodes if n.pods),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from karpenter_tpu_torch import testing
        from karpenter_tpu_torch.api.objects import Taint
        from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
        from karpenter_tpu_torch.ops import bucket_cost
        from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
        from karpenter_tpu_torch.scheduler import build_scheduler
        from karpenter_tpu_torch.solver import DenseSolver, DenseSolveStats
        from karpenter_tpu_torch.solver import dense as dense_module
    except ImportError as exc:
        print(f"chip_smoke: the karpenter_tpu_torch package is not importable here: {exc}", file=sys.stderr)
        return 2
    import numpy as np

    dev = torch.device("cuda")
    kernel = bucket_cost.bucket_cost_packed
    solve_lines = []

    # 1. build the kernel from the checkout's sources
    built = bucket_cost.build(verbose=True)
    ptxas = [line.strip() for line in built["log"].splitlines() if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": built["seconds"], "built": built["built"], "source": "karpenter_tpu_torch/csrc/bucket_cost.cu", "ptxas": ptxas})

    # 2. kernel against its plain version on the card, test_pallas.py's shapes
    mismatches, max_err = [], 0
    for B, T, R in PARITY_SHAPES:
        for seed in PARITY_SEEDS:
            stats, caps, prices, allowed = random_problem(np.random.default_rng(seed * 1000 + B), B, T, R)
            inputs = [torch.from_numpy(a).to(dev) for a in (stats, caps, prices, allowed)]
            equal, diff = compare(kernel, bucket_type_cost_packed, inputs)
            max_err = max(max_err, diff)
            if not equal:
                mismatches.append([B, T, R, seed])
    emit({"phase": "kernel_parity", "shapes": [list(s) for s in PARITY_SHAPES], "seeds": len(PARITY_SEEDS), "tolerance": "exact", "mismatches": mismatches, "max_abs_err": max_err})
    check(not mismatches, f"kernel disagrees with the plain version at {mismatches}")

    def solve(pods, provider, provisioners, solver):
        if solver is not None:
            solver.stats = DenseSolveStats()
        scheduler = build_scheduler(provisioners, provider, pods, dense_solver=solver)
        t0 = time.perf_counter()
        results = scheduler.solve(pods)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, results, solver

    def timed_solves(name, pods, provider, provisioners):
        """One warm-up solve, then SOLVE_TRIALS timed ones by the same solver
        (its catalog stays resident), with the kernel's launch count zeroed
        just before and read just after."""
        solver = DenseSolver(min_batch=1)
        solve(pods, provider, provisioners, solver)
        bucket_cost.LAUNCHES = 0
        runs = [solve(pods, provider, provisioners, solver) for _ in range(SOLVE_TRIALS)]
        launches = bucket_cost.LAUNCHES
        ms, results, solver = runs[-1]
        got = outcome(results, pods)
        s = solver.stats
        line = {
            "phase": "solve",
            "config": name,
            "pods": len(pods),
            "types": len(provider.get_instance_types(provisioners[0])),
            "wall_ms": statistics.median(r[0] for r in runs),
            "wall_ms_runs": [r[0] for r in runs],
            "kernel_launches": launches,
            "pods_committed": s.pods_committed,
            "pods_to_host": s.pods_to_host,
            "nodes": len(got["nodes"]),
            "cost": got["cost"],
            "scheduled": got["scheduled"],
            "unschedulable": got["unschedulable"],
            "phases_ms": {
                k: getattr(s, f"{k}_seconds") * 1e3
                for k in ("encode", "device", "mask", "assemble", "device_wait", "commit")
            },
        }
        emit(line)
        solve_lines.append(line)
        check(launches >= SOLVE_TRIALS, f"{name}: the kernel launched {launches} times in {SOLVE_TRIALS} solves")
        check(got["scheduled"] == len(pods) and got["unschedulable"] == 0, f"{name}: not every pod scheduled")
        return got

    # 3. the headline solve through the kernel; the warm-up run records the
    # kernel's inputs for the timing and parity at the main path's shapes
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
    check(len(captured) == 1, f"the headline solve called the kernel {len(captured)} times, expected 1")
    headline_inputs = captured[0]
    B, T, R = headline_inputs[3].shape[0], headline_inputs[3].shape[1], headline_inputs[0].shape[2]
    dense_out = timed_solves("headline_10k_x_500", pods, provider, provisioners)

    equal, diff = compare(kernel, bucket_type_cost_packed, headline_inputs)
    emit({"phase": "kernel_parity", "shapes": [[B, T, R]], "source": "headline solve inputs", "tolerance": "exact", "mismatches": [] if equal else [[B, T, R]], "max_abs_err": diff})
    check(equal, f"kernel disagrees with the plain version at the headline shape ({B}, {T}, {R})")
    max_err = max(max_err, diff)

    # 4. the same solve with the plain version on the card: same placements
    dense_module.bucket_cost_packed = bucket_type_cost_packed
    try:
        plain_ms, plain_results, _ = solve(pods, provider, provisioners, DenseSolver(min_batch=1))
    finally:
        dense_module.bucket_cost_packed = kernel
    plain_out = outcome(plain_results, pods)
    same = plain_out["nodes"] == dense_out["nodes"]
    emit({"phase": "plain_solve", "config": "headline_10k_x_500", "wall_ms": plain_ms, "nodes": len(plain_out["nodes"]), "cost": plain_out["cost"], "placements_identical": same})
    check(same, "the kernel's and the plain version's solves placed pods differently")

    # 5. the exact host loop on the same batch
    host_ms, host_results, _ = solve(pods, provider, provisioners, None)
    host_out = outcome(host_results, pods)
    within = dense_out["cost"] <= host_out["cost"] * HOST_COST_SLACK + 1e-6
    emit({"phase": "host_solve", "config": "headline_10k_x_500", "wall_ms": host_ms, "nodes": len(host_out["nodes"]), "cost": host_out["cost"], "scheduled": host_out["scheduled"], "dense_cost": dense_out["cost"], "cost_within_slack": within})
    check(host_out["scheduled"] == len(pods) and host_out["unschedulable"] == 0, "host loop left pods unscheduled")
    check(within, f"dense cost {dense_out['cost']} exceeds {HOST_COST_SLACK} x host cost {host_out['cost']}")
    del pods, host_results, plain_results

    # 6. the selectors + taints configuration
    tainted = testing.make_provisioner(taints=[Taint(key="dedicated", value="batch", effect="NoSchedule")])
    timed_solves(
        "selectors_taints_5k_x_500",
        testing.build_selectors_taints_workload(5000),
        FakeCloudProvider(instance_types(500)),
        [tainted],
    )

    # 7. the kernel's time at the headline shape beside its bound and its plain version
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

    # how the kernel's own device time scales with the buckets (rows, one
    # warp each) and the types (the loop each lane runs): tells launch cost
    # from per-warp latency at the main path's low row counts
    scaling = []
    for sB, sT in scaling_shapes(B, T):
        stats, caps, prices, allowed = random_problem(np.random.default_rng(sB * 7 + sT), sB, sT, R)
        inputs = [torch.from_numpy(a).to(dev) for a in (stats, caps, prices, allowed)]
        ms, why = profiled_device_ms(lambda: kernel(*inputs), SCALING_ITERS, "bucket_cost_kernel")
        scaling.append({"shape": [sB, sT, R], "device_ms": ms, "device_ms_missing": why or None})
    emit({"phase": "kernel_scaling", "runs": scaling})
    headline = solve_lines[0]
    emit({
        "kernels": [{
            "name": "bucket_type_cost",
            "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/bucket_cost.cu",
            "replaces": "karpenter_tpu/ops/pallas_kernels.py:35",
            "launches": headline["kernel_launches"],
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
        }]
    })

    # 8. the card
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
