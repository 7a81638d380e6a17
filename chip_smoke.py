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
    solved with both plain versions and through the exact host loop;
  - incremental_churn_300 and incremental_churn_2400: bench.py's
    incremental churn (3 pod binds and 1 node refresh per pass, then a
    50-pod batch; 2 warm-up passes, 12 measured) on 300 and on 2,400
    standing nodes, through one persistent DenseSolver carrying the
    incremental engine (solver/incremental.py) and the residency auditor on
    every pass: each pass is a delta pass whose K2 launch reads the
    engine's resident head buffer, rebased on the card by the torch rebase
    (ops/rebase.py). The measured passes must all be delta passes with no
    full encode, no audit divergence, no kernel build, the resident buffer
    one of the engine's two and one K2 launch each; the same churn with
    K2's plain version swapped in must place every pass identically and
    launch no kernel, and a last pass must place as a fresh solver does.

K2 is held against its plain version three ways per input: through its
wrapper on CUDA tensors, through the warm solve's round trip from host
arrays (ops/warmfill.py:AdmissionSurface.counts) and through the round trip
against a resident [Vp, R] head buffer (counts_resident, the incremental
engine's path, which uploads the sizes only); all make the same one call
into the kernel's library. The torch rebase and the auditor's row gather
are held exactly against the numpy oracle (rebase_parity). Each solve checks that its kernels launched (counts
zeroed just before the timed solves, read just after), that every pod was
scheduled, and that the placements equal the plain versions' solve, in
which neither kernel may launch. The warm solves report K2's round trip
(fill_device) in its parts: staging, enqueue, wait.

The card's name and power limit are read first and printed in every line of
the churn phases. Then it measures, on the same card: the launch floor (the device time of
the smallest kernel PyTorch launches); how each kernel's device time
scales with its shape (kernel_scaling); and each kernel's time at its main
path's shape beside its bound. It prints one JSON object per phase.
chip_sweep.py holds the measurements that chose the kernels' launch
geometries and K2's round trip. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed phase exits non-zero. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# (B, T, R[, kind]): test_pallas.py's shapes, then K1's edges: T past one
# block and not a multiple of it, B past the grid cap, a tie-heavy catalog
# (price in proportion to capacity) and buckets with no feasible type
PARITY_SHAPES = [
    (1, 1, 1), (3, 7, 2), (16, 100, 4), (53, 500, 8), (64, 512, 8),
    (8, 1025, 8), (64, 2000, 8), (2048, 500, 8), (5000, 64, 3),
    (16, 600, 4, "ties"), (30, 500, 8, "ties"), (64, 2000, 8, "ties"),
    (12, 200, 3, "infeasible"), (2048, 500, 8, "infeasible"),
    (30, 500, 8, "unrequested"), (2048, 500, 8, "unrequested"),
]
# (S, V, R): then K2's edges: S not a multiple of the size-class chunk, V
# not a multiple of the node tile, S in the hundreds
WARM_PARITY_SHAPES = [
    (1, 1, 2), (5, 17, 3), (8, 128, 3), (32, 200, 4), (64, 512, 3), (30, 2400, 8),
    (37, 300, 8), (300, 129, 3), (301, 2400, 8), (30, 20001, 4),
]
PARITY_SEEDS = range(8)
K1_SCALING_B, K1_SCALING_T = (30, 2048), (32, 500, 1024, 2000)
K2_SCALING = [(30, 2400), (300, 2400), (30, 20000)]
# (views before, views after, dirty rows, R) of the rebase parity: row pads
# Vp 128, 384 and 2432, 0 to 200 dirty rows
REBASE_SHAPES = [
    (3, 5, 2, 8), (120, 128, 8, 8), (128, 100, 9, 3), (300, 300, 4, 8), (300, 290, 40, 8), (380, 360, 100, 8),
    (2400, 2400, 4, 8), (2400, 2410, 130, 8), (2420, 2432, 200, 8), (2432, 2400, 0, 8),
]
# (name, standing nodes): bench.py's run_incremental_churn(300, 50, 12) and
# the same churn on BASELINE config 4's 2,400-node warm cluster
CHURNS = [("incremental_churn_300", 300), ("incremental_churn_2400", 2400)]
CHURN_PODS, CHURN_WARMUP, CHURN_PASSES, CHURN_AUDIT_SEED = 50, 2, 12, 7
HEADLINE_PODS, HEADLINE_TYPES = 10_000, 500
# (name, pods, workload seed, types, warm nodes): bench.py's repack config
# (BASELINE config 4 at 16k)
REPACK = ("repack_16k_x_2400", 16_000, 5, 100, 2400)
# (name, warm nodes): the headline batch on a cluster too small for it
OVERFLOW = ("warm_overflow_10k_x_500", 300)
SOLVE_TRIALS = 3
KERNEL_ITERS, PLAIN_ITERS, SCALING_ITERS = 200, 20, 50
# the profiler's trace now and then keeps no kernel at all; it is taken again
TRACE_ATTEMPTS = 3
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


def k1_scaling_shapes(B, T):
    """(buckets, types[, kind]) for K1's scaling phase: around the
    headline's (B, T), then K1_SCALING_B x K1_SCALING_T, then the headline's
    resource pattern (most sums zero) at B and 2048."""
    shapes = [(1, T), (B, T), (256, T), (2048, T), (B, 32)]
    shapes += [(b, t) for b in K1_SCALING_B for t in K1_SCALING_T if (b, t) not in shapes]
    return shapes + [(B, T, "unrequested"), (2048, T, "unrequested")]


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


def profiled_total_ms(fn, iters: int):
    """Device time per call of `fn` from torch.profiler's CUDA trace: the
    summed time of every kernel it launched, over `iters` calls (for the
    plain versions, which launch several kernels a call). Returns (ms or
    None, why None)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(evt.self_device_time_total for evt in prof.key_averages())
    if total_us <= 0:
        return None, "the profiler showed no device time"
    return total_us / iters / 1e3, ""


def profiled_device_ms(fn, iters: int, match: str = ""):
    """Device time per launch of `fn`'s one kernel (its name contains
    `match`) from a torch.profiler trace of `iters` calls: the mean over the
    kernels the trace kept, since the profiler may drop events. A trace
    that kept none is taken again, up to TRACE_ATTEMPTS traces. Returns (ms
    or None, why None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kept = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA and match in e.name]
        if kept:
            return statistics.mean(kept) / 1e3, ""
    return None, f"{TRACE_ATTEMPTS} traces kept no kernel named {match!r}"


def profiled_series(fns, iters: int, match: str):
    """profiled_device_ms of each of `fns`, one trace each: (list of ms or
    None, why any is None)."""
    results = [profiled_device_ms(fn, iters, match) for fn in fns]
    return [r[0] for r in results], "; ".join(sorted({r[1] for r in results if r[1]}))


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


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"


def plain_admission_counts(sizes, head, solver, head_dev=None):
    """K2's plain version on the solver's device, in place of the solve's
    round trip (solver/warmfill.py:admission_counts): on the first V rows of
    the engine's resident head where the solve passes it, else on the host
    head uploaded."""
    from karpenter_tpu_torch.ops.warmfill import warm_fill_counts

    t0 = time.perf_counter()
    sizes_t = torch.from_numpy(sizes.astype(np.float32)).to(solver.device)
    if head_dev is not None:
        head_t = head_dev[: head.shape[0]]
    else:
        head_t = torch.from_numpy(head.astype(np.float32)).to(solver.device)
    counts = warm_fill_counts(sizes_t, head_t)
    return counts.cpu().numpy(), (time.perf_counter() - t0, 0.0, 0.0)


def rebase_case(seed, v_old, v_new, d, R):
    """Seeded rebase operands: a buffer with -1.0 pad rows, perm with -1
    slots (padded with -1 to the buffer's rows), d sorted dirty rows and
    their values, as the engine passes them. Also the oracle's idx and rows
    padded as the JAX package pads them (pow2 from 8, pad slots at or past
    Vp, all to be dropped); odd seeds scatter the pad slots among the real
    ones."""
    from karpenter_tpu_torch.ops.rebase import pad_views

    rng = np.random.default_rng(seed * 131 + v_new)
    vp = pad_views(max(v_old, v_new))
    buf = np.full((vp, R), -1.0, np.float32)
    buf[:v_old] = (rng.standard_normal((v_old, R)) * 16).astype(np.float32)
    perm = np.full(vp, -1, np.int64)
    perm[:v_new] = np.where(rng.random(v_new) < 0.8, rng.integers(0, v_old, v_new), -1)
    dirty = np.sort(rng.choice(v_new, size=min(d, v_new), replace=False)).astype(np.int64)
    rows = (rng.standard_normal((len(dirty), R)) * 16).astype(np.float32)
    dp = max(8, 1 << max(len(dirty) - 1, 0).bit_length())
    idx_p = np.concatenate([dirty, vp + rng.integers(0, 3, dp - len(dirty))])
    rows_p = np.concatenate([rows, np.full((dp - len(dirty), R), -1.0, np.float32)])
    if seed % 2:
        order = rng.permutation(dp)
        idx_p, rows_p = idx_p[order], rows_p[order]
    return buf, perm, rows, dirty, idx_p, rows_p


def rebase_parity(dev, card_name) -> None:
    """The torch rebase and the auditor's gather on the card against the
    numpy oracle, exact, into a spare buffer (never allocating its output);
    the oracle is given the JAX package's padded operands."""
    from karpenter_tpu_torch.ops.rebase import gather_rows, rebase_view_state, rebase_view_state_np

    mismatches, err, pads = [], 0.0, set()
    for v_old, v_new, d, R in REBASE_SHAPES:
        for seed in PARITY_SEEDS:
            buf, perm, rows, dirty, idx_p, rows_p = rebase_case(seed, v_old, v_new, d, R)
            vp = buf.shape[0]
            pads.add((vp, idx_p.shape[0]))
            live = torch.from_numpy(buf).to(dev)
            spare = torch.empty_like(live)
            got = rebase_view_state(live, *(torch.from_numpy(a).to(dev) for a in (perm, rows, dirty)), out=spare)
            want = rebase_view_state_np(buf, perm, rows_p, idx_p)
            idx = np.sort(np.random.default_rng(seed).choice(vp, size=min(8, vp), replace=False))
            back = gather_rows(got, torch.from_numpy(idx).to(dev))
            got_np, back_np = got.cpu().numpy(), back.cpu().numpy()
            err = max(err, float(np.abs(got_np - want).max()))
            if got.data_ptr() != spare.data_ptr() or not np.array_equal(got_np, want) or not np.array_equal(back_np, want[idx]):
                mismatches.append([v_old, v_new, d, R, seed])
    emit({"phase": "rebase_parity", "shapes": [list(x) for x in REBASE_SHAPES], "seeds": len(PARITY_SEEDS), "oracle_pads_vp_dp": sorted(pads), "paths": ["rebase_view_state", "gather_rows"], "tolerance": "exact", "mismatches": mismatches, "max_abs_err": err, "card": card_name})
    check(not mismatches, f"the torch rebase disagrees with its numpy oracle at {mismatches}")


def k2_resident_parity(dev, surface, card_name) -> int:
    """K2 from a resident [Vp, R] head buffer (AdmissionSurface.counts_resident,
    only the sizes uploaded) against its plain version on head_dev[:V] and
    against the staged round trip on the same f32 head, exact. Returns the
    largest count difference."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.ops.rebase import pad_views
    from karpenter_tpu_torch.ops.warmfill import warm_fill_counts

    mismatches, err = [], 0
    for S, V, R in WARM_PARITY_SHAPES:
        for seed in PARITY_SEEDS:
            sizes, head = testing.warm_fill_surface(np.random.default_rng(seed * 101 + S), S, V, R)
            padded = np.full((pad_views(V), R), -1.0, np.float32)
            padded[:V] = head.astype(np.float32)
            head_dev = torch.from_numpy(padded).to(dev)
            resident = surface.counts_resident(sizes, head_dev, V)[0].copy()
            staged = surface.counts(sizes, padded[:V])[0].copy()
            plain = warm_fill_counts(torch.from_numpy(sizes.astype(np.float32)).to(dev), head_dev[:V]).cpu().numpy()
            err = max(err, int(np.abs(resident.astype(np.int64) - plain).max()), int(np.abs(staged.astype(np.int64) - plain).max()))
            if not (np.array_equal(resident, plain) and np.array_equal(staged, plain)):
                mismatches.append([S, V, R, seed])
    emit({"phase": "kernel_parity", "kernel": "warm_fill_counts", "shapes": [list(x) for x in WARM_PARITY_SHAPES], "seeds": len(PARITY_SEEDS), "paths": ["AdmissionSurface.counts_resident", "AdmissionSurface.counts", "warm_fill_counts on head_dev[:V]"], "tolerance": "exact", "mismatches": mismatches, "max_abs_err": err, "card": card_name})
    check(not mismatches, f"K2 on a resident head disagrees with its plain version at {mismatches}")
    return err


def churn_run(dev, nodes: int, plain: bool = False) -> dict:
    """bench.py's run_incremental_churn(nodes, CHURN_PODS, CHURN_PASSES) on
    the port, audited every pass: a standing cluster fed through the kube
    store -> watch -> Cluster -> delta journal, one persistent DenseSolver
    carrying the incremental engine and the residency auditor; CHURN_WARMUP
    passes (the cold full encode, the first delta pass), CHURN_PASSES
    measured ones, then a coda pass beside a fresh solver on the same
    snapshot and batch. With plain=True K2's plain version stands in at the
    solve's round trip. Counts are zeroed just before the measured window
    and read per pass. Returns what the run saw."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.controllers.state.cluster import Cluster
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.ops import bucket_cost, warmfill
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver, DenseSolveStats
    from karpenter_tpu_torch.solver import incremental as incremental_module
    from karpenter_tpu_torch.solver import warmfill as fill_module
    from karpenter_tpu_torch.solver.audit import ResidencyAuditor
    from karpenter_tpu_torch.solver.incremental import PASS_DELTA, PASS_FULL, IncrementalEngine

    provider = FakeCloudProvider(instance_types(100))
    provisioners = [testing.make_provisioner()]
    kube = KubeCluster()
    testing.standing_cluster(kube, nodes)
    cluster = Cluster(kube, None)
    engine = IncrementalEngine(cluster.delta_journal, device=dev)
    auditor = ResidencyAuditor(seed=CHURN_AUDIT_SEED)
    solver = DenseSolver(min_batch=1, device=dev, incremental=engine, auditor=auditor)

    # the rebase's device time per pass: CUDA events around the torch
    # program the engine calls (its operands captured for timing it alone)
    rebase = incremental_module.rebase_view_state
    rebase_events, rebase_args = [], []

    def timed_rebase(*args, **kwargs):
        if dev.type != "cuda":
            return rebase(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = rebase(*args, **kwargs)
        end.record()
        rebase_events.append((start, end))
        rebase_args[:] = [list(args), kwargs["out"]]
        return out

    def sig(results):
        existing = [(v.node.name, tuple(p.name for p in v.pods)) for v in results.existing_nodes if v.pods]
        return existing, sorted(tuple(sorted(p.name for p in n.pods)) for n in results.new_nodes)

    def one_pass(run_solver, step):
        pods = testing.churn_batch(step, CHURN_PODS)
        run_solver.stats = DenseSolveStats()
        scheduler = build_scheduler(provisioners, provider, pods, cluster=cluster, state_nodes=cluster.nodes_snapshot(), dense_solver=run_solver)
        del rebase_events[:]
        t0 = time.perf_counter()
        results = scheduler.solve(pods)
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        placed = sig(results)
        check(sum(len(r) for _n, r in placed[0]) + sum(len(r) for r in placed[1]) == len(pods), f"churn on {nodes}: pass {step} left pods unscheduled")
        st = run_solver.stats
        return {
            "step": step,
            "wall_ms": wall,
            "delta_apply_ms": st.delta_apply_seconds * 1e3,
            "rebase_ms": st.rebase_seconds * 1e3,
            "rebase_device_ms": sum(a.elapsed_time(b) for a, b in rebase_events) if rebase_events else None,
            "audit_ms": st.audit_seconds * 1e3,
            "full_encode_ms": st.full_encode_seconds * 1e3,
            "encode_skipped": st.encode_skipped_passes,
            "fills_vectorized": st.fills_vectorized,
            "fill_ms": st.fill_seconds * 1e3,
            "fill_device_ms": st.fill_device_seconds * 1e3,
            "fill_stage_ms": st.fill_stage_seconds * 1e3,
            "fill_enqueue_ms": st.fill_enqueue_seconds * 1e3,
            "fill_wait_ms": st.fill_wait_seconds * 1e3,
            "encode_ms": st.encode_seconds * 1e3,
            "commit_ms": st.commit_seconds * 1e3,
        }, placed

    def read_launches():
        got = {"bucket_type_cost": bucket_cost.LAUNCHES, "warm_fill_counts": warmfill.LAUNCHES}
        bucket_cost.LAUNCHES = 0
        warmfill.LAUNCHES = 0
        return got

    saved = fill_module.admission_counts, incremental_module.rebase_view_state
    if plain:
        fill_module.admission_counts = plain_admission_counts
    incremental_module.rebase_view_state = timed_rebase
    try:
        sigs, records = [], []
        read_launches()
        cold, placed = one_pass(solver, 0)
        sigs.append(placed)
        testing.standing_churn(kube, 0, nodes)
        _first, placed = one_pass(solver, 1)
        sigs.append(placed)
        check(engine.passes[PASS_DELTA] >= 1, f"churn on {nodes}: the warm-up never reached the delta path")
        base = dict(engine.passes)
        audits0 = auditor.audits
        builds0 = {lib.name: lib.builds for lib in (bucket_cost.LIBRARY, warmfill.LIBRARY)}
        buffers = {b.data_ptr() for b in engine.buffers}
        # every K2 call of the window and the coda: whether it was given the
        # engine's live resident buffer (nothing staged but the sizes); the
        # coda's inputs are kept for timing K2 at the run's own shape
        admission = fill_module.admission_counts
        calls, captured = [], []

        def watching(sizes, head, run_solver, head_dev=None):
            calls.append(head_dev is not None and head_dev.data_ptr() == engine._resident.head_dev.data_ptr())
            if head_dev is not None:
                captured[:] = [(sizes.copy(), head.copy(), head_dev.clone())]
            return admission(sizes, head, run_solver, head_dev)

        fill_module.admission_counts = watching
        warmup_launches = read_launches()
        for step in range(CHURN_WARMUP, CHURN_PASSES + CHURN_WARMUP):
            testing.standing_churn(kube, step, nodes)
            before = warmfill.LAUNCHES
            del calls[:]
            record, placed = one_pass(solver, step)
            record["k2_launches"] = warmfill.LAUNCHES - before
            record["k2_calls_on_resident_head"] = sum(calls)
            record["k2_calls_staged"] = len(calls) - sum(calls)
            record["resident_buffer_ok"] = engine._resident.head_dev.data_ptr() in buffers and {b.data_ptr() for b in engine.buffers} == buffers
            records.append(record)
            sigs.append(placed)
        launches = read_launches()
        builds = {lib.name: lib.builds - builds0[lib.name] for lib in (bucket_cost.LIBRARY, warmfill.LIBRARY)}
        window = {
            "delta_passes": engine.passes[PASS_DELTA] - base[PASS_DELTA],
            "full_passes": engine.passes[PASS_FULL] - base[PASS_FULL],
            "audits": auditor.audits - audits0,
            "divergences": dict(auditor.divergences),
            "builds": builds,
            "launches": launches,
        }

        # the coda: the next pass beside a fresh solver on the same snapshot
        # and batch
        step = CHURN_PASSES + CHURN_WARMUP
        testing.standing_churn(kube, step, nodes)
        del calls[:]
        coda, placed = one_pass(solver, step)
        check(calls == [True], f"churn on {nodes}: the coda's K2 calls on the resident head: {calls}")
        fill_module.admission_counts = admission
        fresh, fresh_placed = one_pass(DenseSolver(min_batch=1, device=dev), step)
        sigs.append(placed)
        coda_launches = read_launches()
    finally:
        fill_module.admission_counts, incremental_module.rebase_view_state = saved
    return {
        "cold": cold,
        "records": records,
        "window": window,
        "coda": coda,
        "fresh": fresh,
        "coda_identical": placed == fresh_placed,
        "sigs": sigs,
        "launches_all": {k: warmup_launches[k] + launches[k] + coda_launches[k] for k in launches},
        "k2_inputs": captured[0],
        "rebase_args": rebase_args,
        "views": nodes,
        "vp": engine._resident.vp,
        "engine_passes": dict(engine.passes),
        "engine_invalidations": dict(engine.invalidations),
    }


def incremental_churn(dev, name: str, nodes: int, card_name) -> dict:
    """One churn phase: the run through the kernels, its checks, the same
    churn with K2's plain version, and K2 and the rebase timed at the run's
    own shapes. Prints the phase line; returns it."""
    from karpenter_tpu_torch.ops.rebase import rebase_view_state
    from karpenter_tpu_torch.ops.warmfill import warm_fill_counts

    run = churn_run(dev, nodes)
    w, records = run["window"], run["records"]
    plain = churn_run(dev, nodes, plain=True)
    same = plain["sigs"] == run["sigs"]
    med = lambda key: statistics.median(r[key] for r in records)  # noqa: E731
    line = {
        "phase": "incremental_churn",
        "config": name,
        "card": card_name,
        "standing_nodes": nodes,
        "vp": run["vp"],
        "pods_per_pass": CHURN_PODS,
        "passes": CHURN_PASSES,
        "warmup_passes": CHURN_WARMUP,
        "cold_full_encode_ms": run["cold"]["full_encode_ms"],
        "cold_wall_ms": run["cold"]["wall_ms"],
        "window": w,
        "engine_passes": run["engine_passes"],
        "engine_invalidations": run["engine_invalidations"],
        "median_ms": {k: med(k) for k in ("wall_ms", "delta_apply_ms", "rebase_ms", "audit_ms", "fill_ms", "fill_device_ms", "fill_stage_ms", "fill_enqueue_ms", "fill_wait_ms", "encode_ms", "commit_ms")},
        "median_rebase_device_ms": statistics.median(r["rebase_device_ms"] for r in records) if records[0]["rebase_device_ms"] is not None else None,
        "per_pass": records,
        "coda_wall_ms": run["coda"]["wall_ms"],
        "coda_fresh_wall_ms": run["fresh"]["wall_ms"],
        "coda_fresh_encode_ms": run["fresh"]["encode_ms"],
        "coda_fresh_fill_ms": run["fresh"]["fill_ms"],
        "coda_placements_identical": run["coda_identical"],
        "plain_run": {"launches": plain["launches_all"], "coda_identical": plain["coda_identical"], "placements_identical": same, "median_wall_ms": statistics.median(r["wall_ms"] for r in plain["records"])},
    }
    check(w["delta_passes"] == CHURN_PASSES and w["full_passes"] == 0, f"{name}: {w['delta_passes']}/{CHURN_PASSES} delta passes, {w['full_passes']} full in the window")
    check(sum(r["encode_skipped"] for r in records) == CHURN_PASSES, f"{name}: presolve skipped {sum(r['encode_skipped'] for r in records)}/{CHURN_PASSES} encodes")
    check(max(r["full_encode_ms"] for r in records) == 0.0, f"{name}: full-encode time charged on a delta pass")
    check(w["divergences"] == {} and w["audits"] >= CHURN_PASSES, f"{name}: the auditor found {w['divergences']} in {w['audits']} audits")
    check(not any(w["builds"].values()), f"{name}: kernel builds inside the window: {w['builds']}")
    check(all(r["resident_buffer_ok"] for r in records), f"{name}: the resident head left the engine's two buffers")
    check(all(r["k2_launches"] == 1 for r in records), f"{name}: K2 launches per pass {[r['k2_launches'] for r in records]}")
    for run_ in (run, plain):
        calls = [(r["k2_calls_on_resident_head"], r["k2_calls_staged"]) for r in run_["records"]]
        check(all(c == (1, 0) for c in calls), f"{name}: K2 calls per pass (on the resident head, staged) {calls}")
    check(all(r["fills_vectorized"] == 1 for r in records), f"{name}: a pass left the vectorized fill")
    check(run["coda_identical"], f"{name}: the incremental coda placed pods differently from a fresh solver")
    check(not any(plain["launches_all"].values()), f"{name}: the plain run launched kernels: {plain['launches_all']}")
    check(same and plain["coda_identical"], f"{name}: K2's plain version placed the churn differently")

    # K2 at this run's own resident shape: the resident launch, its plain
    # version on head_dev[:V] and the staged round trip, exact; then timed
    sizes, head, head_dev = run["k2_inputs"]
    V = head.shape[0]
    S, R = sizes.shape
    line["k2_shape"] = [S, V, R]
    # as the kernels line counts it: each input read once, the counts written once
    line["k2_bound_ms"] = max(((S + V) * R * 4 + S * V * 4) / H100_BYTES_PER_S, S * V * (7 * R + 4) / H100_F32_OPS_PER_S) * 1e3
    if dev.type == "cuda":
        from karpenter_tpu_torch.ops.warmfill import AdmissionSurface

        surface = AdmissionSurface(dev)
        resident = surface.counts_resident(sizes, head_dev, V)[0].copy()
        staged = surface.counts(sizes, head)[0].copy()
        plain_counts = warm_fill_counts(torch.from_numpy(sizes.astype(np.float32)).to(dev), head_dev[:V]).cpu().numpy()
        equal = np.array_equal(resident, plain_counts) and np.array_equal(staged, plain_counts)
        trips = {"resident": [], "staged": []}
        for _ in range(KERNEL_ITERS):
            for key, fn in (("resident", lambda: surface.counts_resident(sizes, head_dev, V)), ("staged", lambda: surface.counts(sizes, head))):
                t0 = time.perf_counter()
                fn()
                trips[key].append((time.perf_counter() - t0) * 1e3)
        line["k2_parity_exact"] = equal
        line["k2_round_trip_ms"] = {k: statistics.median(v) for k, v in trips.items()}
        line["k2_resident_device_ms"], why = profiled_device_ms(lambda: surface.counts_resident(sizes, head_dev, V), SCALING_ITERS, "warm_fill_kernel")
        line["k2_resident_device_ms_missing"] = why or None
        check(equal, f"{name}: K2 on the resident head disagrees with its plain version or the staged path")
        args, spare = run["rebase_args"]
        line["rebase_shape"] = {"vp": args[0].shape[0], "r": args[0].shape[1], "dirty": args[3].shape[0]}
        line["rebase_event_ms"] = cuda_ms(lambda: rebase_view_state(*args, out=spare), KERNEL_ITERS)
        line["rebase_bytes"] = sum(a.numel() * a.element_size() for a in args) + spare.numel() * spare.element_size()
        line["rebase_bound_ms"] = line["rebase_bytes"] / H100_BYTES_PER_S * 1e3
    emit(line)
    return line


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

    dev = torch.device("cuda")
    card_name = card()
    kernel = bucket_cost.bucket_cost_packed
    k2 = warmfill.warm_fill_counts_device
    solve_lines = {}

    # 1. build both kernels from the checkout's sources
    build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])

    def k1_problem(seed, B, T, R, kind="random"):
        arrays = testing.bucket_cost_problem(np.random.default_rng(seed), B, T, R, kind)
        return [torch.from_numpy(a).to(dev) for a in arrays]

    # 2. K1 against its plain version on the card: test_pallas.py's shapes,
    # then the edges of its block and grid
    mismatches, max_err = [], 0
    for B, T, R, *kind in PARITY_SHAPES:
        for seed in PARITY_SEEDS:
            equal, diff = compare(kernel, bucket_type_cost_packed, k1_problem(seed * 1000 + B, B, T, R, *kind))
            max_err = max(max_err, diff)
            if not equal:
                mismatches.append([B, T, R, *kind, seed])
    emit({"phase": "kernel_parity", "kernel": "bucket_type_cost", "shapes": [list(s) for s in PARITY_SHAPES], "seeds": len(PARITY_SEEDS), "tolerance": "exact", "mismatches": mismatches, "max_abs_err": max_err})
    check(not mismatches, f"K1 disagrees with its plain version at {mismatches}")

    # 3. K2 against its plain version on the card (exact), through its
    # wrapper and through the solve's round trip, and the counts an upper
    # bound on the exact f64 closed form
    surface = warmfill.AdmissionSurface(dev)

    def k2_parity(sizes_np, head_np):
        """Host sizes/head, cast to f32; returns (equal, max |diff|, upper bound holds)."""
        sizes, head = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (sizes_np, head_np))
        want = warm_fill_counts(sizes, head)
        got = [k2(sizes, head), torch.from_numpy(surface.counts(sizes_np, head_np)[0].copy()).to(dev)]
        torch.cuda.synchronize()
        diff = max(int((g.long() - want.long()).abs().max().item()) for g in got)
        exact = warm_fill_counts_np(sizes.double().cpu().numpy(), head.double().cpu().numpy())
        bound = all(bool((g.cpu().numpy() >= np.minimum(exact, 1 << 30)).all()) for g in got)
        return all(torch.equal(g, want) for g in got), diff, bound

    mismatches, under, k2_err = [], [], 0
    for S, V, R in WARM_PARITY_SHAPES:
        for seed in PARITY_SEEDS:
            sizes, head = testing.warm_fill_surface(np.random.default_rng(seed * 101 + S), S, V, R)
            equal, diff, bound = k2_parity(sizes, head)
            k2_err = max(k2_err, diff)
            if not equal:
                mismatches.append([S, V, R, seed])
            if not bound:
                under.append([S, V, R, seed])
    emit({"phase": "kernel_parity", "kernel": "warm_fill_counts", "shapes": [list(s) for s in WARM_PARITY_SHAPES], "seeds": len(PARITY_SEEDS), "paths": ["warm_fill_counts_device", "AdmissionSurface.counts"], "tolerance": "exact", "mismatches": mismatches, "upper_bound_violations": under, "max_abs_err": k2_err})
    check(not mismatches, f"K2 disagrees with its plain version at {mismatches}")
    check(not under, f"K2 under-counts the exact closed form at {under}")
    # ... and from a resident head buffer, the incremental engine's path;
    # then the torch rebase that keeps that buffer, against its oracle
    k2_err = max(k2_err, k2_resident_parity(dev, surface, card_name))
    rebase_parity(dev, card_name)

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
                for k in (
                    "encode", "fill", "fill_device", "fill_stage", "fill_enqueue", "fill_wait",
                    "device", "mask", "assemble", "device_wait", "commit",
                )
            },
            "fill_device_ms_runs": [r[2].fill_device_seconds * 1e3 for r in runs],
        }
        emit(line)
        solve_lines[name] = line
        for k in kernels:
            check(launches[k] >= SOLVE_TRIALS, f"{name}: {k} launched {launches[k]} times in {SOLVE_TRIALS} solves")
        check(got["scheduled"] == len(pods) and got["unschedulable"] == 0, f"{name}: not every pod scheduled")
        return got

    def plain_solve(pods, provider, provisioners, state_nodes=()):
        """The solve with both kernels' plain versions on the card, swapped in
        at the seams the solve calls (K1's wrapper, K2's round trip). Fails if
        either kernel launched in it."""
        saved = dense_module.bucket_cost_packed, fill_module.admission_counts
        dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
        bucket_cost.LAUNCHES = 0
        warmfill.LAUNCHES = 0
        try:
            ms, results, _ = solve(pods, provider, provisioners, DenseSolver(min_batch=1), state_nodes)
        finally:
            dense_module.bucket_cost_packed, fill_module.admission_counts = saved
        launches = {"bucket_type_cost": bucket_cost.LAUNCHES, "warm_fill_counts": warmfill.LAUNCHES}
        check(not any(launches.values()), f"the plain versions' solve launched kernels: {launches}")
        return ms, outcome(results, pods), launches

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

    # 5. the same solve with the plain versions on the card: same placements
    plain_ms, plain_out, launches = plain_solve(pods, provider, provisioners)
    same = plain_out["nodes"] == dense_out["nodes"]
    emit({"phase": "plain_solve", "config": "headline_10k_x_500", "wall_ms": plain_ms, "kernel_launches": launches, "nodes": len(plain_out["nodes"]), "cost": plain_out["cost"], "placements_identical": same})
    check(same, "K1's and its plain version's solves placed pods differently")

    # 6. the exact host loop on the same batch
    host_ms, host_results, _ = solve(pods, provider, provisioners, None)
    host_out = outcome(host_results, pods)
    within = dense_out["cost"] <= host_out["cost"] * HOST_COST_SLACK + 1e-6
    emit({"phase": "host_solve", "config": "headline_10k_x_500", "wall_ms": host_ms, "nodes": len(host_out["nodes"]), "cost": host_out["cost"], "scheduled": host_out["scheduled"], "dense_cost": dense_out["cost"], "cost_within_slack": within})
    check(host_out["scheduled"] == len(pods) and host_out["unschedulable"] == 0, "host loop left pods unscheduled")
    check(within, f"dense cost {dense_out['cost']} exceeds {HOST_COST_SLACK} x host cost {host_out['cost']}")
    del host_results

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
    # records K2's inputs, on the card and as the host arrays the solver
    # staged them from.
    name, n_pods, seed, n_types, n_nodes = REPACK
    repack_pods = testing.build_workload(n_pods, seed=seed)
    repack_provider = FakeCloudProvider(instance_types(n_types))
    repack_nodes = testing.build_repack_state(n_nodes)
    host_captured = []
    admission_counts = fill_module.admission_counts

    def recording(sizes, head, solver, head_dev=None):
        counts, parts = admission_counts(sizes, head, solver, head_dev)
        host_captured.append((sizes.copy(), head.copy(), counts.copy()))
        return counts, parts

    fill_module.admission_counts = recording
    try:
        solve(repack_pods, repack_provider, provisioners, DenseSolver(min_batch=1), repack_nodes)
    finally:
        fill_module.admission_counts = admission_counts
    check(len(host_captured) == 1, f"the repack solve computed the surface {len(host_captured)} times, expected 1")
    sizes_np, head_np, solve_counts = host_captured[0]
    repack_inputs = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (sizes_np, head_np)]
    S, V, R2 = repack_inputs[0].shape[0], repack_inputs[1].shape[0], repack_inputs[0].shape[1]
    equal, diff, bound = k2_parity(sizes_np, head_np)
    round_trip_equal = np.array_equal(solve_counts, warm_fill_counts(*repack_inputs).cpu().numpy())
    emit({"phase": "kernel_parity", "kernel": "warm_fill_counts", "shapes": [[S, V, R2]], "source": "repack solve inputs", "tolerance": "exact", "mismatches": [] if equal else [[S, V, R2]], "upper_bound_holds": bound, "solve_round_trip_equal": round_trip_equal, "max_abs_err": diff})
    check(equal, f"K2 disagrees with its plain version at the repack shape ({S}, {V}, {R2})")
    check(bound, "K2 under-counts the exact closed form at the repack solve's inputs")
    check(round_trip_equal, "the solve's round trip through K2 returned other counts than the plain version")
    k2_err = max(k2_err, diff)

    repack_out = timed_solves(name, repack_pods, repack_provider, provisioners, repack_nodes, kernels=("warm_fill_counts",))
    line = solve_lines[name]
    check(line["fills_vectorized"] == SOLVE_TRIALS, f"{name}: {line['fills_vectorized']} vectorized fills in {SOLVE_TRIALS} solves")
    check(line["fill_pods_host"] == 0, f"{name}: {line['fill_pods_host']} pods took the host-loop fill")
    check(line["kernel_launches"]["bucket_type_cost"] == 0, f"{name}: K1 launched though the fill took every pod")

    plain_ms, plain_out, launches = plain_solve(repack_pods, repack_provider, provisioners, repack_nodes)
    same = plain_out["views"] == repack_out["views"] and plain_out["nodes"] == repack_out["nodes"]
    emit({"phase": "plain_solve", "config": name, "wall_ms": plain_ms, "kernel_launches": launches, "on_existing": plain_out["on_existing"], "nodes": len(plain_out["nodes"]), "placements_identical": same})
    check(same, f"{name}: K2's and its plain version's solves placed pods differently")
    del repack_pods

    # 9. the headline batch on a warm cluster too small for it: K2 fills the
    # existing nodes, then K1 prices new nodes for the rest in the same solve
    name, n_nodes = OVERFLOW
    warm_nodes = testing.build_repack_state(n_nodes)
    overflow_out = timed_solves(name, pods, provider, provisioners, warm_nodes, kernels=("bucket_type_cost", "warm_fill_counts"))
    check(overflow_out["on_existing"] > 0 and overflow_out["nodes"], f"{name}: the fill or the new-node solve placed nothing")
    plain_ms, plain_out, launches = plain_solve(pods, provider, provisioners, warm_nodes)
    same = plain_out["views"] == overflow_out["views"] and plain_out["nodes"] == overflow_out["nodes"]
    emit({"phase": "plain_solve", "config": name, "wall_ms": plain_ms, "kernel_launches": launches, "on_existing": plain_out["on_existing"], "nodes": len(plain_out["nodes"]), "cost": plain_out["cost"], "placements_identical": same})
    check(same, f"{name}: the kernels' and the plain versions' solves placed pods differently")
    host_ms, host_results, _ = solve(pods, provider, provisioners, None, warm_nodes)
    host_out = outcome(host_results, pods)
    within = overflow_out["cost"] <= host_out["cost"] * HOST_COST_SLACK + 1e-6
    emit({"phase": "host_solve", "config": name, "wall_ms": host_ms, "on_existing": host_out["on_existing"], "nodes": len(host_out["nodes"]), "cost": host_out["cost"], "scheduled": host_out["scheduled"], "dense_cost": overflow_out["cost"], "cost_within_slack": within})
    check(host_out["scheduled"] == len(pods) and host_out["unschedulable"] == 0, f"{name}: host loop left pods unscheduled")
    check(within, f"{name}: dense cost {overflow_out['cost']} exceeds {HOST_COST_SLACK} x host cost {host_out['cost']}")
    del pods, host_results

    # 10. the incremental churn on 300 and on 2,400 standing nodes: delta
    # passes whose K2 launch reads the engine's resident head buffer
    churn_lines = [incremental_churn(dev, name, nodes, card_name) for name, nodes in CHURNS]

    # 11. the launch floor: the device time of the smallest kernel PyTorch
    # launches (a fill of one element), in this run, on this card
    one = torch.zeros(1, device=dev)
    launch_floor_ms, floor_why = profiled_device_ms(one.zero_, KERNEL_ITERS)
    emit({"phase": "launch_floor", "op": "zero_() of a 1-element CUDA tensor", "device_ms": launch_floor_ms, "device_ms_missing": floor_why or None})
    check(launch_floor_ms is not None, f"no launch floor: {floor_why}")

    # 12. how each kernel's device time scales: K1 with the buckets (blocks)
    # and the types (threads per block, then types per thread); K2 with the
    # size classes and the nodes
    shapes = k1_scaling_shapes(B, T)
    inputs = [k1_problem(sB * 7 + sT, sB, sT, R, *kind) for sB, sT, *kind in shapes]
    times, why = profiled_series([functools.partial(kernel, *i) for i in inputs], SCALING_ITERS, "bucket_cost_kernel")
    runs = [{"shape": [sB, sT, R, *kind], "device_ms": ms} for (sB, sT, *kind), ms in zip(shapes, times)]
    emit({"phase": "kernel_scaling", "kernel": "bucket_type_cost", "runs": runs, "launch_floor_ms": launch_floor_ms, "device_ms_missing": why or None})
    inputs, bad = [], []
    for sS, sV in K2_SCALING:
        arrays = testing.warm_fill_surface(np.random.default_rng(sS * 7 + sV), sS, sV, R2)
        inputs.append([torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays])
        if not compare(k2, warm_fill_counts, inputs[-1])[0]:
            bad.append([sS, sV, R2])
    times, why = profiled_series([functools.partial(k2, *i) for i in inputs], SCALING_ITERS, "warm_fill_kernel")
    runs = [{"shape": [sS, sV, R2], "device_ms": ms} for (sS, sV), ms in zip(K2_SCALING, times)]
    emit({"phase": "kernel_scaling", "kernel": "warm_fill_counts", "runs": runs, "launch_floor_ms": launch_floor_ms, "mismatches": bad, "device_ms_missing": why or None})
    check(not bad, f"K2 disagrees with its plain version at {bad}")

    # 13. each kernel's time at its main path's shape beside its bound and
    # its plain version; K2's device time through the solve's round trip
    kernel_ms = cuda_ms(lambda: kernel(*headline_inputs), KERNEL_ITERS)
    plain_ms_k = cuda_ms(lambda: bucket_type_cost_packed(*headline_inputs), PLAIN_ITERS)
    kernel_device_ms, kernel_why = profiled_device_ms(lambda: kernel(*headline_inputs), KERNEL_ITERS, "bucket_cost_kernel")
    plain_device_ms, plain_why = profiled_total_ms(lambda: bucket_type_cost_packed(*headline_inputs), PLAIN_ITERS)
    in_bytes = sum(t.numel() * t.element_size() for t in headline_inputs)
    out_bytes = 3 * B * 4
    # per (b, t, r): divide, max, add, compare; per (b, t): ceil, max, 3 mul, 2 add, select
    ops = B * T * (4 * R + 8)
    bytes_ms = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3

    k2_ms = cuda_ms(lambda: k2(*repack_inputs), KERNEL_ITERS)
    k2_plain_ms = cuda_ms(lambda: warm_fill_counts(*repack_inputs), PLAIN_ITERS)
    k2_device_ms, k2_why = profiled_device_ms(lambda: surface.counts(sizes_np, head_np), KERNEL_ITERS, "warm_fill_kernel")
    trips = []
    for _ in range(KERNEL_ITERS):
        t0 = time.perf_counter()
        surface.counts(sizes_np, head_np)
        trips.append((time.perf_counter() - t0) * 1e3)
    k2_plain_device_ms, k2_plain_why = profiled_total_ms(lambda: warm_fill_counts(*repack_inputs), PLAIN_ITERS)
    k2_bytes_ms = ((S + V) * R2 * 4 + S * V * 4) / H100_BYTES_PER_S * 1e3
    # per (s, v, r): compare, mul, add, select, mul, divide, min; per (s, v):
    # floor, max, min, select
    k2_ops_ms = S * V * (7 * R2 + 4) / H100_F32_OPS_PER_S * 1e3

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
                "launch_floor_ms": launch_floor_ms,
                "plain_device_ms": plain_device_ms,
                "device_ms_missing": kernel_why or plain_why or None,
                "note": "ms and plain_ms are CUDA-event times per call of the wrapper, back to back; "
                "device_ms is the kernel's own time in the profiler's trace, launch_floor_ms that of a "
                "1-element fill. The bound is far below both: latency sets the kernel's time "
                "(kernel_scaling phase)",
            },
            {
                "name": "warm_fill_counts",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/warm_fill.cu",
                "replaces": "karpenter_tpu/ops/warmfill.py:89",
                "launches": solve_lines[REPACK[0]]["kernel_launches"]["warm_fill_counts"],
                "resident_launches": {c["config"]: c["window"]["launches"]["warm_fill_counts"] for c in churn_lines},
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
                "launch_floor_ms": launch_floor_ms,
                "plain_device_ms": k2_plain_device_ms,
                "round_trip_ms": statistics.median(trips),
                "device_ms_missing": k2_why or k2_plain_why or None,
                "note": "ms and plain_ms per call on CUDA tensors (events); device_ms in the trace of the "
                "solve's round trip from the repack's host arrays, round_trip_ms its host-clock median, "
                "back to back. Launches are those of the repack solve's 3 timed solves; the overflow "
                "solve's are in its solve line, resident_launches those of the churn phases' measured "
                "passes against the engine's resident head. No single PyTorch call computes the surface",
            },
        ]
    })

    # 14. the card
    print(card_name, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
