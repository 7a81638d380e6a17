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
    launch no kernel, and a last pass must place as a fresh solver does;
  - the provisioning controller (controllers/provisioning/), routed by the
    crossover it measures on the card first (crossover: K1's probe round
    trip, and the exact host loop's seconds per pod beside the JAX
    package's calibration): controller_round_overflow, the headline batch
    created in a kube store with 300 standing nodes and provisioned by
    ProvisionerController.provision() (a warm-up and 3 timed rounds, each
    on a fresh cluster, split into get_pods / schedule / launch / bind;
    K1 and K2 in every round; the same as the plain versions' round and as
    a bare solve on the same snapshot); controller_ice_resolve, the
    headline batch on an empty cluster with the fake provider refusing
    every pool of the type a warm-up round launched most often, then of
    every type it launched (the typed failures feed the re-solve; K1 in
    every re-solve of the second case; no node on a refused pool; the same
    as the plain versions' round); controller_loop, the reconciler and the
    threaded batch loop on the real clock, 2,000 pods, stopped once every
    pod is nominated;
  - consolidation through the disruption orchestrator
    (controllers/disruption/, controllers/consolidation/, with the node and
    termination controllers), at the same routing: consolidation_delete,
    2,000 standing 16-CPU nodes each running 72 ReplicaSet-owned pods
    (144,000 pods), where each pass's what-if fills one node's pods onto
    the other 1,999 (K2) and the orchestrator deletes and drains it;
    consolidation_replace, 300 full nodes and one 64-CPU node running 72
    pods, whose what-if finds no slot (K2) and prices one cheaper node (K1),
    which the orchestrator launches, waits on and drains onto. A stand-in
    for the ReplicaSet controller recreates each evicted pod, and a
    provisioning round places them. A warm-up and 3 timed passes each,
    held against the same passes with the plain versions;
  - a spot reclaim wave through the interruption controller
    (controllers/interruption/) over the simulated cloud
    (cloudprovider/simulated/), at the same routing:
    interruption_reclaim_wave, 10,000 ReplicaSet-owned pods provisioned
    onto a spot-only fleet, then spot notices for the first 8 populated
    nodes; each notice quarantines its pool and re-solves the victim's pods
    with the victim excluded (K2 onto the standing nodes, K1 for the
    replacements, the quarantined pools zeros in K1's `allowed`), launches
    the replacement and drains the victim; then one provisioning round for
    the recreated pods, the cloud's reclaim and the gc sweep. A warm-up and
    3 timed waves on fresh fleets, held against 4 with the plain versions;
  - the controller process (runtime.py, cmd/controller.py, service/):
    runtime_boot starts `python -m karpenter_tpu_torch.cmd.controller` as a
    child, waits for /healthz and /readyz, reads the crossover its Runtime
    measured at boot with K1's probe on the card, and requires exit code 0
    on SIGTERM; runtime_round creates the headline batch in a store with
    300 standing nodes under a started Runtime (leader election, the
    crossover measured, 1 s / 10 s batch windows) and waits until every pod
    is nominated by its batch loop and its lifecycle and disruption loops
    have passed; every K1 and K2 call in the window is held bit for bit,
    and two fresh Runtimes' provision_once() with the kernels and with the
    plain versions must place identically; solver_sidecar hands the
    overflow round's request, pickled as serve()'s gRPC handler takes it,
    to a SolverServer on the card (K2, then K1) and holds the plan equal to
    the in-process schedule and to a plain-versions server's.

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
the churn and controller phases. Then it measures, on the same card: the launch floor (the device time of
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
# the controller phases: (name, pods, standing nodes); the headline batch on
# a busy cluster, on an empty one for the capacity-failure ladder, and a
# smaller batch through the threaded loop
CONTROLLER_OVERFLOW = ("controller_round_overflow", HEADLINE_PODS, 300)
CONTROLLER_ICE = ("controller_ice_resolve", HEADLINE_PODS)
CONTROLLER_LOOP = ("controller_loop", 2000, 30)
CONTROLLER_TRIALS = 3
# the loop's batch window (idle, max seconds), set through Config, and how
# long the phase waits for every pod to be nominated
LOOP_WINDOW = (0.5, 5.0)
LOOP_TIMEOUT_S = 120.0
EVENT_CAPACITY = 200_000
CROSSOVER_TRIALS = 3
HOST_RATE_PODS = (100, 300)
# the consolidation phases: (name, standing nodes, pods on each); the
# replace cell's standing nodes are full and it adds one larger node (its
# type, its pods). Pods of 0.1 CPU / 128Mi, ReplicaSet-owned and running;
# nodes of 16 CPU / 32Gi / 110 pods (build_repack_state's fake-it-15)
CONSOLIDATION_DELETE = ("consolidation_delete", 2000, 72)
CONSOLIDATION_REPLACE = ("consolidation_replace", 300, 110, "fake-it-63", 72)
CONSOLIDATION_PASSES = 3
CONSOLIDATION_POD = {"cpu": 0.1, "memory": "128Mi"}
NODE_ALLOCATABLE = {"cpu": 16, "memory": "32Gi", "pods": 110}
BIG_ALLOCATABLE = {"cpu": 64, "memory": "128Gi", "pods": 110}
# the interruption cell: the repo's spot_reclaim_wave scenario
# (karpenter_tpu/scenarios/campaign.py, SpotReclaimWave: the first populated
# nodes in store order, a fraction 0.6 of them, at most 8) on a spot-only
# fleet that took the headline's 10,000-pod batch; EC2's 2-minute warning
WAVE = ("interruption_reclaim_wave", HEADLINE_PODS)
WAVE_FRACTION, WAVE_MAX_VICTIMS = 0.6, 8
WAVE_RUNS = 3
# the controller process: the entry point's command, how long it may take
# to answer both probes and to exit on SIGTERM; the Runtime cell's standing
# nodes (controller_round_overflow's shape) and its deadlines; the sidecar
# cell's standing nodes and its timed solves after a warm-up
CONTROLLER_COMMAND = [sys.executable, "-m", "karpenter_tpu_torch.cmd.controller"]
BOOT_DEADLINE_S = 180.0
SHUTDOWN_DEADLINE_S = 60.0
RUNTIME_ROUND = ("runtime_round", HEADLINE_PODS, 300)
RUNTIME_DEADLINE_S = 120.0
LOOP_PASS_DEADLINE_S = 10.0
SIDECAR = ("solver_sidecar", HEADLINE_PODS, 300)
SIDECAR_TRIALS = 3
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


def read_launches():
    """Both kernels' launch counts since they were last read; zeroes them."""
    from karpenter_tpu_torch.ops import bucket_cost, warmfill

    got = {"bucket_type_cost": bucket_cost.LAUNCHES, "warm_fill_counts": warmfill.LAUNCHES}
    bucket_cost.LAUNCHES = 0
    warmfill.LAUNCHES = 0
    return got


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


def crossover(dev, card_name) -> dict:
    """The port's measure_dense_crossover on the card (CROSSOVER_TRIALS
    trials of K1's wrapper at the probe shape, host arrays to host result,
    after one warm-up call), and the exact host loop's seconds per pod on
    this machine's host beside the JAX package's calibration. Routing takes
    the measured min_batch; the host rate is printed, not used."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import dense as dense_module

    probe = dense_module.crossover_probe(dev)
    times, outs = [], []

    def timed_probe():
        t0 = time.perf_counter()
        outs.append(probe())
        times.append(time.perf_counter() - t0)

    min_batch = dense_module.measure_dense_crossover(trials=CROSSOVER_TRIALS, dispatch=timed_probe)
    probe_inputs = [torch.ones((2, 8, 4)), torch.full((32, 4), 8.0), torch.ones(32), torch.ones((8, 32), dtype=torch.bool)]
    want = bucket_type_cost_packed(*probe_inputs).numpy()
    probe_equal = all(np.array_equal(o, want) for o in outs)

    provider = FakeCloudProvider(instance_types(HEADLINE_TYPES))
    provisioners = [testing.make_provisioner()]
    host = []
    for n in HOST_RATE_PODS:
        pods = testing.build_workload(n)
        build_ms, solve_ms = [], []
        for _ in range(SOLVE_TRIALS):
            t0 = time.perf_counter()
            scheduler = build_scheduler(provisioners, provider, pods)
            t1 = time.perf_counter()
            results = scheduler.solve(pods)
            t2 = time.perf_counter()
            build_ms.append((t1 - t0) * 1e3)
            solve_ms.append((t2 - t1) * 1e3)
        check(not results.unschedulable, f"crossover: the host loop left {len(results.unschedulable)} of {n} pods unscheduled")
        host.append({
            "pods": n,
            "build_ms": statistics.median(build_ms),
            "solve_ms": statistics.median(solve_ms),
            "solve_ms_runs": solve_ms,
            "seconds_per_pod": statistics.median(solve_ms) / 1e3 / n,
        })
    round_trip = min(times[1:])
    host_rate = statistics.median(h["seconds_per_pod"] for h in host)
    line = {
        "phase": "crossover",
        "card": card_name,
        "trials": CROSSOVER_TRIALS,
        "dispatch_round_trip_ms": round_trip * 1e3,
        "dispatch_ms_runs": [t * 1e3 for t in times],
        "min_batch": min_batch,
        "host_seconds_per_pod_reference": dense_module.HOST_SECONDS_PER_POD,
        "host_loop": host,
        "host_seconds_per_pod_measured": host_rate,
        "crossover_at_measured_host_rate": round_trip / host_rate,
        "floor": dense_module.CROSSOVER_FLOOR,
        "ceiling": dense_module.CROSSOVER_CEILING,
        "probe_equal_plain": probe_equal,
        "note": "min_batch = dispatch_round_trip / host_seconds_per_pod_reference, clamped to [floor, ceiling]; "
        "the host loop's rate on this host is printed beside it and does not change the routing",
    }
    emit(line)
    check(probe_equal, "crossover: the probe's K1 result disagrees with its plain version")
    check(dense_module.CROSSOVER_FLOOR <= min_batch <= dense_module.CROSSOVER_CEILING, f"crossover: min_batch {min_batch} outside its clamp")
    return line


def controller_env(dev, pods_n: int, standing: int, min_batch: int, tag: str, config=None):
    """A fresh in-memory cluster from the same seeds: the kube store with
    `standing` 16-CPU nodes (testing.standing_cluster), its cluster state,
    FakeCloudProvider(instance_types(HEADLINE_TYPES)), the default
    provisioner and a ProvisionerController (wait_for_cluster_sync, a
    DenseSolver routed at `min_batch`). The batch, build_workload(pods_n)
    named by `tag`, is returned to be created in the store."""
    from types import SimpleNamespace

    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.controllers.provisioning import ProvisionerController
    from karpenter_tpu_torch.controllers.state.cluster import Cluster
    from karpenter_tpu_torch.events import Recorder
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.solver import DenseSolver

    kube = KubeCluster()
    testing.standing_cluster(kube, standing)
    provider = FakeCloudProvider(instance_types(HEADLINE_TYPES))
    cluster = Cluster(kube, provider)
    # every event of the round is kept: nominations are read back from it
    recorder = Recorder(capacity=EVENT_CAPACITY)
    solver = DenseSolver(min_batch=min_batch, device=dev)
    controller = ProvisionerController(
        kube, cluster, provider, config=config, recorder=recorder, dense_solver=solver, wait_for_cluster_sync=True
    )
    kube.create(testing.make_provisioner())
    pods = testing.rename(testing.build_workload(pods_n), tag)
    return SimpleNamespace(kube=kube, cluster=cluster, provider=provider, recorder=recorder, solver=solver, controller=controller, pods=pods)


def create_pods(env) -> None:
    for pod in env.pods:
        env.kube.create(pod)


def instrument(env, dev) -> dict:
    """Time a controller round from outside, on its own instance: get_pods;
    each schedule call (the solver's phases and both kernels' launches in
    it); each launch_nodes call split into the node launches (to the last
    create's return) and the nominations onto existing nodes after them."""
    from karpenter_tpu_torch.ops import bucket_cost, warmfill
    from karpenter_tpu_torch.solver import DenseSolveStats

    ctrl, solver = env.controller, env.solver
    rec = {"get_pods_ms": [], "schedule": [], "launch": []}
    get_pods, schedule, launch_nodes, launch_one = ctrl.get_pods, ctrl.schedule, ctrl.launch_nodes, ctrl._launch_one
    ends = []

    def timed_get_pods():
        t0 = time.perf_counter()
        out = get_pods()
        rec["get_pods_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_schedule(pods, state_nodes, opts=None, **kwargs):
        solver.stats = DenseSolveStats()
        before = (bucket_cost.LAUNCHES, warmfill.LAUNCHES)
        t0 = time.perf_counter()
        results = schedule(pods, state_nodes, opts, **kwargs)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        got = {"bucket_type_cost": bucket_cost.LAUNCHES - before[0], "warm_fill_counts": warmfill.LAUNCHES - before[1]}
        st = solver.stats
        rec["schedule"].append({
            "pods": len(pods),
            "state_nodes": len(state_nodes),
            "wall_ms": ms,
            "new_node_pods": sum(len(n.pods) for n in results.new_nodes),
            "on_existing": sum(len(v.pods) for v in results.existing_nodes),
            "unschedulable": len(results.unschedulable),
            "dense_batches": st.batches,
            "pods_committed": st.pods_committed,
            "pods_to_host": st.pods_to_host,
            "launches": got,
            "phases_ms": {k: getattr(st, f"{k}_seconds") * 1e3 for k in ("encode", "fill", "fill_device", "device", "mask", "assemble", "device_wait", "commit")},
        })
        return results

    def timed_launch_one(vn, ice_failures=None):
        try:
            return launch_one(vn, ice_failures)
        finally:
            ends.append(time.perf_counter())

    def timed_launch_nodes(results, ice_failures=None, **kwargs):
        del ends[:]
        t0 = time.perf_counter()
        launched = launch_nodes(results, ice_failures=ice_failures, **kwargs)
        t1 = time.perf_counter()
        last = max(ends) if ends else t0
        rec["launch"].append({
            "launched": len(launched),
            "create_calls": len(ends),
            "ice_failed_pods": sum(len(vn.pods) for vn in ice_failures or ()),
            "launch_ms": (last - t0) * 1e3,
            "bind_ms": (t1 - last) * 1e3,
        })
        return launched

    ctrl.get_pods, ctrl.schedule, ctrl.launch_nodes, ctrl._launch_one = timed_get_pods, timed_schedule, timed_launch_nodes, timed_launch_one
    return rec


def broken_placements(env, nominated) -> dict:
    """The nodes whose bound and nominated pods together request more than
    the node has, and the hostname anti-affinity and zonal self-affinity
    cohorts of build_workload that the nominations break."""
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.utils import resources as res

    pods = {p.name: p for p in env.kube.list_pods()}
    over, hosts, zones = [], {}, {}
    for node in env.kube.list_nodes():
        free = dict(env.cluster.get_state_node(node.name).available)
        for name in nominated.get(node.name, ()):
            free = res.subtract(free, res.pod_requests(pods[name]))
            labels = pods[name].metadata.labels
            if "anti" in labels:
                hosts.setdefault(labels["anti"], []).append(node.name)
            if "affinity" in labels:
                zones.setdefault(labels["affinity"], set()).add(node.metadata.labels[lbl.LABEL_TOPOLOGY_ZONE])
        if any(v < -1e-6 for v in free.values()):
            over.append(node.name)
    return {
        "over_capacity": len(over),
        "anti_affinity_shared": sorted(v for v, names in hosts.items() if len(names) != len(set(names))),
        "affinity_split": sorted(v for v, found in zones.items() if len(found) > 1),
    }


def round_record(env) -> dict:
    """What a round left in the cluster: each launched node's instance type,
    zone, capacity type and nominated pods (up to the provider's node
    names), the nominations onto standing nodes, the pods it parked, its
    primary solve's unschedulable pods and the placements it broke
    (broken_placements)."""
    from karpenter_tpu_torch.api import labels as lbl

    # a pod placed on an existing node is nominated twice per solve, by the
    # scheduler and by the launch step, as in the JAX package
    nominated = {}
    for event in env.recorder.of("NominatePod"):
        nominated.setdefault(event.message.split()[-1], set()).add(event.object_name)
    live = env.provider.live_instances
    launched, standing = [], []
    for node in env.kube.list_nodes():
        pods = tuple(sorted(nominated.get(node.name, ())))
        labels = node.metadata.labels
        if node.name in live:
            launched.append((labels[lbl.LABEL_INSTANCE_TYPE], labels[lbl.LABEL_TOPOLOGY_ZONE], labels[lbl.LABEL_CAPACITY_TYPE], pods))
        elif pods:
            standing.append((node.name, pods))
    results = env.controller.last_results
    return {
        "launched": sorted(launched),
        "standing": sorted(standing),
        "parked": sorted(name for _ns, name in env.controller._ice_backoff),
        "unschedulable": sorted(p.name for p in results.unschedulable) if results is not None else None,
        "broken": broken_placements(env, nominated),
    }


def run_round(dev, pods_n, standing, min_batch, tag, prepare=None, plain=False):
    """One controller round on a fresh environment: `prepare(env)` runs
    first (strict mode, quarantined pools), then the batch is created in
    the store, the launch counts zeroed and provision() called, timed and
    instrumented. With plain=True both kernels' plain versions stand in at
    the seams the solve calls. Returns (env, record of the round)."""
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    env = controller_env(dev, pods_n, standing, min_batch, tag)
    if prepare is not None:
        prepare(env)
    create_pods(env)
    rec = instrument(env, dev)
    saved = dense_module.bucket_cost_packed, fill_module.admission_counts
    if plain:
        dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
    try:
        read_launches()
        t0 = time.perf_counter()
        env.controller.provision()
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
    finally:
        dense_module.bucket_cost_packed, fill_module.admission_counts = saved
    rec.update(wall_ms=wall, launches=launches, outcome=round_record(env))
    return env, rec


def round_summary(rec) -> dict:
    first = rec["schedule"][0]
    return {
        "wall_ms": rec["wall_ms"],
        "get_pods_ms": sum(rec["get_pods_ms"]),
        "schedule_ms": sum(s["wall_ms"] for s in rec["schedule"]),
        "launch_ms": sum(s["launch_ms"] for s in rec["launch"]),
        "bind_ms": sum(s["bind_ms"] for s in rec["launch"]),
        "schedule_calls": len(rec["schedule"]),
        "phases_ms": first["phases_ms"],
        "launches": rec["launches"],
        "launches_per_solve": [s["launches"] for s in rec["schedule"]],
        "nodes_launched": len(rec["outcome"]["launched"]),
        "pods_on_launched_nodes": sum(len(n[3]) for n in rec["outcome"]["launched"]),
        "pods_nominated_onto_standing": sum(len(n[1]) for n in rec["outcome"]["standing"]),
        "unschedulable": len(rec["outcome"]["unschedulable"]),
        "parked": len(rec["outcome"]["parked"]),
        "broken": rec["outcome"]["broken"],
        "pods_committed": first["pods_committed"],
        "pods_to_host": first["pods_to_host"],
    }


def controller_round_overflow(dev, min_batch: int, card_name) -> dict:
    """The headline batch on a busy cluster through the provisioning
    controller: one warm-up round, CONTROLLER_TRIALS timed rounds (each on a
    fresh environment from the same seeds, since a round launches nodes),
    then the round with the plain versions, and the round's solve against a
    bare build_scheduler(...).solve on the same snapshot."""
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver

    name, pods_n, standing = CONTROLLER_OVERFLOW
    run_round(dev, pods_n, standing, min_batch, "ovf")
    runs = [run_round(dev, pods_n, standing, min_batch, "ovf") for _ in range(CONTROLLER_TRIALS)]
    _env, plain = run_round(dev, pods_n, standing, min_batch, "ovf", plain=True)

    # the bare solve on a fresh environment's snapshot, then that
    # environment's round
    env = controller_env(dev, pods_n, standing, min_batch, "ovf")
    create_pods(env)
    ctrl = env.controller
    pods = ctrl.get_pods()
    bare = build_scheduler(
        [p for p in env.kube.list_provisioners()], env.provider, pods, kube=env.kube, cluster=env.cluster,
        state_nodes=env.cluster.nodes_snapshot(), daemonset_pods=ctrl.daemonset_pods(),
        dense_solver=DenseSolver(min_batch=min_batch, device=dev),
    ).solve(pods)
    round_results = ctrl.provision()
    bare_equal = outcome(bare, pods) == outcome(round_results, pods)

    summaries = [round_summary(rec) for _env, rec in runs]
    first = runs[0][1]["outcome"]
    same_runs = all(rec["outcome"] == first for _env, rec in runs)
    same_plain = plain["outcome"] == first
    line = {
        "phase": "controller_round",
        "config": name,
        "card": card_name,
        "pods": pods_n,
        "standing_nodes": standing,
        "types": HEADLINE_TYPES,
        "min_batch": min_batch,
        "wall_ms": statistics.median(s["wall_ms"] for s in summaries),
        "wall_ms_runs": [s["wall_ms"] for s in summaries],
        "split_ms": {k: statistics.median(s[k] for s in summaries) for k in ("get_pods_ms", "schedule_ms", "launch_ms", "bind_ms")},
        "rounds": summaries,
        "kernel_launches": {k: [s["launches"][k] for s in summaries] for k in ("bucket_type_cost", "warm_fill_counts")},
        "plain_run": {"launches": plain["launches"], "wall_ms": plain["wall_ms"], "placements_identical": same_plain},
        "runs_identical": same_runs,
        "bare_solve_identical": bare_equal,
    }
    emit(line)
    for i, s in enumerate(summaries):
        check(s["launches"]["bucket_type_cost"] >= 1 and s["launches"]["warm_fill_counts"] >= 1, f"{name}: round {i} launched {s['launches']}")
        check(s["unschedulable"] == 0 and s["parked"] == 0, f"{name}: round {i} left {s['unschedulable']} unschedulable, {s['parked']} parked")
        placed = s["pods_on_launched_nodes"] + s["pods_nominated_onto_standing"]
        check(placed == pods_n, f"{name}: round {i} nominated {placed} of {pods_n} pods")
        check(not any(s["broken"].values()), f"{name}: round {i} broke placements: {s['broken']}")
    check(same_runs, f"{name}: the timed rounds placed pods differently")
    check(not any(plain["launches"].values()), f"{name}: the plain versions' round launched kernels: {plain['launches']}")
    check(same_plain, f"{name}: the kernels' and the plain versions' rounds placed pods differently")
    check(bare_equal, f"{name}: the round's solve differs from a bare build_scheduler(...).solve on the same snapshot")
    return line


def controller_ice_resolve(dev, min_batch: int, card_name) -> dict:
    """The capacity-failure ladder on the card: the headline batch on an
    empty cluster. A warm-up round shows which instance types the round
    launches; then the round runs with the fake provider in strict mode,
    once with every pool of the type launched most often refused and once
    with every pool of every type the warm-up launched refused. The typed
    failures feed the re-solves, which count the pods the round already
    nominated (on the nodes it launched, in their free resources and in the
    topology domains), so no node ends the round over its capacity and
    build_workload's anti-affinity and self-affinity cohorts stay whole.
    Where those pods include a required anti-affinity term, the dense path
    routes the whole re-solve to the host loop, as it does for any batch
    beside such pods; with every launched type refused, the first launch
    step places nothing, and the first re-solve runs dense through K1.
    Each round is held against the same round with the plain versions. The
    nodes launch one at a time here, so that both runs' re-solves see them
    in one order: the fake provider names nodes in the order its create
    calls arrive, and a solve walks the nodes in that order."""
    from karpenter_tpu_torch.api import labels as lbl

    name, pods_n = CONTROLLER_ICE
    env, _rec = run_round(dev, pods_n, 0, min_batch, "ice")
    counts = {}
    for node in env.kube.list_nodes():
        it = node.metadata.labels[lbl.LABEL_INSTANCE_TYPE]
        counts[it] = counts.get(it, 0) + 1
    by_count = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    catalog = {t.name(): t for t in env.provider.instance_types_list}
    cases = {"most_launched_type": [by_count[0][0]], "every_launched_type": sorted(counts)}
    line = {
        "phase": "controller_ice",
        "config": name,
        "card": card_name,
        "pods": pods_n,
        "types": HEADLINE_TYPES,
        "min_batch": min_batch,
        "warmup_launches_by_type": dict(by_count),
        "runs": {},
        "kernel_launches": {},
    }
    checks = []
    for case, refused in cases.items():
        pools = {(t, o.zone, o.capacity_type) for t in refused for o in catalog[t].offerings()}

        def strict(env):
            env.provider.allow_insufficient_capacity = False
            env.provider.insufficient_capacity_pools = set(pools)
            # one create at a time: the fake provider names nodes in the
            # order its create calls arrive, and the re-solve's warm fill
            # walks the nodes in the order they reached the cluster, so
            # parallel launches would make the two runs' re-solves differ
            env.controller.LAUNCH_WORKERS = 1

        _env, rec = run_round(dev, pods_n, 0, min_batch, "ice", prepare=strict)
        _env, plain = run_round(dev, pods_n, 0, min_batch, "ice", prepare=strict, plain=True)
        resolves = rec["schedule"][1:]
        fed = [launch["ice_failed_pods"] for launch in rec["launch"]]
        on_quarantine = [n for n in rec["outcome"]["launched"] if tuple(n[:3]) in pools]
        line["runs"][case] = {
            "refused_types": refused,
            "refused_pools": len(pools),
            "round": round_summary(rec),
            "ice_failed_pods_per_launch": fed,
            "retry_batches": [s["pods"] for s in resolves],
            "resolve_wall_ms": [s["wall_ms"] for s in resolves],
            "resolve_phases_ms": [s["phases_ms"] for s in resolves],
            "resolve_launches": [s["launches"] for s in resolves],
            "resolve_dense_batches": [s["dense_batches"] for s in resolves],
            "resolve_pods_to_host": [s["pods_to_host"] for s in resolves],
            "resolve_state_nodes": [s["state_nodes"] for s in resolves],
            "resolve_on_existing": [s["on_existing"] for s in resolves],
            "resolve_new_node_pods": [s["new_node_pods"] for s in resolves],
            "parked": len(rec["outcome"]["parked"]),
            "nodes_on_refused_pools": len(on_quarantine),
            "plain_run": {"launches": plain["launches"], "placements_identical": plain["outcome"] == rec["outcome"]},
        }
        line["kernel_launches"][case] = rec["launches"]
        checks += [
            (resolves, f"{case}: no typed failure fed a re-solve"),
            ([s["pods"] for s in resolves] == fed[: len(resolves)], f"{case}: re-solve batches {[s['pods'] for s in resolves]} are not the failed launches' pods {fed}"),
            (bool(resolves) and resolves[0]["pods"] >= min_batch, f"{case}: the first re-solve's batch stays below min_batch {min_batch}"),
            (not on_quarantine, f"{case}: nodes launched on refused pools: {on_quarantine[:3]}"),
            (not any(plain["launches"].values()), f"{case}: the plain versions' round launched kernels: {plain['launches']}"),
            (plain["outcome"] == rec["outcome"], f"{case}: the kernels' and the plain versions' rounds placed pods differently"),
            (not any(rec["outcome"]["broken"].values()), f"{case}: the round broke placements: {rec['outcome']['broken']}"),
            (
                all(s["launches"]["bucket_type_cost"] >= 1 for s in resolves if s["dense_batches"] and s["new_node_pods"]),
                f"{case}: K1 did not launch in a re-solve that ran dense: {[s['launches'] for s in resolves]}",
            ),
        ]
        if case == "every_launched_type":
            # nothing of the round is placed yet, so no nominated
            # anti-affinity pod sends the first re-solve to the host loop
            checks.append((
                resolves[0]["dense_batches"] >= 1 and resolves[0]["launches"]["bucket_type_cost"] >= 1,
                f"{case}: the first re-solve did not run dense through K1: {resolves[0]}",
            ))
    line["kernel_launches"] = {
        k: sum(v[k] for v in line["kernel_launches"].values()) for k in ("bucket_type_cost", "warm_fill_counts")
    }
    emit(line)
    for cond, what in checks:
        check(bool(cond), f"{name}: {what}")
    return line


def controller_loop(dev, min_batch: int, card_name) -> dict:
    """The threaded path on the real clock: ProvisioningReconciler and the
    batch loop started, then the batch created in the store (each pod event
    pulls the batcher trigger); the window closes after LOOP_WINDOW's idle
    time and the loop runs the round. Stopped once every pod is nominated."""
    from karpenter_tpu_torch.config import Config
    from karpenter_tpu_torch.controllers.provisioning import ProvisioningReconciler

    name, pods_n, standing = CONTROLLER_LOOP
    idle, longest = LOOP_WINDOW
    env = controller_env(dev, pods_n, standing, min_batch, "loop", config=Config(batch_max_duration=longest, batch_idle_duration=idle))
    rounds = []
    provision = env.controller.provision

    def counted_provision():
        t0 = time.perf_counter()
        try:
            return provision()
        finally:
            rounds.append((t0, time.perf_counter()))

    env.controller.provision = counted_provision
    reconciler = ProvisioningReconciler(env.kube, env.controller)
    names = {p.name for p in env.pods}
    read_launches()
    env.controller.start()
    t0 = time.perf_counter()
    try:
        create_pods(env)
        created = time.perf_counter()
        deadline = created + LOOP_TIMEOUT_S
        nominated = set()
        while time.perf_counter() < deadline and env.controller.error is None:
            nominated = {e.object_name for e in env.recorder.of("NominatePod")}
            if names <= nominated and rounds:
                break
            time.sleep(0.02)
        done = time.perf_counter()
    finally:
        reconciler.detach()
        env.controller.stop()  # re-raises the error that ended the loop, if any
    launches = read_launches()
    line = {
        "phase": "controller_loop",
        "config": name,
        "card": card_name,
        "pods": pods_n,
        "standing_nodes": standing,
        "min_batch": min_batch,
        "batch_idle_s": idle,
        "batch_max_s": longest,
        "create_ms": (created - t0) * 1e3,
        "pods_to_last_nomination_ms": (done - t0) * 1e3,
        "rounds": len(rounds),
        "round_ms": [(b - a) * 1e3 for a, b in rounds],
        "window_close_after_last_create_ms": (rounds[0][0] - created) * 1e3 if rounds else None,
        "nominated": len(nominated & names),
        "nodes_launched": len(env.provider.live_instances),
        "kernel_launches": launches,
        "error": None if env.controller.error is None else repr(env.controller.error),
    }
    emit(line)
    check(env.controller.error is None, f"{name}: the loop stopped on {env.controller.error!r}")
    check(names <= nominated, f"{name}: {len(names - nominated)} of {pods_n} pods never nominated within {LOOP_TIMEOUT_S} s")
    check(launches["bucket_type_cost"] >= 1 and launches["warm_fill_counts"] >= 1, f"{name}: the loop's rounds launched {launches}")
    return line


def replicaset_stand_in(kube) -> list:
    """The in-memory store runs no ReplicaSet controller. This stands in for
    one on the store's watch: a ReplicaSet-owned pod that is deleted (an
    eviction by the drain) is created again at once, unbound and pending,
    under a new name, with its labels, requests and spread constraints, as
    a ReplicaSet recreates an evicted pod from its template. Returns the
    list the new pods' names are appended to."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.kube.cluster import DELETED

    created = []

    def on_pod(event):
        pod = event.obj
        if event.type != DELETED or not any(ref.kind == "ReplicaSet" for ref in pod.metadata.owner_references):
            return
        name = f"rs-{len(created):06d}"
        created.append(name)
        kube.create(testing.owned_pod(
            name=name, labels=dict(pod.metadata.labels), requests=dict(pod.spec.containers[0].resources.requests),
            topology_spread_constraints=list(pod.spec.topology_spread_constraints),
        ))

    kube.watch("Pod", on_pod, replay=False)
    return created


class GcPauses:
    """The interpreter's garbage-collection pauses, from gc.callbacks while
    installed: `ms` accumulates every collection's time, `full` counts the
    generation-2 (whole-heap) collections."""

    def __init__(self):
        self.ms, self.full, self._t0 = 0.0, 0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.full += info["generation"] == 2
            self._t0 = None


def disruption_env(dev, min_batch: int):
    """testing.DisruptionEnv on the card: the consolidation-enabled default
    provisioner, FakeCloudProvider(instance_types(HEADLINE_TYPES)), a
    DenseSolver routed at `min_batch` in its provisioning controller (which
    the what-ifs call), the orchestrator with consolidation as a source and
    the termination controller draining, and the ReplicaSet stand-in."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.solver import DenseSolver

    env = testing.DisruptionEnv(
        provisioners=[testing.make_provisioner(consolidation_enabled=True)],
        instance_types_list=instance_types(HEADLINE_TYPES),
    )
    env.provisioner_controller.dense_solver = DenseSolver(min_batch=min_batch, device=dev)
    env.recreated = replicaset_stand_in(env.kube)
    env.catalog = {it.name(): it for it in env.provider.instance_types_list}
    return env


def capture_kernel_calls(captures: list) -> None:
    """Wrap the solve's two kernel seams, solver/dense.py's
    bucket_cost_packed (K1) and solver/warmfill.py's admission_counts (K2),
    so that each call appends its operands and its output to `captures`
    for hold_kernel_calls. K1's are the card tensors it was given and the
    card tensor it returned, kept as they are (the launch stays
    asynchronous and nothing writes them again); K2's are the host arrays
    its round trip uploads, the first V rows of the resident head copied
    on the card where the solve passes one, and a copy of the counts (they
    are a view of the round trip's landing buffer). The caller puts the
    seams back."""
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    k1, k2 = dense_module.bucket_cost_packed, fill_module.admission_counts

    def captured_k1(stats, caps, prices, allowed):
        out = k1(stats, caps, prices, allowed)
        captures.append(("bucket_type_cost", (stats, caps, prices, allowed), out))
        return out

    def captured_k2(sizes, head, solver, head_dev=None):
        counts, seconds = k2(sizes, head, solver, head_dev)
        head_rows = None if head_dev is None else head_dev[: head.shape[0]].clone()
        captures.append(("warm_fill_counts", (sizes.copy(), head.copy(), head_rows), counts.copy()))
        return counts, seconds

    dense_module.bucket_cost_packed, fill_module.admission_counts = captured_k1, captured_k2


def hold_kernel_calls(calls, dev) -> list:
    """Each captured kernel call against its plain version on the same
    operands on the card, bit for bit: K1's plain version on the very
    tensors the kernel read; K2's on the resident head's rows where the
    solve passed them, else on the host head uploaded as f32 (the values
    the round trip stages), with the sizes uploaded the same way."""
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.ops.warmfill import warm_fill_counts

    held = []
    for kernel, operands, out in calls:
        if kernel == "bucket_type_cost":
            got = out
            want = bucket_type_cost_packed(*operands)
            shape = [operands[1].shape[0], *operands[0].shape[1:]]  # T, B, R
        else:
            sizes, head, head_rows = operands
            got = torch.from_numpy(out).to(dev)
            sizes_t = torch.from_numpy(sizes.astype(np.float32)).to(dev)
            head_t = head_rows if head_rows is not None else torch.from_numpy(head.astype(np.float32)).to(dev)
            want = warm_fill_counts(sizes_t, head_t)
            shape = [sizes.shape[0], *head.shape]  # S, V, R
        same_shape = got.shape == want.shape
        err = float((got.long() - want.long()).abs().max()) if same_shape and got.numel() else 0.0
        held.append({
            "kernel": kernel,
            "shape": [int(x) for x in shape],
            "identical": same_shape and bool(torch.equal(got, want)),
            "max_abs_err": err,
        })
    return held


def instrument_disruption(env, dev, pauses: GcPauses, captures: list) -> dict:
    """Time each schedule call of a pass (the what-ifs, in simulation mode,
    and the provisioning round's solve), with the solver's phases, both
    kernels' launches and the garbage-collection pauses in it, and each
    drain (termination.reconcile). Each schedule call's record takes the
    kernel calls captured in it (`captures`, filled by
    capture_kernel_calls), to be held after the pass."""
    from karpenter_tpu_torch.ops import bucket_cost, warmfill
    from karpenter_tpu_torch.solver import DenseSolveStats

    ctrl, termination = env.provisioner_controller, env.termination_controller
    solver = ctrl.dense_solver
    rec = {"schedule": [], "drain_ms": [], "proposed": []}
    schedule, drain, propose = ctrl.schedule, termination.reconcile, env.consolidation.propose

    def timed_schedule(pods, state_nodes, opts=None, **kwargs):
        solver.stats = DenseSolveStats()
        before = (bucket_cost.LAUNCHES, warmfill.LAUNCHES)
        gc_before = pauses.ms
        n0 = len(captures)
        t0 = time.perf_counter()
        results = schedule(pods, state_nodes, opts, **kwargs)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        calls = captures[n0:]
        del captures[n0:]
        st = solver.stats
        rec["schedule"].append({
            "what_if": bool(opts is not None and opts.simulation_mode),
            "gc_ms": pauses.ms - gc_before,
            "pods": len(pods),
            "state_nodes": len(state_nodes),
            "wall_ms": ms,
            "on_existing": sum(len(v.pods) for v in results.existing_nodes),
            "new_node_pods": sum(len(n.pods) for n in results.new_nodes),
            "unschedulable": len(results.unschedulable),
            "dense_batches": st.batches,
            "pods_to_host": st.pods_to_host,
            "launches": {"bucket_type_cost": bucket_cost.LAUNCHES - before[0], "warm_fill_counts": warmfill.LAUNCHES - before[1]},
            "phases_ms": {k: getattr(st, f"{k}_seconds") * 1e3 for k in ("encode", "fill", "fill_device", "device", "mask", "assemble", "device_wait", "commit")},
            "calls": calls,
        })
        return results

    def timed_drain(node):
        t0 = time.perf_counter()
        try:
            return drain(node)
        finally:
            rec["drain_ms"].append((time.perf_counter() - t0) * 1e3)

    def recorded_propose(*args, **kwargs):
        commands = propose(*args, **kwargs)
        rec["proposed"].extend(commands)
        return commands

    ctrl.schedule, termination.reconcile, env.consolidation.propose = timed_schedule, timed_drain, recorded_propose
    return rec


def cluster_price(env) -> float:
    """$/hour of the cluster's nodes, by their instance types' prices."""
    from karpenter_tpu_torch.api import labels as lbl

    return sum(env.catalog[n.metadata.labels[lbl.LABEL_INSTANCE_TYPE]].price() for n in env.kube.list_nodes())


def over_capacity(env) -> list:
    """Nodes whose bound pods request more than the node allocates, pod
    slots included."""
    from karpenter_tpu_torch.utils import resources as res

    used = {}
    for pod in env.kube.list_pods():
        if pod.spec.node_name:
            used[pod.spec.node_name] = res.merge(used.get(pod.spec.node_name, {}), res.pod_requests(pod))
    return sorted(
        node.name for node in env.kube.list_nodes()
        if any(v > node.status.allocatable.get(k, 0.0) + 1e-6 for k, v in used.get(node.name, {}).items())
    )


def disruption_pass(env, dev, rec, replace: bool, pauses: GcPauses) -> dict:
    """One orchestrator pass on the fake clock, stepped past the nomination
    TTL first: reconcile() (a delete: the what-if, the command, validation,
    the drain; a replace: the what-if and the replacement's launch, then
    the node controller initializes it, then a second reconcile() drains
    the candidate), the termination controller's sweep, one provisioning
    round for the pods the ReplicaSet stand-in recreated, and the binding
    of its nominations."""
    from karpenter_tpu_torch.api import labels as lbl

    env.recorder.reset()
    env.clock.step(env.cluster.nomination_ttl + 1)
    for key in rec:
        del rec[key][:]
    nodes_before = {n.name for n in env.kube.list_nodes()}
    price_before = cluster_price(env)
    recreated_before = len(env.recreated)
    gc_start = (pauses.ms, pauses.full)
    read_launches()
    t0 = time.perf_counter()
    env.disruption.reconcile()
    sync(dev)
    reconcile_ms = [(time.perf_counter() - t0) * 1e3]
    init_ms = None
    if replace:
        t0 = time.perf_counter()
        env.node_controller.reconcile_all()
        init_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        env.disruption.reconcile()
        sync(dev)
        reconcile_ms.append((time.perf_counter() - t0) * 1e3)
    pass_launches = read_launches()
    pass_gc_ms = pauses.ms - gc_start[0]
    t0 = time.perf_counter()
    env.termination_controller.reconcile_all()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    recreated = env.recreated[recreated_before:]
    gc_round = pauses.ms
    t0 = time.perf_counter()
    env.provisioner_controller.provision()
    sync(dev)
    round_ms = (time.perf_counter() - t0) * 1e3
    round_gc_ms = pauses.ms - gc_round
    round_launches = read_launches()
    nominated = {}
    for event in env.recorder.of("NominatePod"):
        nominated[event.object_name] = event.message.split()[-1]
    bound = env.bind_nominated()
    nodes_after = {n.name: n for n in env.kube.list_nodes()}
    launched = sorted(set(nodes_after) - nodes_before)
    commands = [
        {
            "method": c.method,
            "nodes": c.node_names(),
            "replacement_types": [vn.instance_type_options[0].name() for vn in c.replacements],
            "outcome": c.outcome,
        }
        for c in rec["proposed"]
    ]
    for s in rec["schedule"]:
        s["held"] = hold_kernel_calls(s.pop("calls"), dev)
    what_ifs = [s for s in rec["schedule"] if s["what_if"]]
    rounds = [s for s in rec["schedule"] if not s["what_if"]]
    return {
        "wall_ms": sum(reconcile_ms) + (init_ms or 0.0),
        "reconcile_ms": reconcile_ms,
        "initialize_ms": init_ms,
        "drain_ms": list(rec["drain_ms"]),
        "sweep_ms": sweep_ms,
        "round_ms": round_ms,
        "what_ifs": what_ifs,
        "rounds": rounds,
        "pass_launches": pass_launches,
        "round_launches": round_launches,
        "gc_ms": {"pass": pass_gc_ms, "round": round_gc_ms, "full_collections": pauses.full - gc_start[1]},
        "price_before": price_before,
        "price_after": cluster_price(env),
        "outcome": {
            "commands": commands,
            "deleted": sorted(nodes_before - set(nodes_after)),
            "launched": [
                (name, nodes_after[name].metadata.labels[lbl.LABEL_INSTANCE_TYPE], nodes_after[name].metadata.labels[lbl.LABEL_TOPOLOGY_ZONE], nodes_after[name].metadata.labels[lbl.LABEL_CAPACITY_TYPE])
                for name in launched
            ],
            "recreated": len(recreated),
            "placements": sorted((name, nominated.get(name)) for name in recreated),
        },
        "bound": bound,
        "unnominated": sorted(name for name in recreated if name not in nominated),
        "over_capacity": over_capacity(env),
    }


def disruption_phase_runs(dev, min_batch: int, build, replace: bool, plain: bool = False) -> list:
    """A warm-up pass and CONSOLIDATION_PASSES timed passes, on one cluster
    (`build(env)` once) or, for the replace cell, on a fresh cluster each;
    the set-up's garbage is collected before the first pass on it, so a
    pass's collections are its own. With plain=True both kernels' plain
    versions stand in at the seams the solve calls; else each kernel call
    is captured and held against its plain version after its pass.
    Returns the passes' records, the warm-up's first."""
    import gc

    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    saved = dense_module.bucket_cost_packed, fill_module.admission_counts
    captures = []
    if plain:
        dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
    else:
        capture_kernel_calls(captures)
    runs, env = [], None
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    try:
        for i in range(1 + CONSOLIDATION_PASSES):
            setup_s = None
            if env is None or replace:
                env = None
                gc.collect()
                env = disruption_env(dev, min_batch)
                t0 = time.perf_counter()
                build(env)
                setup_s = time.perf_counter() - t0
                rec = instrument_disruption(env, dev, pauses, captures)
                gc.collect()
            runs.append(dict(disruption_pass(env, dev, rec, replace, pauses), setup_s=setup_s, pods_in_store=len(env.kube.list_pods())))
    finally:
        gc.callbacks.remove(pauses)
        dense_module.bucket_cost_packed, fill_module.admission_counts = saved
    return runs


def disruption_phase(dev, min_batch: int, card_name, name: str, build, replace: bool, shape: dict) -> dict:
    """Run a consolidation cell with the kernels and again with their plain
    versions, print its line and check it: every pass takes its action
    (DELETE, or REPLACE by a cheaper type), every what-if runs dense with
    the expected kernels (K2, and K1 for a replacement), every recreated
    pod is nominated and bound, no node ends over its capacity or pod
    slots, every kernel call of every pass (what-if and round) equals its
    plain version on its own operands bit for bit, and the plain versions'
    run takes the same actions and placements while launching no kernel."""
    runs = disruption_phase_runs(dev, min_batch, build, replace)
    plain = disruption_phase_runs(dev, min_batch, build, replace, plain=True)
    timed = runs[1:]
    expect_k1 = 1 if replace else 0
    what_if_launches = {k: sum(w["launches"][k] for r in timed for w in r["what_ifs"]) for k in ("bucket_type_cost", "warm_fill_counts")}
    holds = {}
    for where in ("what_ifs", "rounds"):
        for kernel in ("bucket_type_cost", "warm_fill_counts"):
            held = [h for r in runs for s in r[where] for h in s["held"] if h["kernel"] == kernel]
            holds[f"{where[:-1]}/{kernel}"] = {
                "calls": len(held),
                "identical": sum(h["identical"] for h in held),
                "max_abs_err": max((h["max_abs_err"] for h in held), default=0.0),
                "shapes": sorted({tuple(h["shape"]) for h in held}),
            }
    round_launches = {k: sum(r["round_launches"][k] for r in timed) for k in ("bucket_type_cost", "warm_fill_counts")}
    line = {
        "phase": "disruption",
        "config": name,
        "card": card_name,
        "min_batch": min_batch,
        "types": HEADLINE_TYPES,
        **shape,
        "passes": len(timed),
        "wall_ms": statistics.median(r["wall_ms"] for r in timed),
        "wall_ms_runs": [r["wall_ms"] for r in timed],
        "what_if_ms": statistics.median(w["wall_ms"] for r in timed for w in r["what_ifs"]),
        "what_if_ms_runs": [[w["wall_ms"] for w in r["what_ifs"]] for r in timed],
        "what_if_phases_ms": [r["what_ifs"][0]["phases_ms"] for r in timed if r["what_ifs"]],
        "what_if_gc_ms_runs": [[w["gc_ms"] for w in r["what_ifs"]] for r in timed],
        "gc_ms_runs": [r["gc_ms"] for r in timed],
        "drain_ms": statistics.median(sum(r["drain_ms"]) for r in timed),
        "drain_ms_runs": [r["drain_ms"] for r in timed],
        "round_ms": statistics.median(r["round_ms"] for r in timed),
        "round_ms_runs": [r["round_ms"] for r in timed],
        "round_phases_ms": [r["rounds"][0]["phases_ms"] for r in timed if r["rounds"]],
        "reconcile_ms_runs": [r["reconcile_ms"] for r in timed],
        "initialize_ms_runs": [r["initialize_ms"] for r in timed],
        "setup_s_runs": [r["setup_s"] for r in runs],
        "kernel_launches": {"what_if": what_if_launches, "round": round_launches},
        "kernel_holds": holds,
        "launches_per_pass": [{"what_if": [w["launches"] for w in r["what_ifs"]], "round": r["round_launches"]} for r in timed],
        "what_if_pods": [[(w["pods"], w["state_nodes"], w["pods_to_host"], w["dense_batches"]) for w in r["what_ifs"]] for r in timed],
        "actions": [r["outcome"]["commands"] for r in timed],
        "launched": [r["outcome"]["launched"] for r in timed],
        "deleted": [r["outcome"]["deleted"] for r in timed],
        "price_per_hour": [(r["price_before"], r["price_after"]) for r in runs],
        "recreated": [r["outcome"]["recreated"] for r in timed],
        "bound": [r["bound"] for r in timed],
        "plain_run": {
            "launches": [r["pass_launches"] for r in plain] + [r["round_launches"] for r in plain],
            "wall_ms_runs": [r["wall_ms"] for r in plain[1:]],
            "outcomes_identical": [r["outcome"] for r in plain] == [r["outcome"] for r in runs],
        },
    }
    emit(line)
    action = "replace" if replace else "delete"
    for i, r in enumerate(runs):
        tag = f"{name}: pass {i} ({'warm-up' if i == 0 else 'timed'})"
        cmds = r["outcome"]["commands"]
        check(len(cmds) == 1 and cmds[0]["method"] == "consolidation" and cmds[0]["outcome"] == "disrupted", f"{tag}: commands {cmds}")
        check(bool(cmds[0]["replacement_types"]) == replace, f"{tag}: expected a {action}, got {cmds[0]}")
        check(len(r["outcome"]["deleted"]) == 1 and r["outcome"]["deleted"] == cmds[0]["nodes"], f"{tag}: deleted {r['outcome']['deleted']}")
        check(len(r["outcome"]["launched"]) == (1 if replace else 0), f"{tag}: launched {r['outcome']['launched']}")
        check(len(r["what_ifs"]) == 1, f"{tag}: {len(r['what_ifs'])} what-ifs, expected 1")
        for w in r["what_ifs"]:
            check(w["pods"] >= min_batch and w["dense_batches"] >= 1 and w["pods_to_host"] == 0, f"{tag}: the what-if did not run dense: {w}")
            check(w["launches"] == {"bucket_type_cost": expect_k1, "warm_fill_counts": 1}, f"{tag}: the what-if launched {w['launches']}")
        check(len(r["rounds"]) == 1 and r["rounds"][0]["pods_to_host"] == 0 and r["rounds"][0]["unschedulable"] == 0, f"{tag}: the round {r['rounds']}")
        check(r["round_launches"] == {"bucket_type_cost": 0, "warm_fill_counts": 1}, f"{tag}: the round launched {r['round_launches']}")
        for s in r["what_ifs"] + r["rounds"]:
            for kernel in ("bucket_type_cost", "warm_fill_counts"):
                held = [h for h in s["held"] if h["kernel"] == kernel]
                check(len(held) == s["launches"][kernel], f"{tag}: {len(held)} {kernel} calls held for {s['launches'][kernel]} launches")
                check(all(h["identical"] for h in held), f"{tag}: {kernel} differs from its plain version on its own operands: {held}")
        check(r["outcome"]["recreated"] > 0 and not r["unnominated"] and r["bound"] == r["outcome"]["recreated"], f"{tag}: {len(r['unnominated'])} recreated pods not nominated, {r['bound']} bound")
        check(not r["over_capacity"], f"{tag}: nodes over capacity: {r['over_capacity'][:5]}")
        check(r["price_after"] < r["price_before"], f"{tag}: $/hour {r['price_before']} -> {r['price_after']}")
    for i, r in enumerate(plain):
        check(not any(r["pass_launches"].values()) and not any(r["round_launches"].values()), f"{name}: the plain versions' pass {i} launched kernels")
    check(line["plain_run"]["outcomes_identical"], f"{name}: the kernels' and the plain versions' passes took other actions or placements")
    return line


def consolidation_delete(dev, min_batch: int, card_name) -> dict:
    """Scale-down of a large, half-idle cluster through the orchestrator:
    CONSOLIDATION_DELETE's standing nodes, each running its pods; each pass
    deletes one node, whose pods the what-if fills onto the others (K2)."""
    from karpenter_tpu_torch import testing

    name, nodes, pods = CONSOLIDATION_DELETE

    def build(env):
        prov = env.kube.list_provisioners()[0]
        testing.consolidation_cluster(env.kube, prov, "del", nodes, "fake-it-15", NODE_ALLOCATABLE, pods, CONSOLIDATION_POD)

    return disruption_phase(dev, min_batch, card_name, name, build, False, {"nodes": nodes, "pods_per_node": pods, "pods": nodes * pods})


def consolidation_replace(dev, min_batch: int, card_name) -> dict:
    """Right-sizing an oversized node, on a fresh cluster each pass:
    CONSOLIDATION_REPLACE's full standing nodes and one larger node running
    fewer pods; its what-if finds no slot on the full nodes (K2) and needs
    one new, cheaper node (K1)."""
    from karpenter_tpu_torch import testing

    name, nodes, pods, big_type, big_pods = CONSOLIDATION_REPLACE

    def build(env):
        prov = env.kube.list_provisioners()[0]
        testing.consolidation_cluster(env.kube, prov, "full", nodes, "fake-it-15", NODE_ALLOCATABLE, pods, CONSOLIDATION_POD)
        testing.consolidation_cluster(env.kube, prov, "big", 1, big_type, BIG_ALLOCATABLE, big_pods, CONSOLIDATION_POD)

    shape = {"nodes": nodes, "pods_per_node": pods, "oversized_type": big_type, "oversized_pods": big_pods, "pods": nodes * pods + big_pods}
    return disruption_phase(dev, min_batch, card_name, name, build, True, shape)


def wave_env(dev, min_batch: int):
    """testing.SimulatedEnv on the card, with the fleet a reclaim wave hits:
    the spot-only provisioner on CloudBackend's default catalog, WAVE's pods
    (testing.reclaim_wave_workload) provisioned by one round through a
    DenseSolver routed at `min_batch`, every node Ready, every nomination
    bound, the node controller run; then the ReplicaSet stand-in. Nodes
    launch one at a time, so every run's store holds the fleet in one order
    (the wave's victims are the first populated nodes in store order) and
    every run's re-solves see the same nodes. The event ring keeps every
    event: nominations are read back from it."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.api.objects import NodeCondition
    from karpenter_tpu_torch.solver import DenseSolver

    env = testing.SimulatedEnv(event_capacity=EVENT_CAPACITY)
    env.provisioner_controller.dense_solver = DenseSolver(min_batch=min_batch, device=dev)
    env.provisioner_controller.LAUNCH_WORKERS = 1
    env.kube.create(testing.spot_provisioner())
    for pod in testing.rename(testing.reclaim_wave_workload(WAVE[1]), "wave"):
        env.kube.create(pod)
    env.provision()
    for node in env.kube.list_nodes():
        node.status.conditions = [NodeCondition(type="Ready", status="True")]
        env.kube.update(node)
    env.bind_nominated()
    env.node_controller.reconcile_all()
    env.recreated = replicaset_stand_in(env.kube)
    return env


def pool_of(node) -> tuple:
    from karpenter_tpu_torch.api import labels as lbl

    labels = node.metadata.labels
    return (labels[lbl.LABEL_INSTANCE_TYPE], labels[lbl.LABEL_TOPOLOGY_ZONE], labels[lbl.LABEL_CAPACITY_TYPE])


def instrument_wave(env, dev, captures: list) -> dict:
    """Time each notice's proactive re-solve (the schedule call in
    simulation mode, with the solver's phases, both kernels' launches and
    the kernel calls captured in it), its replacement launch and its drain
    handoff; record each dense solve's catalog (the quarantined offerings
    it encoded) and, for each device solve, the buckets, the pair matrix
    and the availability cube K1's `allowed` was built from."""
    from karpenter_tpu_torch.ops import bucket_cost, warmfill
    from karpenter_tpu_torch.solver import DenseSolveStats
    from karpenter_tpu_torch.solver import dense as dense_module

    ctrl, interruption, provider = env.provisioner_controller, env.interruption, env.provider
    solver = ctrl.dense_solver
    rec = {"notices": [], "problems": [], "device_solves": []}
    schedule, launch, handoff = ctrl.schedule, ctrl.launch_nodes, interruption._hand_off_to_termination
    encode, stack, mask = dense_module.encode_problem, solver._stack_dedicated_buckets, dense_module.availability_counts

    def timed_schedule(pods, state_nodes, opts=None, **kwargs):
        if opts is None or not opts.simulation_mode:
            return schedule(pods, state_nodes, opts, **kwargs)
        solver.stats = DenseSolveStats()
        before = (bucket_cost.LAUNCHES, warmfill.LAUNCHES)
        n0, p0, d0 = len(captures), len(rec["problems"]), len(rec["device_solves"])
        quarantined = sorted(provider.unavailable.snapshot())
        t0 = time.perf_counter()
        results = schedule(pods, state_nodes, opts, **kwargs)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        st = solver.stats
        calls = captures[n0:]
        del captures[n0:]
        rec["notices"].append({
            "pods": len(pods),
            "state_nodes": len(state_nodes),
            "route": "dense" if st.batches else "host",
            "resolve_ms": ms,
            "on_existing": sum(len(v.pods) for v in results.existing_nodes),
            "new_node_pods": sum(len(n.pods) for n in results.new_nodes),
            "unschedulable": len(results.unschedulable),
            "dense_batches": st.batches,
            "pods_to_host": st.pods_to_host,
            "launches": {"bucket_type_cost": bucket_cost.LAUNCHES - before[0], "warm_fill_counts": warmfill.LAUNCHES - before[1]},
            "phases_ms": {k: getattr(st, f"{k}_seconds") * 1e3 for k in ("encode", "fill", "fill_device", "device", "mask", "assemble", "device_wait", "commit")},
            "quarantined": quarantined,
            "problems": rec["problems"][p0:],
            "device_solves": rec["device_solves"][d0:],
            "calls": calls,
        })
        return results

    def timed_launch(results, *args, **kwargs):
        t0 = time.perf_counter()
        names = launch(results, *args, **kwargs)
        notice = rec["notices"][-1] if rec["notices"] else None
        if notice is not None and "launch_ms" not in notice:
            notice["launch_ms"] = (time.perf_counter() - t0) * 1e3
            notice["replacements"] = [pool_of(env.kube.get_node(name)) for name in names]
            notice["quarantined_at_launch"] = sorted(provider.unavailable.snapshot())
        return names

    def timed_handoff(node):
        t0 = time.perf_counter()
        try:
            return handoff(node)
        finally:
            if rec["notices"]:
                rec["notices"][-1]["handoff_ms"] = (time.perf_counter() - t0) * 1e3

    def recorded_encode(*args, **kwargs):
        problem = encode(*args, **kwargs)
        rec["problems"].append(problem)
        return problem

    def recorded_stack(problem, buckets):
        stacked = stack(problem, buckets)
        rec["device_solves"].append({"problem": problem, "buckets": stacked})
        return stacked

    def recorded_mask(pair, cube):
        out = mask(pair, cube)
        if rec["device_solves"]:
            rec["device_solves"][-1].update(pair=pair, cube=cube)
        return out

    def restore():
        dense_module.encode_problem, dense_module.availability_counts = encode, mask

    ctrl.schedule, ctrl.launch_nodes, interruption._hand_off_to_termination = timed_schedule, timed_launch, timed_handoff
    solver._stack_dedicated_buckets = recorded_stack
    dense_module.encode_problem, dense_module.availability_counts = recorded_encode, recorded_mask
    rec["restore"] = restore
    return rec


def allowed_cleared(solve, k1_allowed, dev) -> dict:
    """K1's `allowed` of one device solve against the same solve with the
    quarantined offerings restored: availability_counts (the plain version,
    the solve's own) on the captured pair matrix against the captured cube
    and against the cube of every offering of the solve's types, each
    ANDed with the buckets' compatibility rows. Returns the entries the
    quarantine cleared and whether the rebuilt `allowed` equals the one K1
    was given."""
    from karpenter_tpu_torch.ops.feasibility import availability_counts

    problem, buckets = solve["problem"], solve["buckets"]
    zi = {z: i for i, z in enumerate(problem.zones)}
    ci = {c: i for i, c in enumerate(problem.capacity_types)}
    restored = np.zeros(problem.avail.shape, dtype=bool)
    for t, it in enumerate(problem.instance_types):
        for o in it.offerings():
            restored[t, zi[o.zone], ci[o.capacity_type]] = True
    cube_r = torch.from_numpy(restored.reshape(problem.T, -1).astype(np.float32)).to(dev)
    compat = np.zeros((len(buckets), problem.T), dtype=bool)
    for b, bucket in enumerate(buckets):
        if bucket.zone != "__infeasible__":
            compat[b] = bucket.compat_row if bucket.compat_row is not None else problem.compat[bucket.group_index]
    with_quarantine = compat & availability_counts(solve["pair"], solve["cube"]).cpu().numpy()
    without = compat & availability_counts(solve["pair"], cube_r).cpu().numpy()
    return {
        "cleared": int((without & ~with_quarantine).sum()),
        "allowed_rebuilt": bool(np.array_equal(with_quarantine, k1_allowed.cpu().numpy())),
        "shape": [len(buckets), problem.T],
    }


def wave_run(dev, min_batch: int, plain: bool = False) -> dict:
    """One reclaim wave on a fresh fleet. Timed: the poll_once() calls
    until every notice is handled and deleted. Then converge: termination
    until the victims are gone, one provisioning round for the pods the
    ReplicaSet stand-in recreated and the binding of its nominations; the
    clock past the deadlines, the cloud's reclaim, one gc sweep. With
    plain=True both kernels' plain versions stand in at the seams the solve
    calls; else each kernel call is captured and held against its plain
    version on its own operands after the run."""
    import gc

    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.solver import DenseSolveStats
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    saved = dense_module.bucket_cost_packed, fill_module.admission_counts
    captures = []
    if plain:
        dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
    else:
        capture_kernel_calls(captures)
    rec = None
    try:
        t0 = time.perf_counter()
        env = wave_env(dev, min_batch)
        setup_s = time.perf_counter() - t0
        kube, backend, provider = env.kube, env.backend, env.provider
        fleet = kube.list_nodes()
        populated = [n for n in fleet if kube.pods_on_node(n.name)]
        victims = populated[: max(1, min(WAVE_MAX_VICTIMS, int(len(populated) * WAVE_FRACTION)))]
        victim_pods = [len(kube.pods_on_node(v.name)) for v in victims]
        rec = instrument_wave(env, dev, captures)
        gc.collect()
        deadlines = [backend.interrupt_spot_instance(env.instance_id(v)) for v in victims]
        handled_before = env.interruption.actions_performed.value(action="cordon_and_drain")
        del captures[:]
        read_launches()
        polls = 0
        t0 = time.perf_counter()
        while backend.notifications.depth() and polls < 10:
            env.interruption.poll_once()
            polls += 1
        sync(dev)
        wave_ms = (time.perf_counter() - t0) * 1e3
        wave_launches = read_launches()
        handled = env.interruption.actions_performed.value(action="cordon_and_drain") - handled_before
        t0 = time.perf_counter()
        drain_passes = 0
        while any(kube.get_node(v.name) is not None for v in victims) and drain_passes < 4:
            env.termination_controller.reconcile_all()
            drain_passes += 1
        drain_ms = (time.perf_counter() - t0) * 1e3
        drained = len(env.recreated)
        quarantined = set(provider.unavailable.snapshot())
        before = {n.name for n in kube.list_nodes()}
        n0 = len(captures)
        round_stats = env.provisioner_controller.dense_solver.stats = DenseSolveStats()
        t0 = time.perf_counter()
        results = env.provision()
        sync(dev)
        round_ms = (time.perf_counter() - t0) * 1e3
        round_launches = read_launches()
        round_calls = captures[n0:]
        post_drain = [pool_of(n) for n in kube.list_nodes() if n.name not in before]
        bound = env.bind_nominated()
        pending = sum(1 for p in kube.list_pods() if not p.spec.node_name)
        env.clock.step(max(deadlines) - env.clock.now() + 1.0)
        reclaimed = backend.reclaim_due_instances()
        swept = env.gc.reconcile()
        live = {i.instance_id for i in backend.list_instances()}
        nodes = {n.name: n for n in kube.list_nodes()}
        dead_nodes = sorted(name for name, n in nodes.items() if env.instance_id(n) not in live)
        unbound = sum(1 for p in kube.list_pods() if p.spec.node_name not in nodes)
        over = over_capacity(env)
        depth = backend.notifications.depth()
    finally:
        if rec is not None:
            rec["restore"]()
        dense_module.bucket_cost_packed, fill_module.admission_counts = saved
    notices = rec["notices"]
    for notice, pods in zip(notices, victim_pods):
        notice["victim_pods"] = pods
        problems = notice.pop("problems")
        types = [{it.name() for it in p.instance_types} for p in problems]
        notice["masked_offerings"] = [p.masked_offerings for p in problems]
        notice["quarantined_in_catalog"] = [sum(1 for q in notice["quarantined"] if q[0] in names) for names in types]
        solves = [s for s in notice.pop("device_solves") if "pair" in s]
        k1_calls = [c for c in notice["calls"] if c[0] == "bucket_type_cost"]
        notice["k1_allowed"] = [allowed_cleared(s, c[1][3], dev) for s, c in zip(solves, k1_calls)] if not plain else []
        notice["k1_allowed_cleared"] = sum(a["cleared"] for a in notice["k1_allowed"])
        notice["held"] = hold_kernel_calls(notice.pop("calls"), dev) if not plain else []
    return {
        "setup_s": setup_s,
        "fleet": len(fleet),
        "populated": len(populated),
        "fleet_types": sorted({pool_of(n)[0] for n in fleet}),
        "victims": [pool_of(v) for v in victims],
        "handled": handled,
        "polls": polls,
        "wave_ms": wave_ms,
        "wave_launches": wave_launches,
        "notices": notices,
        "drain_ms": drain_ms,
        "drain_passes": drain_passes,
        "drained_pods": drained,
        "round_ms": round_ms,
        "round_launches": round_launches,
        "round_held": hold_kernel_calls(round_calls, dev) if not plain else [],
        "round_phases_ms": {k: getattr(round_stats, f"{k}_seconds") * 1e3 for k in ("encode", "fill", "fill_device", "device", "mask", "assemble", "device_wait", "commit")},
        "round": {
            "on_existing": sum(len(v.pods) for v in results.existing_nodes),
            "new_node_pods": sum(len(n.pods) for n in results.new_nodes),
            "unschedulable": len(results.unschedulable),
            "route": "dense" if round_stats.batches else "host",
            "node_guard_failopens": round_stats.node_guard_failopens,
        },
        "quarantined_pools": sorted(quarantined),
        "post_drain_launches": post_drain,
        "post_drain_on_quarantined": sorted(p for p in post_drain if p in quarantined),
        "bound_after_round": bound,
        "pending_after_round": pending,
        "reclaimed": reclaimed,
        "gc": swept,
        "dead_nodes": dead_nodes,
        "unbound_pods": unbound,
        "over_capacity": over,
        "queue_depth": depth,
        "pods": len(kube.list_pods()),
    }


def wave_outcome(run) -> dict:
    """What two runs of the wave must agree on: the victims, each
    replacement's (type, zone, capacity type) in order, the pods each
    notice placed on standing nodes, and the post-drain round's launches."""
    return {
        "victims": run["victims"],
        "replacements": [n.get("replacements", []) for n in run["notices"]],
        "on_existing": [n["on_existing"] for n in run["notices"]],
        "post_drain_launches": run["post_drain_launches"],
        "pending_after_round": run["pending_after_round"],
    }


def interruption_reclaim_wave(dev, min_batch: int, card_name) -> dict:
    """A spot reclaim wave through the interruption controller: a warm-up
    and WAVE_RUNS timed waves on fresh fleets, then the same with both
    kernels' plain versions. Prints the `interruption` line and checks it."""
    name, pods_n = WAVE
    runs = [wave_run(dev, min_batch) for _ in range(1 + WAVE_RUNS)]
    plain = [wave_run(dev, min_batch, plain=True) for _ in range(1 + WAVE_RUNS)]
    timed = runs[1:]
    last = timed[-1]

    def notice_line(n):
        return {
            "pods": n["pods"],
            "victim_pods": n["victim_pods"],
            "state_nodes": n["state_nodes"],
            "route": n["route"],
            "resolve_ms": n["resolve_ms"],
            "launch_ms": n.get("launch_ms"),
            "handoff_ms": n.get("handoff_ms"),
            "phases_ms": n["phases_ms"],
            "launches": n["launches"],
            "on_existing": n["on_existing"],
            "new_node_pods": n["new_node_pods"],
            "pods_to_host": n["pods_to_host"],
            "replacements": n.get("replacements", []),
            "masked_offerings": n["masked_offerings"],
            "quarantined_in_catalog": n["quarantined_in_catalog"],
            "k1_allowed_cleared": n["k1_allowed_cleared"],
        }

    holds = {}
    for kernel in ("bucket_type_cost", "warm_fill_counts"):
        held = [h for r in runs for n in r["notices"] for h in n["held"] if h["kernel"] == kernel]
        held += [h for r in runs for h in r["round_held"] if h["kernel"] == kernel]
        holds[kernel] = {
            "calls": len(held),
            "identical": sum(h["identical"] for h in held),
            "max_abs_err": max((h["max_abs_err"] for h in held), default=0.0),
            "shapes": sorted({tuple(h["shape"]) for h in held}),
        }
    line = {
        "phase": "interruption",
        "config": name,
        "card": card_name,
        "min_batch": min_batch,
        "pods": pods_n,
        "fleet_nodes": last["fleet"],
        "populated_nodes": last["populated"],
        "victims": last["victims"],
        "warning_s": 120.0,
        "runs": len(timed),
        "wave_ms": statistics.median(r["wave_ms"] for r in timed),
        "wave_ms_runs": [r["wave_ms"] for r in timed],
        "polls": [r["polls"] for r in timed],
        "notices": [notice_line(n) for n in last["notices"]],
        "resolve_ms_runs": [[n["resolve_ms"] for n in r["notices"]] for r in timed],
        "converge_ms": statistics.median(r["drain_ms"] + r["round_ms"] for r in timed),
        "converge_ms_runs": [{"drain": r["drain_ms"], "round": r["round_ms"]} for r in timed],
        "round_phases_ms": last["round_phases_ms"],
        "round": last["round"],
        "drained_pods": last["drained_pods"],
        "post_drain_launches": last["post_drain_launches"],
        "pending_after_round": last["pending_after_round"],
        "quarantined_pools": last["quarantined_pools"],
        "gc": last["gc"],
        "reclaimed": last["reclaimed"],
        "setup_s_runs": [r["setup_s"] for r in runs],
        "kernel_launches": {
            "wave": {k: sum(r["wave_launches"][k] for r in timed) for k in ("bucket_type_cost", "warm_fill_counts")},
            "round": {k: sum(r["round_launches"][k] for r in timed) for k in ("bucket_type_cost", "warm_fill_counts")},
        },
        "kernel_holds": holds,
        "plain_run": {
            "launches": [r["wave_launches"] for r in plain] + [r["round_launches"] for r in plain],
            "wave_ms_runs": [r["wave_ms"] for r in plain[1:]],
            "outcomes_identical": [wave_outcome(r) for r in plain] == [wave_outcome(r) for r in runs],
        },
    }
    emit(line)
    for i, r in enumerate(runs + plain):
        tag = f"{name}: run {i}"
        check(len(r["victims"]) == WAVE_MAX_VICTIMS and r["handled"] == WAVE_MAX_VICTIMS, f"{tag}: {r['handled']} of {len(r['victims'])} notices handled")
        check(len(r["notices"]) == WAVE_MAX_VICTIMS, f"{tag}: {len(r['notices'])} re-solves for {WAVE_MAX_VICTIMS} notices")
        check(r["queue_depth"] == 0, f"{tag}: {r['queue_depth']} messages left on the queue")
        for j, n in enumerate(r["notices"]):
            at_launch = set(map(tuple, n.get("quarantined_at_launch", [])))
            check(not [p for p in n.get("replacements", []) if p in at_launch], f"{tag}: notice {j} launched on a quarantined pool: {n.get('replacements')}")
            if n["route"] == "dense":
                check(n["masked_offerings"] == n["quarantined_in_catalog"], f"{tag}: notice {j} encoded {n['masked_offerings']} masked offerings for {n['quarantined_in_catalog']} quarantined pools in its catalog")
        check(not r["post_drain_on_quarantined"], f"{tag}: post-drain launches on quarantined pools: {r['post_drain_on_quarantined']}")
        check(r["pending_after_round"] == 0 and r["unbound_pods"] == 0, f"{tag}: {r['pending_after_round']} pods pending, {r['unbound_pods']} on gone nodes")
        check(not r["dead_nodes"], f"{tag}: nodes on dead instances: {r['dead_nodes'][:5]}")
        check(r["gc"] == {"orphans": [], "ghosts": []}, f"{tag}: gc collected {r['gc']}")
        check(not r["over_capacity"], f"{tag}: nodes over capacity: {r['over_capacity'][:5]}")
    for i, r in enumerate(runs):
        tag = f"{name}: run {i}"
        dense = [n for n in r["notices"] if n["route"] == "dense"]
        check(any(n["launches"]["warm_fill_counts"] for n in dense), f"{tag}: no dense re-solve through K2")
        check(any(n["launches"]["bucket_type_cost"] for n in dense), f"{tag}: no dense re-solve through K1")
        check(sum(n["launches"]["bucket_type_cost"] for n in r["notices"]) == r["wave_launches"]["bucket_type_cost"], f"{tag}: K1 launched outside the re-solves")
        for n in r["notices"]:
            for kernel in ("bucket_type_cost", "warm_fill_counts"):
                held = [h for h in n["held"] if h["kernel"] == kernel]
                check(len(held) == n["launches"][kernel], f"{tag}: {len(held)} {kernel} calls held for {n['launches'][kernel]} launches")
                check(all(h["identical"] for h in held), f"{tag}: {kernel} differs from its plain version on its own operands: {held}")
            check(all(a["allowed_rebuilt"] for a in n["k1_allowed"]), f"{tag}: K1's allowed could not be rebuilt from the captured mask")
        for kernel in ("bucket_type_cost", "warm_fill_counts"):
            held = [h for h in r["round_held"] if h["kernel"] == kernel]
            check(len(held) == r["round_launches"][kernel] and all(h["identical"] for h in held), f"{tag}: the round's {kernel} calls {held}")
    for i, r in enumerate(plain):
        check(not any(r["wave_launches"].values()) and not any(r["round_launches"].values()), f"{name}: the plain versions' run {i} launched kernels")
    check(line["plain_run"]["outcomes_identical"], f"{name}: the kernels' and the plain versions' waves differ in outcome")
    return line


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def probe_status(port: int, path: str) -> int:
    """The HTTP status of one probe, 0 while nothing answers."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=2) as resp:
            return resp.status
    except urllib.error.HTTPError as err:
        return err.code
    except OSError:
        return 0


def runtime_boot(card_name, command=None) -> dict:
    """The controller process on the card: `python -m
    karpenter_tpu_torch.cmd.controller` (or `command`) as a child with a
    free health-probe port; /healthz and /readyz polled until both answer
    200; the crossover the Runtime measured at boot (K1's probe round trip)
    read from the child's log with the device its solver runs on; then
    SIGTERM, and exit code 0 required. The child is killed on any failure."""
    import re
    import signal

    port = free_port()
    argv = list(command or CONTROLLER_COMMAND) + ["--health-probe-port", str(port), "--log-level", "info"]
    lines: list = []
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
    reader.start()
    ready_ms = shutdown_ms = None
    try:
        deadline = t0 + BOOT_DEADLINE_S
        while time.perf_counter() < deadline and proc.poll() is None:
            if probe_status(port, "/healthz") == 200 and probe_status(port, "/readyz") == 200:
                ready_ms = (time.perf_counter() - t0) * 1e3
                break
            time.sleep(0.05)
        if ready_ms is not None:
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=SHUTDOWN_DEADLINE_S)
                shutdown_ms = (time.perf_counter() - t1) * 1e3
            except subprocess.TimeoutExpired:
                pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    log = "".join(lines)
    crossover_line = re.search(r"dispatch rt ([0-9.]+) ms -> min_batch (\d+)", log)
    device = re.search(r"dense_solver=(\S+)", log)
    line = {
        "phase": "runtime_boot",
        "card": card_name,
        "command": argv,
        "boot_to_ready_ms": ready_ms,
        "probe_round_trip_ms": float(crossover_line.group(1)) if crossover_line else None,
        "min_batch": int(crossover_line.group(2)) if crossover_line else None,
        "solver_device": device.group(1) if device else None,
        "shutdown_ms": shutdown_ms,
        "exit_code": proc.returncode,
        "log_tail": log.splitlines()[-12:],
        "note": "K1's probe ran in the child, whose launch counts this process cannot read; the Runtime logs "
        "its solver's device, and on a CUDA device the wrapper launches the kernel or raises",
    }
    emit(line)
    check(ready_ms is not None, f"runtime_boot: the probes did not both answer 200 within {BOOT_DEADLINE_S} s (exit {proc.returncode})")
    check(crossover_line is not None, "runtime_boot: the child logged no measured crossover")
    check(device is not None and device.group(1).startswith("cuda"), f"runtime_boot: the Runtime's solver ran on {line['solver_device']}")
    check(shutdown_ms is not None and proc.returncode == 0, f"runtime_boot: exit code {proc.returncode} after SIGTERM")
    return line


def runtime_store(pods_n: int, standing: int, tag: str):
    """The in-memory store of the Runtime cells: `standing` 16-CPU nodes
    (testing.standing_cluster), the default provisioner; and the batch,
    build_workload(pods_n) named by `tag`, to be created in it."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.kube.cluster import KubeCluster

    kube = KubeCluster()
    testing.standing_cluster(kube, standing)
    kube.create(testing.make_provisioner())
    return kube, testing.rename(testing.build_workload(pods_n), tag)


def watch_placements(provisioner, sink: list, ends: list) -> None:
    """Wrap the provisioner's launch_nodes so each call's (node name, pods)
    placements (its `placed` list: launched nodes and nominations onto
    standing ones) land in `sink` too, with the instant the call returned in
    `ends`."""
    launch_nodes = provisioner.launch_nodes

    def watched(results, ice_failures=None, placed=None):
        mine = [] if placed is None else placed
        n0 = len(mine)
        launched = launch_nodes(results, ice_failures=ice_failures, placed=mine)
        sink.extend(mine[n0:])
        ends.append(time.perf_counter())
        return launched

    provisioner.launch_nodes = watched


def runtime_outcome(kube, placed, prices) -> dict:
    """What a Runtime's rounds placed, by node: a launched node (one the
    fake provider created) by its instance type, zone and capacity type, a
    standing node by name, each with its sorted pod names; and the
    launched nodes' $/hour."""
    from karpenter_tpu_torch.api import labels as lbl

    launched, standing, price = [], [], 0.0
    for name, pods in placed:
        node = kube.get_node(name)
        names = tuple(sorted(p.name for p in pods))
        if not node.spec.provider_id:
            standing.append((name, names))
        else:
            labels = node.metadata.labels
            launched.append((labels[lbl.LABEL_INSTANCE_TYPE], labels[lbl.LABEL_TOPOLOGY_ZONE], labels[lbl.LABEL_CAPACITY_TYPE], names))
            price += prices[labels[lbl.LABEL_INSTANCE_TYPE]]
    return {"launched": sorted(launched), "standing": sorted(standing), "price_per_hour": price}


def runtime_provision_once(dev, min_batch: int, plain: bool) -> dict:
    """A fresh Runtime (leader election off, the dense solver at
    `min_batch`) on a fresh store of the runtime cell's contents, driven by
    one synchronous provision_once(); with plain=True both kernels' plain
    versions stand in at the solve's seams. Its launches, placements and
    $/hour."""
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module
    from karpenter_tpu_torch.utils.options import parse

    _name, pods_n, standing = RUNTIME_ROUND
    kube, pods = runtime_store(pods_n, standing, "rto")
    catalog = instance_types(HEADLINE_TYPES)
    options = parse(["--no-leader-elect", "--dense-min-batch", str(min_batch)])
    rt = Runtime(kube=kube, cloud_provider=FakeCloudProvider(catalog), options=options, device=dev)
    placed, ends = [], []
    watch_placements(rt.provisioner, placed, ends)
    for pod in pods:
        kube.create(pod)
    saved = dense_module.bucket_cost_packed, fill_module.admission_counts
    if plain:
        dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
    try:
        read_launches()
        t0 = time.perf_counter()
        rt.provision_once()
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
    finally:
        dense_module.bucket_cost_packed, fill_module.admission_counts = saved
        rt.stop()
    got = runtime_outcome(kube, placed, {it.name(): it.price() for it in catalog})
    return {"wall_ms": wall, "launches": launches, "nominated": sum(len(p) for _n, p in placed), **got}


def runtime_round(dev, card_name) -> dict:
    """The headline batch through a running Runtime's threads: Options from
    parse() with the reference's defaults (leader election on, the
    crossover measured at boot, batch windows 1 s idle / 10 s max),
    FakeCloudProvider(instance_types(HEADLINE_TYPES)), a store holding the
    provisioner and 300 standing nodes. start() returns once the Runtime is
    elected and recovered; then the batch is created and the phase waits
    until every pod is nominated and the lifecycle and disruption loops have
    passed at least once. Every K1 and K2 call in the window is captured
    and held bit for bit against its plain version; no node may end over
    capacity; after stop() every thread is joined and the Lease released.
    Then two fresh Runtimes at the measured min_batch, one with the kernels
    and one with the plain versions, each run one provision_once() and must
    place identically."""
    from types import SimpleNamespace

    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module
    from karpenter_tpu_torch.utils.options import parse

    name, pods_n, standing = RUNTIME_ROUND
    kube, pods = runtime_store(pods_n, standing, "rt")
    catalog = instance_types(HEADLINE_TYPES)
    options = parse(["--dense-min-batch", "0"])
    t_boot = time.perf_counter()
    rt = Runtime(kube=kube, cloud_provider=FakeCloudProvider(catalog), options=options, device=dev)
    construct_ms = (time.perf_counter() - t_boot) * 1e3
    min_batch = rt.dense_solver.min_batch
    env = SimpleNamespace(controller=rt.provisioner, solver=rt.dense_solver, kube=kube, cluster=rt.cluster)
    rec = instrument(env, dev)
    placed, ends, captures = [], [], []
    watch_placements(rt.provisioner, placed, ends)
    names = {p.name for p in pods}
    seams = dense_module.bucket_cost_packed, fill_module.admission_counts
    capture_kernel_calls(captures)
    stopped = False
    try:
        t_start = time.perf_counter()
        rt.start()
        start_ms = (time.perf_counter() - t_start) * 1e3
        recovered = dict(rt.passes)
        read_launches()
        t0 = time.perf_counter()
        for pod in pods:
            kube.create(pod)
        created = time.perf_counter()
        deadline = created + RUNTIME_DEADLINE_S
        nominated = set()
        while time.perf_counter() < deadline and rt.healthy():
            nominated = {p.name for _n, pod_list in list(placed) for p in pod_list}
            if names <= nominated:
                break
            time.sleep(0.02)
        done = max(ends) if ends else time.perf_counter()
        loop_deadline = time.perf_counter() + LOOP_PASS_DEADLINE_S
        while time.perf_counter() < loop_deadline and rt.healthy() and not (rt.passes.get("node", 0) >= 1 and rt.passes.get("disruption", 0) >= 1):
            time.sleep(0.05)
        sync(dev)
        launches = read_launches()
        passes = dict(rt.passes)
        healthy = rt.healthy()
        by_node = {}
        for node_name, pod_list in placed:
            by_node.setdefault(node_name, set()).update(p.name for p in pod_list)
        broken = broken_placements(env, by_node)
        t_stop = time.perf_counter()
        stopped = True
        rt.stop()  # re-raises what ended a loop, if anything did
        stop_ms = (time.perf_counter() - t_stop) * 1e3
    finally:
        dense_module.bucket_cost_packed, fill_module.admission_counts = seams
        if not stopped:
            rt.stop()
    alive = [t.name for t in rt.threads() if t.is_alive()]
    lease = kube.get("Lease", rt.elector.name, rt.elector.namespace)
    released = lease is not None and lease.spec.holder_identity == rt.elector.identity and lease.spec.renew_time == 0.0
    holds = hold_kernel_calls(captures, dev)
    got = runtime_outcome(kube, placed, {it.name(): it.price() for it in catalog})
    disruption = rt.disruption.commands._counts
    kernel_run = runtime_provision_once(dev, min_batch, plain=False)
    plain_run = runtime_provision_once(dev, min_batch, plain=True)
    same = {k: kernel_run[k] == plain_run[k] for k in ("launched", "standing", "price_per_hour", "nominated")}
    schedules = rec["schedule"]
    line = {
        "phase": "runtime_round",
        "config": name,
        "card": card_name,
        "pods": pods_n,
        "standing_nodes": standing,
        "types": HEADLINE_TYPES,
        "min_batch": min_batch,
        "batch_idle_s": options.batch_idle_duration,
        "batch_max_s": options.batch_max_duration,
        "construct_ms": construct_ms,
        "start_ms": start_ms,
        "create_ms": (created - t0) * 1e3,
        "pods_to_last_nomination_ms": (done - t0) * 1e3,
        "stop_ms": stop_ms,
        "rounds": len(rec["get_pods_ms"]),
        "round_schedule_calls": len(schedules),
        "nominated": len(nominated & names),
        "nodes_launched": len(got["launched"]),
        "pods_nominated_onto_standing": sum(len(n[1]) for n in got["standing"]),
        "price_per_hour": got["price_per_hour"],
        "kernel_launches": launches,
        "phases_ms": schedules[0]["phases_ms"] if schedules else None,
        "schedule_ms": [s["wall_ms"] for s in schedules],
        "get_pods_ms": rec["get_pods_ms"],
        "launch": rec["launch"],
        "passes_after_start": recovered,
        "passes": passes,
        "disruption_commands": [[dict(k), v] for k, v in disruption.items()],
        "kernel_holds": holds,
        "broken": broken,
        "healthy": healthy,
        "threads_alive_after_stop": alive,
        "lease_released": released,
        "provision_once": {"kernels": kernel_run, "plain": plain_run, "identical": same},
    }
    line["provision_once"]["kernels"] = {k: kernel_run[k] for k in ("wall_ms", "launches", "nominated", "price_per_hour")}
    line["provision_once"]["plain"] = {k: plain_run[k] for k in ("wall_ms", "launches", "nominated", "price_per_hour")}
    emit(line)
    check(healthy, f"{name}: the Runtime turned unhealthy")
    check(recovered.get("gc", 0) >= 1, f"{name}: start() returned before the startup gc sweep ({recovered})")
    check(names <= nominated, f"{name}: {len(names - nominated)} of {pods_n} pods never nominated within {RUNTIME_DEADLINE_S} s")
    check(passes.get("node", 0) >= 1 and passes.get("disruption", 0) >= 1, f"{name}: the lifecycle and disruption loops did not both pass ({passes})")
    check(launches["bucket_type_cost"] >= 1 and launches["warm_fill_counts"] >= 1, f"{name}: the window launched {launches}")
    check(holds and all(h["identical"] for h in holds), f"{name}: a kernel call differs from its plain version: {[h for h in holds if not h['identical']]}")
    check(not any(broken.values()), f"{name}: the rounds broke placements: {broken}")
    check(not alive, f"{name}: threads alive after stop(): {alive}")
    check(released, f"{name}: the Lease was not released")
    check(kernel_run["launches"]["bucket_type_cost"] >= 1 and kernel_run["launches"]["warm_fill_counts"] >= 1, f"{name}: provision_once launched {kernel_run['launches']}")
    check(not any(plain_run["launches"].values()), f"{name}: the plain versions' provision_once launched {plain_run['launches']}")
    check(kernel_run["nominated"] == pods_n, f"{name}: provision_once nominated {kernel_run['nominated']} of {pods_n}")
    check(all(same.values()), f"{name}: the kernels' and the plain versions' provision_once differ: {same}")
    return line


def sidecar_plan(results) -> dict:
    """A launch plan by pod uid: each new node's instance types in price
    order and pods, the existing placements, the unschedulable pods and the
    new nodes' $/hour."""
    new = sorted(
        (tuple(it.name() for it in sorted(n.instance_type_options, key=lambda t: t.price())), tuple(sorted(p.uid for p in n.pods)))
        for n in results.new_nodes
        if n.pods
    )
    return {
        "new_nodes": new,
        "existing": sorted((v.node.name, tuple(sorted(p.uid for p in v.pods))) for v in results.existing_nodes if v.pods),
        "unschedulable": sorted(p.uid for p in results.unschedulable),
        "cost": sum(min(it.price() for it in n.instance_type_options) for n in results.new_nodes if n.pods),
    }


def solver_sidecar(dev, card_name) -> dict:
    """deploy/karpenter-tpu-sidecar.yaml's shape with the solve in the
    sidecar: the overflow round's request (the headline batch,
    instance_types(HEADLINE_TYPES), 300 standing-node wire snapshots, the
    cluster's pods and nodes) built by the client's build_request, pickled,
    handed to a SolverServer on the card (its own DenseSolver, min_batch 1)
    through schedule_bytes as serve()'s gRPC handler does, the response
    unpickled and materialized. A warm-up and SIDECAR_TRIALS timed remote
    solves, each launching K2 and K1 once, every call held bit for bit;
    the plan equal to the in-process ProvisionerController.schedule of the
    same batch on the same store at min_batch 1 and to a second server's
    running the plain versions. It imports no grpc: the handler gets the
    bytes serve() would hand it, in process."""
    import pickle

    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.scheduler.builder import apply_kubelet_max_pods
    from karpenter_tpu_torch.service.client import build_request, materialize
    from karpenter_tpu_torch.service.server import SolverServer
    from karpenter_tpu_torch.solver import DenseSolveStats
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    name, pods_n, standing = SIDECAR
    env = controller_env(dev, pods_n, standing, 1, "sc")
    create_pods(env)
    ctrl = env.controller
    pods = ctrl.get_pods()
    provisioners = [p for p in env.kube.list_provisioners()]
    instance_types = {p.name: apply_kubelet_max_pods(p, env.provider.get_instance_types(p)) for p in provisioners}

    def remote(server, captures=None):
        """One remote solve: (plan, record)."""
        server.dense_solver.stats = DenseSolveStats()
        state_nodes = env.cluster.nodes_snapshot()
        schedule = server.schedule
        solve_s = []

        def timed_schedule(request):
            t = time.perf_counter()
            try:
                return schedule(request)
            finally:
                sync(dev)
                solve_s.append(time.perf_counter() - t)

        server.schedule = timed_schedule
        seams = dense_module.bucket_cost_packed, fill_module.admission_counts
        if captures is not None:
            capture_kernel_calls(captures)
        try:
            read_launches()
            t0 = time.perf_counter()
            request = build_request(provisioners, instance_types, pods, ctrl.daemonset_pods(), state_nodes, env.kube)
            t1 = time.perf_counter()
            request_bytes = pickle.dumps(request)
            t2 = time.perf_counter()
            response_bytes = server.schedule_bytes(request_bytes)
            t3 = time.perf_counter()
            response = pickle.loads(response_bytes)
            t4 = time.perf_counter()
            results = materialize(response, provisioners, instance_types, pods, state_nodes)
            t5 = time.perf_counter()
            launches = read_launches()
        finally:
            dense_module.bucket_cost_packed, fill_module.admission_counts = seams
            del server.schedule
        stats = server.dense_solver.stats
        return sidecar_plan(results), {
            "wall_ms": (t5 - t0) * 1e3,
            "build_request_ms": (t1 - t0) * 1e3,
            "pickle_ms": ((t2 - t1) + (t4 - t3)) * 1e3,
            "server_ms": (t3 - t2) * 1e3,
            "server_solve_ms": solve_s[0] * 1e3,
            "server_unpickle_pickle_ms": ((t3 - t2) - solve_s[0]) * 1e3,
            "materialize_ms": (t5 - t4) * 1e3,
            "request_bytes": len(request_bytes),
            "response_bytes": len(response_bytes),
            "launches": launches,
            "phases_ms": {k: getattr(stats, f"{k}_seconds") * 1e3 for k in ("encode", "fill", "fill_device", "device", "mask", "assemble", "device_wait", "commit")},
            "error": response.error,
        }

    def local(batch=None):
        """The in-process schedule of the batch (or of `batch`, the same
        pods as other objects)."""
        ctrl.dense_solver.stats = DenseSolveStats()
        t0 = time.perf_counter()
        results = ctrl.schedule(batch or pods, env.cluster.nodes_snapshot())
        sync(dev)
        return sidecar_plan(results), (time.perf_counter() - t0) * 1e3

    server = SolverServer(device=dev)
    remote(server)  # warm-up: catalog upload, encodings
    captures = []
    runs = [remote(server, captures) for _ in range(SIDECAR_TRIALS)]
    holds = hold_kernel_calls(captures, dev)
    local()
    local_runs = [local() for _ in range(SIDECAR_TRIALS)]
    # the same pods as the server gets them: unpickled, so no requirement
    # or request the scheduler memoizes on a pod object is cached yet
    cold_runs = [local(pickle.loads(pickle.dumps(pods))) for _ in range(SIDECAR_TRIALS)]
    plain_server = SolverServer(device=dev)
    seams = dense_module.bucket_cost_packed, fill_module.admission_counts
    dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
    try:
        plain_plan, plain_rec = remote(plain_server)
    finally:
        dense_module.bucket_cost_packed, fill_module.admission_counts = seams
    plan = runs[-1][0]
    records = [r for _p, r in runs]
    same_runs = all(p == plan for p, _r in runs)
    same_local = all(p == plan for p, _ms in local_runs + cold_runs)
    same_plain = plain_plan == plan

    def median(key):
        return statistics.median(r[key] for r in records)

    line = {
        "phase": "solver_sidecar",
        "config": name,
        "card": card_name,
        "pods": pods_n,
        "standing_nodes": standing,
        "types": HEADLINE_TYPES,
        "min_batch": 1,
        "transport": "in-process pickle round trip (SolverServer.schedule_bytes, serve()'s gRPC handler)",
        "request_bytes": median("request_bytes"),
        "response_bytes": median("response_bytes"),
        "wall_ms": median("wall_ms"),
        "build_request_ms": median("build_request_ms"),
        "pickle_ms": median("pickle_ms"),
        "server_ms": median("server_ms"),
        "server_solve_ms": median("server_solve_ms"),
        "server_unpickle_pickle_ms": median("server_unpickle_pickle_ms"),
        "materialize_ms": median("materialize_ms"),
        "in_process_schedule_ms": statistics.median(ms for _p, ms in local_runs),
        "in_process_cold_pods_schedule_ms": statistics.median(ms for _p, ms in cold_runs),
        "phases_ms": records[-1]["phases_ms"],
        "runs": records,
        "in_process_schedule_ms_runs": [ms for _p, ms in local_runs],
        "in_process_cold_pods_schedule_ms_runs": [ms for _p, ms in cold_runs],
        "kernel_launches": {k: [r["launches"][k] for r in records] for k in ("bucket_type_cost", "warm_fill_counts")},
        "kernel_holds": holds,
        "new_nodes": len(plan["new_nodes"]),
        "pods_on_existing": sum(len(v[1]) for v in plan["existing"]),
        "unschedulable": len(plan["unschedulable"]),
        "cost": plan["cost"],
        "runs_identical": same_runs,
        "in_process_identical": same_local,
        "plain_server": {"launches": plain_rec["launches"], "server_solve_ms": plain_rec["server_solve_ms"], "identical": same_plain},
    }
    emit(line)
    check(not any(r["error"] for r in records), f"{name}: the server's solve failed: {records[-1]['error']}")
    for i, r in enumerate(records):
        check(r["launches"] == {"bucket_type_cost": 1, "warm_fill_counts": 1}, f"{name}: remote solve {i} launched {r['launches']}")
    check(len(holds) == 2 * SIDECAR_TRIALS and all(h["identical"] for h in holds), f"{name}: a kernel call differs from its plain version: {holds}")
    check(not plan["unschedulable"] and plan["existing"] and plan["new_nodes"], f"{name}: the plan is not the overflow's (existing and new nodes, none unschedulable)")
    check(same_runs and same_local, f"{name}: the remote plans differ from each other or from the in-process schedule")
    check(not any(plain_rec["launches"].values()), f"{name}: the plain versions' server launched {plain_rec['launches']}")
    check(same_plain, f"{name}: the plain versions' server planned differently")
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from karpenter_tpu_torch import logsetup, testing
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
        read_launches()
        runs = [solve(pods, provider, provisioners, solver, state_nodes) for _ in range(SOLVE_TRIALS)]
        launches = read_launches()
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
        read_launches()
        try:
            ms, results, _ = solve(pods, provider, provisioners, DenseSolver(min_batch=1), state_nodes)
        finally:
            dense_module.bucket_cost_packed, fill_module.admission_counts = saved
        launches = read_launches()
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

    # 11. the provisioning controller, routed by the crossover measured here:
    # the headline batch on a busy cluster, the capacity-failure ladder and
    # the threaded batch loop
    min_batch = crossover(dev, card_name)["min_batch"]
    controller_lines = [
        controller_round_overflow(dev, min_batch, card_name),
        controller_ice_resolve(dev, min_batch, card_name),
        controller_loop(dev, min_batch, card_name),
    ]

    def controller_launches(kernel_name):
        """Each controller phase's launches of one kernel (per timed round
        where a phase times several)."""
        return {line["config"]: line["kernel_launches"][kernel_name] for line in controller_lines}

    # 12. consolidation through the disruption orchestrator, at the same
    # routing: a scale-down by DELETE (K2 in each what-if) and a right-size
    # by REPLACE (K2, then K1 in each what-if)
    disruption_lines = [
        consolidation_delete(dev, min_batch, card_name),
        consolidation_replace(dev, min_batch, card_name),
    ]

    def disruption_launches(kernel_name):
        """Each consolidation phase's launches of one kernel over its timed
        passes, in the what-ifs and in the provisioning rounds."""
        return {
            line["config"]: {part: line["kernel_launches"][part][kernel_name] for part in ("what_if", "round")}
            for line in disruption_lines
        }

    # 12b. a spot reclaim wave through the interruption controller, at the
    # same routing: each notice's proactive re-solve (K2 onto the standing
    # nodes, K1 for the replacements) with the reclaimed pools quarantined,
    # the drain, the post-drain round and the gc sweep
    wave_line = interruption_reclaim_wave(dev, min_batch, card_name)

    # 12c. the controller process: the entry point booted as a child (the
    # crossover measured at boot, the probes, SIGTERM), the headline batch
    # through a running Runtime's threads, and the solve in the sidecar. The
    # Runtimes configure the port's log handler at info; later phases log
    # warnings only
    runtime_boot(card_name)
    runtime_line = runtime_round(dev, card_name)
    sidecar_line = solver_sidecar(dev, card_name)
    logsetup.set_level("warning")

    def runtime_launches(kernel_name):
        """The Runtime cell's launches of one kernel: in the threaded window
        and in the synchronous provision_once() (the boot's probe runs in
        the child process, whose counts are not readable here)."""
        return {
            "runtime_round": runtime_line["kernel_launches"][kernel_name],
            "provision_once": runtime_line["provision_once"]["kernels"]["launches"][kernel_name],
        }

    def interruption_launches(kernel_name):
        """The wave's launches of one kernel over its timed runs, in the
        re-solves and in the post-drain rounds."""
        return {part: wave_line["kernel_launches"][part][kernel_name] for part in ("wave", "round")}

    # 13. the launch floor: the device time of the smallest kernel PyTorch
    # launches (a fill of one element), in this run, on this card
    one = torch.zeros(1, device=dev)
    launch_floor_ms, floor_why = profiled_device_ms(one.zero_, KERNEL_ITERS)
    emit({"phase": "launch_floor", "op": "zero_() of a 1-element CUDA tensor", "device_ms": launch_floor_ms, "device_ms_missing": floor_why or None})
    check(launch_floor_ms is not None, f"no launch floor: {floor_why}")

    # 14. how each kernel's device time scales: K1 with the buckets (blocks)
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

    # 15. each kernel's time at its main path's shape beside its bound and
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
                "controller_launches": controller_launches("bucket_type_cost"),
                "disruption_launches": disruption_launches("bucket_type_cost"),
                "interruption_launches": interruption_launches("bucket_type_cost"),
                "runtime_launches": runtime_launches("bucket_type_cost"),
                "sidecar_launches": sidecar_line["kernel_launches"]["bucket_type_cost"],
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
                "controller_launches": controller_launches("warm_fill_counts"),
                "disruption_launches": disruption_launches("warm_fill_counts"),
                "interruption_launches": interruption_launches("warm_fill_counts"),
                "runtime_launches": runtime_launches("warm_fill_counts"),
                "sidecar_launches": sidecar_line["kernel_launches"]["warm_fill_counts"],
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

    # 16. the card
    print(card_name, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
