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
  - solver_mesh: the solver mesh (parallel/). K1's keyed launch, which
    also returns each bucket's winning key, held bit for bit against its
    plain version and the unkeyed launch; the sharded dispatch on 8 logical
    blocks of the card (pods 4 x types 2), bit-equal to one K1 launch on
    the headline solve's inputs, a padded shape, ties planted across the
    type blocks and rows with no feasible type; the headline solve through
    DenseSolver(mesh=...), with the unsharded solve's placements, node
    count and $/hour and every block's K1 call held, timed in turns with
    the unsharded solver; the same solve over that mesh with
    --solver-hbm-budget 1 (mesh_budget_case: two unkeyed K1 launches on the
    card's halves of the bucket axis, no keyed launch, the unsharded
    outcome, the mesh kept); the two-process fleet
    (parallel/peers.py) over gloo with both processes on the card; over
    NCCL, one card per process, where there are several cards;
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
  - incremental_residency: the engine serves the rows of the snapshot it
    was handed. bind_after_snapshot, on incremental_churn_2400's cluster
    and catalog with the auditor on every pass: on the cold pass and on a
    full pass forced with reason audit, the snapshot is taken first, then
    8 nodes are filled to their room and every pod of one more node is
    deleted through the kube store, then the solve; a clean pass follows
    each. Every pass must serve no row that differs from a fresh encode of
    its own views, keep the resident head equal to the mirror's f32 head,
    find no divergence, book no node beyond its room (the snapshot's bound
    pods and the pass's placements) and place as a fresh solver on the
    same snapshot and batch. ice_resolve_incremental, the headline's
    10,000 pods (reclaim_wave_workload's, whose placed pods carry no
    anti-affinity that would send a re-solve to the host loop) on 300
    standing nodes with every pool of every type a warm-up round launched
    refused, the provisioner's solver carrying the engine and the auditor:
    every re-solve that runs dense must bypass the engine, the round book
    no node beyond its room, nominations included, find no divergence and
    decide as the same round with no engine. Both cases run through the
    kernels, every K1 and K2 call held bit for bit, and again with the
    plain versions;
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
    1,200 standing 16-CPU nodes each running 72 ReplicaSet-owned pods
    (86,400 pods), where each pass's what-if fills one node's pods onto
    the other 1,199 (K2) and the orchestrator deletes and drains it;
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
    replacements, the quarantined pools zeros in K1's `allowed`), counting
    what the wave's earlier re-solves placed (the controller's ledger),
    launches the replacement and drains the victim; then one provisioning
    round for the recreated pods, the cloud's reclaim and the gc sweep. A
    warm-up and 3 timed waves on fresh fleets, held against 4 with the
    plain versions, then one more through the kernels with the notices
    split over 2 polls (MAX_MESSAGES 4 on the controller instance), whose
    outcome must be the one-poll wave's; in every wave no node is booked
    beyond its room (the pods bound at the start and every pod a notice
    placed on it against its allocatable less the daemonset overhead), and
    the line reports the bookings against the room, the replacements plus
    the post-drain launches and the end state's $/hour;
  - the controller process (runtime.py, cmd/controller.py, service/):
    runtime_boot starts `python -m karpenter_tpu_torch.cmd.controller` as a
    child, waits for /healthz and /readyz, then /metrics and /debug, reads
    the crossover its Runtime measured at boot with K1's probe on the card,
    requires exit code 0 on SIGTERM, and splits the boot: the runtime's
    import, the CUDA context and K1's probe, each in a fresh child;
    runtime_round creates the headline batch in a store with
    300 standing nodes under a started Runtime (leader election, the
    crossover measured, 1 s / 10 s batch windows) and waits until every pod
    is nominated by its batch loop and its lifecycle and disruption loops
    have passed; every K1 and K2 call in the window is held bit for bit,
    and two fresh Runtimes' provision_once() with the kernels and with the
    plain versions must place identically; runtime_round_traced runs the
    same cell with --enable-tracing, --enable-lock-witness and /metrics
    served (metrics.py, tracing.py, analysis/witness.py, the scrapers):
    the round's trace must link provision → batch → solve (encode, fill,
    device with mask and assemble, commit) → launch (every launch-node,
    bind), the decision records must equal the nominations, /metrics must
    answer with the telemetry's families, the witness must find no
    lock-order cycle, and the outcome must equal the untraced round's;
    runtime_round_recorded runs it with the recorders on (flight.py,
    journal.py, slo.py with the SLO scraper, capsule.py, profiling.py,
    invariants.py, kube/coherence.py: --enable-solver-telemetry,
    --enable-journal, --enable-capsules, --enable-slo, --enable-profiling,
    --invariants-interval, --coherence-interval, /metrics served), binds
    the batch, and holds one flight record per dense solve (its phases, a
    cuda dispatch, a device-memory peak from torch.cuda.memory_stats, no
    kernel build), every batch pod's six journal transitions, the
    waterfall's and the SLO's 10,000 pending durations, a clean invariant
    monitor and coherence witness, no capsule, and the outcome of the plain
    round; then the SLO scraper's compute_drift, the ideal repack of every
    bound pod as a cold dense solve through K1 (its K1 call held, its ideal
    cost equal to the plain versions'), a device trace of
    /debug/pprof/trace and of maybe_profile_round naming both kernels, and
    a planted device-corrupt divergence in the incremental engine's
    resident head that fires exactly one residency-divergence capsule,
    read back by `python -m karpenter_tpu_torch.cmd.capsule inspect`;
    runtime_round_faulted (solver/faults.py) classifies four real faults
    on the card (an allocation past the free memory, a device-side assert
    in a child process, nvcc on a broken source, K1's shim given an
    argument it rejects), then runs the same cell with the breaker at
    threshold 3 and an injected device-lost plan at K1's "cuda" seam: three
    rounds raise typed, the breaker opens (one breaker-open capsule, read
    back), a round while it is open launches nothing and leaves every pod
    pending, and after the backoff the recovery probe places the batch as
    runtime_round did; then the cell with no plan, with a budget split
    (--solver-hbm-budget 1: two K1 launches, bit-equal to one), the three
    corruptions injected by plans (each found once and healed) and a mixed
    plan's history twice, identical;
    solver_sidecar hands the
    overflow round's request, pickled as serve()'s gRPC handler takes it,
    to a SolverServer on the card (K2, then K1) and holds the plan equal to
    the in-process schedule and to a plain-versions server's, then sends
    the same request over a gRPC loopback (service.server.serve() and
    service.client.SolverClient) and holds that plan and its kernel calls
    the same way;
  - the wire (kube/apiserver.py, kube/client.py, kube/codec.py), at the
    headline's full width: runtime_round_http runs runtime_round's cell,
    10,000 pods on 300 standing nodes x 500 types, with the Runtime on an
    HttpKubeClient (built by cmd/controller.build_kube_backend for
    --apiserver-url, 200 QPS / 300 burst) against an APIServer on
    127.0.0.1 in a child process, the standing nodes and the batch written
    in that process as other clients' writes; its LIST, watch delivery and
    node POSTs are measured, every K1/K2 call held, and the outcome must
    equal a provision_once() on an in-memory store of the same shape;
    controller_process_http boots the entry point
    (karpenter_tpu_torch.cmd.controller, run as `python -m` runs it, under
    WIRE_COUNTED_CONTROLLER, which counts its client's requests) with
    --apiserver-url as a child against an apiserver process, writes the
    headline's 10,000 pods onto the empty cluster, times the first pod to
    the last Node the child POSTs, holds the node types against an
    in-process solve (kernels and plain versions), and requires the Lease
    released and exit code 0 on SIGTERM. In both, the client's one shared
    informer per kind feeds the round's topology reads (ROADMAP C2): the
    provisioner thread sends at most 2 Pod LISTs a round (get_pods and the
    cluster-sync check), none from the topology, and the server holds one
    Pod and one Node watch stream of the client;
  - controller_restart_device_lost (ROADMAP C7): two controller processes
    in turn against an apiserver process. A real device-side assert on the
    card in the first one's K1 call ends its batch loop; it must exit
    non-zero without hanging, having POSTed no Node and released its
    Lease, and the successor, started as it exits, must win the Lease,
    build no kernel and place every pod as the in-process solve does (each
    K1/K2 call of that solve held). Case `empty`: the entry point itself,
    2,000 pods on an empty cluster. Case `standing`: Runtimes on the
    simulated cloud, served here over its cloud API, 2,000 pods placed and
    bound, then 1,000 that overflow them (K2, then K1 faults); the
    successor's recovery sweep must find no ghost and no orphan. Measured:
    fault to exit, exit to ready, the Lease wait, fault to the last
    nomination and to the last Node;
  - analysis_contracts: `python -m karpenter_tpu_torch.cmd.analyze
    --contracts --check --device cuda` as a child (exit 0), then every
    registered device entry of analysis/contracts.py traced on the card at
    both grid points: its dtype, in-place, promotion, host-constant and
    library facts equal to the committed contract (written from the CPU),
    no kernel build, and K1's, keyed K1's and K2's outputs bit-equal to
    their plain versions on the same inputs; per entry the host->device
    bytes and builds of each call;
  - cost_regret: tests/test_cost_regret.py's six instances
    (testing.cost_regret_cases), each solved by the exhaustive MILP
    (solver/optimal.py, HiGHS), by the dense path on the card
    (DenseSolver(min_batch=1), K1, every call held bit for bit) and by the
    exact host loop, at the reference's gates: dense within 3% of the
    optimum, the host loop within 25%, neither below it; the
    mixed-constraints instance, outside the MILP's model, dense within 3%
    of the host loop.

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
path's shape beside its bound. It prints one JSON object per phase, then
the script's wall time and the card's name and power limit, each on a line
of its own. chip_sweep.py holds the measurements that chose the kernels'
launch geometries and K2's round trip. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed phase exits non-zero. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SCRIPT_T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
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
# incremental_residency: bind_after_snapshot on incremental_churn_2400's
# cluster and catalog, RESIDENCY_FILLED nodes filled after each planted
# snapshot; ice_resolve_incremental on controller_round_overflow's shape
RESIDENCY_NODES, RESIDENCY_TYPES, RESIDENCY_FILLED = 2400, 100, 8
HEADLINE_PODS, HEADLINE_TYPES = 10_000, 500
RESIDENCY_ICE = ("ice_resolve_incremental", HEADLINE_PODS, 300)
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
# nodes of 16 CPU / 32Gi / 110 pods (build_repack_state's fake-it-15). The
# delete cell runs 1,200 of its 2,000 nodes: with the wire at the
# headline's width the script took 1057.75 s of its 1200 s limit on an
# NVIDIA H100 80GB HBM3 (700.00 W) machine, this cell 169.4 s of it, most
# of that its two stores of 144,000 pods (70.23 s to build the kernel
# run's); 1,200 nodes (86,400 pods) take about 68 s off, which brings that
# run under 950 s
CONSOLIDATION_DELETE = ("consolidation_delete", 1200, 72)
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
# the split-poll wave: MAX_MESSAGES on the controller instance, so the 8
# notices arrive in 2 polls with no provisioning round between them
WAVE_SPLIT_MESSAGES = 4
# the nomination window: on the wave's fleet, one round nominates a second
# batch (testing.reclaim_wave_workload(2000, seed=43)) and leaves it
# unbound while the wave's 8 notices arrive in one poll, as they do in a
# Runtime with --interruption-queue whose notices come while a round's pods
# wait to bind
WINDOW = ("nomination_window", 2000, 43)
# the controller process: the entry point's command, how long it may take
# to answer both probes and to exit on SIGTERM; the Runtime cell's standing
# nodes (controller_round_overflow's shape) and its deadlines; the sidecar
# cell's standing nodes and its timed solves after a warm-up
CONTROLLER_COMMAND = [sys.executable, "-m", "karpenter_tpu_torch.cmd.controller"]
BOOT_DEADLINE_S = 180.0
SHUTDOWN_DEADLINE_S = 60.0
RUNTIME_ROUND = ("runtime_round", HEADLINE_PODS, 300)
RUNTIME_ROUND_TRACED = ("runtime_round_traced", HEADLINE_PODS, 300)
RUNTIME_DEADLINE_S = 120.0
# the recorders (PR 13): runtime_round's cell with every recorder on
RUNTIME_ROUND_RECORDED = ("runtime_round_recorded", HEADLINE_PODS, 300)
RECORDED_INTERVAL_S = 1.0  # the invariant monitor's and the coherence witness's
RECORDED_JOURNAL_RING = 131072  # every batch pod's six transitions and the nodes'
RECORDED_POD_EVENTS = ("created", "queued", "batch-admitted", "solved", "nominated", "bound")
RECORDED_DEBUG_ROUTES = (
    "/debug", "/debug/solver", "/debug/journal", "/debug/waterfall", "/debug/slo", "/debug/capsules",
    "/debug/invariants", "/debug/coherence", "/debug/pprof/",
)
# the families of the recorders' modules (flight, journal, capsule, slo,
# invariants, kube/coherence)
RECORDER_FAMILIES = (
    "karpenter_jax_compilations_total", "karpenter_jax_compile_seconds_total", "karpenter_solver_hbm_peak_bytes",
    "karpenter_solver_hbm_live_bytes", "karpenter_flight_records_stored", "karpenter_flight_records_dropped",
    "karpenter_solver_solve_duration_seconds", "karpenter_journal_events_total", "karpenter_journal_events_stored",
    "karpenter_journal_events_dropped", "karpenter_journal_spool_rotations_total", "karpenter_waterfall_segment_seconds",
    "karpenter_capsule_captures_total", "karpenter_capsule_suppressed_total", "karpenter_capsule_spool_evictions_total",
    "karpenter_capsule_spool_bytes", "karpenter_slo_burn_rate", "karpenter_slo_pod_pending_duration_seconds",
    "karpenter_slo_node_ready_duration_seconds", "karpenter_slo_pending_pods", "karpenter_slo_cluster_cost_per_hour",
    "karpenter_slo_ideal_cost_per_hour", "karpenter_slo_cost_drift_ratio", "karpenter_slo_nodes_churned_total",
    "karpenter_slo_pods_displaced_total", "karpenter_invariant_violations_total", "karpenter_invariant_samples_total",
    "karpenter_invariant_leaked_threads", "karpenter_invariant_leaked_watches", "karpenter_informer_divergences_total",
    "karpenter_coherence_checks_total",
)
KERNEL_SYMBOLS = ("bucket_cost_kernel", "warm_fill_kernel")  # K1's and K2's __global__ names
PROFILED_ROUND = (2000, 30)  # pods, standing nodes: K2 fills the nodes, K1 prices the rest
PROFILE_TRACE_S = 1
PROFILER_START_S = 30.0
PLANTED = (300, 9500)  # standing nodes, churn seed
# recorded_profiling in a fresh process of its own: a metrics listener with
# --enable-profiling's routes, then the two traced rounds; prints one JSON
# object (argv: device, profile directory, min_batch)
PROFILING_CHILD = r"""
import json, os, sys, torch
import chip_smoke
from karpenter_tpu_torch.cmd.controller import debug_routes
from karpenter_tpu_torch.observability import ObservabilityServer
from karpenter_tpu_torch.profiling import ENV_DIR
from karpenter_tpu_torch.utils.options import parse

device, profile_dir, min_batch = torch.device(sys.argv[1]), sys.argv[2], int(sys.argv[3])
os.environ[ENV_DIR] = profile_dir
port = chip_smoke.free_port()
options = parse(["--enable-profiling", "--metrics-port", str(port)])
obs = ObservabilityServer(
    healthy=lambda: True, ready=lambda: True, health_port=None, metrics_port=port, host="127.0.0.1",
    extra_routes=debug_routes(options),
)
obs.start()
try:
    out = chip_smoke.recorded_profiling(device, port, profile_dir, min_batch)
finally:
    obs.stop()
print(json.dumps(out))
"""
PROFILING_CHILD_TIMEOUT_S = 600.0
LOOP_PASS_DEADLINE_S = 10.0
RUNTIME_ROUND_FAULTED = ("runtime_round_faulted", HEADLINE_PODS, 300)
FAULTED_THRESHOLD = 3  # the breaker opens on the third consecutive fault
FAULTED_BACKOFF_S = 8.0  # long enough for the open breaker's checks, waited out by the phase
FAULTED_JOURNAL_RING = 262144  # every pod's transitions over the faulted and recovered rounds
FAULTED_OPEN_DEADLINE_S = 120.0
FAULTED_NO_PLAN_RUNS = 2
CAPSULE_SPOOL_WAIT_S = 10.0  # a capsule another thread's poll is still writing
# the injected corruption kinds, their state seams and the audit finding each must give
CORRUPTIONS = (
    ("corrupt-device", "rebase", "device-corrupt"),
    ("corrupt-row", "resident-row", "row-drift"),
    ("suppress-delta", "journal-record", "missed-delta"),
)
CORRUPTION_NODES = 300
# the determinism run: a mixed plan (seed 11) over a small warm cluster that
# the batch overflows, so each solve consults the warm fill's seam and K1's
FAULT_HISTORY_SPECS = (
    {"kind": "hbm", "entry": "plain", "nth": 2},
    {"kind": "kernel", "entry": "warmfill", "probability": 0.5},
    {"kind": "device-lost", "entry": "cuda", "nth": 4},
)
FAULT_HISTORY_STEPS, FAULT_HISTORY_NODES, FAULT_HISTORY_PODS = 6, 10, 300
# a child process whose CUDA context a device-side assert breaks: it prints
# the kind classify() gives the error
DEVICE_LOST_CHILD = r"""
import json
import torch
from karpenter_tpu_torch.solver.faults import classify
x = torch.zeros(8, device="cuda")
try:
    y = x[torch.tensor([1 << 20], device="cuda")]
    torch.cuda.synchronize()
    print(json.dumps({"kind": None, "error": "the out-of-range index raised nothing"}))
except Exception as exc:
    fault = classify(exc)
    print(json.dumps({"kind": fault.kind if fault is not None else None, "type": type(exc).__name__, "error": str(exc)[:240]}), flush=True)
"""
# a child process whose Runtime's batch loop meets a device-side assert
# inside the bucket choice (K1's wrapper, wrapped to index out of range on
# the card first): a device-lost the card raised ends the loop
# (solver/faults.py ends_the_loop), so healthy() turns false and a restart
# gets a fresh context; the pods stay pending. It prints what it saw.
DEVICE_LOST_RUNTIME_CHILD = r"""
import json, os, time
import torch
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.kube.cluster import KubeCluster
from karpenter_tpu_torch.runtime import Runtime
from karpenter_tpu_torch.solver import dense
from karpenter_tpu_torch.solver.faults import BREAKER
from karpenter_tpu_torch.utils.options import parse

launch = dense.bucket_cost_packed

def asserting(stats, caps, prices, allowed):
    probe = torch.zeros(8, device=stats.device)
    probe[torch.tensor([1 << 20], device=stats.device)].sum().item()
    return launch(stats, caps, prices, allowed)

dense.bucket_cost_packed = asserting
kube = KubeCluster()
kube.create(testing.make_provisioner())
rt = Runtime(kube=kube, cloud_provider=FakeCloudProvider(instance_types(30)), options=parse(["--dense-min-batch", "1"]), device="cuda")
rt.start()
for i in range(40):
    kube.create(testing.make_pod(name=f"lost-{i:02d}", requests={"cpu": "1"}))
deadline = time.monotonic() + 120
while time.monotonic() < deadline and rt.healthy():
    time.sleep(0.05)
err = rt.error
print(json.dumps({
    "healthy": rt.healthy(), "error": type(err).__name__ if err is not None else None,
    "kind": getattr(err, "kind", None), "injected": getattr(err, "injected", None),
    "loop_alive": bool(rt.provisioner.thread is not None and rt.provisioner.thread.is_alive()),
    "pending": len(kube.pending_pods()), "nodes": len(kube.list_nodes()), "breaker": BREAKER.state,
    "message": str(err)[:240],
}), flush=True)
os._exit(0)
"""
DEVICE_LOST_TIMEOUT_S = 180.0
SIDECAR = ("solver_sidecar", HEADLINE_PODS, 300)
SIDECAR_TRIALS = 3
GRPC_TIMEOUT_S = 300.0
# the wire (kube/apiserver.py, kube/client.py): runtime_round's cell over
# HTTP, and a fresh controller process against an apiserver on an empty
# cluster, both at the headline's depth: the topology reads the client's
# informer cache, so no LIST grows with pods x groups; each is held against
# an in-memory run of its own shape
RUNTIME_ROUND_HTTP = ("runtime_round_http", HEADLINE_PODS, 300)
CONTROLLER_PROCESS_HTTP = ("controller_process_http", HEADLINE_PODS)
# Pod LISTs the provisioner thread may send a round: get_pods and the
# cluster-sync check (Cluster.synchronized)
PROVISIONER_POD_LISTS_PER_ROUND = 2
# how long the Node informer's store may take to hold every node the server
# holds once the round is over (the stream decodes; no handler delays it)
NODE_STORE_WAIT_S = 10.0
# the kube fault domain (kube/chaos.py) on runtime_round's cell: conflicts
# on the batch's binds (pod updates) and one stale read; the watch gap, its
# compaction and the lease steal are the phase's actions
RUNTIME_ROUND_KUBE_CHAOS = ("runtime_round_kube_chaos", HEADLINE_PODS, 300)
KUBE_CHAOS_SPECS = (
    {"fault": "conflict", "verb": "update", "obj_kind": "Pod", "nth": 5, "count": 3},
    {"fault": "conflict", "verb": "update", "obj_kind": "Pod", "nth": 4000, "count": 2},
    {"fault": "stale-read", "verb": "get", "obj_kind": "Pod", "nth": 7, "count": 1},
)
KUBE_CHAOS_SEED = 16
KUBE_CHAOS_LEASE = ("3.0", "0.5")  # --lease-duration, --lease-renew-period: a stolen lease expires in the phase
KUBE_CHAOS_JOURNAL_RING = 131072
KUBE_CHAOS_DEADLINE_S = 60.0
# the scenario campaign (scenarios/): (scenario, transports); every run's
# Runtime on the dense path, so K1 and K2 carry each batch
SCENARIO_RUNS = (("smoke_burst", ("inprocess", "http")), ("device_fault_storm", ("inprocess",)), ("watch_gap_storm", ("inprocess",)))
SCENARIO_ZERO_SCORES = (
    "lost_pods", "budget_violations", "leaked_instances", "double_launches", "informer_divergences",
    "invariant_violations", "leaked_threads", "leaked_watches",
)
# the solver mesh (parallel/): 8 logical blocks on the one card, pods 4 x
# types 2; the sharded dispatch's checks at (B, T, R[, kind]); the fleet of
# two processes over gloo sharing the card (NCCL refuses two ranks on one
# GPU), parallel/peers.py's demo shape
MESH_BLOCKS, MESH_TYPES_PARALLEL = 8, 2
MESH_SHAPES = [(30, 500, 8), (29, 501, 8), (30, 500, 8, "cross_block_ties"), (30, 500, 8, "all_infeasible")]
MESH_DISPATCH_ITERS = 50
FLEET = {"n_processes": 2, "devices_per_process": 4, "pod_count": 48, "solves": 3}
FLEET_TIMEOUT_S = 300.0
# cmd/solver_service.py --coordinator on the card: two processes over gloo,
# 4 logical blocks each, serving the headline batch over gRPC
SERVICE_FLEET = {"n_processes": 2, "devices_per_process": 4, "backend": "gloo"}
SERVICE_TRIALS = 3
SERVICE_BOOT_S, SERVICE_STOP_S = 180.0, 60.0
HTTP_ROUND_DEADLINE_S = 180.0
NODES_SETTLE_S = 3.0
THREAD_JOIN_DEADLINE_S = 60.0
# a child's log line at info level ("I12:34:56 ..."); controller_process_http
# keeps the others (at most LOG_PROBLEMS_KEPT) in its line
INFO_LINE = re.compile(r"I\d\d:\d\d:\d\d ")
LOG_PROBLEMS_KEPT = 80
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (`at_s`), so the lines split the script's wall."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - SCRIPT_T0}
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


def overbooked_nodes(snapshot, results) -> list:
    """The nodes whose bound pods, as the solve's snapshot has them, and the
    pods the solve placed on them together request more than the node has,
    in any resource."""
    from karpenter_tpu_torch.utils import resources as res

    by_name = {state.name: state for state in snapshot}
    over = []
    for view in results.existing_nodes:
        free = dict(by_name[view.node.name].available)
        for pod in view.pods:
            free = res.subtract(free, res.pod_requests(pod))
        if any(v < -1e-6 for v in free.values()):
            over.append(view.node.name)
    return sorted(over)


def served_stale_rows(views, enc) -> list:
    """The rows of an encoding the engine served that differ, byte for byte
    in any encoded field, from a fresh encode_warm_views of the same views."""
    from karpenter_tpu_torch.ir.encode import encode_warm_views

    fresh = encode_warm_views(views)
    stale = []
    for i, view in enumerate(views):
        arrays = all(getattr(fresh, f)[i].tobytes() == getattr(enc, f)[i].tobytes() for f in ("usable", "avail_tol", "requests0", "head0"))
        labels = (fresh.zone[i], fresh.ct[i], fresh.hostname[i], tuple(fresh.taint_sig[i])) == (enc.zone[i], enc.ct[i], enc.hostname[i], tuple(enc.taint_sig[i]))
        if not (arrays and labels):
            stale.append(view.node.name)
    return stale


def watch_engine(engine, served: list) -> None:
    """Wrap the engine's advance: each pass appends its kind, reason and
    dirty rows, the rows it served that a fresh encode of its own views
    disagrees with, and whether the resident head's first V rows equal the
    mirror's f32 head, byte for byte (None where the pass served none)."""
    advance = engine.advance

    def watched(views, *args):
        adv = advance(views, *args)
        rec = {"pass": adv.kind, "reason": adv.reason, "dirty_rows": adv.dirty_rows, "stale_rows": None, "head_dev_equal": None}
        if adv.enc is not None:
            rec["stale_rows"] = served_stale_rows(views, adv.enc)
            head = adv.enc.head_dev[: len(views)].cpu().numpy()
            rec["head_dev_equal"] = head.tobytes() == adv.enc.head0.astype(np.float32).tobytes()
        served.append(rec)
        return adv

    engine.advance = watched


def held_summary(held) -> dict:
    """hold_kernel_calls' list as counts per kernel, whether every call was
    identical and the largest difference."""
    calls = {}
    for h in held:
        calls[h["kernel"]] = calls.get(h["kernel"], 0) + 1
    return {"calls": calls, "identical": all(h["identical"] for h in held), "max_abs_err": max((h["max_abs_err"] for h in held), default=0.0)}


def residency_bind_run(dev, plain: bool = False) -> dict:
    """incremental_residency's bind_after_snapshot case on one tree's
    package: incremental_churn_2400's cluster (testing.standing_cluster,
    RESIDENCY_NODES nodes) and catalog, one DenseSolver carrying the
    incremental engine and ResidencyAuditor(interval=1). Four passes: the
    cold pass and a full pass forced with reason 'audit' are planted (the
    snapshot, then RESIDENCY_FILLED nodes filled to their room by a bound
    pod each and every pod of one more node deleted, through the kube
    store, then the solve of churn_batch on that snapshot); each is
    followed by a clean pass on a fresh snapshot. Per pass: the engine's
    record (watch_engine), the divergences the auditor found, the nodes
    booked beyond their room (overbooked_nodes), whether the placements
    equal a fresh solver's on the same snapshot and batch, the launches
    and, through the kernels, every K1/K2 call held against its plain
    version. With plain=True the plain versions stand in at both seams,
    for the fresh solver too."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.controllers.state.cluster import Cluster
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver, DenseSolveStats
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module
    from karpenter_tpu_torch.solver.audit import ResidencyAuditor
    from karpenter_tpu_torch.solver.incremental import IncrementalEngine

    names = [f"churn-n{i:04d}" for i in range(RESIDENCY_NODES)]
    provider = FakeCloudProvider(instance_types(RESIDENCY_TYPES))
    provisioners = [testing.make_provisioner()]
    kube = KubeCluster()
    testing.standing_cluster(kube, RESIDENCY_NODES)
    bound = iter(range(1 << 20))

    def bind(node, cpu, memory):
        kube.create(testing.make_pod(
            name=f"rsd-bound-{next(bound):04d}", labels={"app": "standing"}, requests={"cpu": cpu, "memory": memory},
            node_name=node, phase="Running", unschedulable=False,
        ))

    # the node each planted pass empties holds pods from the start
    emptied = [names[-1], names[-2]]
    for node in emptied:
        for _ in range(3):
            bind(node, 4, "8Gi")
    cluster = Cluster(kube, None)
    engine = IncrementalEngine(cluster.delta_journal, device=dev)
    auditor = ResidencyAuditor(seed=CHURN_AUDIT_SEED, interval=1)
    solver = DenseSolver(min_batch=1, device=dev, incremental=engine, auditor=auditor)
    served = []
    watch_engine(engine, served)

    def plant(filled, empty):
        def mutate():
            for node in filled:
                bind(node, 16, "32Gi")  # the node's whole room
            for pod in kube.list_pods():
                if pod.spec.node_name == empty:
                    kube.delete(pod, grace=False)

        return mutate

    k = RESIDENCY_FILLED
    plan = [("cold", plant(names[:k], emptied[0])), ("next", None), ("audit", plant(names[k:2 * k], emptied[1])), ("next", None)]
    saved = dense_module.bucket_cost_packed, fill_module.admission_counts
    if plain:
        dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
    passes = []
    try:
        for step, (planted, mutate) in enumerate(plan):
            if planted == "audit":
                engine.invalidate("audit")
            snapshot = cluster.nodes_snapshot()
            if mutate is not None:
                mutate()
            pods = testing.churn_batch(step, CHURN_PODS)
            before = dict(auditor.divergences)
            captures = []
            if not plain:
                capture_kernel_calls(captures)
            solver.stats = DenseSolveStats()
            read_launches()
            try:
                t0 = time.perf_counter()
                results = build_scheduler(provisioners, provider, pods, cluster=cluster, state_nodes=snapshot, dense_solver=solver).solve(pods)
                sync(dev)
                wall = (time.perf_counter() - t0) * 1e3
            finally:
                if not plain:
                    dense_module.bucket_cost_packed, fill_module.admission_counts = saved
            launches = read_launches()
            fresh = build_scheduler(provisioners, provider, pods, cluster=cluster, state_nodes=snapshot, dense_solver=DenseSolver(min_batch=1, device=dev)).solve(pods)
            sync(dev)
            fresh_launches = read_launches()
            check(len(served) == step + 1, f"bind_after_snapshot: pass {step} advanced the engine {len(served) - step} times")
            passes.append({
                "step": step,
                "planted": planted,
                **served[step],
                "divergences": {kind: n - before.get(kind, 0) for kind, n in auditor.divergences.items() if n != before.get(kind, 0)},
                "overbooked": overbooked_nodes(snapshot, results),
                "same_as_fresh": outcome(results, pods) == outcome(fresh, pods),
                "outcome": outcome(results, pods),
                "on_existing": sum(len(v.pods) for v in results.existing_nodes),
                "wall_ms": wall,
                "launches": launches,
                "fresh_launches": fresh_launches,
                "held": None if plain else held_summary(hold_kernel_calls(captures, dev)),
            })
    finally:
        dense_module.bucket_cost_packed, fill_module.admission_counts = saved
    return {"passes": passes, "engine_passes": dict(engine.passes), "audits": auditor.audits, "divergences": dict(auditor.divergences)}


def residency_ice_round(dev, min_batch: int, pools, engine: bool, plain: bool = False, audit: bool = True) -> dict:
    """One round of incremental_residency's ice_resolve_incremental case on
    one tree's package: RESIDENCY_ICE's pods (reclaim_wave_workload) created
    in a store with its standing nodes, the fake provider strict with
    `pools` refused, nodes launched one at a time; with `engine` the
    provisioner's DenseSolver carries an IncrementalEngine on the cluster's
    journal and, with `audit`, ResidencyAuditor(interval=1) (unset, as
    the Runtime leaves it by default, nothing heals a stale row). Returns
    the round's record
    (run_round's), each schedule call's engine pass kinds, route and pods
    placed onto standing nodes, the auditor's counts and, through the
    kernels, every K1/K2 call of the round held against its plain version."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module
    from karpenter_tpu_torch.solver.audit import ResidencyAuditor
    from karpenter_tpu_torch.solver.incremental import IncrementalEngine

    name, pods_n, standing = RESIDENCY_ICE
    standing_names = {f"churn-n{i:04d}" for i in range(standing)}
    captures, calls, rig = [], [], {}
    saved = dense_module.bucket_cost_packed, fill_module.admission_counts

    def prepare(env):
        env.pods = testing.rename(testing.reclaim_wave_workload(pods_n), "rsd")
        if pools is not None:
            env.provider.allow_insufficient_capacity = False
            env.provider.insufficient_capacity_pools = set(pools)
        env.controller.LAUNCH_WORKERS = 1
        if engine:
            rig["engine"] = IncrementalEngine(env.cluster.delta_journal, device=dev)
            rig["auditor"] = ResidencyAuditor(seed=CHURN_AUDIT_SEED, interval=1) if audit else None
            env.solver = env.controller.dense_solver = DenseSolver(min_batch=min_batch, device=dev, incremental=rig["engine"], auditor=rig["auditor"])
        schedule = env.controller.schedule

        def watched(pods, state_nodes, opts=None, **kwargs):
            kinds = dict(rig["engine"].passes) if engine else {}
            results = schedule(pods, state_nodes, opts, **kwargs)
            calls.append({
                "pods": len(pods),
                "passes": sorted(k for k, n in rig["engine"].passes.items() if n != kinds[k]) if engine else [],
                "onto_standing": sum(len(v.pods) for v in results.existing_nodes if v.node.name in standing_names),
            })
            return results

        env.controller.schedule = watched
        if not plain:
            capture_kernel_calls(captures)

    try:
        _env, rec = run_round(dev, pods_n, standing, min_batch, "rsd", prepare=prepare, plain=plain)
    finally:
        dense_module.bucket_cost_packed, fill_module.admission_counts = saved
    for call, timed in zip(calls, rec["schedule"]):
        call["route"] = "dense" if timed["dense_batches"] else "host"
        call["launches"] = timed["launches"]
        call["wall_ms"] = timed["wall_ms"]
    auditor = rig.get("auditor")
    return {
        "rec": rec,
        "calls": calls,
        "auditor": None if auditor is None else {"passes": auditor.passes, "audits": auditor.audits, "divergences": dict(auditor.divergences)},
        "engine_passes": dict(rig["engine"].passes) if engine else None,
        "held": None if plain else held_summary(hold_kernel_calls(captures, dev)),
    }


def residency_ice_pools(dev, min_batch: int):
    """The instance types a warm-up round of RESIDENCY_ICE's batch launches
    (no refusal, no engine), and every pool of them."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.api import labels as lbl

    def prepare(env):
        env.pods = testing.rename(testing.reclaim_wave_workload(RESIDENCY_ICE[1]), "rsd")
        env.controller.LAUNCH_WORKERS = 1

    env, _rec = run_round(dev, RESIDENCY_ICE[1], RESIDENCY_ICE[2], min_batch, "rsd", prepare=prepare)
    catalog = {t.name(): t for t in env.provider.instance_types_list}
    launched = sorted({node.metadata.labels[lbl.LABEL_INSTANCE_TYPE] for node in env.kube.list_nodes() if node.name in env.provider.live_instances})
    return launched, {(t, o.zone, o.capacity_type) for t in launched for o in catalog[t].offerings()}


def residency_cases(dev, min_batch: int) -> dict:
    """Both cases of incremental_residency on the tree whose package is
    imported, through the kernels and with the plain versions, with no
    check applied: the phase (this tree) checks them, and `chip_cmp.py
    residency_cases` runs them on another tree for comparison."""
    t0 = time.perf_counter()
    bind = {"kernels": residency_bind_run(dev), "plain": residency_bind_run(dev, plain=True)}
    t1 = time.perf_counter()
    refused_types, pools = residency_ice_pools(dev, min_batch)
    ice = {
        "refused_types": refused_types,
        "refused_pools": len(pools),
        "kernels": residency_ice_round(dev, min_batch, pools, engine=True),
        "plain": residency_ice_round(dev, min_batch, pools, engine=True, plain=True),
        "unaudited": residency_ice_round(dev, min_batch, pools, engine=True, audit=False),
        "no_engine": residency_ice_round(dev, min_batch, pools, engine=False),
    }
    return {"bind_after_snapshot": bind, "ice_resolve_incremental": ice, "bind_s": t1 - t0, "ice_s": time.perf_counter() - t1}


def residency_pass_line(passes) -> list:
    """The passes of a bind_after_snapshot run as the phase line gives them."""
    return [{k: v for k, v in p.items() if k != "outcome"} for p in passes]


def incremental_residency(dev, min_batch: int, card_name) -> list:
    """The phase: residency_cases on this tree, one line per case, and the
    checks. Returns the two lines."""
    cases = residency_cases(dev, min_batch)
    checks = []
    bind = cases["bind_after_snapshot"]
    kern, plain = bind["kernels"], bind["plain"]
    bind_line = {
        "phase": "incremental_residency",
        "case": "bind_after_snapshot",
        "card": card_name,
        "standing_nodes": RESIDENCY_NODES,
        "types": RESIDENCY_TYPES,
        "filled_per_plant": RESIDENCY_FILLED,
        "pods_per_pass": CHURN_PODS,
        "stale_rows": sum(len(p["stale_rows"] or ()) for run in (kern, plain) for p in run["passes"]),
        "overbooked": sum(len(p["overbooked"]) for run in (kern, plain) for p in run["passes"]),
        "divergences": {"kernels": kern["divergences"], "plain": plain["divergences"]},
        "passes": residency_pass_line(kern["passes"]),
        "plain_passes": residency_pass_line(plain["passes"]),
        "engine_passes": kern["engine_passes"],
        "audits": kern["audits"],
        "kernel_launches": {k: sum(p["launches"][k] for p in kern["passes"]) for k in ("bucket_type_cost", "warm_fill_counts")},
        "plain_launches": {k: sum(p["launches"][k] for p in plain["passes"]) for k in ("bucket_type_cost", "warm_fill_counts")},
        "wall_s": cases["bind_s"],
    }
    emit(bind_line)
    kinds = [(p["pass"], p["reason"]) for p in kern["passes"]]
    checks += [
        (kinds == [("full", "cold"), ("delta", ""), ("full", "audit"), ("delta", "")], f"bind_after_snapshot: pass kinds {kinds}"),
        (bind_line["stale_rows"] == 0, "bind_after_snapshot: the engine served rows that differ from a fresh encode of the pass's views"),
        (all(p["head_dev_equal"] for run in (kern, plain) for p in run["passes"]), "bind_after_snapshot: the resident head differs from the mirror's f32 head"),
        (not kern["divergences"] and not plain["divergences"], f"bind_after_snapshot: divergences {bind_line['divergences']}"),
        (bind_line["overbooked"] == 0, "bind_after_snapshot: a pass booked a node beyond its room"),
        (all(p["same_as_fresh"] for run in (kern, plain) for p in run["passes"]), "bind_after_snapshot: a pass placed pods otherwise than a fresh solver"),
        ([p["outcome"] for p in kern["passes"]] == [p["outcome"] for p in plain["passes"]], "bind_after_snapshot: the plain versions placed pods differently"),
        (all(p["launches"]["warm_fill_counts"] == 1 for p in kern["passes"]), f"bind_after_snapshot: K2 launches per pass {[p['launches'] for p in kern['passes']]}"),
        (all(p["held"]["identical"] for p in kern["passes"]), "bind_after_snapshot: a kernel call disagrees with its plain version"),
        (not any(bind_line["plain_launches"].values()), f"bind_after_snapshot: the plain run launched {bind_line['plain_launches']}"),
    ]

    ice = cases["ice_resolve_incremental"]
    name, pods_n, standing = RESIDENCY_ICE
    runs = {k: ice[k] for k in ("kernels", "plain", "unaudited", "no_engine")}
    kern = runs["kernels"]
    resolves = kern["calls"][1:]
    ice_line = {
        "phase": "incremental_residency",
        "case": name,
        "card": card_name,
        "pods": pods_n,
        "standing_nodes": standing,
        "types": HEADLINE_TYPES,
        "min_batch": min_batch,
        "refused_types": ice["refused_types"],
        "refused_pools": ice["refused_pools"],
        "primary": kern["calls"][0],
        "resolves": resolves,
        "overbooked": {k: r["rec"]["outcome"]["broken"]["over_capacity"] for k, r in runs.items()},
        "broken": kern["rec"]["outcome"]["broken"],
        "auditor": {k: r["auditor"] for k, r in runs.items()},
        "engine_passes": {k: r["engine_passes"] for k, r in runs.items()},
        "same_as_no_engine": kern["rec"]["outcome"] == runs["no_engine"]["rec"]["outcome"] == runs["unaudited"]["rec"]["outcome"],
        "resolves_unaudited": runs["unaudited"]["calls"][1:],
        "same_as_plain": kern["rec"]["outcome"] == runs["plain"]["rec"]["outcome"],
        "round": round_summary(kern["rec"]),
        "no_engine_round_ms": runs["no_engine"]["rec"]["wall_ms"],
        "kernel_launches": kern["rec"]["launches"],
        "plain_launches": runs["plain"]["rec"]["launches"],
        "held": kern["held"],
        "wall_s": cases["ice_s"],
    }
    emit(ice_line)
    dense = [r for r in resolves if r["route"] == "dense"]
    checks += [
        (bool(resolves), f"{name}: no typed failure fed a re-solve"),
        (kern["calls"][0]["passes"] == ["full"], f"{name}: the primary solve's engine pass {kern['calls'][0]['passes']}"),
        (bool(dense), f"{name}: no re-solve ran dense: {resolves}"),
        (all(r["passes"] == ["bypass"] for r in dense) and all(r["passes"] == [] for r in resolves if r["route"] == "host"), f"{name}: re-solves' engine passes {resolves}"),
        (all(r["auditor"]["passes"] == 1 and not r["auditor"]["divergences"] for k, r in runs.items() if k in ("kernels", "plain")), f"{name}: the auditor {ice_line['auditor']}"),
        (all(r["passes"] == ["bypass"] for r in ice_line["resolves_unaudited"] if r["route"] == "dense"), f"{name}: re-solves' engine passes with no auditor {ice_line['resolves_unaudited']}"),
        (not any(ice_line["overbooked"].values()), f"{name}: nodes booked beyond their room {ice_line['overbooked']}"),
        (not any(kern["rec"]["outcome"]["broken"].values()), f"{name}: the round broke placements {kern['rec']['outcome']['broken']}"),
        (ice_line["same_as_no_engine"], f"{name}: the round with the engine decided otherwise than the round with none"),
        (ice_line["same_as_plain"], f"{name}: the plain versions' round decided otherwise"),
        (kern["rec"]["launches"]["bucket_type_cost"] >= 1 and kern["rec"]["launches"]["warm_fill_counts"] >= 1, f"{name}: launches {kern['rec']['launches']}"),
        (all(runs[k]["held"]["identical"] for k in ("kernels", "unaudited", "no_engine")), f"{name}: a kernel call disagrees with its plain version"),
        (not any(runs["plain"]["rec"]["launches"].values()), f"{name}: the plain run launched {runs['plain']['rec']['launches']}"),
    ]
    for cond, what in checks:
        check(bool(cond), what)
    return [bind_line, ice_line]


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

    def timed_launch_one(vn, *args):
        try:
            return launch_one(vn, *args)
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
    cohorts of build_workload that the nominations break; a node the
    cluster state does not know yet cannot be judged and is listed."""
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.utils import resources as res

    pods = {p.name: p for p in env.kube.list_pods()}
    over, hosts, zones, unknown = [], {}, {}, []
    for node in env.kube.list_nodes():
        state = env.cluster.get_state_node(node.name)
        if state is None:
            unknown.append(node.name)
            continue
        free = dict(state.available)
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
        "unknown_to_cluster": sorted(unknown),
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
    generation-2 (whole-heap) collections, `longest_ms` is the longest one."""

    def __init__(self):
        self.ms, self.full, self.longest_ms, self._t0 = 0.0, 0, 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            pause = (time.perf_counter() - self._t0) * 1e3
            self.ms += pause
            self.longest_ms = max(self.longest_ms, pause)
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


def node_price(env, node) -> float:
    """$/hour of a node in the simulated cloud: its pool's price in the
    backend's books (spot by type and zone, on-demand by type)."""
    type_name, zone, capacity_type = pool_of(node)
    if capacity_type == "spot":
        return env.backend.get_spot_price(type_name, zone)
    return env.backend.get_on_demand_price(type_name)


class WaveBookings:
    """What one wave booked onto each node against its room. Made on a
    wave's fresh fleet: it reads the requests of the pods bound to each node
    (daemonset pods aside) and each node's allocatable less the daemonset
    overhead, and wraps the interruption controller's re-solve and the
    provisioner's launch_nodes, so each launch inside a re-solve adds its
    (node name, pods) pairs (`placed`; from the results when the caller
    passed none: the new nodes with pods in order, every create of the wave
    succeeding, then the standing nodes) and a replacement's room. The
    provisioning rounds' launches are not the wave's, unless `every_launch`
    is set: then every launch from its making on is booked, a round's
    nominations included (nomination_window). It reads only what every
    version of the package has, so a comparison script can attach it to
    another tree's package (chip_cmp.py)."""

    def __init__(self, env, every_launch: bool = False):
        from karpenter_tpu_torch.utils import resources as res

        self.res, self.env = res, env
        overhead = {}
        for pod in env.provisioner_controller.daemonset_pods():
            overhead = res.merge(overhead, res.pod_requests(pod))
        self.overhead = overhead
        self.room, self.used, self.launched, self.booked_onto, self.placed_pods = {}, {}, [], set(), 0
        for node in env.kube.list_nodes():
            self._room(node)
        for pod in env.kube.list_pods():
            if pod.spec.node_name and not any(r.kind == "DaemonSet" for r in pod.metadata.owner_references):
                self._add(pod.spec.node_name, pod)
        inside = []
        provision, launch = env.interruption._provision_replacement, env.provisioner_controller.launch_nodes

        def resolving(node):
            inside.append(node.name)
            try:
                return provision(node)
            finally:
                inside.pop()

        def booking(results, *args, **kwargs):
            names = launch(results, *args, **kwargs)
            if inside or every_launch:
                placed = kwargs.get("placed")
                if placed is None:
                    new = [vn for vn in results.new_nodes if vn.pods]
                    if len(names) != len(new):
                        raise PhaseFailed(f"a create failed in the wave: {len(names)} of {len(new)} launched")
                    placed = list(zip(names, (vn.pods for vn in new))) + [(v.node.name, v.pods) for v in results.existing_nodes if v.pods]
                self.book(placed)
            return names

        env.interruption._provision_replacement = resolving
        env.provisioner_controller.launch_nodes = booking

    def _room(self, node) -> None:
        if node.name not in self.room:
            self.room[node.name] = self.res.subtract(dict(node.status.allocatable), self.overhead)

    def _add(self, name, pod) -> None:
        self.used[name] = self.res.merge(self.used.get(name, {}), self.res.pod_requests(pod))

    def book(self, placed) -> None:
        for name, pods in placed:
            if name not in self.room:
                self.launched.append(name)
                self._room(self.env.kube.get_node(name))
            for pod in pods:
                self._add(name, pod)
            self.booked_onto.add(name)
            self.placed_pods += len(pods)

    def summary(self) -> dict:
        """The nodes booked beyond their room (in any resource, pod slots
        included), the bookings and the room summed over the nodes the wave
        booked onto (the pods bound there at the start included), the
        replacements launched, and the end state's $/hour
        (read when called: after the run, the cluster's nodes then)."""
        over = sorted(
            name for name, used in self.used.items()
            if any(v > self.room[name].get(key, 0.0) + 1e-6 for key, v in used.items())
        )
        summed = {"booked": {}, "room": {}}
        for name in self.booked_onto:
            summed["booked"] = self.res.merge(summed["booked"], self.used[name])
            summed["room"] = self.res.merge(summed["room"], self.room[name])
        keys = ("cpu", "memory", "pods")
        return {
            "overbooked": len(over),
            "overbooked_nodes": over[:10],
            "placed_pods": self.placed_pods,
            "booked": {key: summed["booked"].get(key, 0.0) for key in keys},
            "room": {key: summed["room"].get(key, 0.0) for key in keys},
            "replacements": len(self.launched),
            "end_price_per_hour": sum(node_price(self.env, n) for n in self.env.kube.list_nodes()),
        }


def wave_run(dev, min_batch: int, plain: bool = False, max_messages=None) -> dict:
    """One reclaim wave on a fresh fleet. Timed: the poll_once() calls
    until every notice is handled and deleted (with `max_messages` set on
    the controller instance, the notices arrive over several polls, with no
    provisioning round between them; each notice records its poll). Then
    converge: termination until the victims are gone, one provisioning
    round for the pods the ReplicaSet stand-in recreated and the binding of
    its nominations; the clock past the deadlines, the cloud's reclaim, one
    gc sweep. WaveBookings holds what the re-solves booked against each
    node's room over the whole wave (each re-solve counts what the wave's
    earlier ones placed: the interruption controller's ledger), with the
    replacements launched and the end state's $/hour. With plain=True both
    kernels' plain versions stand in at the seams the solve calls; else
    each kernel call is captured and held against its plain version on its
    own operands after the run."""
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
        bookings = WaveBookings(env)
        if max_messages is not None:
            env.interruption.MAX_MESSAGES = max_messages
        rec = instrument_wave(env, dev, captures)
        gc.collect()
        deadlines = [backend.interrupt_spot_instance(env.instance_id(v)) for v in victims]
        handled_before = env.interruption.actions_performed.value(action="cordon_and_drain")
        del captures[:]
        read_launches()
        polls = 0
        t0 = time.perf_counter()
        while backend.notifications.depth() and polls < 10:
            n0 = len(rec["notices"])
            env.interruption.poll_once()
            polls += 1
            for notice in rec["notices"][n0:]:
                notice["poll"] = polls
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
        booked = bookings.summary()
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
        "bookings": booked,
        "launches_total": booked["replacements"] + len(post_drain),
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
    kernels' plain versions, then one more timed wave through the kernels
    with the notices split over polls (WAVE_SPLIT_MESSAGES on the
    controller instance). In every wave no node is booked beyond its room
    (`overbooked`), and the split wave's outcome is the one-poll waves'.
    Prints the `interruption` line and checks it."""
    name, pods_n = WAVE
    runs = [wave_run(dev, min_batch) for _ in range(1 + WAVE_RUNS)]
    plain = [wave_run(dev, min_batch, plain=True) for _ in range(1 + WAVE_RUNS)]
    split = wave_run(dev, min_batch, max_messages=WAVE_SPLIT_MESSAGES)
    timed = runs[1:]
    last = timed[-1]

    def notice_line(n):
        return {
            "pods": n["pods"],
            "poll": n["poll"],
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

    def bookings_line(r):
        return {**r["bookings"], "post_drain_launches": len(r["post_drain_launches"]), "launches_total": r["launches_total"]}

    holds = {}
    for kernel in ("bucket_type_cost", "warm_fill_counts"):
        held = [h for r in runs + [split] for n in r["notices"] for h in n["held"] if h["kernel"] == kernel]
        held += [h for r in runs + [split] for h in r["round_held"] if h["kernel"] == kernel]
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
        "overbooked": [r["bookings"]["overbooked"] for r in timed],
        "bookings": bookings_line(last),
        "bookings_runs": [bookings_line(r) for r in runs],
        "launches_total_runs": [r["launches_total"] for r in timed],
        "end_price_per_hour_runs": [r["bookings"]["end_price_per_hour"] for r in timed],
        "pending_after_round": last["pending_after_round"],
        "quarantined_pools": last["quarantined_pools"],
        "gc": last["gc"],
        "reclaimed": last["reclaimed"],
        "setup_s_runs": [r["setup_s"] for r in runs],
        "kernel_launches": {
            "wave": {k: sum(r["wave_launches"][k] for r in timed) for k in ("bucket_type_cost", "warm_fill_counts")},
            "round": {k: sum(r["round_launches"][k] for r in timed) for k in ("bucket_type_cost", "warm_fill_counts")},
            "split": {k: split["wave_launches"][k] + split["round_launches"][k] for k in ("bucket_type_cost", "warm_fill_counts")},
        },
        "kernel_holds": holds,
        "plain_run": {
            "launches": [r["wave_launches"] for r in plain] + [r["round_launches"] for r in plain],
            "wave_ms_runs": [r["wave_ms"] for r in plain[1:]],
            "overbooked": [r["bookings"]["overbooked"] for r in plain],
            "outcomes_identical": [wave_outcome(r) for r in plain] == [wave_outcome(r) for r in runs],
        },
        "split_run": {
            "max_messages": WAVE_SPLIT_MESSAGES,
            "polls": split["polls"],
            "notice_polls": [n["poll"] for n in split["notices"]],
            "wave_ms": split["wave_ms"],
            "resolve_ms": [n["resolve_ms"] for n in split["notices"]],
            "routes": [n["route"] for n in split["notices"]],
            "launches": {"wave": split["wave_launches"], "round": split["round_launches"]},
            "bookings": bookings_line(split),
            "outcome_equal_to_one_poll": wave_outcome(split) == wave_outcome(last),
        },
    }
    emit(line)
    for i, r in enumerate(runs + plain + [split]):
        tag = f"{name}: run {i}" if i < len(runs) + len(plain) else f"{name}: the split-poll run"
        check(r["bookings"]["overbooked"] == 0, f"{tag}: {r['bookings']['overbooked']} nodes booked beyond their room: {r['bookings']['overbooked_nodes']}")
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
    for i, r in enumerate(runs + [split]):
        tag = f"{name}: run {i}" if i < len(runs) else f"{name}: the split-poll run"
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
    want_polls = [i // WAVE_SPLIT_MESSAGES + 1 for i in range(WAVE_MAX_VICTIMS)]
    check(line["split_run"]["notice_polls"] == want_polls, f"{name}: the split run's notices arrived in polls {line['split_run']['notice_polls']}, not {want_polls}")
    check(line["split_run"]["outcome_equal_to_one_poll"], f"{name}: the split-poll wave's outcome differs from the one-poll wave's")
    return line


def window_run(dev, min_batch: int, plain: bool = False) -> dict:
    """The nomination window on a fresh fleet (wave_env): WINDOW's second
    batch created and one provisioning round run on it (K2 fills the
    fleet's spare room, K1 prices the new nodes), its nominations left
    unbound; then the wave's notices (wave_run's victims) delivered and
    handled in one poll. WaveBookings(every_launch=True) books the round's
    (node name, pods) pairs and every re-solve's against each node's room,
    read from a wrapper of launch_nodes (not from the port's record of
    nominations, so `chip_cmp.py window_cases` reads any tree alike). Then
    converge as wave_run does, the round's nominations bound first. With
    plain=True both kernels' plain versions stand in at the solve's seams;
    else every kernel call is captured and held against its plain version
    after the run."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.solver import DenseSolveStats
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    name, batch, seed = WINDOW
    saved = dense_module.bucket_cost_packed, fill_module.admission_counts
    captures = []
    if plain:
        dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
    else:
        capture_kernel_calls(captures)
    try:
        t0 = time.perf_counter()
        env = wave_env(dev, min_batch)
        setup_s = time.perf_counter() - t0
        kube, backend = env.kube, env.backend
        fleet = kube.list_nodes()
        populated = [n for n in fleet if kube.pods_on_node(n.name)]
        victims = populated[: max(1, min(WAVE_MAX_VICTIMS, int(len(populated) * WAVE_FRACTION)))]
        bookings = WaveBookings(env, every_launch=True)
        for pod in testing.rename(testing.reclaim_wave_workload(batch, seed), "round"):
            kube.create(pod)
        solver = env.provisioner_controller.dense_solver
        round_stats = solver.stats = DenseSolveStats()
        del captures[:]
        read_launches()
        t0 = time.perf_counter()
        results = env.provision()
        sync(dev)
        round_ms = (time.perf_counter() - t0) * 1e3
        round_launches = read_launches()
        round_calls, captures[:] = list(captures), []
        round_new = [pool_of(kube.get_node(n)) for n in bookings.launched]
        round_pods = bookings.placed_pods
        round_bound = sum(1 for p in kube.list_pods() if p.spec.node_name and p.name.startswith("dp-round-"))
        deadlines = [backend.interrupt_spot_instance(env.instance_id(v)) for v in victims]
        wave_stats = solver.stats = DenseSolveStats()
        t0 = time.perf_counter()
        handled = env.interruption.poll_once()
        sync(dev)
        wave_ms = (time.perf_counter() - t0) * 1e3
        wave_launches = read_launches()
        wave_calls, captures[:] = list(captures), []
        booked = bookings.summary()
        replacements = [pool_of(kube.get_node(n)) for n in bookings.launched[len(round_new):]]
        bound_round = env.bind_nominated()
        drain_passes = 0
        while any(kube.get_node(v.name) is not None for v in victims) and drain_passes < 4:
            env.termination_controller.reconcile_all()
            drain_passes += 1
        drained = len(env.recreated)
        before = {n.name for n in kube.list_nodes()}
        env.provision()
        post_drain = [pool_of(n) for n in kube.list_nodes() if n.name not in before]
        converge_launches = read_launches()
        converge_calls, captures[:] = list(captures), []
        env.bind_nominated()
        pending = sum(1 for p in kube.list_pods() if not p.spec.node_name)
        env.clock.step(max(deadlines) - env.clock.now() + 1.0)
        reclaimed = backend.reclaim_due_instances()
        swept = env.gc.reconcile()
        live = {i.instance_id for i in backend.list_instances()}
        nodes = {n.name: n for n in kube.list_nodes()}
        dead_nodes = sorted(n for n, node in nodes.items() if env.instance_id(node) not in live)
        unbound = sum(1 for p in kube.list_pods() if p.spec.node_name not in nodes)
        over = over_capacity(env)
        end_price = sum(node_price(env, n) for n in nodes.values())
    finally:
        dense_module.bucket_cost_packed, fill_module.admission_counts = saved
    return {
        "setup_s": setup_s,
        "fleet": len(fleet),
        "victims": [pool_of(v) for v in victims],
        "round": {
            "pods": batch,
            "on_standing": sum(len(v.pods) for v in results.existing_nodes),
            "new_node_pods": sum(len(n.pods) for n in results.new_nodes),
            "new_nodes": round_new,
            "unschedulable": len(results.unschedulable),
            "route": "dense" if round_stats.batches else "host",
            "booked_pods": round_pods,
            "bound_before_wave": round_bound,
            "ms": round_ms,
        },
        "handled": handled,
        "wave_ms": wave_ms,
        "wave_route": "dense" if wave_stats.batches else "host",
        "wave_pods_to_host": wave_stats.pods_to_host,
        "bookings": booked,
        "replacements": replacements,
        "bound_round": bound_round,
        "drain_passes": drain_passes,
        "drained_pods": drained,
        "post_drain_launches": post_drain,
        "launches_total": len(replacements) + len(post_drain),
        "end_price_per_hour": end_price,
        "pending_after_round": pending,
        "unbound_pods": unbound,
        "dead_nodes": dead_nodes,
        "over_capacity": over,
        "reclaimed": reclaimed,
        "gc": swept,
        "launches": {"round": round_launches, "wave": wave_launches, "converge": converge_launches},
        "held": [] if plain else hold_kernel_calls(round_calls + wave_calls + converge_calls, dev),
    }


def window_outcome(run) -> dict:
    """What the kernels' and the plain versions' windows must agree on."""
    keys = ("victims", "replacements", "post_drain_launches", "pending_after_round", "end_price_per_hour")
    return {**{k: run[k] for k in keys}, "round": {k: run["round"][k] for k in ("on_standing", "new_node_pods", "new_nodes")}, "overbooked": run["bookings"]["overbooked"]}


def window_cases(dev, min_batch: int) -> dict:
    """nomination_window's two runs, kernels then plain versions, with no
    check (`chip_cmp.py window_cases` runs them on other trees' packages)."""
    return {"kernels": window_run(dev, min_batch), "plain": window_run(dev, min_batch, plain=True)}


def nomination_window(dev, min_batch: int, card_name) -> dict:
    """A provisioning round's nominations still unbound when a spot reclaim
    wave's notices arrive (window_run), through the kernels and through
    their plain versions. Prints the `window` line and checks it: no node
    booked beyond its room in either run, the same outcome, every K1/K2
    call held bit for bit, K2 and K1 in the round and in the re-solves."""
    name, batch, seed = WINDOW
    t0 = time.perf_counter()
    cases = window_cases(dev, min_batch)
    kern, plain = cases["kernels"], cases["plain"]

    def launches(run):
        return {part: run["launches"][part] for part in ("round", "wave", "converge")}

    holds = {}
    for kernel in ("bucket_type_cost", "warm_fill_counts"):
        held = [h for h in kern["held"] if h["kernel"] == kernel]
        holds[kernel] = {
            "calls": len(held),
            "identical": sum(h["identical"] for h in held),
            "max_abs_err": max((h["max_abs_err"] for h in held), default=0.0),
        }
    line = {
        "phase": "window",
        "config": name,
        "card": card_name,
        "min_batch": min_batch,
        "fleet_pods": WAVE[1],
        "round_pods": batch,
        "round_seed": seed,
        "fleet_nodes": kern["fleet"],
        "victims": kern["victims"],
        "round": kern["round"],
        "handled": kern["handled"],
        "wave_ms": kern["wave_ms"],
        "wave_route": kern["wave_route"],
        "overbooked": {"kernels": kern["bookings"]["overbooked"], "plain": plain["bookings"]["overbooked"]},
        # WaveBookings' `replacements` counts the round's new nodes too
        "bookings": {k: v for k, v in kern["bookings"].items() if k != "replacements"},
        "replacements": kern["replacements"],
        "post_drain_launches": kern["post_drain_launches"],
        "launches_total": kern["launches_total"],
        "end_price_per_hour": kern["end_price_per_hour"],
        "kernel_launches": launches(kern),
        "kernel_holds": holds,
        "plain_run": {
            "launches": launches(plain),
            "overbooked": plain["bookings"]["overbooked"],
            "outcome_identical": window_outcome(plain) == window_outcome(kern),
        },
        "setup_s": [kern["setup_s"], plain["setup_s"]],
        "phase_s": time.perf_counter() - t0,
    }
    emit(line)
    for tag, run in (("kernels", kern), ("plain", plain)):
        check(run["bookings"]["overbooked"] == 0, f"{name} ({tag}): {run['bookings']['overbooked']} nodes booked beyond their room: {run['bookings']['overbooked_nodes']}")
        check(run["round"]["bound_before_wave"] == 0, f"{name} ({tag}): {run['round']['bound_before_wave']} of the round's pods bound before the wave")
        check(run["round"]["on_standing"] > 0, f"{name} ({tag}): the round nominated nothing onto the fleet")
        check(run["handled"] == len(run["victims"]) == WAVE_MAX_VICTIMS, f"{name} ({tag}): {run['handled']} messages in the poll for {len(run['victims'])} victims")
        check(len(run["replacements"]) > 0, f"{name} ({tag}): the re-solves launched no replacement")
        check(run["pending_after_round"] == 0 and run["unbound_pods"] == 0, f"{name} ({tag}): {run['pending_after_round']} pods pending, {run['unbound_pods']} on gone nodes")
        check(not run["dead_nodes"] and not run["over_capacity"], f"{name} ({tag}): dead nodes {run['dead_nodes'][:5]}, over capacity {run['over_capacity'][:5]}")
        check(run["gc"] == {"orphans": [], "ghosts": []}, f"{name} ({tag}): gc collected {run['gc']}")
    for part in ("round", "wave"):
        got = kern["launches"][part]
        check(got["warm_fill_counts"] > 0 and got["bucket_type_cost"] > 0, f"{name}: the {part} launched {got}, not both kernels")
    for kernel in ("bucket_type_cost", "warm_fill_counts"):
        launched = sum(kern["launches"][part][kernel] for part in ("round", "wave", "converge"))
        check(holds[kernel]["calls"] == launched, f"{name}: {holds[kernel]['calls']} {kernel} calls held for {launched} launches")
        check(holds[kernel]["identical"] == holds[kernel]["calls"], f"{name}: a {kernel} call differs from its plain version: {holds[kernel]}")
    check(not any(v for part in plain["launches"].values() for v in part.values()), f"{name}: the plain versions' run launched kernels: {plain['launches']}")
    check(line["plain_run"]["outcome_identical"], f"{name}: the kernels' and the plain versions' runs differ: {window_outcome(kern)} vs {window_outcome(plain)}")
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


# each part of the controller's boot, timed in a fresh child of its own:
# the child prints one JSON object, its part's ms
BOOT_PARTS = {
    "import_torch_ms": (
        "import json, time; t = time.perf_counter(); import torch; "
        "print(json.dumps({'ms': (time.perf_counter() - t) * 1e3}))"
    ),
    "import_runtime_ms": (
        "import json, time; t = time.perf_counter(); import karpenter_tpu_torch.runtime; "
        "print(json.dumps({'ms': (time.perf_counter() - t) * 1e3}))"
    ),
    # the first allocation and synchronize, after the import of torch
    "cuda_context_ms": (
        "import json, time, torch; t = time.perf_counter(); torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
        "print(json.dumps({'ms': (time.perf_counter() - t) * 1e3}))"
    ),
    # the part after the import of torch, which the line's import_torch_ms times
    "k1_probe_ms": (
        "import json, time, torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
        "from karpenter_tpu_torch.solver.dense import measure_dense_crossover; t = time.perf_counter(); "
        "min_batch = measure_dense_crossover(device='cuda'); "
        "print(json.dumps({'ms': (time.perf_counter() - t) * 1e3, 'min_batch': min_batch}))"
    ),
}


def boot_split(parts=None) -> dict:
    """ROADMAP B3's split of the controller's boot: each of BOOT_PARTS
    (`parts` replaces them) in a fresh child, its ms as the child measured
    it, and the child's wall from spawn to exit (the interpreter's start
    included). The kernels' libraries are already built on disk by then,
    as in a deployed image."""
    out = {}
    for part, code in (parts or BOOT_PARTS).items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=BOOT_DEADLINE_S)
        wall = (time.perf_counter() - t0) * 1e3
        check(proc.returncode == 0, f"boot split {part}: exit {proc.returncode}: {proc.stderr[-2000:]}")
        out[part] = {**json.loads(proc.stdout.strip().splitlines()[-1]), "child_wall_ms": wall}
    return out


def runtime_boot(card_name, command=None, parts=None) -> dict:
    """The controller process on the card: `python -m
    karpenter_tpu_torch.cmd.controller` (or `command`) as a child with a
    free health-probe port and a free metrics port; /healthz and /readyz
    polled until both answer 200, then /metrics and /debug; the crossover
    the Runtime measured at boot (K1's probe round trip) read from the
    child's log with the device its solver runs on; then SIGTERM, and exit
    code 0 required. The child is killed on any failure. Then the boot's
    split (boot_split, `parts` in place of BOOT_PARTS)."""
    import re
    import signal

    port, metrics_port = free_port(), free_port()
    argv = list(command or CONTROLLER_COMMAND) + [
        "--health-probe-port", str(port), "--metrics-port", str(metrics_port), "--log-level", "info",
    ]
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
        served = {path: probe_status(metrics_port, path) for path in ("/metrics", "/debug")}
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
        "metrics_port_status": served,
        "shutdown_ms": shutdown_ms,
        "exit_code": proc.returncode,
        "boot_split": boot_split(parts),
        "log_tail": log.splitlines()[-12:],
        "note": "K1's probe ran in the child, whose launch counts this process cannot read; the Runtime logs "
        "its solver's device, and on a CUDA device the wrapper launches the kernel or raises",
    }
    emit(line)
    check(ready_ms is not None, f"runtime_boot: the probes did not both answer 200 within {BOOT_DEADLINE_S} s (exit {proc.returncode})")
    check(all(v == 200 for v in served.values()), f"runtime_boot: the metrics port answered {served}")
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


def drive_runtime_round(rt, env, dev, names, write_batch, deadline_s: float, before_stop=None) -> dict:
    """One round of a Runtime cell: start() the Runtime (elected and
    recovered when it returns), write the batch through `write_batch` (which
    returns the instants its first write began and its last one ended), wait
    until every pod in `names` is nominated and the lifecycle and disruption
    loops have passed at least once (the batch loop stopped once the batch
    is nominated), then (within the same deadline) until every node a pod
    went to is in the Runtime's Cluster, and stop() it. Every K1 and K2 call from
    start() to stop() is captured (`captures`, for hold_kernel_calls); each
    launch call's placements land in `placed`, the instant it returned in
    `ends`. `before_stop(run)`, where given, runs with the Runtime still
    up and the kernel calls still captured, just before stop(); what it
    returns is the run's "before_stop". The seams are put back whatever
    happens, and the Runtime is stopped.

    The objects alive when the round starts are frozen out of the garbage
    collector's reach (gc.freeze) until the Runtime stops: by then the
    script's heap holds millions of them, and a full collection over it
    took 0.22-1.48 s on the host of an NVIDIA H100 80GB HBM3 (700.00 W)
    machine (chip_gc_pauses.py); one during the batch's writes held every
    thread past the batcher's 1 s idle window, which closed on part of the
    batch."""
    import gc

    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    placed, ends, captures = [], [], []
    watch_placements(rt.provisioner, placed, ends)
    seams = dense_module.bucket_cost_packed, fill_module.admission_counts
    capture_kernel_calls(captures)
    stopped = False
    gc.collect()
    gc.freeze()
    try:
        t_start = time.perf_counter()
        rt.start()
        start_ms = (time.perf_counter() - t_start) * 1e3
        recovered = dict(rt.passes)
        read_launches()
        t0, created = write_batch()
        deadline = time.perf_counter() + deadline_s
        nominated = set()
        while time.perf_counter() < deadline and rt.healthy():
            nominated = {p.name for _n, pod_list in list(placed) for p in pod_list}
            if names <= nominated:
                break
            time.sleep(0.02)
        done = max(ends) if ends else time.perf_counter()
        # no pod is bound in these cells, so a later round would solve the
        # batch again: pod events delivered during the round (over HTTP,
        # behind the loops' LISTs) trigger one. The round measured is the
        # first; the batch loop stops once it has nominated the batch.
        rt.provisioner.stop()
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
        # a launched node reaches the Runtime's Cluster through its watch
        # (over HTTP, behind the loops' LISTs: the round's deadline bounds it)
        known_deadline = time.perf_counter() + deadline_s
        while time.perf_counter() < known_deadline and any(rt.cluster.get_state_node(n) is None for n in by_node):
            time.sleep(0.05)
        nodes_known_ms = (time.perf_counter() - done) * 1e3
        broken = broken_placements(env, by_node)
        extra = before_stop({"placed": placed, "captures": captures, "names": names}) if before_stop is not None else None
        t_stop = time.perf_counter()
        stopped = True
        rt.stop()  # re-raises what ended a loop, if anything did
        stop_ms = (time.perf_counter() - t_stop) * 1e3
    finally:
        dense_module.bucket_cost_packed, fill_module.admission_counts = seams
        if not stopped:
            rt.stop()
        gc.unfreeze()
    return {
        "placed": placed, "ends": ends, "captures": captures, "start_ms": start_ms, "recovered": recovered,
        "t0": t0, "created": created, "done": done, "nominated": nominated, "launches": launches,
        "passes": passes, "healthy": healthy, "broken": broken, "t_stop": t_stop, "stop_ms": stop_ms,
        "nodes_known_ms": nodes_known_ms, "before_stop": extra,
    }


def runtime_reads(rt, kube, run, catalog, dev) -> tuple:
    """What a stopped Runtime's round left, read through `kube`: whether
    its Lease was released, its captured kernel calls held against their
    plain versions, and its outcome (runtime_outcome)."""
    released = lease_released(kube, rt.elector.identity)
    holds = hold_kernel_calls(run["captures"], dev)
    return released, holds, runtime_outcome(kube, run["placed"], {it.name(): it.price() for it in catalog})


def runtime_provision_once(dev, min_batch: int, plain: bool, shape=RUNTIME_ROUND, tag: str = "rto") -> dict:
    """A fresh Runtime (leader election off, the dense solver at
    `min_batch`) on a fresh store of a Runtime cell's contents (`shape`:
    its name, pods and standing nodes; the batch named by `tag`), driven by
    one synchronous provision_once(); with plain=True both kernels' plain
    versions stand in at the solve's seams. Its launches, placements and
    $/hour."""
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module
    from karpenter_tpu_torch.utils.options import parse

    _name, pods_n, standing = shape
    kube, pods = runtime_store(pods_n, standing, tag)
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
    from collections import Counter
    from types import SimpleNamespace

    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.runtime import Runtime
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
    names = {p.name for p in pods}
    # the registry's command counter is process-wide: the line takes this round's
    commands_before = dict(rt.disruption.commands.values())

    def write_batch():
        t0 = time.perf_counter()
        for pod in pods:
            kube.create(pod)
        return t0, time.perf_counter()

    run = drive_runtime_round(rt, env, dev, names, write_batch, RUNTIME_DEADLINE_S)
    recovered, nominated, launches, passes, healthy, broken = (run[k] for k in ("recovered", "nominated", "launches", "passes", "healthy", "broken"))
    t0, created, done, start_ms, stop_ms = (run[k] for k in ("t0", "created", "done", "start_ms", "stop_ms"))
    alive = [t.name for t in rt.threads() if t.is_alive()]
    released, holds, got = runtime_reads(rt, kube, run, catalog, dev)
    disruption = {k: v - commands_before.get(k, 0) for k, v in rt.disruption.commands.values().items() if v != commands_before.get(k, 0)}
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
        "launched_types": dict(sorted(Counter(t for t, *_rest in got["launched"]).items())),
        "pods_nominated_onto_standing": sum(len(n[1]) for n in got["standing"]),
        "price_per_hour": got["price_per_hour"],
        "kernel_launches": launches,
        "phases_ms": schedules[0]["phases_ms"] if schedules else None,
        "schedule_ms": [s["wall_ms"] for s in schedules],
        "get_pods_ms": rec["get_pods_ms"],
        "launch": rec["launch"],
        "passes_after_start": recovered,
        "passes": passes,
        "disruption_commands": [[dict(zip(("method", "outcome"), k)), v] for k, v in disruption.items()],
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


def http_get(port: int, path: str) -> tuple:
    """(status, body bytes, ms) of one GET on 127.0.0.1; status 0 while
    nothing answers."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as err:
        status, body = err.code, err.read()
    except OSError:
        status, body = 0, b""
    return status, body, (time.perf_counter() - t0) * 1e3


def span_durations(tree) -> dict:
    """Each span name's duration in a trace tree: the one span's ms, or
    for a repeated name its count, total and longest."""
    found = {}

    def walk(node):
        found.setdefault(node["name"], []).append(node["duration_ms"])
        for child in node["children"]:
            walk(child)

    walk(tree)
    return {k: v[0] if len(v) == 1 else {"count": len(v), "total_ms": sum(v), "max_ms": max(v)} for k, v in found.items()}


def trace_chain(tree) -> list:
    """What a provisioning round's trace lacks of the chain provision →
    batch, solve (encode, fill, device with mask and assemble, commit),
    launch (every launch-node, bind); empty when the chain is whole."""

    def kids(node):
        return {c["name"]: c for c in node["children"]} if node is not None else {}

    top = kids(tree)
    solve = kids(top.get("solve"))
    device = kids(solve.get("device"))
    launch = [c["name"] for c in top["launch"]["children"]] if "launch" in top else []
    want = [
        ("provision", tree["name"] == "provision"),
        *((f"provision/{n}", n in top) for n in ("batch", "solve", "launch")),
        *((f"solve/{n}", n in solve) for n in ("encode", "fill", "device", "commit")),
        *((f"device/{n}", n in device) for n in ("mask", "assemble")),
        ("launch/launch-node", "launch-node" in launch),
        ("launch/bind", "bind" in launch),
    ]
    return [name for name, ok in want if not ok]


def runtime_round_traced(dev, card_name, untraced_line) -> dict:
    """runtime_round's cell with the telemetry on: parse() defaults plus
    --enable-tracing --enable-lock-witness --metrics-port, the witness
    enabled before the store is built (as cmd/controller.main does, so the
    kube.store lock is witnessed), and an ObservabilityServer serving
    /metrics with cmd/controller.debug_routes. The round goes through
    drive_runtime_round. Measured: pods to last nomination beside the
    untraced round's, the round's trace (each span's duration), the
    decision log, one /metrics scrape after the round (ms, bytes), each
    scraper's pass at this size, and the witness's acquisitions, contended
    acquisitions, long holds and longest hold by lock with its edge and
    cycle gauges. Held: one trace links provision → batch → solve →
    encode/fill/device(mask, assemble)/commit → launch → every launch-node
    → bind; the decision records equal the nominations onto standing and
    new nodes, the ring keeps its 4,096 and the dropped counter counts the
    rest; /metrics answers 200 with the provisioning, reconcile, scheduling,
    cloud-provider and witness families and no launch failure; no
    lock-order cycle; every K1/K2 call held bit for bit; the outcome equal
    to the untraced round's; no node over capacity; threads joined and the
    Lease released after stop()."""
    import gc
    from collections import Counter
    from types import SimpleNamespace

    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.analysis import witness
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.cmd.controller import debug_routes
    from karpenter_tpu_torch.metrics import REGISTRY
    from karpenter_tpu_torch.observability import ObservabilityServer
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.utils.options import parse

    name, pods_n, standing = RUNTIME_ROUND_TRACED
    port = free_port()
    options = parse(["--dense-min-batch", "0", "--enable-tracing", "--enable-lock-witness", "--metrics-port", str(port)])
    WITNESS, TRACER, DECISIONS = witness.WITNESS, tracing.TRACER, tracing.DECISIONS
    WITNESS.reset()
    WITNESS.enable()
    DECISIONS.reset()
    decisions = Counter()
    record = DECISIONS.record

    def counted(rec):
        decisions[rec.outcome] += 1
        record(rec)

    DECISIONS.record = counted
    counters = {"acquisitions": witness.ACQUISITIONS, "contended": witness.CONTENDED, "long_holds": witness.LONG_HOLDS}
    before = {k: dict(c.values()) for k, c in counters.items()}
    dropped_before = tracing.DECISIONS_DROPPED.value()
    # the registry is process-wide: earlier phases' capacity failures are in it
    failures = REGISTRY.get("karpenter_provisioning_launch_failures_total")
    failures_before = sum(failures.values().values()) if failures is not None else 0.0
    obs = None
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    try:
        kube, pods = runtime_store(pods_n, standing, "rtt")
        catalog = instance_types(HEADLINE_TYPES)
        t_boot = time.perf_counter()
        rt = Runtime(kube=kube, cloud_provider=FakeCloudProvider(catalog), options=options, device=dev)
        construct_ms = (time.perf_counter() - t_boot) * 1e3
        TRACER.reset()
        obs = ObservabilityServer(
            healthy=rt.healthy, ready=lambda: rt.ready() and rt.healthy(), health_port=None,
            metrics_port=options.metrics_port, host="127.0.0.1", extra_routes=debug_routes(options),
        )
        obs.start()
        env = SimpleNamespace(controller=rt.provisioner, solver=rt.dense_solver, kube=kube, cluster=rt.cluster)
        rec = instrument(env, dev)
        names = {p.name for p in pods}

        def write_batch():
            t0 = time.perf_counter()
            for pod in pods:
                kube.create(pod)
            return t0, time.perf_counter()

        run = drive_runtime_round(rt, env, dev, names, write_batch, RUNTIME_DEADLINE_S)
        alive = [t.name for t in rt.threads() if t.is_alive()]
        released, holds, got = runtime_reads(rt, kube, run, catalog, dev)
        rounds = []
        for entry in TRACER.traces():
            tree = TRACER.span_tree(entry["trace_id"]) if entry["root"] == "provision" else None
            if tree is not None and tree["attributes"].get("pods", 0) > 0:
                rounds.append({"trace_id": entry["trace_id"], "spans": entry["spans"], "attributes": tree["attributes"], "missing": trace_chain(tree), "durations_ms": span_durations(tree), "launch_nodes": sum(1 for c in next((c for c in tree["children"] if c["name"] == "launch"), {"children": []})["children"] if c["name"] == "launch-node")})
        scrapes = {}
        for scraper in ("pod_metrics", "provisioner_metrics", "node_metrics"):
            t0 = time.perf_counter()
            getattr(rt, scraper).scrape()
            scrapes[scraper] = (time.perf_counter() - t0) * 1e3
        status, body, scrape_ms = http_get(port, "/metrics")
        text = body.decode()
        families = sorted({line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")})
        launch_failures = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines() if line.startswith("karpenter_provisioning_launch_failures_total")) - failures_before
        debug = {path: http_get(port, path)[0] for path in ("/debug", "/debug/traces", "/debug/decisions", "/debug/locks")}
        snapshot = WITNESS.snapshot()
        by_lock = {}
        for key, counter in counters.items():
            for (lock,), value in counter.values().items():
                delta = value - before[key].get((lock,), 0)
                if delta:
                    by_lock.setdefault(lock, {})[key] = delta
        for lock, held in snapshot["max_hold_seconds"].items():
            by_lock.setdefault(lock, {})["max_hold_ms"] = held * 1e3
        ring = len(DECISIONS)
        dropped = tracing.DECISIONS_DROPPED.value() - dropped_before
        edges, cycles = witness.EDGES.value(), witness.CYCLES.value()
    finally:
        gc.callbacks.remove(pauses)
        del DECISIONS.record
        if obs is not None:
            obs.stop()
        TRACER.disable()
        TRACER.reset()
        DECISIONS.reset()
        WITNESS.disable()
    on_standing = sum(len(n[1]) for n in got["standing"])
    launched_types = dict(sorted(Counter(t for t, *_rest in got["launched"]).items()))
    untraced = {k: untraced_line[k] for k in ("launched_types", "pods_nominated_onto_standing", "price_per_hour")}
    traced = {"launched_types": launched_types, "pods_nominated_onto_standing": on_standing, "price_per_hour": got["price_per_hour"]}
    wait_ms = (run["done"] - run["t0"]) * 1e3
    schedules = rec["schedule"]
    line = {
        "phase": name,
        "config": name,
        "card": card_name,
        "pods": pods_n,
        "standing_nodes": standing,
        "types": HEADLINE_TYPES,
        "min_batch": rt.dense_solver.min_batch,
        "construct_ms": construct_ms,
        "start_ms": run["start_ms"],
        "create_ms": (run["created"] - run["t0"]) * 1e3,
        "pods_to_last_nomination_ms": wait_ms,
        "untraced_pods_to_last_nomination_ms": untraced_line["pods_to_last_nomination_ms"],
        "telemetry_share_of_pod_wait": (wait_ms - untraced_line["pods_to_last_nomination_ms"]) / wait_ms,
        "stop_ms": run["stop_ms"],
        "rounds": len(rec["get_pods_ms"]),
        "phases_ms": schedules[0]["phases_ms"] if schedules else None,
        "schedule_ms": [s["wall_ms"] for s in schedules],
        "get_pods_ms": rec["get_pods_ms"],
        "launch": rec["launch"],
        "traces": rounds,
        "decisions": dict(decisions),
        "decision_ring": ring,
        "decisions_dropped": dropped,
        "metrics": {"status": status, "ms": scrape_ms, "bytes": len(body), "families": len(families), "launch_failures": launch_failures},
        "debug_status": debug,
        "scrape_ms": scrapes,
        "gc": {"ms": pauses.ms, "full": pauses.full, "longest_ms": pauses.longest_ms},
        "witness": {"locks": by_lock, "edges": edges, "cycles": cycles, "cycle_list": snapshot["cycles"], "long_hold_threshold_s": snapshot["long_hold_threshold_seconds"]},
        "outcome": traced,
        "untraced_outcome": untraced,
        "kernel_launches": run["launches"],
        "kernel_holds": holds,
        "broken": run["broken"],
        "healthy": run["healthy"],
        "threads_alive_after_stop": alive,
        "lease_released": released,
    }
    emit(line)
    new_pods = pods_n - on_standing
    wanted = [
        "karpenter_provisioning_launch_failures_total", "karpenter_reconcile_duration_seconds",
        "karpenter_allocation_controller_scheduling_duration_seconds", "karpenter_cloudprovider_duration_seconds",
        "karpenter_lockwitness_acquisitions_total", "karpenter_lockwitness_edges", "karpenter_lockwitness_cycles",
    ]
    check(run["healthy"], f"{name}: the Runtime turned unhealthy")
    check(names <= run["nominated"], f"{name}: {len(names - run['nominated'])} of {pods_n} pods never nominated within {RUNTIME_DEADLINE_S} s")
    check(rounds and not rounds[0]["missing"], f"{name}: the round's trace lacks {rounds[0]['missing'] if rounds else 'a provision root'}")
    check(rounds and rounds[0]["launch_nodes"] == len(got["launched"]), f"{name}: {rounds[0]['launch_nodes'] if rounds else 0} launch-node spans for {len(got['launched'])} launches")
    check(decisions.get("placed-existing", 0) == on_standing and decisions.get("placed-new", 0) == new_pods, f"{name}: decisions {dict(decisions)} against {on_standing} onto standing and {new_pods} onto new nodes")
    check(ring == min(pods_n, tracing.DEFAULT_DECISION_RING) and dropped == sum(decisions.values()) - ring, f"{name}: the decision ring holds {ring} and counted {dropped} dropped of {sum(decisions.values())}")
    check(status == 200 and all(f in families for f in wanted), f"{name}: /metrics answered {status}; missing {[f for f in wanted if f not in families]}")
    check(launch_failures == 0, f"{name}: /metrics counts {launch_failures} launch failures")
    check(all(v == 200 for v in debug.values()), f"{name}: debug routes answered {debug}")
    check(not snapshot["cycles"] and cycles == 0, f"{name}: lock-order cycles {snapshot['cycles']}")
    check(run["launches"]["bucket_type_cost"] >= 1 and run["launches"]["warm_fill_counts"] >= 1, f"{name}: the window launched {run['launches']}")
    check(holds and all(h["identical"] for h in holds), f"{name}: a kernel call differs from its plain version: {[h for h in holds if not h['identical']]}")
    check(traced == untraced, f"{name}: the traced round's outcome {traced} differs from the untraced round's {untraced}")
    check(not any(run["broken"].values()), f"{name}: the round broke placements: {run['broken']}")
    check(not alive, f"{name}: threads alive after stop(): {alive}")
    check(released, f"{name}: the Lease was not released")
    return line


def bind_placed(kube, placed) -> int:
    """The kube-scheduler's part: bind every pod a round placed, by name, to
    the node it went to. Returns the bindings made."""
    pods = {p.name: p for p in kube.list_pods()}
    bound = 0
    for node_name, pod_list in placed:
        for placed_pod in pod_list:
            pod = pods.get(placed_pod.name)
            if pod is not None and not pod.spec.node_name:
                kube.bind_pod(pod, node_name)
                bound += 1
    return bound


def trace_kernels(path) -> dict:
    """A Chrome trace's device events (category "kernel"), and how many of
    them name K1's and K2's kernel symbols."""
    from pathlib import Path

    from collections import Counter

    doc = json.loads(Path(path).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    device = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    return {
        "device_events": len(device),
        **{symbol: sum(symbol in str(e.get("name", "")) for e in device) for symbol in KERNEL_SYMBOLS},
        "categories": dict(Counter(str(e.get("cat", "")) for e in events)),
    }


def recorded_profiled_runtime(dev, min_batch: int, tag: str, extra_args=()):
    """A Runtime (leader election off, the dense solver at `min_batch`) on a
    fresh store of PROFILED_ROUND's size, its batch created: one
    provision_once() launches K2 onto the standing nodes and K1 for the
    rest."""
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.utils.options import parse

    pods_n, standing = PROFILED_ROUND
    kube, pods = runtime_store(pods_n, standing, tag)
    options = parse(["--no-leader-elect", "--dense-min-batch", str(min_batch), *extra_args])
    rt = Runtime(kube=kube, cloud_provider=FakeCloudProvider(instance_types(HEADLINE_TYPES)), options=options, device=dev)
    for pod in pods:
        kube.create(pod)
    return rt


def recorded_profiling(dev, port: int, profile_dir, min_batch: int) -> dict:
    """The profiler on the card: a Runtime with --enable-profiling, whose
    provision_once() maybe_profile_round wraps in a host profile and a
    device trace under `profile_dir`; then /debug/pprof/trace?seconds=
    PROFILE_TRACE_S on the metrics listener at `port`, with one
    provision_once() of a fresh Runtime started once the profiler is on.
    Each trace's device events by kernel symbol. The profiler may drop a
    session's device events (as profiled_device_ms finds), so each is taken
    on a fresh Runtime up to TRACE_ATTEMPTS times, until a trace names both
    kernels; every attempt is in the result."""
    from pathlib import Path

    from karpenter_tpu_torch.profiling import TRACE_FILE

    def both(kernels) -> bool:
        return kernels is not None and all(kernels[s] >= 1 for s in KERNEL_SYMBOLS)

    rounds, lives = [], []
    for attempt in range(TRACE_ATTEMPTS):
        before = set(Path(profile_dir).glob("provision-*"))
        rt = recorded_profiled_runtime(dev, min_batch, f"rtq{attempt}", ("--enable-profiling",))
        try:
            read_launches()
            rt.provision_once()
            sync(dev)
            launches = read_launches()
        finally:
            rt.stop()
        written = set(Path(profile_dir).glob("provision-*")) - before
        profs = [f for f in written if f.suffix == ".prof"]
        traces = [f / TRACE_FILE for f in written if f.is_dir() and (f / TRACE_FILE).exists()]
        rounds.append({
            "launches": launches, "prof_files": len(profs), "prof_bytes": sum(f.stat().st_size for f in profs),
            "device_traces": len(traces), "trace_bytes": sum(f.stat().st_size for f in traces),
            "kernels": trace_kernels(traces[0]) if traces else None,
        })
        if both(rounds[-1]["kernels"]):
            break
    for attempt in range(TRACE_ATTEMPTS):
        rt = recorded_profiled_runtime(dev, min_batch, f"rtl{attempt}")
        try:
            got = {}
            getter = threading.Thread(target=lambda: got.update(trace=http_get(port, f"/debug/pprof/trace?seconds={PROFILE_TRACE_S}")))
            getter.start()
            deadline = time.perf_counter() + PROFILER_START_S
            while not torch.autograd.profiler._is_profiler_enabled and time.perf_counter() < deadline:
                time.sleep(0.005)
            started = torch.autograd.profiler._is_profiler_enabled
            read_launches()
            t0 = time.perf_counter()
            rt.provision_once()
            sync(dev)
            round_ms = (time.perf_counter() - t0) * 1e3
            launches = read_launches()
            getter.join(timeout=PROFILE_TRACE_S + 120)
            status, body, request_ms = got.get("trace", (0, b"", 0.0))
            written = body.decode().strip().rsplit(" ", 1)[-1] if status == 200 else ""
            trace = Path(written) / TRACE_FILE if written else None
            lives.append({
                "status": status, "request_ms": request_ms, "profiler_started": started, "round_ms": round_ms,
                "launches": launches, "trace_bytes": trace.stat().st_size if trace is not None and trace.exists() else 0,
                "kernels": trace_kernels(trace) if trace is not None and trace.exists() else None,
            })
        finally:
            rt.stop()
        if both(lives[-1]["kernels"]):
            break
    return {"round": rounds[-1], "live": lives[-1], "round_attempts": rounds, "live_attempts": lives}


def planted_divergence(dev, spool) -> dict:
    """tests/test_torch_audit.py's planted device-corrupt case on the card:
    PLANTED's standing nodes under one seeded churn, a persistent
    DenseSolver with the incremental engine and the residency auditor on
    `dev`; a cold pass and a clean delta pass, then a pass whose resident
    head gets one element perturbed on the card right after the engine
    advances (a row the audit samples). The audit must report device-corrupt
    and the capsule engine, polled after each pass, capture exactly one
    residency-divergence capsule, spooled under `spool`; `python -m
    karpenter_tpu_torch.cmd.capsule inspect` reads it back."""
    from pathlib import Path

    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.capsule import CAPSULE, TRIGGER_RESIDENCY, capsule_errors
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.controllers.state.cluster import Cluster
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver.audit import KIND_DEVICE_CORRUPT, ResidencyAuditor
    from karpenter_tpu_torch.solver.incremental import IncrementalEngine

    nodes, seed = PLANTED
    provider = FakeCloudProvider(instance_types(40))
    kube = KubeCluster()
    churn = testing.Churn(kube, seed, "pd", min_nodes=8)
    churn.seed_nodes(nodes)
    cluster = Cluster(kube, None)
    engine = IncrementalEngine(cluster.delta_journal, device=dev)
    auditor = ResidencyAuditor(seed=3)
    solver = DenseSolver(min_batch=1, device=dev, incremental=engine, auditor=auditor)
    armed, planted = [], []
    advance = engine.advance

    def advancing(*args):
        adv = advance(*args)
        if armed:
            armed.pop()
            res = engine._resident
            row = auditor.sample(len(res.names), auditor.audits)[0]
            res.head_dev[row, 0] += 1.0
            planted.append(res.names[row])
        return adv

    engine.advance = advancing

    def solve(step) -> int:
        pods = testing.rename(
            [testing.make_pod(labels={"app": "planted"}, requests={"cpu": 0.25, "memory": "256Mi"}) for _ in range(8)], f"pd{step}"
        )
        scheduler = build_scheduler(
            testing.campaign_provisioners(), provider, pods, cluster=cluster,
            state_nodes=cluster.nodes_snapshot(), dense_solver=solver,
        )
        results = scheduler.solve(pods)
        sync(dev)
        return sum(len(n.pods) for n in results.new_nodes) + sum(len(v.pods) for v in results.existing_nodes)

    read_launches()
    placed = [solve(0)]
    churn.step()
    placed.append(solve(1))
    clean = {"divergences": dict(auditor.divergences), "capsules": CAPSULE.poll()}
    churn.step()
    armed.append(True)
    placed.append(solve(2))
    launches = read_launches()
    captured = CAPSULE.poll()
    rows = CAPSULE.index()
    files = sorted(Path(spool).glob(f"CAPSULE_{TRIGGER_RESIDENCY}_*.json"))
    doc = json.loads(files[0].read_text()) if files else None
    inspect = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.cmd.capsule", "inspect", str(files[0])] if files else [sys.executable, "-c", "raise SystemExit(9)"],
        capture_output=True, text=True, timeout=120, cwd=Path(__file__).resolve().parent,
    )
    return {
        "standing_nodes": nodes,
        "placed": placed,
        "clean": clean,
        "planted_row": planted,
        "divergences": dict(auditor.divergences),
        "last_divergence_kinds": (auditor.last_divergence or {}).get("kinds"),
        "audits": auditor.audits,
        "heals": auditor.heals,
        "launches": launches,
        "captured": captured,
        "capsules": [{"id": r["id"], "trigger": r["trigger"], "detail": r["detail"]} for r in rows],
        "capsule_files": [f.name for f in files],
        "capsule_bytes": files[0].stat().st_size if files else 0,
        "capsule_errors": capsule_errors(doc) if doc is not None else ["no capsule file"],
        "inspect_rc": inspect.returncode,
        "inspect_out": inspect.stdout.splitlines()[:3],
        "expected_kind": KIND_DEVICE_CORRUPT,
    }


def runtime_round_recorded(dev, card_name, plain_line) -> dict:
    """runtime_round's cell with the recorders on: parse() defaults plus
    --enable-solver-telemetry --enable-journal --enable-capsules
    --enable-slo --enable-profiling (KARPENTER_TPU_PROFILE_DIR set to a
    fresh directory), --invariants-interval and --coherence-interval of
    RECORDED_INTERVAL_S, the capsules spooled and /metrics served with
    cmd/controller.debug_routes. The round goes through
    drive_runtime_round; once the batch is nominated, every pod is bound to
    its node (the kube-scheduler's part) while the Runtime runs, and the
    phase waits for an invariant sample and a coherence check after it.
    Then, the Runtime stopped: the SLO scraper's compute_drift (the ideal
    repack of every bound pod onto an empty cluster, a cold dense solve on
    the card through K1), again with the plain versions; the profiler on
    the card (recorded_profiling, in a fresh process: PROFILING_CHILD); and
    a planted divergence (planted_divergence). Held: the outcome equal to `plain_line`'s; every
    K1/K2 call bit for bit, compute_drift's included; one flight record per
    dense solve, each with its phases, dispatch "cuda", a peak of device
    memory above zero and no kernel build; the journal holding each batch
    pod's six transitions; the waterfall's and the SLO's pending-duration
    counts equal to the batch; the invariant monitor clean, and after
    stop() no leaked thread or watch; no coherence divergence; no capsule
    in the clean round, and the flight recorder's steady-recompile
    cross-check against the port's committed contract (analysis/
    solver_contracts.json) with no violation over the round's records; the
    planted divergence's one capsule, read back
    clean; both device traces naming K1's and K2's symbols; /metrics
    rendering every registered family."""
    import gc
    import os
    import tempfile
    from collections import Counter
    from pathlib import Path
    from types import SimpleNamespace

    from karpenter_tpu_torch import capsule, flight, invariants, journal, profiling, slo
    from karpenter_tpu_torch.analysis.contracts import recompile_violations
    from karpenter_tpu_torch.capsule import TRIGGER_STEADY_RECOMPILE
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.cmd.controller import debug_routes
    from karpenter_tpu_torch.kube import coherence
    from karpenter_tpu_torch.metrics import REGISTRY
    from karpenter_tpu_torch.observability import ObservabilityServer
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module
    from karpenter_tpu_torch.utils.options import parse

    name, pods_n, standing = RUNTIME_ROUND_RECORDED
    work = Path(tempfile.mkdtemp(prefix="karpenter-recorded-"))
    profile_dir, spool = work / "profiles", work / "capsules"
    port = free_port()
    options = parse([
        "--dense-min-batch", "0", "--enable-solver-telemetry", "--enable-journal", "--enable-capsules",
        "--enable-slo", "--enable-profiling", "--invariants-interval", str(RECORDED_INTERVAL_S),
        "--coherence-interval", str(RECORDED_INTERVAL_S), "--metrics-port", str(port),
        "--journal-ring-size", str(RECORDED_JOURNAL_RING), "--capsule-spool", str(spool),
    ])
    JOURNAL, FLIGHT, CAPSULE, SLO, MONITOR, CENSUS = journal.JOURNAL, flight.FLIGHT, capsule.CAPSULE, slo.SLO, invariants.MONITOR, invariants.CENSUS
    for recorder in (JOURNAL, FLIGHT, CAPSULE, SLO):
        recorder.reset()
    env_before = os.environ.get(profiling.ENV_DIR)
    os.environ[profiling.ENV_DIR] = str(profile_dir)
    builds_before = flight._TALLY.snapshot()[0]
    divergences_before = coherence.divergences_total()
    clean_before = coherence.CHECKS.value(result=coherence.RESULT_CLEAN)
    leaked_before = CENSUS.leaked()
    obs = None
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    try:
        kube, pods = runtime_store(pods_n, standing, "rtr")
        catalog = instance_types(HEADLINE_TYPES)
        t_boot = time.perf_counter()
        rt = Runtime(kube=kube, cloud_provider=FakeCloudProvider(catalog), options=options, device=dev)
        construct_ms = (time.perf_counter() - t_boot) * 1e3
        obs = ObservabilityServer(
            healthy=rt.healthy, ready=lambda: rt.ready() and rt.healthy(), health_port=None,
            metrics_port=options.metrics_port, host="127.0.0.1", extra_routes=debug_routes(options, rt),
        )
        obs.start()
        env = SimpleNamespace(controller=rt.provisioner, solver=rt.dense_solver, kube=kube, cluster=rt.cluster)
        rec = instrument(env, dev)
        names = {p.name for p in pods}

        def write_batch():
            t0 = time.perf_counter()
            for pod in pods:
                kube.create(pod)
            return t0, time.perf_counter()

        def while_up(run):
            """Bind the batch, wait for an invariant sample and a coherence
            check after it, then read the metrics listener."""
            t0 = time.perf_counter()
            bound = bind_placed(kube, run["placed"])
            bind_ms = (time.perf_counter() - t0) * 1e3
            samples = MONITOR.report()["samples"]
            checks = sum(coherence.CHECKS.values().values())
            deadline = time.perf_counter() + 10 * RECORDED_INTERVAL_S + 10
            while time.perf_counter() < deadline and rt.healthy() and not (
                MONITOR.report()["samples"] > samples and sum(coherence.CHECKS.values().values()) > checks
            ):
                time.sleep(0.05)
            status, body, scrape_ms = http_get(port, "/metrics")
            text = body.decode()
            families = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}
            registered = {family for family, *_rest in REGISTRY.families()}
            debug = {path: http_get(port, path)[0] for path in RECORDED_DEBUG_ROUTES}
            return {
                "bound": bound, "bind_ms": bind_ms, "report": MONITOR.report(), "metrics_status": status,
                "metrics_ms": scrape_ms, "metrics_bytes": len(body), "families": families, "debug": debug,
                "unrendered": sorted(registered - families),
            }

        run = drive_runtime_round(rt, env, dev, names, write_batch, RUNTIME_DEADLINE_S, before_stop=while_up)
        up = run["before_stop"]
        alive = [t.name for t in rt.threads() if t.is_alive()]
        released, holds, got = runtime_reads(rt, kube, run, catalog, dev)
        leaked = CENSUS.leaked()
        owners = CENSUS.snapshot()["owners"]
        watchers = kube.watcher_count()
        report = MONITOR.report()
        CAPSULE.poll()
        capsules_clean = CAPSULE.captures_total()
        # the flight recorder's steady-recompile cross-check read the port's
        # committed contract at every record; read it again over the round's
        contract = flight._committed_contracts()
        steady = {
            "contract_libraries": sorted(contract["libraries"]) if contract else None,
            "violations": recompile_violations(FLIGHT.records(), contract),
            "capsules": sum(1 for c in CAPSULE.index() if c["trigger"] == TRIGGER_STEADY_RECOMPILE),
        }
        owner = rt._census_owner
        builds_round = flight._TALLY.snapshot()[0] - builds_before
        records_round = [r.to_dict() for r in FLIGHT.records()]
        round_solves = sum(s["dense_batches"] for s in rec["schedule"])

        # compute_drift: the scraper's ideal repack of every bound pod, once
        # with the kernels (its K1 call captured), once with the plain versions
        drift_captures = []
        seams = dense_module.bucket_cost_packed, fill_module.admission_counts
        capture_kernel_calls(drift_captures)
        try:
            rt.slo_metrics.scrape()
            cluster_cost = slo.CLUSTER_COST.value()
            read_launches()
            drift_captures.clear()
            t0 = time.perf_counter()
            ratio = rt.slo_metrics.compute_drift(actual_cost=cluster_cost)
            sync(dev)
            drift_ms = (time.perf_counter() - t0) * 1e3
            drift_launches = read_launches()
        finally:
            dense_module.bucket_cost_packed, fill_module.admission_counts = seams
        ideal = slo.IDEAL_COST.value()
        drift_holds = hold_kernel_calls(drift_captures, dev)
        drift_k1 = [c for c in drift_captures if c[0] == "bucket_type_cost"]
        drift_k1_ms, drift_k1_why = (
            profiled_device_ms(functools.partial(dense_module.bucket_cost_packed, *drift_k1[0][1]), KERNEL_ITERS, "bucket_cost_kernel")
            if drift_k1 else (None, "compute_drift made no K1 call")
        )
        dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
        try:
            read_launches()  # the timing's launches above
            t0 = time.perf_counter()
            plain_ratio = rt.slo_metrics.compute_drift(actual_cost=cluster_cost)
            sync(dev)
            plain_drift_ms = (time.perf_counter() - t0) * 1e3
            plain_drift_launches = read_launches()
        finally:
            dense_module.bucket_cost_packed, fill_module.admission_counts = seams
        plain_ideal = slo.IDEAL_COST.value()
        records = [r.to_dict() for r in FLIGHT.records()]
        solves = sum(s["dense_batches"] for s in rec["schedule"])

        # the batch's journal and the pending-duration counts
        events = JOURNAL.events(limit=10 * RECORDED_JOURNAL_RING)
        per_pod = Counter(e["entity"] for e in events if e["kind"] == "pod" and e["entity"] in names)
        transitions = Counter(e["event"] for e in events if e["kind"] == "pod" and e["entity"] in names)
        journal_bytes = sum(len(json.dumps(e)) + 1 for e in events)
        stats = JOURNAL.stats()
        waterfall = JOURNAL.waterfall_index()
        waterfall_count = sum(journal.WATERFALL_SEGMENT.count(**labels) for labels in journal.WATERFALL_SEGMENT.series() if labels.get("segment") == "bind")
        pending_count = sum(slo.PENDING_LATENCY.count(**labels) for labels in slo.PENDING_LATENCY.series())

        # in a fresh process: after this script's earlier CUDA-only profiler
        # sessions, a session on the metrics server's thread kept no device
        # events (PERF.md §7)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", PROFILING_CHILD, dev.type, str(profile_dir), str(rt.dense_solver.min_batch)],
            capture_output=True, text=True, timeout=PROFILING_CHILD_TIMEOUT_S, cwd=Path(__file__).resolve().parent,
        )
        check(child.returncode == 0, f"{name}: the profiling child exited {child.returncode}: {child.stderr[-3000:]}")
        profiled = {**json.loads(child.stdout.strip().splitlines()[-1]), "child_wall_ms": (time.perf_counter() - t0) * 1e3}
        planted = planted_divergence(dev, spool)
    finally:
        gc.callbacks.remove(pauses)
        if obs is not None:
            obs.stop()
        for recorder in (JOURNAL, FLIGHT, CAPSULE, SLO):
            recorder.disable()
        if env_before is None:
            os.environ.pop(profiling.ENV_DIR, None)
        else:
            os.environ[profiling.ENV_DIR] = env_before
    on_standing = sum(len(n[1]) for n in got["standing"])
    recorded = {"launched_types": dict(sorted(Counter(t for t, *_rest in got["launched"]).items())), "pods_nominated_onto_standing": on_standing, "price_per_hour": got["price_per_hour"]}
    plain = {k: plain_line[k] for k in recorded}
    wait_ms = (run["done"] - run["t0"]) * 1e3
    # a solve's phases: encode and commit always, the bucket choice's where
    # buckets went to K1, the fill's round trip where a vectorized fill ran
    record_faults = [
        {"id": r["id"], "dispatch": r["dispatch"], "hbm_peak_bytes": r["hbm_peak_bytes"], "compiled_fns": r["compiled_fns"],
         "zero_phases": [k for k in ("encode", "commit") if not r["phases"][k] > 0]
         + [k for k in ("device", "mask", "assemble") if r["signature"]["buckets"] and not r["phases"][k] > 0]
         + (["fill_device"] if r["fill_routing"]["fills_vectorized"] and not r["phases"]["fill_device"] > 0 else [])}
        for r in records
    ]
    record_faults = [f for f in record_faults if f["dispatch"] != "cuda" or f["hbm_peak_bytes"] <= 0 or f["compiled_fns"] or f["zero_phases"]]
    missing_families = up["unrendered"]
    line = {
        "phase": name,
        "config": name,
        "card": card_name,
        "pods": pods_n,
        "standing_nodes": standing,
        "types": HEADLINE_TYPES,
        "min_batch": rt.dense_solver.min_batch,
        "intervals_s": {"invariants": options.invariants_interval, "coherence": options.coherence_interval},
        "construct_ms": construct_ms,
        "start_ms": run["start_ms"],
        "create_ms": (run["created"] - run["t0"]) * 1e3,
        "pods_to_last_nomination_ms": wait_ms,
        "plain_pods_to_last_nomination_ms": plain_line["pods_to_last_nomination_ms"],
        "recorders_share_of_pod_wait": (wait_ms - plain_line["pods_to_last_nomination_ms"]) / wait_ms,
        "stop_ms": run["stop_ms"],
        "bind": {"pods": up["bound"], "ms": up["bind_ms"]},
        "rounds": len(rec["get_pods_ms"]),
        "phases_ms": rec["schedule"][0]["phases_ms"] if rec["schedule"] else None,
        "schedule_ms": [s["wall_ms"] for s in rec["schedule"]],
        "flight": {
            "records": len(records), "dense_solves": solves, "round_records": len(records_round), "round_solves": round_solves,
            "builds_in_round": builds_round, "faults": record_faults,
            "round_record": {k: records_round[0][k] for k in ("dispatch", "phases", "fill_routing", "hbm_peak_bytes", "hbm_live_bytes", "compiled_fns", "signature")} if records_round else None,
        },
        "journal": {
            "events_stored": stats["events_stored"], "events_total": stats["events_total"], "dropped": stats["events_dropped"],
            "bytes": journal_bytes, "pods_with_six": sum(1 for n in names if per_pod.get(n) == len(RECORDED_POD_EVENTS)),
            "transitions": dict(transitions), "waterfall_count": waterfall_count, "waterfall_completed": waterfall["pods_completed"],
            "conservation_violations": waterfall["conservation"]["violations"],
        },
        "slo": {"pending_count": pending_count, "cluster_cost_per_hour": cluster_cost, "pending_pods": SLO.pending_count()},
        "compute_drift": {
            "bound_pods": up["bound"], "wall_ms": drift_ms, "k1_device_ms": drift_k1_ms, "k1_device_ms_missing": drift_k1_why or None,
            "launches": drift_launches, "kernel_holds": drift_holds, "ideal_cost_per_hour": ideal, "ratio": ratio,
            "plain": {"wall_ms": plain_drift_ms, "launches": plain_drift_launches, "ideal_cost_per_hour": plain_ideal, "ratio": plain_ratio},
        },
        "invariants": {"samples": up["report"]["samples"], "violations": up["report"]["violations"], "leaked_after_stop": leaked, "leaked_before": leaked_before, "owners_after_stop": sorted(owners), "watchers_after_stop": watchers, "watchers_baseline": report["watchers"]["baseline"]},
        "coherence": {"divergences": coherence.divergences_total() - divergences_before, "clean_checks": coherence.CHECKS.value(result=coherence.RESULT_CLEAN) - clean_before},
        "capsules_clean_round": capsules_clean,
        "steady_recompile": steady,
        "metrics": {"status": up["metrics_status"], "ms": up["metrics_ms"], "bytes": up["metrics_bytes"], "families": len(up["families"]), "missing": missing_families},
        "debug_status": up["debug"],
        "profiling": profiled,
        "planted_divergence": planted,
        "gc": {"ms": pauses.ms, "full": pauses.full, "longest_ms": pauses.longest_ms},
        "outcome": recorded,
        "plain_outcome": plain,
        "kernel_launches": run["launches"],
        "kernel_holds": holds,
        "broken": run["broken"],
        "healthy": run["healthy"],
        "threads_alive_after_stop": alive,
        "lease_released": released,
    }
    emit(line)
    print(f"{name}: pod wait {wait_ms:.1f} ms with the recorders, {plain_line['pods_to_last_nomination_ms']:.1f} ms without (one run each); "
          f"compute_drift {drift_ms:.1f} ms, its K1 {drift_k1_ms} ms on the card; {len(records)} flight records; "
          f"journal {journal_bytes} bytes; capsule {planted['capsule_bytes']} bytes; on {card_name}", flush=True)
    live, profiled_round = profiled["live"], profiled["round"]
    check(run["healthy"], f"{name}: the Runtime turned unhealthy")
    check(names <= run["nominated"], f"{name}: {len(names - run['nominated'])} of {pods_n} pods never nominated within {RUNTIME_DEADLINE_S} s")
    check(recorded == plain, f"{name}: the recorded round's outcome {recorded} differs from the plain round's {plain}")
    check(run["launches"]["bucket_type_cost"] >= 1 and run["launches"]["warm_fill_counts"] >= 1, f"{name}: the window launched {run['launches']}")
    check(holds and all(h["identical"] for h in holds), f"{name}: a kernel call differs from its plain version: {[h for h in holds if not h['identical']]}")
    check(up["bound"] == pods_n, f"{name}: bound {up['bound']} of {pods_n} pods")
    check(len(records) == solves and solves >= 2, f"{name}: {len(records)} flight records for {solves} dense solves")
    check(not record_faults, f"{name}: flight records without their phases, a cuda dispatch or a device-memory peak, or with a build: {record_faults}")
    check(builds_round == 0, f"{name}: {builds_round} kernel builds inside the timed round")
    check(line["journal"]["pods_with_six"] == pods_n and stats["events_dropped"] == 0, f"{name}: {line['journal']['pods_with_six']} of {pods_n} pods with their six transitions ({dict(transitions)}), {stats['events_dropped']} events dropped")
    check(waterfall_count == pending_count == pods_n, f"{name}: the waterfall counts {waterfall_count} and the SLO {pending_count} pending durations for {pods_n} pods")
    check(line["journal"]["conservation_violations"] == 0, f"{name}: waterfall conservation violations {waterfall['conservation']}")
    check(drift_launches["bucket_type_cost"] == 1 and len(drift_k1) == 1, f"{name}: compute_drift launched {drift_launches}")
    check(drift_holds and all(h["identical"] for h in drift_holds), f"{name}: compute_drift's K1 call differs from its plain version: {drift_holds}")
    check(ideal == plain_ideal and ratio == plain_ratio and ratio is not None, f"{name}: compute_drift's ideal {ideal} / ratio {ratio} against the plain versions' {plain_ideal} / {plain_ratio}")
    check(not any(plain_drift_launches.values()), f"{name}: the plain versions' compute_drift launched {plain_drift_launches}")
    check(up["report"]["samples"] >= 1 and not up["report"]["violations"], f"{name}: the invariant monitor sampled {up['report']['samples']} times with violations {up['report']['violations']}")
    check(not [t for t in leaked if t["owner"] == owner] and owner not in owners, f"{name}: threads leaked after stop(): {leaked}; census owners {sorted(owners)}")
    check(watchers <= report["watchers"]["baseline"], f"{name}: {watchers} watches after stop() against a baseline of {report['watchers']['baseline']}")
    check(line["coherence"]["divergences"] == 0 and line["coherence"]["clean_checks"] >= 1, f"{name}: coherence {line['coherence']}")
    check(capsules_clean == 0 and not planted["clean"]["capsules"], f"{name}: {capsules_clean} capsules captured in the clean round, {planted['clean']['capsules']} in the clean passes")
    check(steady["contract_libraries"] == ["bucket_cost", "warm_fill"] and not steady["violations"] and steady["capsules"] == 0, f"{name}: the steady-recompile cross-check: {steady}")
    check(planted["divergences"] == {planted["expected_kind"]: 1} and planted["captured"] == 1, f"{name}: the planted divergence gave {planted['divergences']} and {planted['captured']} capsules")
    check([c["trigger"] for c in planted["capsules"]] == ["residency-divergence"] and len(planted["capsule_files"]) == 1, f"{name}: capsules {planted['capsules']}, files {planted['capsule_files']}")
    check(planted["capsule_errors"] == [] and planted["inspect_rc"] == 0, f"{name}: the capsule reads back with errors {planted['capsule_errors']}, inspect exit {planted['inspect_rc']}")
    check(planted["launches"]["warm_fill_counts"] >= 1, f"{name}: the planted passes launched {planted['launches']}")
    check(live["status"] == 200 and live["profiler_started"] and live["kernels"] is not None, f"{name}: /debug/pprof/trace answered {live['status']} (profiler started: {live['profiler_started']})")
    check(all(live["kernels"][s] >= 1 for s in KERNEL_SYMBOLS), f"{name}: no live trace of {len(profiled['live_attempts'])} named both kernels: {[a['kernels'] for a in profiled['live_attempts']]} (rounds {[round(a['round_ms']) for a in profiled['live_attempts']]} ms)")
    check(profiled_round["prof_files"] >= 1 and profiled_round["device_traces"] >= 1, f"{name}: maybe_profile_round wrote {profiled_round['prof_files']} .prof files and {profiled_round['device_traces']} device traces")
    check(profiled_round["kernels"] is not None and all(profiled_round["kernels"][s] >= 1 for s in KERNEL_SYMBOLS), f"{name}: no round's device trace of {len(profiled['round_attempts'])} named both kernels: {[a['kernels'] for a in profiled['round_attempts']]}")
    check(up["metrics_status"] == 200 and not missing_families and set(RECORDER_FAMILIES) <= up["families"], f"{name}: /metrics answered {up['metrics_status']}; missing {missing_families or sorted(set(RECORDER_FAMILIES) - up['families'])}")
    check(all(v == 200 for v in up["debug"].values()), f"{name}: debug routes answered {up['debug']}")
    check(not any(run["broken"].values()), f"{name}: the round broke placements: {run['broken']}")
    check(not alive, f"{name}: threads alive after stop(): {alive}")
    check(released, f"{name}: the Lease was not released")
    return line


def real_faults(dev) -> dict:
    """Four real faults on the card, each classified by solver/faults.py's
    classify(): `hbm`, an allocation past torch.cuda.mem_get_info()'s free
    bytes (freed again); `device-lost`, a device-side assert in a child
    process (an out-of-range index on a cuda tensor, then a synchronize:
    the context stays broken, so not in this one), and the same assert met
    by a Runtime's batch loop in a second child, whose loop must end and
    turn healthy() false (DEVICE_LOST_RUNTIME_CHILD); `compile`, nvcc run
    through ops/_cuda_build.py on a one-line broken source in a temporary
    directory (no library is built from it); `kernel`, K1's launch shim
    given R = 9. The shim computes its own launch geometry (threads and
    blocks within its bounds), so no grid it would reject can be passed
    through it; R outside the instantiated 1..8 is the argument it
    rejects, before any launch, with cudaErrorInvalidValue."""
    import tempfile
    from pathlib import Path

    from karpenter_tpu_torch.ops import _cuda_build, bucket_cost
    from karpenter_tpu_torch.solver.faults import classify

    def kind_of(exc):
        fault = classify(exc)
        return {"kind": fault.kind if fault is not None else None, "type": type(exc).__name__, "error": str(exc)[:240]}

    got = {}
    free, total = torch.cuda.mem_get_info(dev)
    try:
        blob = torch.empty((free + (1 << 30),), dtype=torch.uint8, device=dev)
        del blob
        got["hbm"] = {"kind": None, "error": "the allocation succeeded"}
    except Exception as exc:  # noqa: BLE001 - the fault under test
        got["hbm"] = kind_of(exc)
    torch.cuda.empty_cache()
    got["hbm"]["free_bytes"], got["hbm"]["asked_bytes"] = int(free), int(free + (1 << 30))
    got["hbm"]["free_after"] = int(torch.cuda.mem_get_info(dev)[0])

    child = subprocess.run(
        [sys.executable, "-c", DEVICE_LOST_CHILD], capture_output=True, text=True, timeout=DEVICE_LOST_TIMEOUT_S,
        cwd=Path(__file__).resolve().parent,
    )
    lines = [line for line in child.stdout.splitlines() if line.startswith("{")]
    got["device-lost"] = {**(json.loads(lines[-1]) if lines else {"kind": None, "error": child.stderr[-400:]}), "child_rc": child.returncode}
    child = subprocess.run(
        [sys.executable, "-c", DEVICE_LOST_RUNTIME_CHILD], capture_output=True, text=True, timeout=DEVICE_LOST_TIMEOUT_S,
        cwd=Path(__file__).resolve().parent,
    )
    lines = [line for line in child.stdout.splitlines() if line.startswith("{")]
    got["device-lost-runtime"] = {**(json.loads(lines[-1]) if lines else {"error": None, "stderr": child.stderr[-400:]}), "child_rc": child.returncode}

    tmp = Path(tempfile.mkdtemp(prefix="karpenter-broken-"))
    broken = _cuda_build.KernelLibrary("broken", lambda lib: None)
    broken.source, broken.path = tmp / "broken.cu", tmp / "libbroken.so"
    broken.source.write_text("this line is not CUDA C++;\n")
    try:
        broken.build()
        got["compile"] = {"kind": None, "error": "nvcc built the broken source"}
    except Exception as exc:  # noqa: BLE001 - the fault under test
        got["compile"] = kind_of(exc)
    got["compile"]["library_built"] = broken.path.exists()

    lib = bucket_cost.LIBRARY.load()
    B, T, R = 2, 4, 9
    stats = torch.ones((2, B, R), dtype=torch.float32, device=dev)
    caps = torch.ones((T, R), dtype=torch.float32, device=dev)
    prices = torch.ones((T,), dtype=torch.float32, device=dev)
    allowed = torch.ones((B, T), dtype=torch.bool, device=dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bucket_cost_launch(stats.data_ptr(), caps.data_ptr(), prices.data_ptr(), allowed.data_ptr(), out.data_ptr(), B, T, R, stream)
    got["kernel"] = {**kind_of(bucket_cost.launch_error(err)), "cuda_error": int(err), "how": "R = 9 through bucket_cost_launch"}
    sync(dev)  # the context is healthy after it
    return got


def corruption_on_card(dev, kind: str, entry: str, spool) -> dict:
    """One corruption kind injected by a FaultPlan (solver/faults.py) into a
    persistent DenseSolver with the incremental engine and the residency
    auditor on `dev`, over CORRUPTION_NODES standing nodes under one seeded
    churn: warm passes until the next audit is a full shadow (every row
    compared), then the plan (nth 1) at `entry` and one pass: corrupt-device
    perturbs the rebased head on the card, corrupt-row a host-mirror row,
    suppress-delta swallows the journal record of an out-of-band bind. The
    pass must place its 8 pods; then one more pass (a full re-encode after
    the heal). The capsule engine is polled after each pass, spooled under
    `spool`."""
    from pathlib import Path

    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.capsule import CAPSULE, TRIGGER_RESIDENCY
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.controllers.state.cluster import Cluster
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver, audit
    from karpenter_tpu_torch.solver.audit import ResidencyAuditor
    from karpenter_tpu_torch.solver.faults import FAULTS, KIND_SUPPRESS_DELTA, FaultPlan, FaultSpec
    from karpenter_tpu_torch.solver.incremental import IncrementalEngine

    provider = FakeCloudProvider(instance_types(40))
    kube = KubeCluster()
    churn = testing.Churn(kube, PLANTED[1], f"c{kind[:3]}", min_nodes=8)
    churn.seed_nodes(CORRUPTION_NODES)
    cluster = Cluster(kube, None)
    engine = IncrementalEngine(cluster.delta_journal, device=dev)
    auditor = ResidencyAuditor(seed=3)
    solver = DenseSolver(min_batch=1, device=dev, incremental=engine, auditor=auditor)
    passes = []
    advance = engine.advance

    def logged(*args):
        adv = advance(*args)
        passes.append((adv.kind, adv.reason))
        return adv

    engine.advance = logged
    CAPSULE.reset()
    CAPSULE.enable(spool=str(spool))

    def solve(step) -> int:
        pods = testing.rename(
            [testing.make_pod(labels={"app": "planted"}, requests={"cpu": 0.25, "memory": "256Mi"}) for _ in range(8)], f"c{kind[:3]}{step}"
        )
        scheduler = build_scheduler(
            testing.campaign_provisioners(), provider, pods, cluster=cluster,
            state_nodes=cluster.nodes_snapshot(), dense_solver=solver,
        )
        results = scheduler.solve(pods)
        sync(dev)
        CAPSULE.poll()
        return sum(len(n.pods) for n in results.new_nodes) + sum(len(v.pods) for v in results.existing_nodes)

    read_launches()
    placed = [solve(0)]
    step = 1
    while step < 2 or auditor.audits % audit.SHADOW_EVERY != 0:
        churn.step()
        placed.append(solve(step))
        step += 1
    clean = {"divergences": dict(auditor.divergences), "capsules": CAPSULE.captures_total()}
    plan = FaultPlan([FaultSpec(kind=kind, entry=entry, nth=1)])
    FAULTS.install(plan)
    try:
        if kind == KIND_SUPPRESS_DELTA:
            res = engine._resident
            victim = next(n for n in res.names if n not in res.prev_dirty)
            kube.create(testing.make_pod(
                name=f"c{kind[:3]}-suppressed", labels={"app": "standing"}, requests={"cpu": 0.5, "memory": "512Mi"},
                node_name=victim, phase="Running", unschedulable=False,
            ))
        else:
            churn.step()
        placed.append(solve(step))
    finally:
        FAULTS.clear()
    heals = auditor.heals
    churn.step()
    placed.append(solve(step + 1))
    launches = read_launches()
    files = sorted(Path(spool).glob(f"CAPSULE_{TRIGGER_RESIDENCY}_*.json"))
    return {
        "kind": kind,
        "entry": entry,
        "standing_nodes": CORRUPTION_NODES,
        "passes": len(placed),
        "placed": placed,
        "clean_before": clean,
        "fired": plan.corruptions_fired(),
        "history": plan.history(),
        "divergences": dict(auditor.divergences),
        "last_divergence_kinds": (auditor.last_divergence or {}).get("kinds"),
        "last_divergence_fields": [f.get("fields") for f in (auditor.last_divergence or {}).get("findings", [])],
        "heals": heals,
        "pass_after_heal": list(passes[-1]),
        "capsule_files": [f.name for f in files],
        "launches": launches,
    }


def fault_history_run(dev) -> dict:
    """One deterministic run of a mixed FaultPlan (seed 11) on the card:
    FAULT_HISTORY_STEPS batches of FAULT_HISTORY_PODS one-CPU pods onto a
    churning cluster of FAULT_HISTORY_NODES standing nodes through one
    DenseSolver with the incremental engine (K2, then K1 for what
    overflows), the breaker's threshold out of reach. Returns FAULTS.history(), each solve's outcome (placed pods or
    the fault's kind) and the breaker's consecutive count."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.controllers.state.cluster import Cluster
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver.faults import BREAKER, FAULTS, FaultPlan, SolverFault
    from karpenter_tpu_torch.solver.incremental import IncrementalEngine

    provider = FakeCloudProvider(instance_types(40))
    kube = KubeCluster()
    churn = testing.Churn(kube, 9600, "fh", min_nodes=8)
    churn.seed_nodes(FAULT_HISTORY_NODES)
    cluster = Cluster(kube, None)
    solver = DenseSolver(min_batch=1, device=dev, incremental=IncrementalEngine(cluster.delta_journal, device=dev))
    BREAKER.reset()
    BREAKER.configure(threshold=1000)
    FAULTS.install(FaultPlan.from_specs([dict(s) for s in FAULT_HISTORY_SPECS], seed=11))
    outcomes = []
    try:
        for step in range(FAULT_HISTORY_STEPS):
            churn.step()
            pods = testing.rename([testing.make_pod(requests={"cpu": 1, "memory": "2Gi"}) for _ in range(FAULT_HISTORY_PODS)], f"fh{step}")
            scheduler = build_scheduler(
                testing.campaign_provisioners(), provider, pods, cluster=cluster,
                state_nodes=cluster.nodes_snapshot(), dense_solver=solver,
            )
            try:
                results = scheduler.solve(pods)
                outcomes.append(sum(len(n.pods) for n in results.new_nodes) + sum(len(v.pods) for v in results.existing_nodes))
            except SolverFault as fault:
                outcomes.append(fault.kind)
            sync(dev)
        history = FAULTS.plan.history()
    finally:
        FAULTS.clear()
        consecutive = BREAKER.consecutive
        BREAKER.reset()
    return {"history": history, "outcomes": outcomes, "consecutive": consecutive}


def faulted_runtime(dev, tag: str, spool, extra=()):
    """runtime_round's cell (the headline batch, instance_types(500), 300
    standing 16-CPU nodes, parse() defaults with the crossover measured)
    with --enable-solver-telemetry --enable-journal --enable-capsules (its
    spool under `spool`) --solver-incremental and the breaker at threshold
    FAULTED_THRESHOLD, backoff FAULTED_BACKOFF_S, plus `extra` flags: its
    store, pods, catalog, Runtime, instrumented env, the batch's names and
    its write_batch."""
    from types import SimpleNamespace

    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.utils.options import parse

    _name, pods_n, standing = RUNTIME_ROUND_FAULTED
    kube, pods = runtime_store(pods_n, standing, tag)
    catalog = instance_types(HEADLINE_TYPES)
    options = parse([
        "--dense-min-batch", "0", "--enable-solver-telemetry", "--enable-journal", "--enable-capsules",
        "--capsule-spool", str(spool), "--journal-ring-size", str(FAULTED_JOURNAL_RING), "--solver-incremental",
        "--solver-breaker-threshold", str(FAULTED_THRESHOLD), "--solver-breaker-backoff", str(FAULTED_BACKOFF_S), *extra,
    ])
    rt = Runtime(kube=kube, cloud_provider=FakeCloudProvider(catalog), options=options, device=dev)
    env = SimpleNamespace(controller=rt.provisioner, solver=rt.dense_solver, kube=kube, cluster=rt.cluster)
    names = {p.name for p in pods}

    def write_batch():
        t0 = time.perf_counter()
        for pod in pods:
            kube.create(pod)
        return t0, time.perf_counter()

    return kube, catalog, rt, env, names, write_batch


def same_outcome(got, line) -> dict:
    """A Runtime round's outcome against runtime_round's line."""
    from collections import Counter

    return {
        "nodes_launched": len(got["launched"]) == line["nodes_launched"],
        "launched_types": dict(sorted(Counter(t for t, *_rest in got["launched"]).items())) == line["launched_types"],
        "pods_nominated_onto_standing": sum(len(n[1]) for n in got["standing"]) == line["pods_nominated_onto_standing"],
        "price_per_hour": abs(got["price_per_hour"] - line["price_per_hour"]) <= 1e-6 * max(1.0, line["price_per_hour"]),
    }


def runtime_round_faulted(dev, card_name, plain_line) -> dict:
    """The solver fault domain (solver/faults.py) on the card, through
    runtime_round's cell at full width (faulted_runtime):

    - real faults, each classified, and a Runtime whose batch loop ends on
      a device-lost the card raised (real_faults);
    - the breaker end to end: a FaultPlan of device-lost at the "cuda" seam
      (K1's launch), nth 1, count 3, installed once the Runtime is built.
      Three rounds raise typed (SolverDeviceLostError, counted 3 times), the
      breaker opens (one transition, journaled, one breaker-open capsule read
      back by cmd/capsule.py inspect with its fault_domain block). While it
      is open a round the phase triggers raises SolverBreakerOpenError with
      no encode and no K1/K2 launch, every pod stays pending, healthy()
      stays true and the engine records fault-breaker. After the backoff
      the half-open probe runs on the card (K2, then K1), closes the
      breaker and nominates the batch; it is bound, and the outcome must be
      `plain_line`'s; every K1/K2 call is held bit for bit;
    - the same cell with no plan, FAULTED_NO_PLAN_RUNS times: its pod wait
      beside runtime_round's, and its outcome;
    - the budget split: the cell with --solver-hbm-budget 1 (below any peak
      the recorder reads): K1 launches twice in the round, each half held
      bit for bit, the halves' packed result bit-equal to one unsplit launch
      on their operands, the outcome `plain_line`'s, degraded_solves
      {rung="chunked"} 1 and the engine's pending invalidation
      fault-chunked; each half's K1 device time beside the unsplit launch's,
      and the bucket choice's device-memory peak from its host operands,
      split against one launch (the split must hold less);
    - corrupt-device, corrupt-row and suppress-delta injected by plans
      (corruption_on_card), each found once as its kind, one
      residency-divergence capsule, a full re-encode after the heal, no pod
      lost;
    - the same mixed plan and seed twice (fault_history_run): identical
      FAULTS histories."""
    import tempfile
    from pathlib import Path

    from karpenter_tpu_torch import capsule, flight, journal
    from karpenter_tpu_torch.capsule import TRIGGER_BREAKER_OPEN, capsule_errors
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import faults
    from karpenter_tpu_torch.solver.faults import (
        BREAKER, BREAKER_TRANSITIONS, DEGRADED_SOLVES, FAULTS, KIND_DEVICE_LOST, RUNG_CHUNKED, SOLVER_FAULTS,
        STATE_CLOSED, STATE_OPEN, FaultPlan, FaultSpec,
    )
    from karpenter_tpu_torch.utils.clock import Clock

    name, pods_n, standing = RUNTIME_ROUND_FAULTED
    JOURNAL, FLIGHT, CAPSULE = journal.JOURNAL, flight.FLIGHT, capsule.CAPSULE
    work = Path(tempfile.mkdtemp(prefix="karpenter-faulted-"))
    line = {"phase": name, "config": name, "card": card_name, "pods": pods_n, "standing_nodes": standing, "types": HEADLINE_TYPES}
    try:
        # 1. real faults on the card
        line["real_faults"] = real_faults(dev)

        # 2. the breaker, end to end, through the Runtime's rounds
        for recorder in (JOURNAL, FLIGHT, CAPSULE):
            recorder.reset()
        spool = work / "breaker"
        kube, catalog, rt, env, names, write_batch = faulted_runtime(dev, "rtf", spool)
        outcomes, seen = [], []
        provision = rt.provisioner.provision

        def recorded_provision():
            try:
                results = provision()
            except Exception as exc:
                outcomes.append(type(exc).__name__)
                raise
            outcomes.append("ok")
            return results

        rt.provisioner.provision = recorded_provision
        watching = threading.Event()

        def watch_breaker():
            last = None
            while not watching.is_set():
                state = BREAKER.state
                if state != last:
                    seen.append((state, time.perf_counter()))
                    last = state
                time.sleep(0.002)

        watcher = threading.Thread(target=watch_breaker, name="breaker-watch", daemon=True)
        counts_before = {k: SOLVER_FAULTS.value(kind=k) for k in faults.KINDS}
        transitions_before = {s: BREAKER_TRANSITIONS.value(state=s) for s in (STATE_OPEN, "half-open", STATE_CLOSED)}
        plan = FaultPlan([FaultSpec(kind=KIND_DEVICE_LOST, entry="cuda", nth=1, count=FAULTED_THRESHOLD)])
        hold = {}

        def faulted_batch():
            """Create the batch, then, inside the backoff, the checks of the
            open breaker."""
            watcher.start()
            FAULTS.install(plan)
            t0, created = write_batch()
            deadline = time.perf_counter() + FAULTED_OPEN_DEADLINE_S
            while time.perf_counter() < deadline and not (BREAKER.state == STATE_OPEN and len(outcomes) >= FAULTED_THRESHOLD):
                time.sleep(0.005)
            t_open = time.perf_counter()
            hold["faulted_round_launches"] = read_launches()
            hold["outcomes_at_open"] = list(outcomes)
            stats = rt.dense_solver.stats
            batches, encode = stats.batches, stats.encode_seconds
            rt.provisioner.trigger()  # a round while the breaker is open
            while time.perf_counter() < deadline and len(outcomes) < FAULTED_THRESHOLD + 1:
                time.sleep(0.005)
            hold["held_round_ms"] = (time.perf_counter() - t_open) * 1e3
            hold["launches"] = read_launches()
            hold["batches"] = stats.batches - batches
            hold["encode_seconds"] = stats.encode_seconds - encode
            hold["state"] = BREAKER.state
            hold["healthy"] = rt.healthy()
            pending = [p for p in kube.list_pods() if p.name in names and not p.spec.node_name]
            hold["pending"] = len(pending)
            hold["nodes"] = len(kube.list_nodes())
            hold["engine_pending_invalidation"] = rt.dense_solver.incremental._pending_invalidate
            hold["retry_in_s"] = BREAKER.retry_at() - BREAKER.clock.now()
            CAPSULE.poll()
            # the metrics loop's own poll may have drained the trigger first
            # and still be building the capsule: wait for its file
            files = []
            spool_deadline = time.perf_counter() + CAPSULE_SPOOL_WAIT_S
            while not files and time.perf_counter() < spool_deadline:
                files = sorted(spool.glob(f"CAPSULE_{TRIGGER_BREAKER_OPEN}_*.json"))
                if not files:
                    time.sleep(0.05)
            hold["capsule_files"] = [f.name for f in files]
            if files:
                doc = json.loads(files[0].read_text())
                inspect = subprocess.run(
                    [sys.executable, "-m", "karpenter_tpu_torch.cmd.capsule", "inspect", str(files[0])],
                    capture_output=True, text=True, timeout=120, cwd=Path(__file__).resolve().parent,
                )
                hold["capsule"] = {
                    "errors": capsule_errors(doc), "fault_domain": doc.get("fault_domain"),
                    "detail": doc["capsule"]["detail"], "inspect_rc": inspect.returncode,
                    "inspect_breaker": [l for l in inspect.stdout.splitlines() if l.startswith(("breaker", "faults"))],
                }
            return t0, created

        def bind_batch(run):
            t0 = time.perf_counter()
            bound = bind_placed(kube, run["placed"])
            return {"bound": bound, "t_bound": time.perf_counter(), "bind_ms": (time.perf_counter() - t0) * 1e3}

        try:
            run = drive_runtime_round(rt, env, dev, names, faulted_batch, RUNTIME_DEADLINE_S, before_stop=bind_batch)
        finally:
            watching.set()
            watcher.join(timeout=5)
            FAULTS.clear()
        released, holds, got = runtime_reads(rt, kube, run, catalog, dev)
        history = plan.history()
        # the journal serves newest first
        events = [e for e in reversed(JOURNAL.events(limit=FAULTED_JOURNAL_RING)) if e["kind"] == journal.KIND_SOLVER]
        counted = {k: SOLVER_FAULTS.value(kind=k) - counts_before[k] for k in faults.KINDS if SOLVER_FAULTS.value(kind=k) != counts_before[k]}
        transitions = {s: BREAKER_TRANSITIONS.value(state=s) - v for s, v in transitions_before.items()}
        closes = [t for s, t in seen if s == STATE_CLOSED][1:]
        t_closed = closes[0] if closes else None
        bind = run["before_stop"]
        breaker_line = {
            "plan": [{"kind": KIND_DEVICE_LOST, "entry": "cuda", "nth": 1, "count": FAULTED_THRESHOLD}],
            "threshold": FAULTED_THRESHOLD,
            "backoff_s": FAULTED_BACKOFF_S,
            "min_batch": rt.dense_solver.min_batch,
            "round_outcomes": outcomes,
            "history": history,
            "faults_counted": counted,
            "transitions": transitions,
            "states_seen": [s for s, _t in seen],
            "journal": {
                "fault": [e.get("attrs") for e in events if e["event"] == "fault"],
                "degraded": [e.get("attrs") for e in events if e["event"] == "degraded"],
                "breaker": [e["event"] for e in events if e["event"].startswith("breaker-")],
            },
            "hold": hold,
            "engine_invalidations": dict(rt.dense_solver.incremental.invalidations),
            "probe_launches": run["launches"],
            "nominated": len(run["nominated"] & names),
            "bound": bind["bound"],
            "bind_ms": bind["bind_ms"],
            "closed_to_last_nomination_ms": (run["done"] - t_closed) * 1e3 if t_closed else None,
            "closed_to_last_bind_ms": (bind["t_bound"] - t_closed) * 1e3 if t_closed else None,
            "nodes_launched": len(got["launched"]),
            "pods_nominated_onto_standing": sum(len(n[1]) for n in got["standing"]),
            "price_per_hour": got["price_per_hour"],
            "same_as_runtime_round": same_outcome(got, plain_line),
            "kernel_holds": holds,
            "broken": run["broken"],
            "healthy": run["healthy"],
            "lease_released": released,
        }
        line["breaker"] = breaker_line
        line["kernel_launches"] = {k: hold["faulted_round_launches"][k] + hold["launches"][k] + run["launches"][k] for k in run["launches"]}

        # 3. the same cell with no plan installed
        no_plan = []
        for i in range(FAULTED_NO_PLAN_RUNS):
            kube2, catalog2, rt2, env2, names2, write2 = faulted_runtime(dev, f"rtn{i}", work / f"noplan{i}")
            run2 = drive_runtime_round(rt2, env2, dev, names2, write2, RUNTIME_DEADLINE_S)
            _released, holds2, got2 = runtime_reads(rt2, kube2, run2, catalog2, dev)
            no_plan.append({
                "pods_to_last_nomination_ms": (run2["done"] - run2["t0"]) * 1e3,
                "nominated": len(run2["nominated"] & names2),
                "launches": run2["launches"],
                "same_as_runtime_round": same_outcome(got2, plain_line),
                "held": all(h["identical"] for h in holds2) and bool(holds2),
            })
        line["no_plan"] = {"runs": no_plan, "runtime_round_pods_to_last_nomination_ms": plain_line["pods_to_last_nomination_ms"]}

        # 4. the budget split
        degraded_before = DEGRADED_SOLVES.value(rung=RUNG_CHUNKED)
        kube3, catalog3, rt3, env3, names3, write3 = faulted_runtime(dev, "rts", work / "split", extra=("--solver-hbm-budget", "1"))
        run3 = drive_runtime_round(rt3, env3, dev, names3, write3, RUNTIME_DEADLINE_S)
        _released, holds3, got3 = runtime_reads(rt3, kube3, run3, catalog3, dev)
        k1_calls = [c for c in run3["captures"] if c[0] == "bucket_type_cost"]
        split = {"k1_calls": len(k1_calls), "halves": [int(c[1][0].shape[1]) for c in k1_calls]}
        if len(k1_calls) == 2:
            (stats_a, caps, prices, allowed_a), out_a = k1_calls[0][1], k1_calls[0][2]
            (stats_b, _c, _p, allowed_b), out_b = k1_calls[1][1], k1_calls[1][2]
            whole = (torch.cat([stats_a, stats_b], dim=1).contiguous(), caps, prices, torch.cat([allowed_a, allowed_b], dim=0).contiguous())
            one = dense_module.bucket_cost_packed(*whole)
            sync(dev)
            split["packed_equal_to_one_launch"] = bool(torch.equal(torch.cat([out_a, out_b], dim=1), one))
            split["shape"] = [int(whole[0].shape[1]), int(caps.shape[0]), int(caps.shape[1])]
            split["half_device_ms"] = [
                profiled_device_ms(functools.partial(dense_module.bucket_cost_packed, *c[1]), KERNEL_ITERS, "bucket_cost_kernel")[0]
                for c in k1_calls
            ]
            split["unsplit_device_ms"], split["device_ms_missing"] = profiled_device_ms(
                functools.partial(dense_module.bucket_cost_packed, *whole), KERNEL_ITERS, "bucket_cost_kernel"
            )
            # what the split bounds: the bucket choice's device memory from
            # its host operands, one launch against the split's two
            stats_np, allowed_np = whole[0].cpu().numpy(), whole[3].cpu().numpy()

            def dispatch_peak_bytes(dispatch):
                sync(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                dispatch()
                sync(dev)
                return int(torch.cuda.max_memory_allocated(dev) - base)

            split["unsplit_peak_bytes"] = dispatch_peak_bytes(lambda: dense_module.bucket_cost_packed(
                torch.from_numpy(stats_np).to(dev), caps, prices, torch.from_numpy(allowed_np).to(dev)
            ))
            split["split_peak_bytes"] = dispatch_peak_bytes(lambda: rt3.dense_solver._split_dispatch(stats_np, caps, prices, allowed_np))
        split.update({
            "launches": run3["launches"],
            "degraded_chunked": DEGRADED_SOLVES.value(rung=RUNG_CHUNKED) - degraded_before,
            "engine_pending_invalidation": rt3.dense_solver.incremental._pending_invalidate,
            "flight_rungs": [r.rungs for r in FLIGHT.records()[-3:]],
            "kernel_holds": holds3,
            "same_as_runtime_round": same_outcome(got3, plain_line),
            "nominated": len(run3["nominated"] & names3),
        })
        line["budget_split"] = split

        # 5. the corruptions, injected by plans
        line["corruptions"] = [
            corruption_on_card(dev, kind, entry, work / f"corrupt-{kind}") for kind, entry, _found in CORRUPTIONS
        ]

        # 6. determinism
        first, second = fault_history_run(dev), fault_history_run(dev)
        line["determinism"] = {"first": first, "identical": first == second}
    finally:
        FAULTS.clear()
        BREAKER.reset()
        BREAKER.configure(threshold=3, backoff=30.0, clock=Clock())
        for recorder in (JOURNAL, FLIGHT, CAPSULE):
            recorder.disable()
    emit(line)

    real = line["real_faults"]
    for kind in ("hbm", "device-lost", "compile", "kernel"):
        check(real[kind]["kind"] == kind, f"{name}: the real {kind} fault classified as {real[kind]}")
    check(not real["compile"]["library_built"], f"{name}: a library was built from the broken source")
    lost = real["device-lost-runtime"]
    check(
        lost.get("error") == "SolverDeviceLostError" and lost.get("injected") is False and lost.get("healthy") is False
        and lost.get("loop_alive") is False and lost.get("pending") == 40 and lost.get("nodes") == 0,
        f"{name}: a device-lost the card raised did not end the batch loop: {lost}",
    )
    b = breaker_line
    check(b["round_outcomes"][:FAULTED_THRESHOLD] == ["SolverDeviceLostError"] * FAULTED_THRESHOLD, f"{name}: the faulted rounds ended {b['round_outcomes']}")
    check(b["round_outcomes"][FAULTED_THRESHOLD] == "SolverBreakerOpenError", f"{name}: the round while open ended {b['round_outcomes']}")
    check(b["faults_counted"] == {KIND_DEVICE_LOST: FAULTED_THRESHOLD}, f"{name}: faults counted {b['faults_counted']}")
    check(len(b["history"]) == FAULTED_THRESHOLD and all(h["entry"] == "cuda" for h in b["history"]), f"{name}: the plan fired {b['history']}")
    check(b["transitions"] == {STATE_OPEN: 1, "half-open": 1, STATE_CLOSED: 1}, f"{name}: breaker transitions {b['transitions']}")
    check(b["journal"]["breaker"] == ["breaker-opened", "breaker-half-open", "breaker-closed"], f"{name}: journaled {b['journal']['breaker']}")
    check([f["kind"] for f in b["journal"]["fault"]] == [KIND_DEVICE_LOST] * FAULTED_THRESHOLD, f"{name}: journaled faults {b['journal']['fault']}")
    check(any(d.get("reason") == "breaker-open" for d in b["journal"]["degraded"]), f"{name}: no breaker-open hold journaled")
    h = b["hold"]
    check(len(h["capsule_files"]) == 1, f"{name}: breaker-open capsules {h['capsule_files']}")
    cap = h.get("capsule", {})
    check(not cap.get("errors") and cap.get("inspect_rc") == 0, f"{name}: the breaker-open capsule did not read back: {cap}")
    check((cap.get("fault_domain") or {}).get("breaker", {}).get("state") == STATE_OPEN, f"{name}: the capsule's fault_domain {cap.get('fault_domain')}")
    check(h["state"] == STATE_OPEN and h["healthy"], f"{name}: while open the breaker was {h['state']}, healthy {h['healthy']}")
    check(not any(h["launches"].values()) and h["batches"] == 0 and h["encode_seconds"] == 0.0, f"{name}: while open: launches {h['launches']}, batches {h['batches']}")
    check(h["pending"] == pods_n and h["nodes"] == standing, f"{name}: while open {h['pending']} of {pods_n} pods pending, {h['nodes']} nodes")
    check(h["engine_pending_invalidation"] == "fault-breaker", f"{name}: the engine's invalidation {h['engine_pending_invalidation']}")
    check(b["engine_invalidations"].get("fault-breaker") == 1, f"{name}: the engine recorded {b['engine_invalidations']}")
    check(b["probe_launches"]["bucket_type_cost"] >= 1 and b["probe_launches"]["warm_fill_counts"] >= 1, f"{name}: the probe launched {b['probe_launches']}")
    check(b["states_seen"][-1] == STATE_CLOSED and b["closed_to_last_bind_ms"] is not None, f"{name}: the breaker went {b['states_seen']}")
    check(b["nominated"] == pods_n and b["bound"] == pods_n, f"{name}: nominated {b['nominated']}, bound {b['bound']} of {pods_n}")
    check(all(b["same_as_runtime_round"].values()), f"{name}: the recovered round differs from runtime_round: {b['same_as_runtime_round']}")
    check(b["kernel_holds"] and all(x["identical"] for x in b["kernel_holds"]), f"{name}: a kernel call differs from its plain version")
    check(not any(b["broken"].values()) and b["healthy"] and b["lease_released"], f"{name}: broken {b['broken']}, healthy {b['healthy']}")
    for run in line["no_plan"]["runs"]:
        check(run["nominated"] == pods_n and all(run["same_as_runtime_round"].values()) and run["held"], f"{name}: a round with no plan differs: {run}")
    s = line["budget_split"]
    check(s["k1_calls"] == 2 and s["launches"]["bucket_type_cost"] == 2, f"{name}: the budget split launched K1 {s['launches']} ({s['k1_calls']} calls)")
    check(s.get("packed_equal_to_one_launch") is True, f"{name}: the split's packed result differs from one launch")
    check(s.get("split_peak_bytes", 1 << 62) < s.get("unsplit_peak_bytes", 0), f"{name}: the split bounds no memory: {s.get('split_peak_bytes')} against {s.get('unsplit_peak_bytes')}")
    check(s["kernel_holds"] and all(x["identical"] for x in s["kernel_holds"]), f"{name}: a split K1 call differs from its plain version")
    check(s["degraded_chunked"] == 1 and s["engine_pending_invalidation"] == "fault-chunked", f"{name}: chunked {s['degraded_chunked']}, engine {s['engine_pending_invalidation']}")
    check(all(s["same_as_runtime_round"].values()) and s["nominated"] == pods_n, f"{name}: the split round differs: {s['same_as_runtime_round']}")
    for c, (_kind, _entry, found) in zip(line["corruptions"], CORRUPTIONS):
        check(c["fired"] == 1 and c["divergences"] == {found: 1} and c["last_divergence_kinds"] == [found], f"{name}: {c['kind']} found as {c['divergences']}")
        check(c["heals"] == 1 and c["pass_after_heal"] == ["full", "audit"], f"{name}: {c['kind']} healed {c['heals']}, then {c['pass_after_heal']}")
        check(len(c["capsule_files"]) == 1 and c["clean_before"]["capsules"] == 0, f"{name}: {c['kind']} capsules {c['capsule_files']}")
        check(all(p == 8 for p in c["placed"]), f"{name}: {c['kind']} lost pods: {c['placed']}")
    d = line["determinism"]
    check(d["identical"] and d["first"]["history"], f"{name}: the plan's histories differ or are empty: {d}")
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

    def over_grpc(captures):
        """A warm-up and SIDECAR_TRIALS remote solves through
        service.client.SolverClient against service.server.serve() bound to
        127.0.0.1:0 on the card: build_request, gRPC with pickle both ways,
        the server's unpickle, solve and pickle, materialize. Each a (plan,
        record); the timed solves' K1 and K2 calls land in `captures`."""
        try:
            import grpc  # noqa: F401
        except ImportError as exc:
            raise PhaseFailed(f"{name}: grpc is not importable, so the gRPC loopback cannot run: {exc}") from exc
        from karpenter_tpu_torch.service import client as client_module
        from karpenter_tpu_torch.service.client import SolverClient
        from karpenter_tpu_torch.service.server import serve

        grpc_server, port, handler = serve("127.0.0.1:0", device=dev)
        client = SolverClient(f"127.0.0.1:{port}", timeout=GRPC_TIMEOUT_S)
        marks = {}

        def timed(key, fn):
            def run(*args, **kwargs):
                t = time.perf_counter()
                try:
                    out = fn(*args, **kwargs)
                    if key == "server_solve":
                        sync(dev)
                finally:
                    marks[key] = time.perf_counter() - t
                if key == "server":
                    marks["bytes"] = (len(args[0]), len(out))
                return out

            return run

        build, mat = client_module.build_request, client_module.materialize
        client_module.build_request, client_module.materialize = timed("build", build), timed("materialize", mat)
        handler.schedule_bytes, handler.schedule = timed("server", handler.schedule_bytes), timed("server_solve", handler.schedule)
        seams = dense_module.bucket_cost_packed, fill_module.admission_counts
        out = []
        try:
            for trial in range(1 + SIDECAR_TRIALS):
                if trial == 1:
                    capture_kernel_calls(captures)
                handler.dense_solver.stats = DenseSolveStats()
                state_nodes = env.cluster.nodes_snapshot()
                marks.clear()
                read_launches()
                t0 = time.perf_counter()
                results = client.solve(provisioners, instance_types, pods, ctrl.daemonset_pods(), state_nodes, env.kube)
                wall = time.perf_counter() - t0
                launches = read_launches()
                stats = handler.dense_solver.stats
                out.append((sidecar_plan(results), {
                    "wall_ms": wall * 1e3,
                    "build_request_ms": marks["build"] * 1e3,
                    "grpc_and_client_pickle_ms": (wall - marks["build"] - marks["server"] - marks["materialize"]) * 1e3,
                    "server_ms": marks["server"] * 1e3,
                    "server_solve_ms": marks["server_solve"] * 1e3,
                    "server_unpickle_pickle_ms": (marks["server"] - marks["server_solve"]) * 1e3,
                    "materialize_ms": marks["materialize"] * 1e3,
                    "request_bytes": marks["bytes"][0],
                    "response_bytes": marks["bytes"][1],
                    "launches": launches,
                    "phases_ms": {k: getattr(stats, f"{k}_seconds") * 1e3 for k in ("encode", "fill", "fill_device", "device", "mask", "assemble", "device_wait", "commit")},
                }))
        finally:
            dense_module.bucket_cost_packed, fill_module.admission_counts = seams
            client_module.build_request, client_module.materialize = build, mat
            client.close()
            grpc_server.stop(grace=None).wait(timeout=30)
        return out[1:]

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
    grpc_captures = []
    grpc_runs = over_grpc(grpc_captures)
    grpc_holds = hold_kernel_calls(grpc_captures, dev)
    grpc_records = [r for _p, r in grpc_runs]
    plan = runs[-1][0]
    records = [r for _p, r in runs]
    same_runs = all(p == plan for p, _r in runs)
    same_local = all(p == plan for p, _ms in local_runs + cold_runs)
    same_plain = plain_plan == plan
    same_grpc = all(p == plan for p, _r in grpc_runs)

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
        "grpc": {
            "transport": "service.server.serve() on 127.0.0.1:0 and service.client.SolverClient, one process",
            "wall_ms": statistics.median(r["wall_ms"] for r in grpc_records),
            "split_ms": {
                k: statistics.median(r[k] for r in grpc_records)
                for k in ("build_request_ms", "grpc_and_client_pickle_ms", "server_ms", "server_solve_ms", "server_unpickle_pickle_ms", "materialize_ms")
            },
            "request_bytes": grpc_records[-1]["request_bytes"],
            "response_bytes": grpc_records[-1]["response_bytes"],
            "runs": grpc_records,
            "kernel_launches": {k: [r["launches"][k] for r in grpc_records] for k in ("bucket_type_cost", "warm_fill_counts")},
            "kernel_holds": grpc_holds,
            "identical_to_in_process_bytes_path": same_grpc,
        },
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
    for i, r in enumerate(grpc_records):
        check(r["launches"] == {"bucket_type_cost": 1, "warm_fill_counts": 1}, f"{name}: gRPC remote solve {i} launched {r['launches']}")
    check(len(grpc_holds) == 2 * SIDECAR_TRIALS and all(h["identical"] for h in grpc_holds), f"{name}: a kernel call over gRPC differs from its plain version: {grpc_holds}")
    check(same_grpc, f"{name}: the plans over gRPC differ from the in-process bytes path's")
    return line


def lease_released(kube, identity=None) -> bool:
    """The controller's Lease in the server, given up: renewTime zeroed by
    the holder's release (by `identity`, where given)."""
    from karpenter_tpu_torch.kube.leaderelection import LEASE_NAME, LEASE_NAMESPACE

    lease = kube.get("Lease", LEASE_NAME, LEASE_NAMESPACE)
    if lease is None:
        return False
    return lease.spec.renew_time == 0.0 and (identity is None or lease.spec.holder_identity == identity)


def instrument_wire(kube, recording) -> dict:
    """Wrap an HttpKubeClient's one request path: every request counted by
    verb and resource and by thread, each node POST timed (the token
    bucket's wait included), and while `recording.on` is set on the calling
    thread (the round's get_pods) each request's wall and parsed body kept
    for its bytes, counted after the run. Its LISTs too: by thread, their
    count, items and wall (the request and the decode of every item)."""
    rec = {"requests": {}, "requests_by_thread": {}, "lists_by_thread": {}, "node_posts_ms": [], "get_pods_requests": []}
    request, list_kind = kube._request, kube.list

    def timed_list(kind, namespace=None):
        t0 = time.perf_counter()
        out = list_kind(kind, namespace)
        entry = rec["lists_by_thread"].setdefault(threading.current_thread().name, {"lists": 0, "items": 0, "ms": 0.0})
        entry["lists"] += 1
        entry["items"] += len(out)
        entry["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def timed(method, path, body=None):
        t0 = time.perf_counter()
        out = request(method, path, body)
        ms = (time.perf_counter() - t0) * 1e3
        key = wire_request_key(method, path)
        rec["requests"][key] = rec["requests"].get(key, 0) + 1
        thread = threading.current_thread().name
        rec["requests_by_thread"][thread] = rec["requests_by_thread"].get(thread, 0) + 1
        if method == "POST" and path.endswith("/nodes"):
            rec["node_posts_ms"].append(ms)
        if getattr(recording, "on", False):
            rec["get_pods_requests"].append((method, path, ms, out))
        return out

    kube._request, kube.list = timed, timed_list
    return rec


def wire_request_key(method: str, path: str) -> str:
    """A request as "VERB resource" (a subresource after a slash)."""
    from karpenter_tpu_torch.kube.codec import API_REGISTRY

    plurals = {plural for _version, plural, _namespaced in API_REGISTRY.values()}
    parts = [p for p in path.split("?")[0].split("/") if p]
    resource = next((p for p in parts if p in plurals), "?")
    if parts[-1] in ("binding", "eviction"):
        resource += "/" + parts[-1]
    return f"{method} {resource}"


class WireCounts:
    """The wire phases' counts for the shared informers' checks (ROADMAP
    C2), installed on the classes, so that they count every HttpKubeClient
    of the process: in this one (runtime_round_http) or in a controller
    child (WIRE_COUNTED_CONTROLLER, which imports this module). LISTs by
    thread and kind; the requests Topology._count_domains sends on its
    thread, by verb and resource (a Node GET is a bound pod's node the Node
    informer had not decoded yet); the provisioning rounds
    (ProvisionerController.provision); and each client's informers' store
    sizes. Install it before a client is built and uninstall() after."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.lists: dict = {}
        self.topology_requests: dict = {}
        self.rounds = 0
        self.clients: list = []
        self._undo: list = []

    def install(self) -> "WireCounts":
        from karpenter_tpu_torch.controllers.provisioning.provisioner import ProvisionerController
        from karpenter_tpu_torch.kube.client import HttpKubeClient
        from karpenter_tpu_torch.scheduler.topology import Topology

        counts = self
        init, list_kind, request = HttpKubeClient.__init__, HttpKubeClient.list, HttpKubeClient._request
        count_domains, provision = Topology._count_domains, ProvisionerController.provision

        def registered(client, *args, **kwargs):
            init(client, *args, **kwargs)
            with counts.lock:
                counts.clients.append(client)

        def counted_list(client, kind, namespace=None):
            key = f"{threading.current_thread().name} {kind}"
            with counts.lock:
                counts.lists[key] = counts.lists.get(key, 0) + 1
            return list_kind(client, kind, namespace)

        def counted_request(client, method, path, body=None):
            if getattr(counts.local, "topology", False):
                key = wire_request_key(method, path)
                with counts.lock:
                    counts.topology_requests[key] = counts.topology_requests.get(key, 0) + 1
            return request(client, method, path, body)

        def flagged(topology, group):
            counts.local.topology = True
            try:
                return count_domains(topology, group)
            finally:
                counts.local.topology = False

        def counted_provision(controller):
            with counts.lock:
                counts.rounds += 1
            return provision(controller)

        self._undo = [
            (HttpKubeClient, "__init__", init), (HttpKubeClient, "list", list_kind), (HttpKubeClient, "_request", request),
            (Topology, "_count_domains", count_domains), (ProvisionerController, "provision", provision),
        ]
        HttpKubeClient.__init__, HttpKubeClient.list, HttpKubeClient._request = registered, counted_list, counted_request
        Topology._count_domains, ProvisionerController.provision = flagged, counted_provision
        return self

    def uninstall(self) -> None:
        for cls, attr, original in self._undo:
            setattr(cls, attr, original)
        self._undo = []

    def report(self) -> dict:
        with self.lock:
            return {
                "rounds": self.rounds,
                "lists": dict(sorted(self.lists.items())),
                "topology_requests": dict(sorted(self.topology_requests.items())),
                "stores": [
                    {kind: len(informer.store) for kind, informer in sorted(client._informers.items())} for client in self.clients
                ],
            }


# an APIServer in a process of its own for runtime_round_http, driven over
# its stdin: one JSON line answers each command
APISERVER_CHILD = r"""
import json, sys, time
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.kube.apiserver import APIServer
from karpenter_tpu_torch.api.objects import NodeCondition
from karpenter_tpu_torch.kube.codec import API_REGISTRY, from_wire, to_wire

srv = APIServer().start()
create, subscribe = srv.state.create, srv.state.subscribe
node_times, subscribed = [], {}


def timed_create(kind, namespace, wire):
    out = create(kind, namespace, wire)
    if kind == "Node":
        node_times.append(time.time())
    return out


srv.state.create = timed_create


def counted_subscribe(kind, since_rv):
    out = subscribe(kind, since_rv)
    subscribed[kind] = subscribed.get(kind, 0) + 1
    return out


srv.state.subscribe = counted_subscribe


class Writer:
    def create(self, obj):
        create(obj.kind, obj.metadata.namespace if API_REGISTRY[obj.kind][2] else "", to_wire(obj))


writer, batch = Writer(), []
print(json.dumps({"url": srv.url}), flush=True)
for line in sys.stdin:
    cmd, *args = line.split()
    if cmd == "standing":
        testing.standing_cluster(writer, int(args[0]))
        print(json.dumps({"ok": True}), flush=True)
    elif cmd == "provisioner":
        provisioner = testing.make_provisioner()
        if args == ["simulated"]:
            # as the admission webhook leaves it on the simulated cloud
            # (its defaulting hook: on-demand, amd64), so the spec the
            # controllers hash nodes against never changes under them
            from karpenter_tpu_torch.cloudprovider.simulated import SimulatedCloudProvider
            from karpenter_tpu_torch.webhooks import default_provisioner

            default_provisioner(provisioner, SimulatedCloudProvider())
        writer.create(provisioner)
        print(json.dumps({"ok": True}), flush=True)
    elif cmd == "build":
        # build_workload(n), or reclaim_wave_workload(n, seed)
        if args[2:3] == ["reclaim"]:
            pods = testing.reclaim_wave_workload(int(args[0]), seed=int(args[3]))
        else:
            pods = testing.build_workload(int(args[0]))
        batch = testing.rename(pods, args[1])
        print(json.dumps({"ok": True}), flush=True)
    elif cmd == "write":
        t0 = time.time()
        for pod in batch:
            writer.create(pod)
        print(json.dumps({"t0": t0, "t1": time.time()}), flush=True)
    elif cmd == "bind":
        # the kubelet's part for a list of [node, [[namespace, pod], ...]]:
        # each node's one Ready post, and each pod bound to it
        placed, marked = json.load(open(args[0])), 0
        for node_name, pods in placed:
            node = from_wire(srv.state.get("Node", "", node_name), "Node")
            if not node.ready():
                node.status.conditions = [NodeCondition(type="Ready", status="True")]
                srv.state.update("Node", "", node_name, to_wire(node))
                marked += 1
            for namespace, pod_name in pods:
                srv.state.bind(namespace, pod_name, node_name)
        print(json.dumps({"nodes": len(placed), "marked_ready": marked, "pods": sum(len(p) for _n, p in placed)}), flush=True)
    elif cmd == "report":
        print(json.dumps({"node_times": node_times}), flush=True)
    elif cmd == "watches":
        # watch streams by kind: accepted since the start, and open now
        live = {}
        for kind, _q in list(srv.state._watchers):
            live[kind] = live.get(kind, 0) + 1
        print(json.dumps({"opened": subscribed, "live": live}), flush=True)
    elif cmd == "stop":
        srv.state.chaos_kill_watches()
        srv.stop()
        print(json.dumps({"ok": True}), flush=True)
        break
"""


class APIServerChild:
    """kube/apiserver.py's APIServer on 127.0.0.1 in a child process, as a
    cluster's apiserver runs apart from its controllers: its JSON work
    (every LIST copied and encoded, every watch event encoded) does not
    share the controller's interpreter lock. It writes the standing nodes,
    the provisioner and the batch into its own state as other clients'
    writes (a real cluster's pods come from many clients, so they neither
    spend the controller's rate-limited budget nor cross its socket; each
    takes the server's create path: version, journal, watch fan-out), and
    stamps each Node it creates with the wall clock."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", APISERVER_CHILD], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True
        )
        self.url = self._read()["url"]

    def _read(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise PhaseFailed(f"the apiserver process exited ({self.proc.poll()})")
        return json.loads(line)

    def command(self, *words) -> dict:
        self.proc.stdin.write(" ".join(str(w) for w in words) + "\n")
        self.proc.stdin.flush()
        return self._read()

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                self.command("stop")
                self.proc.wait(timeout=30)
            except (OSError, ValueError, PhaseFailed, subprocess.TimeoutExpired):
                pass
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def runtime_round_http(dev, card_name) -> dict:
    """runtime_round's cell over the wire, at RUNTIME_ROUND_HTTP's depth
    (the headline's 10,000 pods on 300 standing nodes x 500 types): an
    APIServer (kube/apiserver.py) on 127.0.0.1 in a process of its own
    (APIServerChild) holds the standing nodes and the provisioner, written
    as other clients' writes;
    the Runtime runs from parse(["--apiserver-url", url]) with the
    reference's defaults (leader election, 1 s idle / 10 s max windows, the
    crossover measured, the client's 200 QPS / 300 burst) on the
    HttpKubeClient that cmd/controller.build_kube_backend builds for that
    flag. Once it is started, the server writes the headline batch and the
    phase waits until every pod is nominated. Measured: pods to last
    nomination, split into the watch's delivery of the last pod to the
    Runtime's Cluster, the round's get_pods (its LIST's request and bytes),
    its schedule and phases and the node POSTs; every request the Runtime
    made, by verb and resource and by thread. Every K1 and K2 call in the
    window is held bit for bit; the outcome (launches by type, pods onto
    standing nodes, $/hour) must equal that of a synchronous
    provision_once() on an in-memory store built the same way, at the
    Runtime's measured min_batch; no node over capacity; after stop() the Runtime's threads end, the Lease
    is released in the server, and the client's watch threads end with the
    server. The client's shared informers (ROADMAP C2), counted by
    WireCounts: check_informer_reads, and the Pod and Node stores holding
    what the server holds (the Node store given NODE_STORE_WAIT_S to take in
    the last launches, its wait reported)."""
    from collections import Counter
    from types import SimpleNamespace

    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.cmd.controller import build_kube_backend
    from karpenter_tpu_torch.controllers.state.cluster import Cluster
    from karpenter_tpu_torch.kube.client import HttpKubeClient
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.utils.options import parse

    name, pods_n, standing = RUNTIME_ROUND_HTTP
    server = APIServerChild()
    kube = rt = reader = None
    counts = WireCounts().install()
    try:
        server.command("standing", standing)
        server.command("provisioner")
        server.command("build", pods_n, "rth")
        names = {f"dp-rth-{i:04d}" for i in range(pods_n)}
        catalog = instance_types(HEADLINE_TYPES)
        options = parse(["--apiserver-url", server.url])
        kube, url = build_kube_backend(options)
        # the checks' reads after the run, apart from the Runtime's budget
        reader = HttpKubeClient(url, qps=1e9, burst=10**9)
        recording = threading.local()
        wire = instrument_wire(kube, recording)
        delivered = {}
        on_pod_event = Cluster._on_pod_event

        def timed_pod_event(self, event):
            on_pod_event(self, event)
            if event.obj.name in names and event.obj.name not in delivered:
                delivered[event.obj.name] = time.perf_counter()

        # the Cluster the Runtime builds registers this handler with its watch
        Cluster._on_pod_event = timed_pod_event
        try:
            t_boot = time.perf_counter()
            rt = Runtime(kube=kube, cloud_provider=FakeCloudProvider(catalog), options=options, device=dev)
            construct_ms = (time.perf_counter() - t_boot) * 1e3
        finally:
            Cluster._on_pod_event = on_pod_event
        min_batch = rt.dense_solver.min_batch
        env = SimpleNamespace(controller=rt.provisioner, solver=rt.dense_solver, kube=reader, cluster=rt.cluster)
        rec = instrument(env, dev)
        timed_get_pods = rt.provisioner.get_pods
        round_starts = []

        def recorded_get_pods():
            round_starts.append(time.perf_counter())
            recording.on = True
            try:
                return timed_get_pods()
            finally:
                recording.on = False

        rt.provisioner.get_pods = recorded_get_pods
        clocks = {}

        def write_batch():
            # the server's wall clock, mapped onto this process's perf_counter
            clocks["perf0"], clocks["wall0"] = time.perf_counter(), time.time()
            written = server.command("write")
            return tuple(clocks["perf0"] + (written[k] - clocks["wall0"]) for k in ("t0", "t1"))

        run = drive_runtime_round(rt, env, dev, names, write_batch, HTTP_ROUND_DEADLINE_S)
        nominated, launches, passes, healthy, broken = (run[k] for k in ("nominated", "launches", "passes", "healthy", "broken"))
        t0, created, done, start_ms, stop_ms, t_stop = (run[k] for k in ("t0", "created", "done", "start_ms", "stop_ms", "t_stop"))
        schedules = list(rec["schedule"])
        # stop() joins each thread for 5 s; a loop in the middle of a pass
        # over the wire ends at its next check of the stop flag
        stragglers = [t.name for t in rt.threads() if t.is_alive()]
        join_deadline = time.perf_counter() + THREAD_JOIN_DEADLINE_S
        for t in rt.threads():
            t.join(timeout=max(0.0, join_deadline - time.perf_counter()))
        joined_ms = (time.perf_counter() - t_stop) * 1e3
        alive = [t.name for t in rt.threads() if t.is_alive()]
        released, holds, got = runtime_reads(rt, reader, run, catalog, dev)
        node_times = [clocks["perf0"] + (w - clocks["wall0"]) for w in server.command("report")["node_times"]]
        watches = server.command("watches")
        server_nodes = len(reader.list_nodes())
        t_nodes = time.perf_counter()
        while len(kube._informers["Node"].store) != server_nodes and time.perf_counter() - t_nodes < NODE_STORE_WAIT_S:
            time.sleep(0.01)
        node_store_wait_ms = (time.perf_counter() - t_nodes) * 1e3
        wire_counts = counts.report()
        stores = {kind: len(informer.store) for kind, informer in sorted(kube._informers.items())}
    finally:
        counts.uninstall()
        for client in (kube, reader):
            if client is not None:
                client.stop()
        server.stop()
    watch_threads = [t for t in (kube._watch_threads if kube is not None else []) if t.is_alive()]
    for t in watch_threads:
        t.join(timeout=5)
    watch_alive = [t.name for t in watch_threads if t.is_alive()]
    list_requests = [(ms, out) for m, _p, ms, out in wire["get_pods_requests"] if m == "GET" and "items" in out]
    list_bytes = [len(json.dumps(out).encode()) for _ms, out in list_requests]
    list_items = [len(out["items"]) for _ms, out in list_requests]
    list_ms = [ms for ms, _out in list_requests]
    wire["get_pods_requests"] = None
    launched_types = dict(sorted(Counter(t for t, *_rest in got["launched"]).items()))
    onto_standing = sum(len(n[1]) for n in got["standing"])
    # the same store in memory, one provision_once() at the same min_batch
    in_memory = runtime_provision_once(dev, min_batch, plain=False, shape=RUNTIME_ROUND_HTTP, tag="rth")
    memory = {
        "launched_types": dict(sorted(Counter(t for t, *_rest in in_memory["launched"]).items())),
        "pods_nominated_onto_standing": sum(len(n[1]) for n in in_memory["standing"]),
        "price_per_hour": in_memory["price_per_hour"],
        "wall_ms": in_memory["wall_ms"],
        "launches": in_memory["launches"],
    }
    same_outcome = {
        "launched_types": launched_types == memory["launched_types"],
        "pods_nominated_onto_standing": onto_standing == memory["pods_nominated_onto_standing"],
        # the same prices summed in another order
        "price_per_hour": abs(got["price_per_hour"] - memory["price_per_hour"]) <= 1e-9 * max(1.0, memory["price_per_hour"]),
    }
    last_delivery = max(delivered.values()) if delivered else None
    first = schedules[0] if schedules else None
    line = {
        "phase": "runtime_round_http",
        "config": name,
        "card": card_name,
        "apiserver": "kube/apiserver.py APIServer on 127.0.0.1, a process of its own",
        "client": {"qps": options.kube_client_qps, "burst": options.kube_client_burst},
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
        "last_pod_delivered_to_cluster_ms": (last_delivery - t0) * 1e3 if last_delivery else None,
        "pods_delivered_to_cluster": len(delivered),
        "first_round_start_ms": (round_starts[0] - t0) * 1e3 if round_starts else None,
        "stop_ms": stop_ms,
        "get_pods_calls": len(rec["get_pods_ms"]),
        "get_pods_ms": rec["get_pods_ms"],
        "get_pods_list_ms": list_ms,
        "get_pods_list_bytes": list_bytes,
        "get_pods_list_items": list_items,
        "schedule_calls": len(schedules),
        "schedule_ms": [s["wall_ms"] for s in schedules],
        "schedule_pods": [s["pods"] for s in schedules],
        "phases_ms": first["phases_ms"] if first else None,
        "launch": rec["launch"],
        "node_posts": len(wire["node_posts_ms"]),
        "node_post_ms_total": sum(wire["node_posts_ms"]),
        "node_post_ms_max": max(wire["node_posts_ms"]) if wire["node_posts_ms"] else None,
        "first_pod_to_last_node_created_ms": (max(node_times) - t0) * 1e3 if node_times else None,
        "nodes_in_cluster_after_last_nomination_ms": run["nodes_known_ms"],
        "requests": dict(sorted(wire["requests"].items())),
        "requests_by_thread": dict(sorted(wire["requests_by_thread"].items())),
        "lists_by_thread": dict(sorted(wire["lists_by_thread"].items())),
        "lists_by_thread_and_kind": wire_counts["lists"],
        "provisioner_rounds": wire_counts["rounds"],
        "provisioner_pod_lists": wire_counts["lists"].get("provisioner Pod", 0),
        "topology_requests": wire_counts["topology_requests"],
        "watch_streams": watches,
        "informer_store_sizes": stores,
        "server_nodes": server_nodes,
        "node_store_wait_ms": node_store_wait_ms,
        "nominated": len(nominated & names),
        "nodes_launched": len(got["launched"]),
        "launched_types": launched_types,
        "pods_nominated_onto_standing": onto_standing,
        "price_per_hour": got["price_per_hour"],
        "in_memory": memory,
        "outcome_equal_to_in_memory": same_outcome,
        "kernel_launches": launches,
        "kernel_holds": holds,
        "passes": passes,
        "broken": broken,
        "healthy": healthy,
        "threads_alive_when_stop_returned": stragglers,
        "threads_joined_ms_after_stop": joined_ms,
        "threads_alive_after_stop": alive,
        "watch_threads_alive_after_server_stop": watch_alive,
        "server_exit_code": server.proc.returncode,
        "lease_released": released,
    }
    emit(line)
    check(healthy, f"{name}: the Runtime turned unhealthy")
    check(names <= nominated, f"{name}: {len(names - nominated)} of {pods_n} pods never nominated within {HTTP_ROUND_DEADLINE_S} s")
    check(len(schedules) == 1 and schedules[0]["pods"] == pods_n, f"{name}: the batch took {len(schedules)} schedules of {[s['pods'] for s in schedules]} pods, expected one of {pods_n}")
    check(list_items and list_items[0] == pods_n, f"{name}: the round's LIST returned {list_items} pods")
    check(passes.get("node", 0) >= 1 and passes.get("disruption", 0) >= 1, f"{name}: the lifecycle and disruption loops did not both pass ({passes})")
    check(launches["bucket_type_cost"] >= 1 and launches["warm_fill_counts"] >= 1, f"{name}: the window launched {launches}")
    check(holds and all(h["identical"] for h in holds), f"{name}: a kernel call differs from its plain version: {[h for h in holds if not h['identical']]}")
    check(all(same_outcome.values()), f"{name}: the outcome differs from the in-memory provision_once()'s: {same_outcome}")
    check(len(wire["node_posts_ms"]) == len(got["launched"]) == len(node_times), f"{name}: {len(wire['node_posts_ms'])} node POSTs, {len(node_times)} nodes created, {len(got['launched'])} launches")
    check(not any(broken.values()), f"{name}: the round broke placements: {broken}")
    check(not alive, f"{name}: threads alive {THREAD_JOIN_DEADLINE_S} s after stop(): {alive}")
    check(released, f"{name}: the Lease was not released in the server")
    check(not watch_alive and server.proc.returncode == 0, f"{name}: watch threads alive after the server stopped: {watch_alive}; server exit {server.proc.returncode}")
    check_informer_reads(name, wire_counts, watches)
    check(stores.get("Pod") == pods_n, f"{name}: the Pod informer's store holds {stores.get('Pod')} pods, the server {pods_n}")
    check(stores.get("Node") == server_nodes, f"{name}: the Node informer's store holds {stores.get('Node')} nodes {NODE_STORE_WAIT_S} s after the round, the server {server_nodes}")
    return line


def check_informer_reads(name: str, counts: dict, watches: dict) -> None:
    """The shared informers' checks of a wire phase (ROADMAP C2), on a
    WireCounts report: at most PROVISIONER_POD_LISTS_PER_ROUND Pod LISTs
    from the provisioner thread a round, no Pod LIST from the topology's
    domain counting (a Node GET there reads a node the cache lacked), and
    one Pod and one Node watch stream of the client open at the server."""
    rounds, pod_lists = counts["rounds"], counts["lists"].get("provisioner Pod", 0)
    check(rounds >= 1 and pod_lists <= PROVISIONER_POD_LISTS_PER_ROUND * rounds, f"{name}: the provisioner thread sent {pod_lists} Pod LISTs in {rounds} rounds")
    topology = counts["topology_requests"]
    check(not any(key.endswith(" pods") for key in topology), f"{name}: the topology's domain counting sent {topology}")
    live = watches.get("live", {})
    check(live.get("Pod") == 1 and live.get("Node") == 1, f"{name}: watch streams open at the server: {live}")


def expected_node_types(results, provider=None, created=None) -> dict:
    """The instance types a controller process's provider (by default the
    entry point's FakeCloudProvider) launches for a solve's new nodes (each
    new node's create replayed on `provider`), by count; and the new nodes
    whose pods request more than that type allocates. Each replayed node
    lands in `created` where given."""
    from collections import Counter

    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.cloudprovider.types import NodeRequest
    from karpenter_tpu_torch.utils import resources as res

    provider = provider or FakeCloudProvider()
    by_name = {it.name(): it for n in results.new_nodes for it in n.instance_type_options}
    types, over = Counter(), 0
    for n in results.new_nodes:
        if not n.pods:
            continue
        node = provider.create(NodeRequest(template=n.template, instance_type_options=n.instance_type_options))
        if created is not None:
            created.append(node)
        type_name = node.metadata.labels[lbl.LABEL_INSTANCE_TYPE]
        types[type_name] += 1
        it = by_name[type_name]
        free = res.subtract(res.subtract(it.resources(), it.overhead()), res.requests_for_pods(*n.pods))
        over += any(v < -1e-6 for v in free.values())
    return {"types": dict(sorted(types.items())), "over_capacity": over}


def in_process_solve(dev, pods, plain: bool, provisioners=None, provider=None, kube=None, cluster=None, min_batch: int = 1, replay=None, created=None) -> tuple:
    """The in-process twin of a controller process's round: one
    build_scheduler(...).solve of `pods` on `provider`'s catalog (by default
    the entry point's FakeCloudProvider and the default provisioner), on
    `cluster`'s nodes where given, with a DenseSolver at `min_batch` on
    `dev`. With plain=True both kernels' plain versions stand in at the
    solve's seams; otherwise every K1 and K2 call is captured and held bit
    for bit against its plain version. The new nodes' types come from their
    creates replayed on `replay` (by default a fresh FakeCloudProvider),
    each replayed node put in `created` where given.
    Returns the record (node types, nodes over capacity, launches,
    unschedulable pods, wall, the node-count guard's fail-opens, the holds)
    and the solve's results."""
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    provisioners = provisioners or [testing.make_provisioner()]
    state_nodes = cluster.nodes_snapshot() if cluster is not None else ()
    solver = DenseSolver(min_batch=min_batch, device=dev)
    saved = dense_module.bucket_cost_packed, fill_module.admission_counts
    captures = []
    if plain:
        dense_module.bucket_cost_packed, fill_module.admission_counts = bucket_type_cost_packed, plain_admission_counts
    else:
        capture_kernel_calls(captures)
    try:
        read_launches()
        t0 = time.perf_counter()
        scheduler = build_scheduler(provisioners, provider or FakeCloudProvider(), pods, kube=kube, cluster=cluster, state_nodes=state_nodes, dense_solver=solver)
        results = scheduler.solve(pods)
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
    finally:
        dense_module.bucket_cost_packed, fill_module.admission_counts = saved
    record = {
        **expected_node_types(results, replay, created),
        "launches": launches,
        "unschedulable": len(results.unschedulable),
        "solve_ms": wall,
        # the dense plan dropped for the exact host loop (the node-count guard)
        "node_guard_failopens": solver.stats.node_guard_failopens,
        "kernel_holds": hold_kernel_calls(captures, dev),
    }
    return record, results


# the entry point as `python -m karpenter_tpu_torch.cmd.controller` runs it
# (runpy, the arguments after the first, which names this script's
# directory), counted by this module's WireCounts; one JSON line on stdout
# when it exits
WIRE_COUNTED_CONTROLLER = r"""
import json, runpy, sys
sys.path.insert(0, sys.argv.pop(1))
import chip_smoke
counts = chip_smoke.WireCounts().install()
sys.argv = ["karpenter_tpu_torch.cmd.controller"] + sys.argv[1:]
try:
    runpy.run_module("karpenter_tpu_torch.cmd.controller", run_name="__main__", alter_sys=True)
finally:
    print(json.dumps({"wire": counts.report()}), flush=True)
"""


def controller_process_http(dev, card_name, command=None, pods_n=None) -> dict:
    """A fresh controller process against an apiserver: an APIServer on
    127.0.0.1 in a process of its own (APIServerChild), and the entry point
    with `--apiserver-url <url> --health-probe-port <free>` as a child on the
    card: by default `karpenter_tpu_torch.cmd.controller` under
    WIRE_COUNTED_CONTROLLER, which runs it as `python -m` does and counts its
    client's requests, or `command`. Boot:
    spawn to both probes answering 200. Then the server writes the default
    provisioner and build_workload(pods_n) (default: CONTROLLER_PROCESS_HTTP's
    10,000 pods) onto the empty cluster, so every pod lands on a new node (K1
    in the child, no K2). Measured: the
    first pod created to the last Node the child POSTs (its first round,
    the crossover measured at boot), the Node count, and SIGTERM to exit 0.
    Held: the multiset of node types equals an in-process
    build_scheduler(...).solve of the same batch on the entry point's
    catalog (the default FakeCloudProvider) with the kernels (each K1 call
    captured and held bit for bit against its plain version, and the
    node-count guard's fail-opens to the host loop recorded) and with the
    plain versions, whose new nodes fit their types; the child's log
    shows one provisioned batch of every pod with none unschedulable and
    its solver on the card; the Lease is released in the server. Under
    WIRE_COUNTED_CONTROLLER, the shared informers' checks
    (check_informer_reads) and the Pod informer's store holding every pod.
    The child is killed and the server stopped on any failure."""
    import signal

    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cloudprovider.fake import default_instance_types
    from karpenter_tpu_torch.kube.client import HttpKubeClient

    name = CONTROLLER_PROCESS_HTTP[0]
    pods_n = pods_n or CONTROLLER_PROCESS_HTTP[1]

    def in_process(plain: bool) -> dict:
        return in_process_solve(dev, testing.rename(testing.build_workload(pods_n), "cph"), plain)[0]

    kernels_solve = in_process(plain=False)
    plain_solve_rec = in_process(plain=True)
    want_nodes = sum(kernels_solve["types"].values())

    server = APIServerChild()
    reader = HttpKubeClient(server.url, qps=1e9, burst=10**9)  # the checks' reads
    port = free_port()
    counted = command is None
    head = [sys.executable, "-c", WIRE_COUNTED_CONTROLLER, ROOT] if counted else list(command)
    argv = head + ["--apiserver-url", server.url, "--health-probe-port", str(port), "--log-level", "info"]
    lines: list = []
    out_lines: list = []
    watches = {}
    proc = log_reader = out_reader = None
    ready_ms = shutdown_ms = t_first = created = None
    node_times, nodes = [], []
    released = False
    try:
        server.command("build", pods_n, "cph")
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        log_reader = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
        log_reader.start()
        out_reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout), daemon=True)
        out_reader.start()
        deadline = t0 + BOOT_DEADLINE_S
        while time.perf_counter() < deadline and proc.poll() is None:
            if probe_status(port, "/healthz") == 200 and probe_status(port, "/readyz") == 200:
                ready_ms = (time.perf_counter() - t0) * 1e3
                break
            time.sleep(0.05)
        if ready_ms is not None:
            server.command("provisioner")
            # the server's wall clock, mapped onto this process's perf_counter
            perf0, wall0 = time.perf_counter(), time.time()
            written = server.command("write")
            t_first = perf0 + (written["t0"] - wall0)
            created = perf0 + (written["t1"] - wall0)
            deadline = time.perf_counter() + HTTP_ROUND_DEADLINE_S
            while time.perf_counter() < deadline and proc.poll() is None:
                node_times = [perf0 + (w - wall0) for w in server.command("report")["node_times"]]
                last = node_times[-1] if node_times else created
                if len(node_times) >= want_nodes and time.perf_counter() - last >= NODES_SETTLE_S:
                    break
                time.sleep(0.25)
            nodes = reader.list_nodes()
            watches = server.command("watches")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=SHUTDOWN_DEADLINE_S)
                shutdown_ms = (time.perf_counter() - t1) * 1e3
            except subprocess.TimeoutExpired:
                pass
            released = lease_released(reader)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        for stream_reader in (log_reader, out_reader):
            if stream_reader is not None:
                stream_reader.join(timeout=10)
        reader.stop()
        server.stop()
    from collections import Counter

    from karpenter_tpu_torch.api import labels as lbl

    log = "".join(lines)
    counts = next((json.loads(s)["wire"] for s in out_lines if s.startswith('{"wire"')), None)
    batches = [
        {"pods": int(m.group(1)), "new_nodes": int(m.group(2)), "launched": int(m.group(3)), "on_existing": int(m.group(4)), "unschedulable": int(m.group(5)), "ms": int(m.group(6))}
        for m in re.finditer(r"provisioned batch: (\d+) pods -> (\d+) new nodes \((\d+) launched\), (\d+) on existing, (\d+) unschedulable in (\d+) ms", log)
    ]
    crossover_line = re.search(r"dispatch rt ([0-9.]+) ms -> min_batch (\d+)", log)
    device = re.search(r"dense_solver=(\S+)", log)
    child_types = dict(sorted(Counter(n.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE) for n in nodes).items()))
    line = {
        "phase": "controller_process_http",
        "config": name,
        "card": card_name,
        "command": ([sys.executable, "-c", "chip_smoke.WIRE_COUNTED_CONTROLLER", ROOT] if counted else head) + argv[len(head):],
        "pods": pods_n,
        "types": len(default_instance_types()),
        "boot_to_ready_ms": ready_ms,
        "probe_round_trip_ms": float(crossover_line.group(1)) if crossover_line else None,
        "min_batch": int(crossover_line.group(2)) if crossover_line else None,
        "solver_device": device.group(1) if device else None,
        "create_ms": (created - t_first) * 1e3 if created else None,
        "first_pod_to_last_node_ms": (node_times[-1] - t_first) * 1e3 if node_times and t_first else None,
        "first_pod_to_first_node_ms": (node_times[0] - t_first) * 1e3 if node_times and t_first else None,
        "nodes": len(nodes),
        "node_types": child_types,
        "batches": batches,
        "shutdown_ms": shutdown_ms,
        "exit_code": proc.returncode if proc is not None else None,
        "lease_released": released,
        "in_process": {"kernels": kernels_solve, "plain": plain_solve_rec},
        "kernel_launches": "in the child (K1's probe at boot, K1 in the round), whose counts this process cannot read",
        "provisioner_rounds": counts["rounds"] if counts else None,
        "provisioner_pod_lists": counts["lists"].get("provisioner Pod", 0) if counts else None,
        "lists_by_thread_and_kind": counts["lists"] if counts else None,
        "topology_requests": counts["topology_requests"] if counts else None,
        "watch_streams": watches,
        "informer_store_sizes": counts["stores"] if counts else None,
        "server_nodes": len(nodes),
        "log_tail": log.splitlines()[-12:],
        # every line of the child's log above info level: warnings, errors and tracebacks
        "log_problems": [s for s in log.splitlines() if s.strip() and not INFO_LINE.match(s)][:LOG_PROBLEMS_KEPT],
    }
    emit(line)
    if proc is not None and proc.returncode != 0:
        print(f"chip_smoke: {name}: the child exited {proc.returncode}; its log above info level:", file=sys.stderr)
        print("\n".join(line["log_problems"]), file=sys.stderr, flush=True)
    check(ready_ms is not None, f"{name}: the probes did not both answer 200 within {BOOT_DEADLINE_S} s (exit {proc.returncode if proc else None})")
    check(device is not None and device.group(1).startswith("cuda"), f"{name}: the child's solver ran on {line['solver_device']}")
    check(kernels_solve["launches"]["bucket_type_cost"] >= 1 and kernels_solve["launches"]["warm_fill_counts"] == 0, f"{name}: the in-process solve launched {kernels_solve['launches']}")
    holds = kernels_solve["kernel_holds"]
    check(holds and all(h["identical"] for h in holds), f"{name}: a kernel call of the in-process solve differs from its plain version: {[h for h in holds if not h['identical']]}")
    check(not any(plain_solve_rec["launches"].values()), f"{name}: the plain versions' solve launched {plain_solve_rec['launches']}")
    check(kernels_solve["types"] == plain_solve_rec["types"], f"{name}: the kernels' and the plain versions' solves chose other types")
    check(kernels_solve["over_capacity"] == 0 and kernels_solve["unschedulable"] == 0, f"{name}: the in-process solve: {kernels_solve}")
    check(sum(b["pods"] for b in batches) == pods_n and all(b["unschedulable"] == 0 for b in batches), f"{name}: the child's batches {batches}")
    check(child_types == kernels_solve["types"], f"{name}: the child launched {child_types}, the in-process solve {kernels_solve['types']}")
    check(released, f"{name}: the Lease was not released in the server")
    check(shutdown_ms is not None and proc.returncode == 0, f"{name}: exit code {proc.returncode} after SIGTERM")
    if counted:
        check(counts is not None, f"{name}: the child printed no request counts")
        check_informer_reads(name, counts, watches)
        stores = counts["stores"]
        check(any(sizes.get("Pod") == pods_n for sizes in stores), f"{name}: no informer's store holds the {pods_n} pods: {stores}")
        check(any(sizes.get("Node") == len(nodes) for sizes in stores), f"{name}: no informer's store holds the server's {len(nodes)} nodes at exit: {stores}")
    return line


# the restart after a real device-lost (ROADMAP C7): controller processes in
# turn against one apiserver, the first ended by a device-side assert in its
# bucket choice (K1's seam), the second started as the first exits. A
# python -c wrapper arms the first: on the card, an out-of-range index inside
# the wrapped K1 call, in the batch loop's thread only, once the boot's
# crossover probe (which launches K1 too) has returned. It prints the
# machine's monotonic clock just before the assert fires.
RESTART_ARMED_CHILD = r"""
import json, sys, threading, time
import torch
from karpenter_tpu_torch.cmd import controller
from karpenter_tpu_torch.kube import leaderelection
from karpenter_tpu_torch.solver import dense

booted = threading.Event()
measure, launch = dense.measure_dense_crossover, dense.bucket_cost_packed
stop_elector = leaderelection.LeaseElector.stop


def measured(*args, **kwargs):
    out = measure(*args, **kwargs)
    booted.set()
    return out


def asserting(stats, caps, prices, allowed):
    if booted.is_set() and threading.current_thread().name == "provisioner":
        print(json.dumps({"t_fault": time.monotonic(), "shape": [stats.shape[1], caps.shape[0], stats.shape[2]]}), flush=True)
        probe = torch.zeros(8, device=stats.device)
        probe[torch.tensor([1 << 20], device=stats.device)].sum().item()
    return launch(stats, caps, prices, allowed)


def timed_stop(self, release=True):
    t0 = time.monotonic()
    try:
        return stop_elector(self, release=release)
    finally:
        print(json.dumps({"t_elector_stop": [t0, time.monotonic()], "release": release}), flush=True)


dense.measure_dense_crossover, dense.bucket_cost_packed = measured, asserting
leaderelection.LeaseElector.stop = timed_stop
sys.exit(controller.main(sys.argv[1:]))
"""
# a controller process on the simulated cloud that outlives it: the Runtime
# on HttpKubeClient(--apiserver-url) and SimulatedCloudProvider over the
# cloud API's sockets (argv[1]), run by cmd/controller.serve. It prints each
# launch_nodes call's placements and each gc sweep's outcome. With an arm
# file named (argv[2]), the batch loop's K1 call asserts on the card once the
# file exists, and the line before the assert counts the warm fill's (K2)
# calls in the armed round.
RESTART_SIM_CHILD = r"""
import json, os, sys, threading, time
import torch
from karpenter_tpu_torch.cloudprovider.simulated import CloudAPIClient, SimulatedCloudProvider
from karpenter_tpu_torch.cmd import controller
from karpenter_tpu_torch.kube import leaderelection
from karpenter_tpu_torch.ops import bucket_cost
from karpenter_tpu_torch.ops import warmfill as ops_warmfill
from karpenter_tpu_torch.runtime import Runtime
from karpenter_tpu_torch.solver import dense, warmfill
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.options import parse

cloud_url, arm_path, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
fills = []
launch, admission = dense.bucket_cost_packed, warmfill.admission_counts
stop_elector = leaderelection.LeaseElector.stop


def say(**fields):
    print(json.dumps(fields), flush=True)


def timed_stop(self, release=True):
    t0 = time.monotonic()
    try:
        return stop_elector(self, release=release)
    finally:
        say(t_elector_stop=[t0, time.monotonic()], release=release)


def armed():
    return bool(arm_path) and os.path.exists(arm_path) and threading.current_thread().name == "provisioner"


def counted_fill(*args, **kwargs):
    if armed():
        fills.append(time.monotonic())
    return admission(*args, **kwargs)


def asserting(stats, caps, prices, allowed):
    if armed():
        say(t_fault=time.monotonic(), fills=len(fills), shape=[stats.shape[1], caps.shape[0], stats.shape[2]])
        probe = torch.zeros(8, device=stats.device)
        probe[torch.tensor([1 << 20], device=stats.device)].sum().item()
    return launch(stats, caps, prices, allowed)


dense.bucket_cost_packed, warmfill.admission_counts = asserting, counted_fill
leaderelection.LeaseElector.stop = timed_stop
options = parse(argv)
kube, url = controller.build_kube_backend(options)
provider = SimulatedCloudProvider(backend=CloudAPIClient(cloud_url), kube=kube, clock=Clock())
rt = Runtime(kube=kube, cloud_provider=provider, options=options, device="cuda")
launch_nodes, sweep = rt.provisioner.launch_nodes, rt.gc.reconcile


def reported_launch(results, ice_failures=None, placed=None):
    mine = [] if placed is None else placed
    n0 = len(mine)
    launched = launch_nodes(results, ice_failures=ice_failures, placed=mine)
    say(
        t=time.monotonic(), placed=[[node, [[p.namespace, p.name] for p in pods]] for node, pods in mine[n0:]],
        launches={"bucket_type_cost": bucket_cost.LAUNCHES, "warm_fill_counts": ops_warmfill.LAUNCHES},
    )
    return launched


def reported_sweep():
    out = sweep()
    say(t=time.monotonic(), gc={k: list(v) for k, v in out.items()}, nodes=len(kube.list_nodes()), instances=len(provider.list_instances()))
    return out


rt.provisioner.launch_nodes, rt.gc.reconcile = reported_launch, reported_sweep
sys.exit(controller.serve(rt, options, url))
"""
# (phase, pods of the empty case's batch and of the standing case's first
# batch, pods of the standing case's second batch). The standing case's
# batches are reclaim_wave_workload's (build_workload's mix without its
# affinity and anti-affinity cohorts: a placed anti-affinity pod sends every
# later batch to the host loop, solver/dense.py presolve)
CONTROLLER_RESTART = ("controller_restart_device_lost", 2000, 1000)
RESTART_EXIT_DEADLINE_S = 120.0
RESTART_SETTLE_S = 60.0  # the standing case's first batch: bound to every node initialized
PROVISIONED_BATCH = re.compile(r"provisioned batch: (\d+) pods -> (\d+) new nodes \((\d+) launched\), (\d+) on existing, (\d+) unschedulable in (\d+) ms")


class ControllerChild:
    """A controller process the phase starts and watches: its log (stderr)
    and the JSON lines its wrapper prints (stdout), each read on a thread of
    its own and stamped with time.monotonic() as it arrives (stderr is line
    buffered). The machine's monotonic clock is the one every process here
    shares: the wrappers' fault stamps and the Lease's times are on it."""

    def __init__(self, argv):
        self.argv = list(argv)
        self.t_spawn = time.monotonic()
        self.proc = subprocess.Popen(self.argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.log, self.out = [], []
        self.t_exit = None
        self.readers = [
            threading.Thread(target=self._read, args=(stream, sink), daemon=True)
            for stream, sink in ((self.proc.stderr, self.log), (self.proc.stdout, self.out))
        ]
        for reader in self.readers:
            reader.start()

    @staticmethod
    def _read(stream, sink) -> None:
        for line in stream:
            sink.append((time.monotonic(), line))

    def records(self) -> list:
        """The wrapper's JSON lines, each with its arrival as `t_seen`."""
        out = []
        for t, line in list(self.out):
            try:
                out.append({**json.loads(line), "t_seen": t})
            except ValueError:
                pass
        return out

    def log_text(self) -> str:
        return "".join(line for _t, line in list(self.log))

    def first_line(self, needle: str):
        """The arrival of the first log line holding `needle`, or None."""
        return next((t for t, line in list(self.log) if needle in line), None)

    def batches(self) -> list:
        """Each 'provisioned batch' log line, with its arrival."""
        out = []
        for t, line in list(self.log):
            m = PROVISIONED_BATCH.search(line)
            if m:
                pods, new, launched, existing, unschedulable, ms = (int(g) for g in m.groups())
                out.append({"t": t, "pods": pods, "new_nodes": new, "launched": launched, "on_existing": existing, "unschedulable": unschedulable, "ms": ms})
        return out

    def wait_ready(self, port: int, deadline_s: float):
        """The instant both probes first answer 200, or None."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and self.proc.poll() is None:
            if probe_status(port, "/healthz") == 200 and probe_status(port, "/readyz") == 200:
                return time.monotonic()
            time.sleep(0.02)
        return None

    def wait_exit(self, deadline_s: float):
        """The exit code within the deadline (its instant in t_exit), else
        None: a process that hangs."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                self.t_exit = time.monotonic()
                return self.proc.returncode
            time.sleep(0.01)
        return None

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for reader in self.readers:
            reader.join(timeout=10)

    def problems(self) -> list:
        """The log's lines above info level: warnings, errors, tracebacks."""
        return [s for s in self.log_text().splitlines() if s.strip() and not INFO_LINE.match(s)][:LOG_PROBLEMS_KEPT]


def server_node_times(server) -> list:
    """The instants, on this machine's monotonic clock, at which the
    apiserver process created each Node (it stamps them with the wall
    clock)."""
    mono0, wall0 = time.monotonic(), time.time()
    return [mono0 + (w - wall0) for w in server.command("report")["node_times"]]


def debug_solver(port: int) -> dict:
    """The successor's flight recorder (/debug/solver): its kernel builds
    and its dense solves' dispatch."""
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/solver", timeout=10) as resp:
            body = json.loads(resp.read())
    except (OSError, ValueError) as err:
        return {"error": str(err)}
    return {
        "compile_events": body.get("compile_events"),
        "compilations_by_fn": body.get("compilations_by_fn"),
        "solves": len(body.get("records", [])),
        "dispatch": sorted({r.get("dispatch") for r in body.get("records", []) if r.get("dispatch")}),
    }


def library_mtimes() -> dict:
    """Each built kernel library's modification time: a rebuild renames a
    new file into place."""
    from karpenter_tpu_torch.ops import bucket_cost, warmfill

    return {lib.path.name: lib.path.stat().st_mtime if lib.path.exists() else None for lib in (bucket_cost.LIBRARY, warmfill.LIBRARY)}


def fault_and_handover(first, successor_argv, server, reader, health_port: int, metrics_port: int, batch: int, want_nodes: int, nodes_before: int, while_booting=None) -> dict:
    """Steps 3 and 4 of a restart case, from the batch written: wait for the
    first process to end (a hang is a failure), read what it left (exit
    code, its fault line, the Lease, the Nodes it created), start the
    successor with `successor_argv` as a supervisor would, and follow it:
    both probes, the Lease won, every pod of the batch in its
    'provisioned batch' log lines (logged once the round's launch_nodes has
    nominated every pod), the Nodes it creates (want_nodes of them, then
    NODES_SETTLE_S with no new one), its flight recorder's builds and
    solves, then SIGTERM to exit 0 and the Lease released.
    `while_booting()`, where given, runs as soon as the successor is
    spawned; what it returns is the result's "while_booting". The successor
    is stopped whatever happens; the caller stops `first`."""
    import signal

    from karpenter_tpu_torch.kube.leaderelection import LEASE_NAME, LEASE_NAMESPACE

    mtimes = library_mtimes()
    rc = first.wait_exit(RESTART_EXIT_DEADLINE_S)
    if rc is None:
        first.stop()
    fault = next((r for r in first.records() if "t_fault" in r), None)
    elector_stop = next((r["t_elector_stop"] for r in first.records() if "t_elector_stop" in r), None)
    lease = reader.get("Lease", LEASE_NAME, LEASE_NAMESPACE)
    first_lease = {
        "holder": lease.spec.holder_identity if lease else None,
        "renew_time": lease.spec.renew_time if lease else None,
        "released": bool(lease and lease.spec.renew_time == 0.0),
    }
    nodes_after_exit = len(server_node_times(server))
    out = {
        "first": {
            "exit_code": rc,
            "hung": rc is None,
            "fault": fault,
            "fault_to_exit_ms": (first.t_exit - fault["t_fault"]) * 1e3 if fault and first.t_exit else None,
            # the teardown joins every loop before the elector's stop, which
            # releases the Lease
            "fault_to_elector_stop_ms": (elector_stop[0] - fault["t_fault"]) * 1e3 if fault and elector_stop else None,
            "elector_stop_ms": (elector_stop[1] - elector_stop[0]) * 1e3 if elector_stop else None,
            "elector_stop_to_exit_ms": (first.t_exit - elector_stop[1]) * 1e3 if elector_stop and first.t_exit else None,
            "stderr_names_device_lost": "SolverDeviceLostError" in first.log_text(),
            "stderr_names_device_side_assert": "device-side assert" in first.log_text(),
            "traceback": "Traceback (most recent call last)" in first.log_text(),
            "aborted": rc is not None and rc < 0,
            "terminate_called": "terminate called" in first.log_text(),
            "nodes_posted": nodes_after_exit - nodes_before,
            "lease": first_lease,
            "batches": first.batches(),
            "log_problems": first.problems(),
        },
    }
    if rc is None:
        return out
    successor = ControllerChild(successor_argv)
    try:
        out["while_booting"] = while_booting() if while_booting is not None else None
        ready = successor.wait_ready(health_port, BOOT_DEADLINE_S)
        t_fault, t_exit = (fault or {}).get("t_fault"), first.t_exit
        done_t, placed_pods, node_times = None, 0, []
        deadline = time.monotonic() + HTTP_ROUND_DEADLINE_S
        while ready is not None and time.monotonic() < deadline and successor.proc.poll() is None:
            if done_t is None:
                total = 0
                for b in successor.batches():
                    total += b["pods"]
                    if total >= batch:
                        done_t = b["t"]
                        break
                placed_pods = total
            node_times = server_node_times(server)[nodes_before:]
            last = node_times[-1] if node_times else None
            if done_t is not None and len(node_times) >= want_nodes and (last is None or time.monotonic() - last >= NODES_SETTLE_S):
                break
            time.sleep(0.25)
        recorder = debug_solver(metrics_port)
        t_term = time.monotonic()
        successor.proc.send_signal(signal.SIGTERM)
        successor_rc = successor.wait_exit(SHUTDOWN_DEADLINE_S)
        lease = reader.get("Lease", LEASE_NAME, LEASE_NAMESPACE)
    finally:
        successor.stop()
    campaign, won = successor.first_line("campaigning"), successor.first_line("leader election won")
    log = successor.log_text()
    device = re.search(r"dense_solver=(\S+)", log)
    crossover_line = re.search(r"dispatch rt ([0-9.]+) ms -> min_batch (\d+)", log)
    out["successor"] = {
        "command": successor_argv,
        "exit_to_ready_ms": (ready - t_exit) * 1e3 if ready else None,
        "lease_wait_ms": (won - campaign) * 1e3 if won and campaign else None,
        "exit_to_leader_ms": (won - t_exit) * 1e3 if won else None,
        "fault_to_last_nomination_ms": (done_t - t_fault) * 1e3 if done_t and t_fault else None,
        "fault_to_last_node_ms": (node_times[-1] - t_fault) * 1e3 if node_times and t_fault else None,
        "fault_to_first_node_ms": (node_times[0] - t_fault) * 1e3 if node_times and t_fault else None,
        "pods_in_batches": placed_pods,
        "batches": successor.batches(),
        "nodes_created": len(node_times),
        "solver_device": device.group(1) if device else None,
        "probe_round_trip_ms": float(crossover_line.group(1)) if crossover_line else None,
        "min_batch": int(crossover_line.group(2)) if crossover_line else None,
        "flight_recorder": recorder,
        "kernel_libraries_rebuilt": library_mtimes() != mtimes,
        "shutdown_ms": (successor.t_exit - t_term) * 1e3 if successor.t_exit else None,
        "exit_code": successor_rc,
        "lease_released": bool(lease and lease.spec.renew_time == 0.0 and lease.spec.holder_identity != first_lease["holder"]),
        "lease_transitions": lease.spec.lease_transitions if lease else None,
        "log_problems": successor.problems(),
    }
    out["successor_records"] = successor.records()
    return out


def restart_case_empty(dev) -> dict:
    """Case `empty`, ROADMAP C7 as written: the first process is the entry
    point itself (cmd.controller.main) under RESTART_ARMED_CHILD, on an
    empty cluster; once both probes answer, the apiserver process writes the
    default provisioner and build_workload(pods); the first round's K1 call
    asserts on the card. The successor is `python -m
    karpenter_tpu_torch.cmd.controller` with the same arguments. Held
    against: the in-process solve of the same batch on the entry point's
    catalog with the kernels (each K1 call held bit for bit)."""
    from collections import Counter

    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.kube.client import HttpKubeClient

    _name, pods_n, _second_batch = CONTROLLER_RESTART
    held, _results = in_process_solve(dev, testing.rename(testing.build_workload(pods_n), "rsa"), plain=False)
    want_nodes = sum(held["types"].values())
    server = APIServerChild()
    reader = HttpKubeClient(server.url, qps=1e9, burst=10**9)  # the checks' reads
    health, metrics = free_port(), free_port()
    args = [
        "--apiserver-url", server.url, "--health-probe-port", str(health), "--metrics-port", str(metrics),
        "--log-level", "info", "--enable-solver-telemetry",
    ]
    first, out, nodes, write = None, {}, [], None
    try:
        server.command("build", pods_n, "rsa")
        first = ControllerChild([sys.executable, "-c", RESTART_ARMED_CHILD, *args])
        ready = first.wait_ready(health, BOOT_DEADLINE_S)
        out["first_boot_to_ready_ms"] = (ready - first.t_spawn) * 1e3 if ready else None
        if ready is not None:
            server.command("provisioner")
            mono0, wall0 = time.monotonic(), time.time()
            written = server.command("write")
            write = mono0 + (written["t0"] - wall0)
            out.update(fault_and_handover(first, CONTROLLER_COMMAND + args, server, reader, health, metrics, pods_n, want_nodes, 0))
            nodes = reader.list_nodes()
    finally:
        if first is not None:
            first.stop()
            if "first" not in out:
                out["first"] = {"exit_code": first.proc.returncode, "log_problems": first.problems()}
        reader.stop()
        server.stop()
    fault = out.get("first", {}).get("fault")
    out["first"]["write_to_fault_ms"] = (fault["t_fault"] - write) * 1e3 if fault and write else None
    out.pop("successor_records", None)
    out.pop("while_booting", None)
    node_types = dict(sorted(Counter(n.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE) for n in nodes).items()))
    return {
        "case": "empty",
        "pods": pods_n,
        **out,
        "nodes": len(nodes),
        "node_types": node_types,
        "in_process": held,
        "outcome_equal": node_types == held["types"],
    }


def sim_price(backend, node) -> float:
    """A simulated-cloud node's $/hour from the cloud's price books, by the
    type, zone and capacity type on its labels."""
    from karpenter_tpu_torch.api import labels as lbl

    labels = node.metadata.labels
    type_name = labels[lbl.LABEL_INSTANCE_TYPE]
    if labels.get(lbl.LABEL_CAPACITY_TYPE) == "spot":
        return backend.spot_prices[(type_name, labels[lbl.LABEL_TOPOLOGY_ZONE])]
    return backend.od_prices[type_name]


def restart_case_standing(dev) -> dict:
    """Case `standing`: a cloud that outlives its controllers. The
    simulated cloud's CloudBackend is served here by CloudAPIService, and
    each controller is RESTART_SIM_CHILD: a Runtime on SimulatedCloudProvider
    over the cloud API's sockets, run by cmd/controller.serve. The first
    process places a first batch on the empty cluster
    (reclaim_wave_workload's); this process binds
    each placement and marks its node Ready (the kubelet's part) and waits
    for the first process to initialize every node. Then the arm file is
    made and a second batch (of another seed) written, which overflows the
    standing room: its
    round runs K2 (the warm fill), then K1, which asserts. While the
    successor boots, the apiserver's state is read; after the run it is
    loaded into an in-memory store and solved in process with the kernels at
    the successor's min_batch (each K1 and K2 call held bit for bit): the
    pods onto standing nodes, the new nodes' types, count and $/hour must be
    the successor's. The successor's recovery sweep must find no ghost and
    no orphan, and no standing node or instance may go."""
    import tempfile
    from collections import Counter
    from pathlib import Path

    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.cloudprovider.simulated import CloudAPIService, SimulatedCloudProvider
    from karpenter_tpu_torch.cloudprovider.simulated.backend import CloudBackend
    from karpenter_tpu_torch.controllers.state.cluster import Cluster
    from karpenter_tpu_torch.kube.client import HttpKubeClient
    from karpenter_tpu_torch.kube.cluster import KubeCluster
    from karpenter_tpu_torch.utils.clock import Clock

    _name, first_n, pods_n = CONTROLLER_RESTART
    backend = CloudBackend(clock=Clock())
    service = CloudAPIService(backend=backend).start()
    server = APIServerChild()
    reader = HttpKubeClient(server.url, qps=1e9, burst=10**9)
    health, metrics = free_port(), free_port()
    args = [
        "--apiserver-url", server.url, "--health-probe-port", str(health), "--metrics-port", str(metrics),
        "--log-level", "info", "--enable-solver-telemetry",
    ]
    scratch = tempfile.TemporaryDirectory()
    arm = Path(scratch.name) / "arm"

    def command(arm_path: str) -> list:
        return [sys.executable, "-c", RESTART_SIM_CHILD, service.url, arm_path, *args]

    def snapshot() -> dict:
        return {"provisioners": reader.list_provisioners(), "nodes": reader.list_nodes(), "pods": reader.list_pods()}

    first, out, standing, instances_before, nodes = None, {}, set(), set(), []
    try:
        server.command("provisioner", "simulated")
        server.command("build", first_n, "rsb1", "reclaim", 42)
        first = ControllerChild(command(str(arm)))
        ready = first.wait_ready(health, BOOT_DEADLINE_S)
        out["first_boot_to_ready_ms"] = (ready - first.t_spawn) * 1e3 if ready else None
        placed = []
        if ready is not None:
            server.command("write")
            deadline = time.monotonic() + HTTP_ROUND_DEADLINE_S
            while time.monotonic() < deadline and first.proc.poll() is None:
                placed = [pair for r in first.records() if "placed" in r for pair in r["placed"]]
                if sum(len(p) for _n, p in placed) >= first_n:
                    break
                time.sleep(0.25)
        out["first_batch"] = {"pods": first_n, "placed": sum(len(p) for _n, p in placed), "nodes": len(placed), "batches": first.batches()}
        if placed and sum(len(p) for _n, p in placed) >= first_n:
            path = Path(scratch.name) / "placed.json"
            path.write_text(json.dumps(placed))
            t0 = time.perf_counter()
            out["first_batch"]["bound"] = server.command("bind", path)
            out["first_batch"]["bind_ms"] = (time.perf_counter() - t0) * 1e3
            # the first process's node controller initializes each node on
            # the stand-in's one Ready post: its writes re-apply their edits
            # to a fresh read (retry_on_conflict), so none may take Ready
            # back, and nothing posts Ready again
            deadline, lost_ready = time.monotonic() + RESTART_SETTLE_S, set()
            while time.monotonic() < deadline:
                standing_nodes = reader.list_nodes()
                lost_ready.update(n.name for n in standing_nodes if not n.ready())
                if all(n.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) == "true" for n in standing_nodes):
                    break
                time.sleep(0.5)
            out["first_batch"]["initialized"] = sum(n.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) == "true" for n in standing_nodes)
            out["first_batch"]["lost_ready"] = sorted(lost_ready)
            # the Ready posts a kubelet would have to make again: one for
            # each node a controller's write took Ready from
            out["first_batch"]["marked_ready_again"] = len(lost_ready)
            out["first_batch"]["settle_ms"] = (time.perf_counter() - t0) * 1e3
            standing = {n.name for n in standing_nodes}
            instances_before = set(backend.instances)
            arm.touch()
            server.command("build", pods_n, "rsb2", "reclaim", 43)
            mono0, wall0 = time.monotonic(), time.time()
            written = server.command("write")
            write = mono0 + (written["t0"] - wall0)
            out.update(fault_and_handover(first, command(""), server, reader, health, metrics, pods_n, 0, len(standing), while_booting=snapshot))
            fault = out["first"]["fault"]
            out["first"]["write_to_fault_ms"] = (fault["t_fault"] - write) * 1e3 if fault else None
            nodes = reader.list_nodes()
    finally:
        if first is not None:
            first.stop()
            if "first" not in out:
                out["first"] = {"exit_code": first.proc.returncode, "log_problems": first.problems()}
        reader.stop()
        server.stop()
        service.stop()
        scratch.cleanup()
    records = out.pop("successor_records", [])
    state = out.pop("while_booting", None)
    sweeps = [r for r in records if "gc" in r]
    placed2 = [pair for r in records if "placed" in r for pair in r["placed"]]
    launches = next((r["launches"] for r in reversed(records) if "launches" in r), None)
    new_nodes = [n for n in nodes if n.name not in standing]
    got = {
        "pods_onto_standing": sum(len(p) for node, p in placed2 if node in standing),
        "node_types": dict(sorted(Counter(n.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE) for n in new_nodes).items())),
        "nodes": len(new_nodes),
        "price_per_hour": sum(sim_price(backend, n) for n in new_nodes),
    }
    held = None
    if state is not None and out.get("successor", {}).get("min_batch"):
        kube = KubeCluster(clock=Clock())
        for obj in state["provisioners"] + state["nodes"] + state["pods"]:
            kube.create(obj)
        provider = SimulatedCloudProvider(backend=CloudBackend(clock=Clock()), kube=kube, clock=Clock())
        cluster = Cluster(kube, provider, clock=Clock())
        pending = [p for p in state["pods"] if not p.spec.node_name]
        created = []  # the new nodes' creates, replayed on a cloud of their own
        replay = SimulatedCloudProvider(backend=CloudBackend(clock=Clock()), clock=Clock())
        record, results = in_process_solve(
            dev, pending, plain=False, provisioners=state["provisioners"], provider=provider, kube=kube,
            cluster=cluster, min_batch=out["successor"]["min_batch"], replay=replay, created=created,
        )
        cluster.detach()
        held = {
            **record,
            "pending": len(pending),
            "pods_onto_standing": sum(len(v.pods) for v in results.existing_nodes),
            "nodes": len(created),
            "price_per_hour": sum(sim_price(backend, n) for n in created),
        }
    outcome_equal = held is not None and {
        "pods_onto_standing": got["pods_onto_standing"] == held["pods_onto_standing"],
        "node_types": got["node_types"] == held["types"],
        "nodes": got["nodes"] == sum(held["types"].values()),
        "price_per_hour": abs(got["price_per_hour"] - held["price_per_hour"]) <= 1e-9 * max(1.0, held["price_per_hour"]),
    }
    survivors = {n.name for n in nodes if n.metadata.deletion_timestamp is None}
    registered = {n.spec.provider_id.rsplit("/", 1)[-1] for n in nodes if n.spec.provider_id}
    return {
        "case": "standing",
        "pods": pods_n,
        **out,
        "recovery_sweep": sweeps[0] if sweeps else None,
        "sweeps": len(sweeps),
        "standing_nodes": len(standing),
        "standing_nodes_lost": sorted(standing - survivors),
        "instances_lost": sorted(instances_before - set(backend.instances)),
        "instances_without_node": sorted(set(backend.instances) - registered),
        "successor_launches": launches,
        "outcome": got,
        "in_process": held,
        "outcome_equal": outcome_equal,
    }


def controller_restart_device_lost(dev, card_name) -> dict:
    """The restart after a real device-lost (ROADMAP C7), in two cases
    (restart_case_empty, restart_case_standing): in each, a device-side
    assert on the card in the first controller process's bucket choice
    ends its batch loop (a device-lost the card raised ends the loop:
    solver/faults.py ends_the_loop); the process must exit non-zero within
    RESTART_EXIT_DEADLINE_S, having POSTed no Node of the batch, and this
    process starts the successor as it exits. Measured: the fault to the
    exit, the exit to both probes, the Lease wait, the fault to the last
    nomination and to the last Node. Held: the successor places every pod
    with none unschedulable, with the outcome of the in-process solve with
    the kernels (each kernel call held bit for bit), its solver on the card,
    no kernel build (its flight recorder, and the libraries' mtimes), exit 0
    on SIGTERM with the Lease released; in the standing case the first
    process's armed round ran K2 before K1, the recovery sweep found no
    ghost and no orphan, and no standing node or instance went."""
    name = CONTROLLER_RESTART[0]
    cases = {"empty": restart_case_empty(dev), "standing": restart_case_standing(dev)}
    line = {"phase": name, "card": card_name, "cases": cases}
    emit(line)
    for case, c in cases.items():
        first, successor = c.get("first", {}), c.get("successor")
        tag = f"{name}/{case}"
        if first.get("hung") or first.get("exit_code") == 0:
            print(f"chip_smoke: {tag}: the first process exited {first.get('exit_code')}; its log above info level:", file=sys.stderr)
            print("\n".join(first.get("log_problems", [])), file=sys.stderr, flush=True)
        check(c.get("first_boot_to_ready_ms") is not None, f"{tag}: the first process's probes did not both answer 200")
        check(not first.get("hung"), f"{tag}: the first process did not exit within {RESTART_EXIT_DEADLINE_S} s of its fault")
        check(first.get("fault") is not None, f"{tag}: the armed K1 call never ran")
        check(first.get("exit_code") not in (None, 0), f"{tag}: the first process exited {first.get('exit_code')} after its device-lost")
        check(first.get("stderr_names_device_lost") and first.get("stderr_names_device_side_assert"), f"{tag}: the first process's log names no SolverDeviceLostError from a device-side assert")
        check(first.get("nodes_posted") == 0, f"{tag}: the first process POSTed {first.get('nodes_posted')} Nodes of the faulted batch")
        check(successor is not None, f"{tag}: no successor ran")
        check(successor["exit_to_ready_ms"] is not None, f"{tag}: the successor's probes did not both answer 200")
        check(successor["lease_wait_ms"] is not None, f"{tag}: the successor never won the Lease")
        check(successor["pods_in_batches"] >= c["pods"] and all(b["unschedulable"] == 0 for b in successor["batches"]), f"{tag}: the successor's batches {successor['batches']}")
        check(successor["solver_device"] is not None and successor["solver_device"].startswith("cuda"), f"{tag}: the successor's solver ran on {successor['solver_device']}")
        recorder = successor["flight_recorder"]
        check(recorder.get("compile_events") == 0 and not successor["kernel_libraries_rebuilt"], f"{tag}: the successor built kernels: {recorder}")
        check(recorder.get("solves", 0) >= 1 and recorder.get("dispatch") == ["cuda"], f"{tag}: the successor's flight recorder: {recorder}")
        check(successor["exit_code"] == 0 and successor["lease_released"], f"{tag}: the successor exited {successor['exit_code']} on SIGTERM, Lease released {successor['lease_released']}")
        holds = (c.get("in_process") or {}).get("kernel_holds") or []
        check(holds and all(h["identical"] for h in holds), f"{tag}: a kernel call of the in-process solve differs from its plain version: {[h for h in holds if not h['identical']]}")
        check(c["in_process"]["unschedulable"] == 0 and c["in_process"]["over_capacity"] == 0, f"{tag}: the in-process solve: {c['in_process']}")
    empty, standing = cases["empty"], cases["standing"]
    check(empty["outcome_equal"], f"{name}/empty: the successor launched {empty['node_types']}, the in-process solve {empty['in_process']['types']}")
    check(empty["in_process"]["launches"]["bucket_type_cost"] >= 1, f"{name}/empty: the in-process solve launched {empty['in_process']['launches']}")
    first_batch = standing["first_batch"]
    check(first_batch.get("initialized") == first_batch["nodes"] == standing["standing_nodes"], f"{name}/standing: the first batch's nodes were not all initialized before the second batch: {first_batch}")
    check(first_batch.get("marked_ready_again") == 0 and first_batch.get("lost_ready") == [], f"{name}/standing: a node lost the stand-in's one Ready post: {first_batch}")
    check(standing["first"]["fault"].get("fills", 0) >= 1, f"{name}/standing: the armed round ran no warm fill before K1")
    check(standing["outcome_equal"] and all(standing["outcome_equal"].values()), f"{name}/standing: the successor's outcome {standing['outcome']} differs from the in-process solve's: {standing['outcome_equal']}")
    launches = standing["in_process"]["launches"]
    check(launches["bucket_type_cost"] >= 1 and launches["warm_fill_counts"] >= 1, f"{name}/standing: the in-process solve launched {launches}")
    sweep = standing["recovery_sweep"]
    check(sweep is not None and not sweep["gc"]["orphans"] and not sweep["gc"]["ghosts"], f"{name}/standing: the successor's recovery sweep: {sweep}")
    check(not standing["standing_nodes_lost"] and not standing["instances_lost"] and not standing["instances_without_node"], f"{name}/standing: lost nodes {standing['standing_nodes_lost']}, instances {standing['instances_lost']}, instances with no node {standing['instances_without_node']}")
    return line


def bind_with_retries(kube, placed) -> dict:
    """bind_placed as a kube-scheduler does it under conflicts: each pod is
    read back from the store (a stale read may answer) and bound; a bind
    that loses to a 409 is read again and retried until it lands (a lost
    attempt leaves the stored pod as it was: only a write that lands is
    stored and seen by the watches). Returns the bindings made and the
    conflicts caught."""
    from karpenter_tpu_torch.kube.cluster import Conflict

    bound = caught = 0
    for node_name, pod_list in placed:
        for placed_pod in pod_list:
            for _attempt in range(8):
                pod = kube.get("Pod", placed_pod.name, placed_pod.namespace)
                if pod is None:
                    break
                try:
                    kube.bind_pod(pod, node_name)
                    bound += 1
                    break
                except Conflict:
                    caught += 1
    return {"bound": bound, "conflicts_caught": caught}


def runtime_round_kube_chaos(dev, card_name, plain_line) -> dict:
    """The control-plane fault domain (kube/chaos.py) on runtime_round's
    cell: the same store, batch and catalog, the crossover runtime_round
    measured, with --enable-journal, --coherence-interval 1 and a short
    Lease, under a seeded KubeFaultPlan (KUBE_CHAOS_SPECS: conflicts on the
    batch's binds, one stale read). The batch is created inside a watch gap
    whose events a forced compaction drops, so the Runtime's informers learn
    of it from the relist. Once it is nominated, the batch is bound by a
    stand-in for the kube-scheduler that retries its conflicts, the Lease
    is stolen, and the phase waits until the Runtime has won it back and
    run its recovery. Held: runtime_round's outcome (launches by type, pods
    onto standing nodes, $/hour), no lost pod (every batch pod bound to a
    node in the store), no node launched twice, every K1/K2 call bit for bit,
    zero informer divergences at quiesce, the plan's conflicts counted in
    karpenter_kube_conflicts_total, and `watch-gap` and `relist` in the
    journal."""
    import hashlib
    from types import SimpleNamespace

    from karpenter_tpu_torch import journal
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.kube import chaos
    from karpenter_tpu_torch.kube.coherence import COHERENCE, divergences_total
    from karpenter_tpu_torch.kube.leaderelection import steal_lease
    from karpenter_tpu_torch.runtime import Runtime
    from karpenter_tpu_torch.utils.options import parse

    name, pods_n, standing = RUNTIME_ROUND_KUBE_CHAOS
    kube, pods = runtime_store(pods_n, standing, "rkc")
    catalog = instance_types(HEADLINE_TYPES)
    provider = FakeCloudProvider(catalog)
    options = parse([
        "--dense-min-batch", str(plain_line["min_batch"]), "--enable-journal", "--journal-ring-size", str(KUBE_CHAOS_JOURNAL_RING),
        "--coherence-interval", "1", "--lease-duration", KUBE_CHAOS_LEASE[0], "--lease-renew-period", KUBE_CHAOS_LEASE[1],
    ])
    rt = Runtime(kube=kube, cloud_provider=provider, options=options, device=dev)
    env = SimpleNamespace(controller=rt.provisioner, solver=rt.dense_solver, kube=kube, cluster=rt.cluster)
    names = {p.name for p in pods}
    JOURNAL = journal.JOURNAL
    plan = chaos.KubeFaultPlan.from_specs(list(KUBE_CHAOS_SPECS), seed=KUBE_CHAOS_SEED)
    conflicts_before, divergences_before = chaos.conflicts_total(), divergences_total()

    def write_batch():
        # the batch lands inside a watch gap, and a forced compaction drops
        # the gap's events: the informers learn of it from the relist
        t0 = time.perf_counter()
        kube.chaos_watch_gap_begin()
        for pod in pods:
            kube.create(pod)
        kube.chaos_compact()
        kube.chaos_watch_gap_end()
        return t0, time.perf_counter()

    def after_round(run):
        t_bind = time.perf_counter()
        binding = bind_with_retries(kube, run["placed"])
        bind_ms = (time.perf_counter() - t_bind) * 1e3
        t_steal = time.perf_counter()
        stolen = steal_lease(kube, identity="kube-chaos-thief")
        lost = regained = False
        deadline = time.perf_counter() + KUBE_CHAOS_DEADLINE_S
        while time.perf_counter() < deadline and rt.healthy():
            lost = lost or not rt.elector.is_leader()
            if lost and rt.elector.is_leader() and rt._may_act():
                regained = True
                break
            time.sleep(0.02)
        regain_ms = (time.perf_counter() - t_steal) * 1e3
        standing_divergences = COHERENCE.final_check(timeout=10.0)
        return {
            "binding": binding, "bind_ms": bind_ms, "stolen": stolen, "deposed": lost, "regained": regained,
            "regain_ms": regain_ms, "standing_divergences": [str(d) for d in standing_divergences],
        }

    chaos.KUBE_CHAOS.install(plan)
    try:
        run = drive_runtime_round(rt, env, dev, names, write_batch, RUNTIME_DEADLINE_S, before_stop=after_round)
    finally:
        chaos.KUBE_CHAOS.clear()
        kube_events = [(e["entity"], e["event"], e["attrs"]) for e in reversed(JOURNAL.events(limit=KUBE_CHAOS_JOURNAL_RING)) if e["kind"] == journal.KIND_KUBE]
        JOURNAL.disable()
        JOURNAL.reset()
    after = run["before_stop"]
    released, holds, got = runtime_reads(rt, kube, run, catalog, dev)
    same = same_outcome(got, plain_line)
    history = plan.history()
    launched_names = [n for n, _pods in run["placed"] if kube.get_node(n) is not None and kube.get_node(n).spec.provider_id]
    pods_now = {p.name: p for p in kube.list_pods()}
    lost_pods = sorted(n for n in names if not pods_now[n].spec.node_name or kube.get_node(pods_now[n].spec.node_name) is None)
    line = {
        "phase": name,
        "card": card_name,
        "pods": pods_n,
        "standing_nodes": standing,
        "types": HEADLINE_TYPES,
        "min_batch": plain_line["min_batch"],
        "specs": list(KUBE_CHAOS_SPECS),
        "seed": KUBE_CHAOS_SEED,
        "create_in_gap_ms": (run["created"] - run["t0"]) * 1e3,
        "pods_to_last_nomination_ms": (run["done"] - run["t0"]) * 1e3,
        "runtime_round_pods_to_last_nomination_ms": plain_line["pods_to_last_nomination_ms"],
        "nominated": len(run["nominated"] & names),
        "nodes_launched": len(got["launched"]),
        "pods_nominated_onto_standing": sum(len(n[1]) for n in got["standing"]),
        "price_per_hour": got["price_per_hour"],
        "same_outcome": same,
        "binding": after["binding"],
        "bind_ms": after["bind_ms"],
        "lease": {"stolen": after["stolen"], "deposed": after["deposed"], "regained": after["regained"], "regain_ms": after["regain_ms"]},
        "kube_faults_injected": plan.fired(),
        "kube_conflicts_total": chaos.conflicts_total() - conflicts_before,
        "history_digest": hashlib.sha256(json.dumps(history, sort_keys=True).encode()).hexdigest()[:16],
        "history": history,
        "journal_kube_events": kube_events,
        "lost_pods": len(lost_pods),
        # a node name placed twice, or a cloud create with no node of its own
        "double_launches": (len(launched_names) - len(set(launched_names))) + (len(provider.create_calls) - len(set(launched_names))),
        "informer_divergences": len(after["standing_divergences"]) + divergences_total() - divergences_before,
        "kernel_launches": run["launches"],
        "kernel_holds": holds,
        "broken": run["broken"],
        "healthy": run["healthy"],
        "lease_released": released,
    }
    emit(line)
    faults = [h["fault"] for h in history if "fault" in h]
    actions = [h["action"] for h in history if "action" in h]
    events = [e[1] for e in kube_events]
    gap_events = [e for e in events if e in ("watch-gap", "relist")]
    check(run["healthy"], f"{name}: the Runtime turned unhealthy")
    check(names <= run["nominated"], f"{name}: {len(names - run['nominated'])} of {pods_n} pods never nominated")
    check(all(same.values()), f"{name}: the outcome differs from runtime_round's: {same}")
    check(line["lost_pods"] == 0, f"{name}: lost pods {lost_pods[:10]}")
    check(line["double_launches"] == 0, f"{name}: a node launched twice ({len(provider.create_calls)} creates, {len(launched_names)} launched)")
    check(line["informer_divergences"] == 0, f"{name}: informer divergences {after['standing_divergences']}")
    check(after["binding"]["bound"] == pods_n, f"{name}: bound {after['binding']['bound']} of {pods_n}")
    check(faults.count("conflict") == 5 and faults.count("stale-read") == 1, f"{name}: the plan fired {faults}")
    check(line["kube_conflicts_total"] == after["binding"]["conflicts_caught"] == 5, f"{name}: conflicts counted {line['kube_conflicts_total']}, caught {after['binding']['conflicts_caught']}")
    check(actions == ["watch-gap-begin", "compact", "watch-gap-end", "lease-steal"], f"{name}: the plan recorded actions {actions}")
    check(gap_events == ["watch-gap", "relist"], f"{name}: the journal's watch-gap events {kube_events}")
    check(events.count("conflict-storm") == 5 and "lease-lost" in events, f"{name}: the journal's kube events {kube_events}")
    check(after["stolen"] and after["deposed"] and after["regained"], f"{name}: the lease steal {line['lease']}")
    check(run["launches"]["bucket_type_cost"] >= 1 and run["launches"]["warm_fill_counts"] >= 1, f"{name}: the window launched {run['launches']}")
    check(holds and all(h["identical"] for h in holds), f"{name}: a kernel call differs from its plain version: {[h for h in holds if not h['identical']]}")
    check(not any(run["broken"].values()), f"{name}: the round broke placements: {run['broken']}")
    check(released, f"{name}: the Lease was not released")
    return line


def scenario_campaign(dev, card_name) -> dict:
    """The scenario campaign (scenarios/) through CampaignRunner on the
    card: SCENARIO_RUNS, each a live Runtime with its own threads, batcher,
    interruption loop and disruption orchestrator, the workload stand-in
    around it, each scenario on the dense path (`dense_solver=True`: K1 and
    K2 carry every batch). smoke_burst on both cloud transports; device_fault_storm (the
    breaker opened by injected device-lost faults, the burst held and solved
    by the recovery probe) and watch_gap_storm (watch gaps, a compaction and
    a 409 storm on node registration) in process. Each run's document
    validates through scenario_doc_errors, converges, and has every zero
    score zero; each run launches K1, the phase K2; every K1/K2 call of each
    run is captured and held bit for bit. Artifacts go to a temporary
    directory."""
    import dataclasses
    import tempfile

    from karpenter_tpu_torch.scenarios import CampaignRunner, default_campaign, scenario_doc_errors, smoke_campaign
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    by_name = {s.name: s for s in default_campaign() + smoke_campaign()}
    runs, seams = [], (dense_module.bucket_cost_packed, fill_module.admission_counts)
    with tempfile.TemporaryDirectory() as out:
        for scenario_name, transports in SCENARIO_RUNS:
            for transport in transports:
                runner = CampaignRunner(out_dir=out, transports=(transport,), device=str(dev))
                captures = []
                capture_kernel_calls(captures)
                read_launches()
                t0 = time.perf_counter()
                try:
                    (doc,) = runner.run([dataclasses.replace(by_name[scenario_name], dense_solver=True)])
                finally:
                    dense_module.bucket_cost_packed, fill_module.admission_counts = seams
                wall_s = time.perf_counter() - t0
                sync(dev)
                launches = read_launches()
                holds = hold_kernel_calls(captures, dev)
                (run,) = doc["runs"]
                scores = run["scores"]
                runs.append({
                    "scenario": scenario_name,
                    "transport": transport,
                    "converged": run["converged"],
                    "doc_errors": scenario_doc_errors(doc),
                    "wall_s": wall_s,
                    "duration_s": run["duration_seconds"],
                    "zero_scores": {k: scores[k] for k in SCENARIO_ZERO_SCORES},
                    "pods": [scores["pods_bound"], scores["pods_desired"]],
                    "pending_latency_s": scores["pending_latency_seconds"],
                    "solver_faults": [scores["solver_faults_injected"], scores["solver_faults_total"]],
                    "breaker_state": scores["breaker_state"],
                    "kube": [scores["kube_faults_injected"], scores["kube_conflicts_total"]],
                    "capsule_triggers": sorted(scores["capsule_triggers"]),
                    "kernel_launches": launches,
                    "kernel_calls_held": len(holds),
                    "kernel_calls_identical": sum(h["identical"] for h in holds),
                })
    line = {"phase": "scenario_campaign", "card": card_name, "runs": runs}
    emit(line)
    for r in runs:
        where = f"scenario_campaign {r['scenario']}/{r['transport']}"
        check(not r["doc_errors"], f"{where}: invalid document {r['doc_errors']}")
        check(r["converged"], f"{where}: did not converge")
        check(not any(r["zero_scores"].values()), f"{where}: nonzero scores {r['zero_scores']}")
        check(r["pods"][0] == r["pods"][1] > 0, f"{where}: bound {r['pods']}")
        check(r["kernel_launches"]["bucket_type_cost"] >= 1, f"{where}: launched {r['kernel_launches']}")
        check(r["kernel_calls_held"] > 0 and r["kernel_calls_identical"] == r["kernel_calls_held"], f"{where}: {r['kernel_calls_identical']} of {r['kernel_calls_held']} kernel calls identical")
    # K2 runs where a batch finds standing nodes: device_fault_storm holds
    # every burst until its probe, which places them all on an empty cluster
    k2_launches = sum(r["kernel_launches"]["warm_fill_counts"] for r in runs)
    check(k2_launches >= 1, f"scenario_campaign: K2 never launched ({[r['kernel_launches'] for r in runs]})")
    storm = next(r for r in runs if r["scenario"] == "device_fault_storm")
    check(storm["capsule_triggers"] == ["breaker-open"] and storm["breaker_state"] == "closed", f"scenario_campaign device_fault_storm: {storm}")
    gaps = next(r for r in runs if r["scenario"] == "watch_gap_storm")
    check(gaps["kube"][0] >= 1 and gaps["kube"][1] >= gaps["kube"][0], f"scenario_campaign watch_gap_storm: kube faults/conflicts {gaps['kube']}")
    return line



def fleet_placements_hold(fleet_out, dev) -> bool:
    """The fleet coordinator's layouts against one in-process solve of the
    same demo pods on the card, with no mesh."""
    from karpenter_tpu_torch.api.provisioner import Provisioner
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.parallel.peers import _demo_pods, demo_layout
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver

    pods = _demo_pods(FLEET["pod_count"])
    solver = DenseSolver(min_batch=1, device=dev, use_mesh=False)
    want = demo_layout(build_scheduler([Provisioner()], FakeCloudProvider(instance_types(64)), pods, dense_solver=solver).solve(pods))
    return fleet_out["layouts"] == [want] * FLEET["solves"]


def service_fleet_headline(pods, provider, provisioners, dense_out) -> dict:
    """cmd/solver_service.py --coordinator on the card, as a deployment
    starts it: SERVICE_FLEET["n_processes"] processes on cuda:0 over gloo
    with 4 logical blocks each (an 8-block mesh); process 0 serves gRPC with
    DenseSolver(min_batch=1, peer_fabric=...), process 1 follows its
    solves. The headline batch through service.client.SolverClient: a
    warm-up and SERVICE_TRIALS solves, each one's placements, node count and
    $/hour held against the in-process unsharded solve (dense_out); the
    coordinator's Scheduler.solve alone, from its health answer; SIGTERM to
    process 0 releases the peer, and both exit 0."""
    import os
    import signal
    import tempfile

    from karpenter_tpu_torch.service.client import SolverClient

    n = SERVICE_FLEET["n_processes"]
    coordinator, address = f"127.0.0.1:{free_port()}", f"127.0.0.1:{free_port()}"
    argv = [
        sys.executable, "-m", "karpenter_tpu_torch.cmd.solver_service",
        "--coordinator", coordinator, "--address", address,
        "--backend", SERVICE_FLEET["backend"], "--devices-per-process", str(SERVICE_FLEET["devices_per_process"]),
        "--log-level", "info",
    ]
    instance_types = {p.name: provider.get_instance_types(p) for p in provisioners}
    procs, runs, client = [], [], None
    boot_s = None
    with tempfile.TemporaryDirectory() as logs:
        paths = [f"{logs}/process-{pid}.log" for pid in range(n)]
        try:
            t0 = time.perf_counter()
            for pid in range(n):
                env = {**os.environ, "KARPENTER_TPU_NUM_PROCESSES": str(n), "KARPENTER_TPU_PROCESS_ID": str(pid)}
                with open(paths[pid], "w") as log:
                    procs.append(subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT, text=True, env=env, cwd=os.path.dirname(os.path.abspath(__file__))))
            client = SolverClient(address, timeout=GRPC_TIMEOUT_S)
            while boot_s is None and all(p.poll() is None for p in procs) and time.perf_counter() - t0 < SERVICE_BOOT_S:
                try:
                    client.health()
                    boot_s = time.perf_counter() - t0
                except Exception:  # noqa: BLE001 - not serving yet
                    time.sleep(0.25)
            if boot_s is not None:
                for _ in range(1 + SERVICE_TRIALS):
                    t1 = time.perf_counter()
                    results = client.solve(provisioners, instance_types, pods)
                    wall_ms = (time.perf_counter() - t1) * 1e3
                    health = client.health()
                    runs.append({"client_wall_ms": wall_ms, "coordinator_solve_ms": health["last_solve_seconds"] * 1e3, "sharded_batches": health["sharded_batches"], "outcome": outcome(results, pods)})
                procs[0].send_signal(signal.SIGTERM)
                t2 = time.perf_counter()
                for p in procs:
                    try:
                        p.wait(timeout=max(1.0, SERVICE_STOP_S - (time.perf_counter() - t2)))
                    except subprocess.TimeoutExpired:
                        pass
        finally:
            if client is not None:
                client.close()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            texts = []
            for path in paths:
                try:
                    with open(path) as log:
                        texts.append(log.read())
                except OSError:
                    texts.append("")
    codes = [p.returncode for p in procs]
    released = re.search(r"peer 1 released after (\d+) solves", texts[1]) if len(texts) > 1 else None
    timed = runs[1:]
    line = {
        "command": argv[1:],
        "processes": n,
        "devices_per_process": SERVICE_FLEET["devices_per_process"],
        "backend": SERVICE_FLEET["backend"],
        "pods": len(pods),
        "boot_to_serving_s": boot_s,
        "coordinator_solve_ms": statistics.median(r["coordinator_solve_ms"] for r in timed) if timed else None,
        "coordinator_solve_ms_runs": [r["coordinator_solve_ms"] for r in timed],
        "client_wall_ms": statistics.median(r["client_wall_ms"] for r in timed) if timed else None,
        "client_wall_ms_runs": [r["client_wall_ms"] for r in timed],
        "warmup_coordinator_solve_ms": runs[0]["coordinator_solve_ms"] if runs else None,
        "sharded_batches": runs[-1]["sharded_batches"] if runs else None,
        "nodes": [len(r["outcome"]["nodes"]) for r in runs],
        "cost": [r["outcome"]["cost"] for r in runs],
        "placements_identical": bool(runs) and all(r["outcome"]["nodes"] == dense_out["nodes"] for r in runs),
        "peer_served": int(released.group(1)) if released else None,
        "exit_codes": codes,
    }
    if any(codes):
        for pid, text in enumerate(texts):
            print(f"chip_smoke: solver_service process {pid} exited {codes[pid]}; its log's end:\n{text[-3000:]}", file=sys.stderr, flush=True)
    check(boot_s is not None, f"the solver service fleet did not serve within {SERVICE_BOOT_S} s (exit codes {codes})")
    check(len(runs) == 1 + SERVICE_TRIALS, f"the solver service fleet answered {len(runs)} solves")
    check(line["placements_identical"], "the solver service fleet placed the headline differently from the in-process solve")
    check(all(r["outcome"]["cost"] == dense_out["cost"] and r["outcome"]["scheduled"] == len(pods) and r["outcome"]["unschedulable"] == 0 for r in runs), f"the solver service fleet's $/hour or scheduled pods differ: {line['cost']}")
    check(line["sharded_batches"] == 1 + SERVICE_TRIALS, f"the coordinator dispatched {line['sharded_batches']} sharded batches in {1 + SERVICE_TRIALS} solves")
    check(codes == [0] * n, f"the solver service processes exited {codes}")
    check(line["peer_served"] == 1 + SERVICE_TRIALS, f"the peer served {line['peer_served']} solves")
    return line


def mesh_budget_case(dev, mesh, pods, provider, provisioners, dense_out) -> dict:
    """The budget split under a solver mesh: the batch through
    DenseSolver(mesh=mesh, hbm_budget_bytes=1) with the flight recorder on,
    so the pre-solve memory peak is over the budget and the solve launches
    the unkeyed K1 on each half of the bucket axis on the solver's card,
    dispatching nothing over the mesh, which stays for the next solve. The
    counts are zeroed just before the solve and read just after; each K1
    call is captured and held bit for bit against its plain version on the
    same card tensors, and the halves against one unsplit launch."""
    from karpenter_tpu_torch.flight import FLIGHT
    from karpenter_tpu_torch.ops import bucket_cost
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver import dense as dense_module

    kernel, calls = dense_module.bucket_cost_packed, []

    def recording(*operands):
        packed = kernel(*operands)
        calls.append((operands, packed))
        return packed

    was_enabled = FLIGHT.enabled
    FLIGHT.enable()
    solver = DenseSolver(min_batch=1, device=dev, mesh=mesh, hbm_budget_bytes=1)
    dense_module.bucket_cost_packed = recording
    try:
        scheduler = build_scheduler(provisioners, provider, pods, dense_solver=solver)
        read_launches()
        keyed_before = bucket_cost.KEYED_LAUNCHES
        t0 = time.perf_counter()
        results = scheduler.solve(pods)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        keyed = bucket_cost.KEYED_LAUNCHES - keyed_before
        record = FLIGHT.records()[-1] if FLIGHT.records() else None
    finally:
        dense_module.bucket_cost_packed = kernel
        if not was_enabled:
            FLIGHT.disable()
            FLIGHT.reset()
    got = outcome(results, pods)
    held = [bool(torch.equal(packed, bucket_type_cost_packed(*operands))) for operands, packed in calls]
    halves = [int(operands[0].shape[1]) for operands, _ in calls]
    case = {
        "hbm_budget_bytes": 1,
        "wall_ms": wall_ms,
        "launches": launches,
        "keyed_launches": keyed,
        "halves": halves,
        "buckets": sum(halves),
        "kernel_holds": {"calls": len(calls), "identical": held.count(True)},
        "flight": {"dispatch": record.dispatch, "rungs": record.rungs, "hbm_peak_bytes": record.hbm_peak_bytes} if record is not None else None,
        "sharded_batches": solver.stats.sharded_batches,
        "mesh_kept": solver._active_mesh() is mesh,
        "nodes": len(got["nodes"]),
        "cost": got["cost"],
        "placements_identical": got["nodes"] == dense_out["nodes"],
        "scheduled": got["scheduled"],
    }
    if len(calls) == 2:
        (stats_a, caps, prices, allowed_a), out_a = calls[0]
        (stats_b, _caps, _prices, allowed_b), out_b = calls[1]
        whole = (torch.cat([stats_a, stats_b], dim=1).contiguous(), caps, prices, torch.cat([allowed_a, allowed_b], dim=0).contiguous())
        case["packed_equal_to_one_launch"] = bool(torch.equal(torch.cat([out_a, out_b], dim=1), kernel(*whole)))
        case["half_device_ms"], case["device_ms_missing"] = profiled_series(
            [functools.partial(kernel, *operands) for operands, _ in calls], KERNEL_ITERS, "bucket_cost_kernel"
        )
        case["half_ms"] = [cuda_ms(functools.partial(kernel, *operands), KERNEL_ITERS) for operands, _ in calls]
    B = -(-case["buckets"] // 2)
    check(launches["bucket_type_cost"] == 2 and halves == [B, case["buckets"] - B], f"the budget split under the mesh launched K1 {launches} at {halves}")
    check(keyed == 0 and case["sharded_batches"] == 0, f"the budget split under the mesh dispatched over the mesh: {keyed} keyed launches")
    check(len(held) == 2 and all(held), f"a K1 call of the budget split under the mesh differs from its plain version: {held}")
    check(case.get("packed_equal_to_one_launch") is True, "the budget split's halves differ from one unsplit launch")
    check(case["flight"] is not None and case["flight"]["rungs"] == ["chunked"] and case["flight"]["dispatch"] == ("cuda" if dev.type == "cuda" else "plain"), f"the budget split's flight record: {case['flight']}")
    check(case["mesh_kept"], "the budget split retired the mesh")
    check(case["placements_identical"] and got["cost"] == dense_out["cost"], "the budget split under the mesh placed pods differently from the unsharded solve")
    check(got["scheduled"] == len(pods) and got["unschedulable"] == 0, "the budget split under the mesh left pods unscheduled")
    return case


def solver_mesh_phase(dev, card_name, headline_inputs, pods, provider, provisioners, dense_out) -> dict:
    """The solver mesh on the card (parallel/): K1's keyed launch held
    against its plain version; make_sharded_bucket_cost on 8 logical blocks
    of the card (pods 4 x types 2), bit-equal to one unsharded K1 launch at
    the headline's shape, a padded shape, ties planted across the type
    blocks and rows with no feasible type; the headline solve through
    DenseSolver(mesh=...) with the unsharded solve's placements, types, node
    count and $/hour, every block's K1 call held; the two-process fleet over
    gloo on the card, at the reference's demo shape and, through
    cmd/solver_service.py --coordinator, at the headline's; the NCCL fleet
    over every card where there are several."""
    from karpenter_tpu_torch.ops import bucket_cost
    from karpenter_tpu_torch.ops.bucket_cost import bucket_cost_keyed, bucket_cost_packed
    from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_keyed
    from karpenter_tpu_torch.parallel import sharded as sharded_module
    from karpenter_tpu_torch.parallel.mesh import solver_mesh
    from karpenter_tpu_torch.parallel.peers import run_demo_fleet
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolveStats, DenseSolver
    from karpenter_tpu_torch import testing

    def keyed_holds(inputs):
        """(packed equal, key equal, max |diff| of the packed, of the finite
        keys): the keyed launch against its plain version on the same card
        tensors, and its packed against the unkeyed launch's."""
        packed, key = bucket_cost_keyed(*inputs)
        want_packed, want_key = bucket_type_cost_keyed(*inputs)
        unkeyed = bucket_cost_packed(*inputs)
        torch.cuda.synchronize()
        same_packed = bool(torch.equal(packed, want_packed)) and bool(torch.equal(packed, unkeyed))
        same_key = bool(torch.equal(key, want_key))
        diff = int(torch.maximum((packed.long() - want_packed.long()).abs(), (packed.long() - unkeyed.long()).abs()).max()) if packed.numel() else 0
        finite = torch.isfinite(want_key) & torch.isfinite(key)
        kdiff = float((key[finite] - want_key[finite]).abs().max()) if bool(finite.any()) else 0.0
        if not torch.equal(torch.isfinite(key), torch.isfinite(want_key)):
            kdiff = float("inf")
        return same_packed, same_key, diff, kdiff

    # 1. K1's keyed launch against its plain version, both outputs, and
    # against the unkeyed launch
    mismatches, max_err, key_err = [], 0, 0.0
    for B, T, R, *kind in PARITY_SHAPES:
        for seed in PARITY_SEEDS:
            arrays = testing.bucket_cost_problem(np.random.default_rng(seed * 1000 + B), B, T, R, *kind)
            same_packed, same_key, diff, kdiff = keyed_holds([torch.from_numpy(a).to(dev) for a in arrays])
            max_err, key_err = max(max_err, diff), max(key_err, kdiff)
            if not (same_packed and same_key):
                mismatches.append([B, T, R, *kind, seed])
    keyed_parity = {"shapes": len(PARITY_SHAPES), "seeds": len(PARITY_SEEDS), "tolerance": "exact", "mismatches": mismatches, "max_abs_err": max_err, "key_max_abs_err": key_err}
    check(not mismatches, f"K1's keyed launch disagrees with its plain version at {mismatches}")
    same_packed, same_key, diff, kdiff = keyed_holds(headline_inputs)
    check(same_packed and same_key, "K1's keyed launch disagrees with its plain version at the headline solve's inputs")

    # 2. the sharded dispatch on 8 logical blocks of the card
    card_dev = torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
    mesh = solver_mesh(MESH_BLOCKS, types_parallel=MESH_TYPES_PARALLEL, devices=[card_dev] * MESH_BLOCKS)
    cost = sharded_module.make_sharded_bucket_cost(mesh)
    headline_host = [t.cpu().numpy() for t in headline_inputs]
    dispatches = []
    cases = [("headline_solve_inputs", headline_host)] + [
        ("x".join(map(str, shape)), testing.bucket_cost_problem(np.random.default_rng(17 * shape[0] + shape[1]), *shape))
        for shape in MESH_SHAPES
    ]
    for name, arrays in cases:
        one_launch = bucket_cost_packed(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]).cpu().numpy()
        before = bucket_cost.KEYED_LAUNCHES
        got = cost(*arrays)
        launches = bucket_cost.KEYED_LAUNCHES - before
        dispatches.append({
            "case": name,
            "shape": [int(arrays[0].shape[1]), int(arrays[1].shape[0]), int(arrays[0].shape[2])],
            "bit_equal_to_one_launch": bool(np.array_equal(got, one_launch)),
            "max_abs_err": int(np.abs(got.astype(np.int64) - one_launch).max()) if got.size else 0,
            "launches": launches,
            "feasible": int(got[2].sum()),
        })
        check(dispatches[-1]["bit_equal_to_one_launch"], f"the sharded dispatch disagrees with one K1 launch at {name}")
        check(launches == mesh.size, f"the sharded dispatch at {name} launched K1 {launches} times, expected {mesh.size}")

    # the dispatch's time at the headline's inputs: the padded batch's
    # uploads, 8 keyed launches and copies, the wait and the host combine
    stats, caps, prices, allowed = headline_host
    caps_p, prices_p = sharded_module.pad_catalog(mesh, caps, prices)
    stats_p, allowed_p = sharded_module.pad_batch(mesh, stats, allowed, caps_p.shape[0])
    placed = cost.place_catalog(caps_p, prices_p)
    host_ms = []
    for _ in range(3):
        cost.dispatch(stats_p, placed, allowed_p).wait()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(MESH_DISPATCH_ITERS):
        t0 = time.perf_counter()
        cost.dispatch(stats_p, placed, allowed_p).wait()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    end.record()
    end.synchronize()
    dispatch_ms = start.elapsed_time(end) / MESH_DISPATCH_ITERS
    blocks = cost.dispatch(stats_p, placed, allowed_p).blocks().numpy()
    combine_ms = []
    for _ in range(MESH_DISPATCH_ITERS):
        t0 = time.perf_counter()
        cost.combine(blocks, caps_p.shape[0])
        combine_ms.append((time.perf_counter() - t0) * 1e3)
    Bb, Tb = stats_p.shape[1] // mesh.shape["pods"], caps_p.shape[0] // mesh.shape["types"]
    block_inputs = [
        sharded_module.block_of(mesh, a, spec, 0, 0).to(dev)
        for a, spec in ((stats_p, sharded_module.STATS_SPEC), (caps_p, sharded_module.CAPS_SPEC), (prices_p, sharded_module.PRICES_SPEC), (allowed_p, sharded_module.ALLOWED_SPEC))
    ]
    block_device_ms, block_why = profiled_device_ms(lambda: bucket_cost_keyed(*block_inputs), KERNEL_ITERS, "bucket_cost_kernel")

    # 3. the headline solve through DenseSolver(mesh=...): a recorded
    # warm-up, then SOLVE_TRIALS timed solves in turns with the unsharded
    # solver's, the counts zeroed just before each and read just after
    calls = []

    def recording(stats_t, caps_t, prices_t, allowed_t):
        packed, key = bucket_cost_keyed(stats_t, caps_t, prices_t, allowed_t)
        calls.append(((stats_t, caps_t, prices_t, allowed_t), packed, key))
        return packed, key

    solver = DenseSolver(min_batch=1, device=dev, mesh=mesh)
    sharded_module.bucket_cost_keyed = recording
    try:
        scheduler = build_scheduler(provisioners, provider, pods, dense_solver=solver)
        warm = outcome(scheduler.solve(pods), pods)
    finally:
        sharded_module.bucket_cost_keyed = bucket_cost_keyed
    torch.cuda.synchronize()
    held = []
    for operands, packed, key in calls:
        want_packed, want_key = bucket_type_cost_keyed(*operands)
        held.append(bool(torch.equal(packed, want_packed)) and bool(torch.equal(key, want_key)))
    check(len(calls) == mesh.size and all(held), f"the mesh solve's K1 calls: {len(calls)} captured, {held.count(False)} disagree with the plain version")
    # the timed solves, the mesh's beside the unsharded solver's in turns
    # (mesh, unsharded, unsharded, mesh, mesh, unsharded), each solver warm
    unsharded = DenseSolver(min_batch=1, device=dev)
    build_scheduler(provisioners, provider, pods, dense_solver=unsharded).solve(pods)
    phase_names = ("encode", "fill", "device", "mask", "assemble", "device_wait", "commit")
    runs = {"mesh": [], "unsharded": []}
    keyed_launches, unkeyed_in_mesh, sharded_batches, results = 0, 0, 0, None
    for which in ("mesh", "unsharded", "unsharded", "mesh", "mesh", "unsharded"):
        timed = solver if which == "mesh" else unsharded
        timed.stats = DenseSolveStats()
        scheduler = build_scheduler(provisioners, provider, pods, dense_solver=timed)
        read_launches()
        keyed_before = bucket_cost.KEYED_LAUNCHES
        t0 = time.perf_counter()
        got_results = scheduler.solve(pods)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        runs[which].append({"wall_ms": ms, "phases_ms": {k: getattr(timed.stats, f"{k}_seconds") * 1e3 for k in phase_names}})
        if which == "mesh":
            keyed_launches += bucket_cost.KEYED_LAUNCHES - keyed_before
            unkeyed_in_mesh += launches["bucket_type_cost"]
            sharded_batches += timed.stats.sharded_batches
            results = got_results
    got = outcome(results, pods)

    def medians(which):
        return {k: statistics.median(r["phases_ms"][k] for r in runs[which]) for k in phase_names}

    headline = {
        "config": "solver_mesh_headline",
        "pods": len(pods),
        "wall_ms": statistics.median(r["wall_ms"] for r in runs["mesh"]),
        "wall_ms_runs": [r["wall_ms"] for r in runs["mesh"]],
        "phases_ms": medians("mesh"),
        "unsharded_wall_ms": statistics.median(r["wall_ms"] for r in runs["unsharded"]),
        "unsharded_wall_ms_runs": [r["wall_ms"] for r in runs["unsharded"]],
        "unsharded_phases_ms": medians("unsharded"),
        "order": "mesh, unsharded, unsharded, mesh, mesh, unsharded",
        "sharded_batches": sharded_batches,
        "keyed_launches": keyed_launches,
        "unkeyed_launches_in_mesh_solves": unkeyed_in_mesh,
        "kernel_holds": {"calls": len(calls), "identical": held.count(True)},
        "nodes": len(got["nodes"]),
        "cost": got["cost"],
        "unsharded_nodes": len(dense_out["nodes"]),
        "unsharded_cost": dense_out["cost"],
        "placements_identical": got["nodes"] == dense_out["nodes"] and warm["nodes"] == dense_out["nodes"],
        "scheduled": got["scheduled"],
    }
    check(sharded_batches == SOLVE_TRIALS, f"the mesh solves dispatched {sharded_batches} sharded batches")
    check(keyed_launches == SOLVE_TRIALS * mesh.size, f"the mesh solves launched the keyed K1 {keyed_launches} times")
    check(unkeyed_in_mesh == 0, "the mesh solve launched the unsharded K1")
    check(headline["placements_identical"], "the mesh solve placed pods differently from the unsharded solve")
    check(got["cost"] == dense_out["cost"] and len(got["nodes"]) == len(dense_out["nodes"]), "the mesh solve's $/hour or node count differs")
    check(got["scheduled"] == len(pods) and got["unschedulable"] == 0, "the mesh solve left pods unscheduled")

    # 3b. the same solve over the mesh under --solver-hbm-budget 1
    budget = mesh_budget_case(dev, mesh, pods, provider, provisioners, dense_out)
    check(budget["buckets"] == headline_inputs[0].shape[1], f"the budget split's halves cover {budget['buckets']} buckets, the headline has {headline_inputs[0].shape[1]}")

    # 4. the two-process fleet over gloo, both processes on this card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    compute_mode = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    check(compute_mode == "Default", f"the card's compute mode is {compute_mode!r}: two processes cannot share it")
    t0 = time.perf_counter()
    coord, peer = run_demo_fleet(**FLEET, timeout=FLEET_TIMEOUT_S, device="cuda", backend="gloo")
    fleet = {
        # the reference's demo shape: both processes' start-up (torch, the
        # CUDA context, the group) and FLEET["solves"] solves of 48 pods
        "startup_and_solves_s": time.perf_counter() - t0,
        "coordinator_solve_ms_runs": coord["solve_ms"],
        "compute_mode": compute_mode,
        "scheduled": coord["scheduled"],
        "requested": coord["requested"],
        "unschedulable": coord["unschedulable"],
        "catalog_broadcasts": coord["catalog_broadcasts"],
        "served": peer["served"],
        "mesh": coord["mesh"],
        "devices": [coord["device"], peer["device"]],
        "backend": coord["backend"],
        "sharded_batches": coord["sharded_batches"],
        "k1_launches": {"coordinator": coord["k1_launches"], "peer": peer["k1_launches"]},
        "placements_held": fleet_placements_hold(coord, dev),
    }
    requested = FLEET["pod_count"] * FLEET["solves"]
    check(coord["scheduled"] == requested and coord["unschedulable"] == 0, f"the fleet scheduled {coord['scheduled']} of {requested} pods")
    check(coord["catalog_broadcasts"] == 1, f"the fleet broadcast the catalog {coord['catalog_broadcasts']} times")
    check(peer["served"] >= FLEET["solves"], f"the peer served {peer['served']} solves")
    check(coord["devices"] == peer["devices"] == FLEET["n_processes"] * FLEET["devices_per_process"], "the fleet's mesh is not 8 blocks")
    check(fleet["devices"] == ["cuda:0", "cuda:0"], f"the fleet ran on {fleet['devices']}")
    check(coord["k1_launches"] > 0 and peer["k1_launches"] > 0, f"a fleet process launched no keyed K1: {fleet['k1_launches']}")
    check(fleet["placements_held"], "the fleet's placements differ from the in-process solve")

    # 4b. cmd/solver_service.py --coordinator at the headline's width
    service = service_fleet_headline(pods, provider, provisioners, dense_out)

    # 5. NCCL across cards, where there are several
    cards = torch.cuda.device_count()
    if cards > 1:
        outs = run_demo_fleet(
            n_processes=cards, devices_per_process=1, pod_count=FLEET["pod_count"], solves=FLEET["solves"],
            timeout=FLEET_TIMEOUT_S, device="cuda", backend="nccl",
        )
        multi_card = {
            "cards": cards,
            "devices": [o["device"] for o in outs],
            "scheduled": outs[0]["scheduled"],
            "catalog_broadcasts": outs[0]["catalog_broadcasts"],
            "k1_launches": [o["k1_launches"] for o in outs],
        }
        check(outs[0]["scheduled"] == requested and all(o["k1_launches"] > 0 for o in outs), f"the NCCL fleet: {multi_card}")
    else:
        multi_card = "not run: 1 card"

    keyed_ms = cuda_ms(lambda: bucket_cost_keyed(*headline_inputs), KERNEL_ITERS)
    keyed_plain_ms = cuda_ms(lambda: bucket_type_cost_keyed(*headline_inputs), PLAIN_ITERS)
    keyed_device_ms, keyed_why = profiled_device_ms(lambda: bucket_cost_keyed(*headline_inputs), KERNEL_ITERS, "bucket_cost_kernel")
    line = {
        "phase": "solver_mesh",
        "card": card_name,
        "mesh": {"blocks": mesh.size, **mesh.shape, "device": str(dev)},
        "keyed_parity": keyed_parity,
        "dispatches": dispatches,
        "dispatch_ms": dispatch_ms,
        "dispatch_host_ms": statistics.median(host_ms),
        "combine_host_ms": statistics.median(combine_ms),
        "block_shape": [Bb, Tb, int(stats_p.shape[2])],
        "block_device_ms": block_device_ms,
        "keyed_ms": keyed_ms,
        "keyed_plain_ms": keyed_plain_ms,
        "keyed_device_ms": keyed_device_ms,
        "device_ms_missing": keyed_why or block_why or None,
        "headline": headline,
        "budget": budget,
        "fleet": fleet,
        "service_fleet": service,
        "multi_card": multi_card,
    }
    emit(line)
    return line


# the contract audit (analysis/contracts.py): the child gate's time limit, and
# the entries with a kernel library, each output held bit for bit against its
# plain version on the same inputs at both grid points; but the toy sharded
# step's f32 segment sums (index_add_, atomic on the card, so their order of
# addition is not the CPU's), of which only the largest difference is reported
ANALYZE_TIMEOUT_S = 300.0
KERNEL_ENTRIES = ("bucket_cost_packed", "bucket_cost_keyed", "warm_fill_counts_device", "counts_resident", "sharded_bucket_cost", "sharded_solve_step")
ATOMIC_OUTPUTS = {("sharded_solve_step", 4)}  # bin_usage [num_bins, R] f32
# launches the audit makes at its two grid points: K1 by bucket_cost_packed;
# keyed K1 by bucket_cost_keyed and the two sharded entries (one block); K2
# by warm_fill_counts_device and counts_resident
AUDIT_LAUNCHES = {"bucket_type_cost": 2, "bucket_type_cost_keyed": 6, "warm_fill_counts": 4}
# tests/test_cost_regret.py's gates. Its MILP time limit is 60 s; on the
# host of an NVIDIA H100 80GB HBM3 (700.00 W) machine this phase's HiGHS
# took 268.4 s on mixed_sizes and 19.0 s on homogeneous, so here each MILP
# gets 600 s, and the five start in MILP_WORKERS worker processes (HiGHS
# runs one thread each) as soon as the kernels are built, to be read by the
# cost_regret phase; a MILP that does not reach optimality still fails
REGRET_GATE = 0.03
HOST_FFD_SANITY = 0.25
MILP_TIME_LIMIT_S = 600.0
MILP_WORKERS = 2


def analysis_contracts(dev, card_name) -> dict:
    """The program-contract tier on the card. `python -m
    karpenter_tpu_torch.cmd.analyze --contracts --check --device cuda` as a
    child must exit 0. Then, in this process, every registered device entry
    is traced on the card at both grid points (contracts.audit): the
    contract it gives must equal the committed one (staleness_errors: the
    dtypes, shapes, in-place writes, promotions, host constants and kernel
    libraries are device-independent facts), no finding outside the
    baseline, no kernel build in the audit (the kernels were built at the
    start, so any build would come after the library's first), and every
    entry with a kernel library bit-equal to its plain version on copies of
    the same inputs. Per entry: its dtypes, in-place set, host->device
    bytes per call (the aten copies' sources; the host arguments an entry
    stages itself, as AdmissionSurface does, beside them) and builds."""
    from karpenter_tpu_torch.analysis import contracts
    from karpenter_tpu_torch.analysis.core import Baseline, default_baseline_path
    from karpenter_tpu_torch.analysis.rules.programcheck import CONTRACT_RULE_NAMES, findings_from_contracts
    from karpenter_tpu_torch.ops import bucket_cost

    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.cmd.analyze", "--contracts", "--check", "--device", "cuda"],
        capture_output=True, text=True, timeout=ANALYZE_TIMEOUT_S, cwd=ROOT,
    )
    child_s = time.perf_counter() - t0
    read_launches()
    keyed_before = bucket_cost.KEYED_LAUNCHES
    t1 = time.perf_counter()
    doc, facts = contracts.audit(device=dev)
    audit_s = time.perf_counter() - t1
    launches = read_launches()
    launches["bucket_type_cost_keyed"] = bucket_cost.KEYED_LAUNCHES - keyed_before
    stale = contracts.staleness_errors(contracts.load_committed(ROOT), doc)
    active, _suppressed, stale_baseline = Baseline.load(default_baseline_path()).split(findings_from_contracts(doc), rules=CONTRACT_RULE_NAMES)
    entries = {
        name: {
            "in": [a["dtype"] for a in entry["args"]],
            "out": [o["dtype"] for o in entry["outputs"]],
            "in_place": entry["inplace"]["written"],
            "promotions": entry["promotions"],
            "library": entry["library"],
            "h2d_bytes_per_call": facts[name]["h2d_bytes"],
            "host_arg_bytes_per_call": facts[name]["host_arg_bytes"],
            "builds": facts[name]["builds"],
            "aten_ops_per_call": facts[name]["ops"],
            "bit_equal_to_plain": facts[name]["bit_equal"],
            "max_abs_err": facts[name]["max_abs_err"],
        }
        for name, entry in doc["entries"].items()
    }
    builds = sum(len(b) for f in facts.values() for b in f["builds"])
    line = {
        "phase": "analysis_contracts",
        "card": card_name,
        "check_child": {"exit_code": child.returncode, "seconds": child_s, "stderr_tail": child.stderr.strip().splitlines()[-8:]},
        "audit_s": audit_s,
        "grid": {"base": contracts.GRID_BASE, "alt": contracts.GRID_ALT},
        "entries": entries,
        "equal_to_committed": not stale,
        "stale": stale,
        "findings_outside_baseline": [f.render() for f in active],
        "builds": builds,
        "kernel_launches": launches,
    }
    emit(line)
    check(child.returncode == 0, f"analysis_contracts: analyze --contracts --check --device cuda exited {child.returncode}: {child.stderr[-2000:]}")
    check(not stale, f"analysis_contracts: the card's contract differs from the committed one: {stale}")
    check(not active and not stale_baseline, f"analysis_contracts: findings outside the baseline {[f.render() for f in active]}, stale entries {stale_baseline}")
    check(builds == 0, f"analysis_contracts: {builds} kernel builds during the audit")
    differs = [
        [n, k] for n in KERNEL_ENTRIES for k, same in enumerate(facts[n]["bit_equal"] or [False]) if not same and (n, k) not in ATOMIC_OUTPUTS
    ]
    check(not differs, f"analysis_contracts: kernel entries' outputs [entry, output] differ from their plain versions: {differs}")
    check(launches == AUDIT_LAUNCHES, f"analysis_contracts: the audit launched {launches}, expected {AUDIT_LAUNCHES}")
    return line


def timed_optimum(matrices, time_limit: float):
    """solver/optimal.py's optimal_node_cost on one instance's matrices and
    its seconds, in a worker process of cost_regret's pool."""
    from karpenter_tpu_torch.solver.optimal import optimal_node_cost

    t0 = time.perf_counter()
    opt = optimal_node_cost(*matrices, time_limit=time_limit)
    return opt, time.perf_counter() - t0


def start_milps():
    """testing.cost_regret_cases() and, for those the MILP measures, its
    optimum (timed_optimum) submitted to MILP_WORKERS spawned worker
    processes: (the pool, futures by case name, the cases, the instant the
    pool started). cost_regret reads the futures and shuts the pool down."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.scheduling.nodetemplate import NodeTemplate
    from karpenter_tpu_torch.solver.optimal import problem_matrices

    cases = testing.cost_regret_cases()
    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(max_workers=MILP_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    futures = {
        c["name"]: pool.submit(
            timed_optimum,
            problem_matrices(c["pods"], c["provider"].get_instance_types(c["provisioner"]), NodeTemplate.from_provisioner(c["provisioner"])),
            MILP_TIME_LIMIT_S,
        )
        for c in cases
        if c["milp"]
    }
    return pool, futures, cases, t0


def cost_regret(dev, card_name, milps=None) -> dict:
    """The cost-regret harness on the card: tests/test_cost_regret.py's six
    instances (testing.cost_regret_cases), each solved three ways. The
    exhaustive MILP (solver/optimal.py, HiGHS through scipy on the host; a
    MILP that does not reach optimality fails the phase), timed in a worker
    process (`milps`, from start_milps, or started here); the dense
    path on the card (DenseSolver(min_batch=1), K1 in every solve, each
    call captured and held bit for bit against its plain version), its wall
    and launches; and the exact host loop. The new nodes are priced at
    their cheapest option, as the reference's test prices them. Gates, the
    reference's: every pod placed on both paths, the dense path committing
    pods, dense within REGRET_GATE of the optimum, the host loop within
    HOST_FFD_SANITY, neither below the optimum; mixed_constraints_limits
    (topology constraints, outside the MILP's model) dense within
    REGRET_GATE of the host loop."""
    from karpenter_tpu_torch.scheduler import build_scheduler
    from karpenter_tpu_torch.solver import DenseSolver
    from karpenter_tpu_torch.solver import dense as dense_module
    from karpenter_tpu_torch.solver import warmfill as fill_module

    def solve(case, solver):
        pods = case["pods"]
        t0 = time.perf_counter()
        results = build_scheduler([case["provisioner"]], case["provider"], pods, dense_solver=solver).solve(pods)
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        placed = sum(len(n.pods) for n in results.new_nodes) + sum(len(n.pods) for n in results.existing_nodes)
        return sum(min(it.price() for it in n.instance_type_options) for n in results.new_nodes), placed, wall

    pool, futures, cases, t_pool = milps or start_milps()
    t_wait = time.perf_counter()
    try:
        optima = {name: f.result() for name, f in futures.items()}
    finally:
        pool.shutdown()
    milp_waited_s = time.perf_counter() - t_wait
    rows, failures, total = [], [], {"bucket_type_cost": 0, "warm_fill_counts": 0}
    for case in cases:
        name, pods, provisioner = case["name"], case["pods"], case["provisioner"]
        opt, milp_s = optima.get(name, (None, None))
        solver = DenseSolver(min_batch=1, device=dev)
        captures = []
        seams = dense_module.bucket_cost_packed, fill_module.admission_counts
        capture_kernel_calls(captures)
        try:
            read_launches()
            dense_cost, dense_placed, dense_ms = solve(case, solver)
            launches = read_launches()
        finally:
            dense_module.bucket_cost_packed, fill_module.admission_counts = seams
        holds = hold_kernel_calls(captures, dev)
        host_cost, host_placed, host_ms = solve(case, None)
        for k in total:
            total[k] += launches[k]
        row = {
            "case": name, "pods": len(pods), "types": len(case["provider"].get_instance_types(provisioner)),
            "optimum": opt.cost if opt else None, "milp_status": opt.status if opt else "not run: topology constraints are outside the MILP's model",
            "milp_nodes": opt.nodes if opt else None, "milp_s": milp_s,
            "dense_cost": dense_cost, "host_cost": host_cost,
            "dense_regret": (dense_cost - opt.cost) / opt.cost if opt and opt.ok else None,
            "host_regret": (host_cost - opt.cost) / opt.cost if opt and opt.ok else None,
            "dense_over_host": dense_cost / host_cost - 1.0 if host_cost else None,
            "dense_wall_ms": dense_ms, "host_wall_ms": host_ms,
            "pods_committed": solver.stats.pods_committed, "k1_launches": launches["bucket_type_cost"],
            "k2_launches": launches["warm_fill_counts"], "kernel_holds": holds,
        }
        rows.append(row)
        problems = []
        if dense_placed != len(pods) or host_placed != len(pods):
            problems.append(f"placed {dense_placed} dense / {host_placed} host of {len(pods)}")
        if solver.stats.pods_committed <= 0 or launches["bucket_type_cost"] < 1:
            problems.append(f"the dense path committed {solver.stats.pods_committed} pods with {launches['bucket_type_cost']} K1 launches")
        if not holds or not all(h["identical"] for h in holds):
            problems.append(f"a K1 call differs from its plain version: {holds}")
        if opt is not None:
            if not opt.ok:
                problems.append(f"the MILP ended {opt.status}")
            else:
                if min(dense_cost, host_cost) < opt.cost - 1e-6:
                    problems.append(f"a cost below the optimum {opt.cost}")
                if row["dense_regret"] > REGRET_GATE or row["host_regret"] > HOST_FFD_SANITY:
                    problems.append(f"regret dense {row['dense_regret']:.4f} / host {row['host_regret']:.4f}")
        elif dense_cost > host_cost * (1 + REGRET_GATE) + 1e-9:
            problems.append(f"dense {dense_cost} over the host loop's {host_cost} by more than {REGRET_GATE:.0%}")
        if problems:
            failures.append({"case": name, "problems": problems})
    line = {
        "phase": "cost_regret",
        "card": card_name,
        "gates": {"dense_regret": REGRET_GATE, "host_regret": HOST_FFD_SANITY, "milp_time_limit_s": MILP_TIME_LIMIT_S},
        "cases": rows,
        "milp_s_total": sum(r["milp_s"] or 0.0 for r in rows),
        "milp_workers": MILP_WORKERS,
        "milp_started_s_before_phase": t_wait - t_pool,
        "milp_waited_s": milp_waited_s,
        "kernel_launches": total,
        "failures": failures,
    }
    emit(line)
    check(not failures, f"cost_regret: {failures}")
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

    # 1. build both kernels from the checkout's sources; then start the
    # cost-regret phase's MILPs in worker processes, read in 12g
    build_kernels([bucket_cost.LIBRARY, warmfill.LIBRARY])
    milps = start_milps()

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

    # 6b. the solver mesh: K1's keyed launch, the sharded dispatch on 8
    # logical blocks of the card, the headline solve over that mesh, and the
    # two-process fleet sharing the card
    mesh_line = solver_mesh_phase(dev, card_name, headline_inputs, pods, provider, provisioners, dense_out)

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
    # 10b. the incremental engine on the snapshot it was handed: mutations
    # recorded after a full pass's snapshot, and the capacity-failure
    # re-solve on nominated views, beside the same with no engine
    residency_lines = incremental_residency(dev, min_batch, card_name)
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
    # 12b'. the nomination window: a round's nominations still unbound when
    # the wave's notices arrive; every re-solve counts them
    window_line = nomination_window(dev, min_batch, card_name)

    # 12c. the controller process: the entry point booted as a child (the
    # crossover measured at boot, the probes, SIGTERM), the headline batch
    # through a running Runtime's threads, and the solve in the sidecar. The
    # Runtimes configure the port's log handler at info; later phases log
    # warnings only
    runtime_boot(card_name)
    runtime_line = runtime_round(dev, card_name)
    # 12c'. the same cell with the telemetry on: tracing, the lock witness
    # and /metrics, held to the untraced round's outcome
    traced_line = runtime_round_traced(dev, card_name, runtime_line)
    # 12c''. the same cell with the recorders on: the flight recorder, the
    # journal, the SLO accountant and its ideal repack through K1, the
    # capsules, profiling, the invariant monitor and the coherence witness
    recorded_line = runtime_round_recorded(dev, card_name, runtime_line)
    # 12c'''. the solver fault domain: real faults classified, the breaker
    # opened by injected faults at K1's seam, the batch held with no launch
    # and recovered on the card, the budget split, the corruptions, the
    # plans' determinism
    faulted_line = runtime_round_faulted(dev, card_name, runtime_line)
    # 12c4. the control-plane fault domain: the batch created in a compacted
    # watch gap, conflicts on its binds, a stale read and a lease steal,
    # held to the plain round's outcome
    kube_chaos_line = runtime_round_kube_chaos(dev, card_name, runtime_line)
    sidecar_line = solver_sidecar(dev, card_name)

    # 12d. the wire: the Runtime's cell over HTTP against an apiserver
    # process, then a fresh controller process against one
    runtime_http_line = runtime_round_http(dev, card_name)
    controller_process_http(dev, card_name)
    # 12d'. the restart after a real device-lost: a device-side assert on
    # the card ends a controller process's round, and a fresh process picks
    # up the held batch, on an empty cluster and over standing nodes
    restart_line = controller_restart_device_lost(dev, card_name)
    # 12e. the scenario campaign: live Runtimes under the workload stand-in
    # and seeded chaos, every batch through K1 and K2
    campaign_line = scenario_campaign(dev, card_name)
    # 12f. the program-contract tier on the card: every device entry traced
    # there against the contract committed from the CPU
    analysis_line = analysis_contracts(dev, card_name)
    # 12g. the cost-regret harness: the MILP optimum against the dense path
    # (K1) and the exact host loop
    regret_line = cost_regret(dev, card_name, milps)
    logsetup.set_level("warning")

    def runtime_launches(kernel_name):
        """The Runtime cell's launches of one kernel: in the threaded window
        and in the synchronous provision_once() (the boot's probe runs in
        the child process, whose counts are not readable here)."""
        return {
            "runtime_round": runtime_line["kernel_launches"][kernel_name],
            "provision_once": runtime_line["provision_once"]["kernels"]["launches"][kernel_name],
        }

    def http_launches(kernel_name):
        """The wire cells' launches of one kernel: the Runtime's window over
        HTTP (the fresh process's launches happen in the child, whose counts
        are not readable here)."""
        return {"runtime_round_http": runtime_http_line["kernel_launches"][kernel_name], "controller_process_http": "child"}

    def restart_launches(kernel_name):
        """The restart phase's launches of one kernel: in its in-process
        solves, and in the standing case's successor since its boot (the
        crossover probe's included), as it reported them; the empty case's
        processes' launches are in them, whose counts are not readable
        here."""
        cases = restart_line["cases"]
        return {
            "empty_in_process": cases["empty"]["in_process"]["launches"][kernel_name],
            "standing_in_process": cases["standing"]["in_process"]["launches"][kernel_name],
            "standing_successor": (cases["standing"]["successor_launches"] or {}).get(kernel_name),
        }

    def recorded_launches(kernel_name):
        """The recorded cell's launches of one kernel: in the threaded window,
        in compute_drift's ideal repack, in the profiled rounds and in the
        planted divergence's audited passes."""
        return {
            "runtime_round_recorded": recorded_line["kernel_launches"][kernel_name],
            "compute_drift": recorded_line["compute_drift"]["launches"][kernel_name],
            "profiled_rounds": sum(a["launches"][kernel_name] for part in ("round_attempts", "live_attempts") for a in recorded_line["profiling"][part]),
            "planted_divergence": recorded_line["planted_divergence"]["launches"][kernel_name],
        }

    def faulted_launches(kernel_name):
        """The fault-domain cell's launches of one kernel: the faulted
        Runtime's window (the faulted rounds' K2, the held round's none and
        the recovery probe's), the rounds with no plan, the budget split's
        round and the corruption rigs' passes."""
        return {
            "runtime_round_faulted": faulted_line["kernel_launches"][kernel_name],
            "held_round": faulted_line["breaker"]["hold"]["launches"][kernel_name],
            "no_plan": [r["launches"][kernel_name] for r in faulted_line["no_plan"]["runs"]],
            "budget_split": faulted_line["budget_split"]["launches"][kernel_name],
            "corruptions": {c["kind"]: c["launches"][kernel_name] for c in faulted_line["corruptions"]},
        }

    def campaign_launches(kernel_name):
        """The scenario campaign's launches of one kernel, by run."""
        return {f"{r['scenario']}/{r['transport']}": r["kernel_launches"][kernel_name] for r in campaign_line["runs"]}

    def interruption_launches(kernel_name):
        """The wave's launches of one kernel over its timed runs, in the
        re-solves and in the post-drain rounds, and in the split-poll run
        (re-solves and round together)."""
        return {part: wave_line["kernel_launches"][part][kernel_name] for part in ("wave", "round", "split")}

    def window_launches(kernel_name):
        """The nomination window's launches of one kernel: the round that
        nominates, the wave's re-solves, the converge's round."""
        return {part: window_line["kernel_launches"][part][kernel_name] for part in ("round", "wave", "converge")}

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
                "window_launches": window_launches("bucket_type_cost"),
                "residency_launches": {line["case"]: line["kernel_launches"]["bucket_type_cost"] for line in residency_lines},
                "runtime_launches": runtime_launches("bucket_type_cost"),
                "traced_launches": traced_line["kernel_launches"]["bucket_type_cost"],
                "recorded_launches": recorded_launches("bucket_type_cost"),
                "faulted_launches": faulted_launches("bucket_type_cost"),
                "kube_chaos_launches": kube_chaos_line["kernel_launches"]["bucket_type_cost"],
                "campaign_launches": campaign_launches("bucket_type_cost"),
                "sidecar_launches": sidecar_line["kernel_launches"]["bucket_type_cost"],
                "sidecar_grpc_launches": sidecar_line["grpc"]["kernel_launches"]["bucket_type_cost"],
                "http_launches": http_launches("bucket_type_cost"),
                "restart_launches": restart_launches("bucket_type_cost"),
                "analysis_launches": analysis_line["kernel_launches"]["bucket_type_cost"],
                "regret_launches": regret_line["kernel_launches"]["bucket_type_cost"],
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
                "name": "bucket_type_cost_keyed",
                "route": "cuda",
                "source": "karpenter_tpu_torch/csrc/bucket_cost.cu",
                "replaces": "karpenter_tpu/ops/pallas_kernels.py:35",
                "launches": mesh_line["headline"]["keyed_launches"],
                "fleet_launches": mesh_line["fleet"]["k1_launches"],
                "analysis_launches": analysis_line["kernel_launches"]["bucket_type_cost_keyed"],
                "max_abs_err": max(mesh_line["keyed_parity"]["max_abs_err"], mesh_line["keyed_parity"]["key_max_abs_err"]),
                "ms": mesh_line["keyed_ms"],
                "kernel_ms": mesh_line["keyed_ms"],
                "plain_ms": mesh_line["keyed_plain_ms"],
                "bound_ms": max(bytes_ms + B * 4 / H100_BYTES_PER_S * 1e3, ops_ms),
                "bound_by": "bytes" if bytes_ms + B * 4 / H100_BYTES_PER_S * 1e3 >= ops_ms else "operations",
                "library_ms": None,
                "parity": True,
                "shape": [B, T, R],
                "device_ms": mesh_line["keyed_device_ms"],
                "block_shape": mesh_line["block_shape"],
                "block_device_ms": mesh_line["block_device_ms"],
                "dispatch_ms": mesh_line["dispatch_ms"],
                "combine_host_ms": mesh_line["combine_host_ms"],
                "launch_floor_ms": launch_floor_ms,
                "device_ms_missing": mesh_line["device_ms_missing"],
                "note": "K1's keyed mode (each bucket's winning key as a second output), launched once per "
                "block of the solver mesh. launches are those of the solver_mesh phase's 3 timed headline "
                "solves over 8 blocks of the card; ms, plain_ms and device_ms at the headline's whole "
                "(B, T, R), block_device_ms at one block's; dispatch_ms is one sharded dispatch (uploads, "
                "8 launches, copies, the combine) in CUDA events, combine_host_ms the combine alone",
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
                "window_launches": window_launches("warm_fill_counts"),
                "residency_launches": {line["case"]: line["kernel_launches"]["warm_fill_counts"] for line in residency_lines},
                "runtime_launches": runtime_launches("warm_fill_counts"),
                "traced_launches": traced_line["kernel_launches"]["warm_fill_counts"],
                "recorded_launches": recorded_launches("warm_fill_counts"),
                "faulted_launches": faulted_launches("warm_fill_counts"),
                "kube_chaos_launches": kube_chaos_line["kernel_launches"]["warm_fill_counts"],
                "campaign_launches": campaign_launches("warm_fill_counts"),
                "sidecar_launches": sidecar_line["kernel_launches"]["warm_fill_counts"],
                "sidecar_grpc_launches": sidecar_line["grpc"]["kernel_launches"]["warm_fill_counts"],
                "http_launches": http_launches("warm_fill_counts"),
                "restart_launches": restart_launches("warm_fill_counts"),
                "analysis_launches": analysis_line["kernel_launches"]["warm_fill_counts"],
                "regret_launches": regret_line["kernel_launches"]["warm_fill_counts"],
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

    # 16. the script's wall, kernel builds included, and the card
    emit({"script_wall_s": time.perf_counter() - SCRIPT_T0})
    print(card_name, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
