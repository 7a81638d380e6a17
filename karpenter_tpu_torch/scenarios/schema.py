"""SCENARIO_*.json schema: the structural gate behavioral artifacts must pass.

BENCH_*.json regressions became bisectable once their shape was pinned;
SCENARIO artifacts get the same treatment from day one. `scenario_doc_errors`
is the single validator shared by the campaign runner (every emitted file is
self-checked before it lands on disk) and the tier-1 smoke test — required
keys, a well-formed provenance block, monotonic sample timestamps, and the
scored invariants being the right types.

The port's copy of karpenter_tpu/scenarios/schema.py.
"""

from __future__ import annotations

from typing import List

from ..provenance import provenance_errors

RUN_KEYS = ("transport", "duration_seconds", "converged", "scores", "samples")
SCORE_KEYS = (
    "pending_latency_seconds",
    "node_ready_seconds",
    "cost_per_hour",
    "ideal_cost_per_hour",
    "cost_drift_ratio",
    "lost_pods",
    "leaked_instances",
    "budget_violations",
    "pods_desired",
    "pods_bound",
    "nodes_churned",
    "restarts",
    # capacity-failure scores: node launches that failed during the run
    # (insufficient capacity + other), and the integral of pending pods over
    # the sample timeline — how much pod-time the cluster spent unable to
    # place work (a crunch's user-visible cost even when nothing is lost)
    "launch_failures",
    "unschedulable_pod_seconds",
    # solver-telemetry scores (flight.py): XLA compilations observed during
    # the run (the steady-state property — a settled cluster re-solving
    # under churn must score 0 after warmup) and the p95 of real
    # Scheduler.solve wall-clock (null when the run solved nothing)
    "recompiles_total",
    "solver_latency_p95_seconds",
    # incremental-engine scores (solver/incremental.py): provision passes
    # whose full encode the device-resident state skipped this run (0 on
    # every non-incremental scenario), and the late/early solve-latency
    # p95 ratio (null when the run solved too little to window) — ~1.0 is
    # the O(delta) steady-state witness the soak settled predicate asserts
    "encode_skipped_passes",
    "solver_latency_p95_flatness",
    # the pending-latency waterfall (journal.py): per-segment p50/p95/p99
    # decomposing creation->bind into queue_wait / batch_wait / solve /
    # launch / node_ready / bind — the runner asserts the conservation
    # invariant (segments sum to the observed pending duration) before
    # this block is allowed to land in the artifact
    "waterfall",
    # solver fault-domain scores (solver/faults.py): classified device
    # faults observed during the run (every taxonomy kind summed), the
    # degradation-ladder rungs taken (flavor/chunked/host summed), the
    # faults the run's FaultPlan actually injected (faults_total >=
    # injected is the chaos-scenario acceptance bar), and the circuit
    # breaker's state at convergence — CLOSED proves the device path was
    # re-admitted, not permanently abandoned
    "solver_faults_total",
    "degraded_solves_total",
    "solver_faults_injected",
    "breaker_state",
    # control-plane fault-domain scores (kube/chaos.py + kube/coherence.py):
    # optimistic-concurrency conflicts clients observed during the run
    # (injected storms and organic races), faults the run's KubeFaultPlan
    # actually injected, informer-cache divergences still standing at the
    # teardown coherence check (ZERO is the acceptance bar — the lock-cycle
    # analog for cache coherence), and client-token launches that executed
    # twice (the two-leader / replay-miss witness; also pinned at zero)
    "kube_conflicts_total",
    "kube_faults_injected",
    "informer_divergences",
    "double_launches",
    # invariant-monitor scores (invariants.py): the slow-leak witnesses the
    # soak tier exists for, schema-gated on EVERY run — threads alive after
    # their Runtime released them, watch subscriptions above the armed
    # baseline, the least-squares traced-heap slope (null unless the run
    # traced memory, i.e. the soak tier), and distinct confirmed invariant
    # violations (threads/watches/ring-budget/lock-cycle/coherence/
    # double-launch, each (invariant, entity) counted once)
    "leaked_threads",
    "leaked_watches",
    "rss_growth_slope",
    "invariant_violations",
    # chaos-orchestrator scores (scenarios/chaos_orchestrator.py): total
    # cross-domain fault events delivered this run (imperative schedule
    # events + seeded solver/kube triggers that fired), the schedule's
    # history digest (null when the scenario ran no schedule — equal
    # digests across transports pin the cross-transport determinism
    # witness), and the compressed wall-time the run represents (the
    # recorded span a soak replays; the real duration otherwise)
    "chaos_injected_total",
    "chaos_history_digest",
    "compressed_seconds",
    # incident-capsule scores (capsule.py): evidence bundles captured this
    # run (chaos scenarios require >=1 through their settled predicates,
    # healthy scenarios pin 0) and the per-trigger fingerprint lists —
    # equal maps across transports are the capture-determinism witness the
    # campaign runner asserts before an artifact lands
    "capsules_captured",
    "capsule_triggers",
    # residency-auditor scores (solver/audit.py): divergences the auditor
    # detected this run (healthy scenarios pin 0 — a nonzero here on a run
    # with no corruption specs is a REAL integrity bug, and run_one raises),
    # auto-heals issued (the storm scenario requires heals == divergences),
    # and audits executed (>= 1 proves the auditor actually ran where the
    # scenario enabled it)
    "residency_divergences",
    "residency_heals",
    "audit_passes",
)

BREAKER_STATES = ("closed", "half-open", "open")

# the journal's waterfall segment vocabulary (journal.SEGMENTS mirrored by
# name only — the schema stays importable without the journal's witness/
# metrics imports in consumers that just validate files)
WATERFALL_SEGMENTS = ("queue_wait", "batch_wait", "solve", "launch", "node_ready", "bind")
QUANTILE_KEYS = ("p50", "p95", "p99", "count")
SAMPLE_KEYS = ("t", "pending_pods", "nodes", "cost_per_hour", "disrupting")


def _quantile_errors(block, where: str) -> List[str]:
    errs = []
    if not isinstance(block, dict):
        return [f"{where} must be a dict of per-provisioner quantiles"]
    for provisioner, entry in block.items():
        if not isinstance(entry, dict):
            # a non-dict entry would make `key not in entry` raise (int) or
            # substring-match (str) — report the malformation instead
            errs.append(f"{where}[{provisioner!r}] must be a dict, got {type(entry).__name__}")
            continue
        for key in QUANTILE_KEYS:
            if key not in entry:
                errs.append(f"{where}[{provisioner!r}] missing {key!r}")
    return errs


def run_errors(run, where: str = "run") -> List[str]:
    errs: List[str] = []
    if not isinstance(run, dict):
        return [f"{where} must be a dict"]
    for key in RUN_KEYS:
        if key not in run:
            errs.append(f"{where} missing key {key!r}")
    scores = run.get("scores")
    if isinstance(scores, dict):
        for key in SCORE_KEYS:
            if key not in scores:
                errs.append(f"{where}.scores missing key {key!r}")
        for field in (
            "lost_pods", "leaked_instances", "budget_violations", "restarts", "launch_failures",
            "recompiles_total", "solver_faults_total", "degraded_solves_total", "solver_faults_injected",
            "kube_conflicts_total", "kube_faults_injected", "informer_divergences", "double_launches",
            "leaked_threads", "leaked_watches", "invariant_violations", "chaos_injected_total",
            "encode_skipped_passes", "capsules_captured",
            "residency_divergences", "residency_heals", "audit_passes",
        ):
            value = scores.get(field)
            if value is not None and not isinstance(value, int):
                errs.append(f"{where}.scores.{field} must be an int, got {type(value).__name__}")
        breaker = scores.get("breaker_state")
        if breaker is not None and breaker not in BREAKER_STATES:
            errs.append(f"{where}.scores.breaker_state must be one of {list(BREAKER_STATES)}, got {breaker!r}")
        ups = scores.get("unschedulable_pod_seconds")
        if ups is not None and (not isinstance(ups, (int, float)) or isinstance(ups, bool) or ups < 0):
            errs.append(f"{where}.scores.unschedulable_pod_seconds must be a non-negative number")
        p95 = scores.get("solver_latency_p95_seconds")
        if p95 is not None and (not isinstance(p95, (int, float)) or isinstance(p95, bool) or p95 < 0):
            errs.append(f"{where}.scores.solver_latency_p95_seconds must be null or a non-negative number")
        flat = scores.get("solver_latency_p95_flatness")
        if flat is not None and (not isinstance(flat, (int, float)) or isinstance(flat, bool) or flat < 0):
            errs.append(f"{where}.scores.solver_latency_p95_flatness must be null or a non-negative number")
        slope = scores.get("rss_growth_slope")
        if slope is not None and (not isinstance(slope, (int, float)) or isinstance(slope, bool)):
            # negative is legal (a heap that SHRANK over the window); only
            # a non-number is a malformation
            errs.append(f"{where}.scores.rss_growth_slope must be null or a number")
        digest = scores.get("chaos_history_digest")
        if digest is not None and (not isinstance(digest, str) or not digest):
            errs.append(f"{where}.scores.chaos_history_digest must be null or a non-empty string")
        triggers = scores.get("capsule_triggers")
        if triggers is not None:
            if not isinstance(triggers, dict):
                errs.append(f"{where}.scores.capsule_triggers must be a dict of trigger -> fingerprint list")
            else:
                for trigger, fps in triggers.items():
                    if not isinstance(fps, list) or not fps or any(not isinstance(fp, str) or not fp for fp in fps):
                        errs.append(
                            f"{where}.scores.capsule_triggers[{trigger!r}] must be a non-empty list of"
                            " non-empty fingerprint strings"
                        )
        compressed = scores.get("compressed_seconds")
        if compressed is not None and (
            not isinstance(compressed, (int, float)) or isinstance(compressed, bool) or compressed < 0
        ):
            errs.append(f"{where}.scores.compressed_seconds must be a non-negative number")
        errs.extend(_quantile_errors(scores.get("pending_latency_seconds", {}), f"{where}.scores.pending_latency_seconds"))
        waterfall = scores.get("waterfall")
        if isinstance(waterfall, dict):
            for segment, entry in waterfall.items():
                if segment not in WATERFALL_SEGMENTS:
                    errs.append(
                        f"{where}.scores.waterfall[{segment!r}] is not a waterfall segment"
                        f" (one of {list(WATERFALL_SEGMENTS)})"
                    )
                    continue
                if not isinstance(entry, dict):
                    errs.append(f"{where}.scores.waterfall[{segment!r}] must be a dict, got {type(entry).__name__}")
                    continue
                for key in QUANTILE_KEYS:
                    if key not in entry:
                        errs.append(f"{where}.scores.waterfall[{segment!r}] missing {key!r}")
        elif waterfall is not None:
            errs.append(f"{where}.scores.waterfall must be a dict of per-segment quantiles")
    elif scores is not None:
        errs.append(f"{where}.scores must be a dict")
    samples = run.get("samples")
    if isinstance(samples, list):
        if not samples:
            errs.append(f"{where}.samples must be non-empty")
        last_t = None
        for i, sample in enumerate(samples):
            if not isinstance(sample, dict):
                errs.append(f"{where}.samples[{i}] must be a dict")
                continue
            for key in SAMPLE_KEYS:
                if key not in sample:
                    errs.append(f"{where}.samples[{i}] missing {key!r}")
            t = sample.get("t")
            if isinstance(t, (int, float)):
                if last_t is not None and t < last_t:
                    errs.append(f"{where}.samples[{i}].t={t} goes backwards (prev {last_t}): timestamps must be monotonic")
                last_t = t
    elif samples is not None:
        errs.append(f"{where}.samples must be a list")
    return errs


def scenario_doc_errors(doc) -> List[str]:
    """All structural problems with one SCENARIO_*.json document; empty
    means valid."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["document must be a JSON object"]
    for key in ("scenario", "provenance", "runs"):
        if key not in doc:
            errs.append(f"missing top-level key {key!r}")
    errs.extend(provenance_errors(doc.get("provenance", {})))
    runs = doc.get("runs")
    if isinstance(runs, list):
        if not runs:
            errs.append("runs must be non-empty")
        for i, run in enumerate(runs):
            errs.extend(run_errors(run, where=f"runs[{i}]"))
    elif runs is not None:
        errs.append("runs must be a list")
    return errs
