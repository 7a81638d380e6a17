"""Campaign runner: execute scored scenarios against a live Runtime.

One campaign = a list of composed scenarios (primitives.py), each run
against a REAL Runtime — its own threads, batcher, interruption poll loop,
disruption orchestrator — on one or both cloud transports (the in-process
CloudBackend and the HTTP CloudAPIService/Client pair), with the workload
stand-in (standin.py) playing the cluster around it.

Each scenario emits one `SCENARIO_<name>.json` next to the BENCH_*.json
artifacts: a provenance block (git SHA, timestamp, config hash), per-run
scores (pending-latency p50/p95/p99 per provisioner, time-to-node-ready,
cluster $/hr, cost-drift ratio vs the ideal fresh repack, lost pods, budget
violations, churn counters), and a monotonic sample timeline. Every emitted
document is self-validated against schema.py before it lands on disk, so a
malformed artifact is a crash at emit time, not a silent gap at bisect time.

    python -m karpenter_tpu_torch.scenarios.campaign --out . --transports inprocess,http

Behavioral regressions — pending latency creeping under churn, cost drift
after a reclaim wave — are now diffable artifacts, the way solve-time
regressions have been since bench.py grew per-phase JSON.

The port's copy of karpenter_tpu/scenarios/campaign.py. Its changes:

- `CampaignRunner(device=...)` (default "cuda"; "cpu" runs the plain
  versions of the kernels) passes the device to every Runtime it builds,
  and resolves it first: without a card, "cuda" raises.
- The residency auditor belongs to the Runtime: the runner passes the
  derived audit seed and a full shadow on every audit (`shadow_every=1`)
  through the Runtime's own arguments, and `residency_settled` reads the
  live Runtime's auditor.
- The solver fault specs name the port's seams: "cuda" (K1's launch) where
  the reference names "pallas"; "plain" and "sharded" as the reference
  names them. A run with no mesh never consults "sharded".
- `device_fault_storm`: while the breaker is open the batch is held until
  the half-open probe (solver/faults.py); the reference's host loop takes
  it. `hbm_pressure`: an injected HBM fault holds the batch for a retry, and
  the chunked rung comes only from the pre-solve budget split.
- `chaos_soak`'s bar asks for a counted solver fault where the reference's
  asks for its host-rung capsule, which the port has no counterpart of.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .. import capsule, flight, invariants, journal, slo
from ..kube import chaos as kube_chaos
from ..kube.coherence import COHERENCE
from ..solver import audit as solver_audit
from ..solver import faults as solver_faults
from ..utils.seeds import split_seed
from ..api import labels as lbl
from ..api.objects import NodeSelectorRequirement, ObjectMeta, OP_IN
from ..api.provisioner import Budget, Consolidation, Disruption, Provisioner, ProvisionerSpec
from ..cloudprovider.simulated.backend import CloudBackend
from ..cloudprovider.simulated.provider import SimulatedCloudProvider
from ..controllers.disruption.budgets import allowed_disruptions
from ..device import resolve_device
from ..kube.cluster import KubeCluster
from ..logsetup import get_logger
from ..provenance import provenance_block
from ..runtime import Runtime
from ..utils.options import Options
from .chaos_orchestrator import ChaosSchedule, Soak, diurnal_trace
from .primitives import (
    Burst,
    DiurnalRamp,
    DriftRollout,
    LeaseSteal,
    OutOfBandBind,
    PoolCapacity,
    ProcessCrash,
    Scenario,
    ScenarioContext,
    SpotReclaimWave,
    TransportChaos,
    WatchGap,
)
from .schema import scenario_doc_errors
from .standin import WorkloadStandIn, live_pods

log = get_logger("campaign")

TRANSPORTS = ("inprocess", "http")


def _provisioner(scenario: Scenario) -> Provisioner:
    disruption = None
    if scenario.budget_nodes is not None:
        disruption = Disruption(budgets=[Budget(nodes=scenario.budget_nodes)])
    requirements = [
        NodeSelectorRequirement(
            key=lbl.LABEL_CAPACITY_TYPE,
            operator=OP_IN,
            values=[lbl.CAPACITY_TYPE_SPOT, lbl.CAPACITY_TYPE_ON_DEMAND],
        )
    ]
    if scenario.instance_types:
        requirements.append(
            NodeSelectorRequirement(key=lbl.LABEL_INSTANCE_TYPE, operator=OP_IN, values=list(scenario.instance_types))
        )
    return Provisioner(
        metadata=ObjectMeta(name="default", namespace=""),
        spec=ProvisionerSpec(
            requirements=requirements,
            # admission rejects consolidation + ttlSecondsAfterEmpty together
            ttl_seconds_after_empty=None if scenario.consolidation else scenario.ttl_seconds_after_empty,
            consolidation=Consolidation(enabled=True) if scenario.consolidation else None,
            disruption=disruption,
        ),
    )


def drift_settled(ctx: ScenarioContext) -> bool:
    """The drift scenario's extra convergence bar: every owned node carries
    the CURRENT provisioner spec hash (no survivor is stale) and the
    disruption ledger has drained — the rollout finished, not just paused."""
    from ..scheduling.nodetemplate import NodeTemplate

    provisioner = ctx.kube.get("Provisioner", "default", namespace="")
    if provisioner is None:
        return True
    current = NodeTemplate.from_provisioner(provisioner).spec_hash()
    for node in ctx.kube.list_nodes():
        if node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) != provisioner.name:
            continue
        if node.metadata.annotations.get(lbl.PROVISIONER_HASH_ANNOTATION) != current:
            return False
    disruption = ctx.runtime.disruption
    return disruption is None or disruption.tracker.total_in_flight() == 0


def _leaked_instances(ctx: ScenarioContext) -> int:
    """Cloud instances minus registered capacity: anything running at the
    cloud that no node object points at is paid-for capacity the cluster
    cannot use — the crash-between-launch-and-bind failure shape the GC
    sweep exists to reconcile away."""
    registered = {
        node.spec.provider_id.rsplit("/", 1)[-1] for node in ctx.kube.list_nodes() if node.spec.provider_id
    }
    return sum(1 for instance_id in list(ctx.backend.instances) if instance_id not in registered)


def consolidated_settled(ctx: ScenarioContext) -> bool:
    """The consolidation-on diurnal's convergence bar: the disruption ledger
    has drained AND an explicit drift re-solve prices the surviving fleet
    within 1.5x of the ideal fresh repack — ramp-down capacity was actually
    consolidated away, not merely left stranded (the diurnal ramp scored
    4.5x here with consolidation off)."""
    disruption = ctx.runtime.disruption
    if disruption is not None and disruption.tracker.total_in_flight() > 0:
        return False
    ctx.runtime.slo_metrics.scrape()
    ratio = ctx.runtime.slo_metrics.compute_drift()
    return ratio is not None and ratio <= 1.5


def _node_pool(node) -> tuple:
    labels = node.metadata.labels
    return (
        labels.get(lbl.LABEL_INSTANCE_TYPE),
        labels.get(lbl.LABEL_TOPOLOGY_ZONE),
        labels.get(lbl.LABEL_CAPACITY_TYPE),
    )


def capacity_recovered(ctx: ScenarioContext) -> bool:
    """The capacity-crunch convergence bar: the quarantine has fully
    expired (no offering is still marked unavailable) AND the newest owned
    node launched in the CHEAPEST (type, zone, capacity-type) pool — proof
    the exhausted pool was re-selected once its TTL lapsed, not permanently
    abandoned for the pricier fallback."""
    provider = ctx.runtime.cloud_provider  # metrics decorator forwards .unavailable
    if getattr(provider, "unavailable", None) is not None and provider.unavailable.snapshot():
        return False
    nodes = [
        n
        for n in ctx.kube.list_nodes()
        if n.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) and n.metadata.deletion_timestamp is None
    ]
    if not nodes:
        return False
    od_books, spot_books = ctx.backend.describe_prices()

    def pool_price(pool: tuple) -> float:
        type_name, zone, ct = pool
        if ct == lbl.CAPACITY_TYPE_SPOT:
            return spot_books.get((type_name, zone), float("inf"))
        return od_books.get(type_name, float("inf"))

    newest = max(nodes, key=lambda n: n.metadata.creation_timestamp)
    # cheapest pool the fleet's type(s) could launch in (spot + od books)
    types = {n.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE) for n in nodes}
    candidates = [(t, z, ct) for t in types for (t2, z) in spot_books if t2 == t for ct in (lbl.CAPACITY_TYPE_SPOT,)]
    candidates += [(t, s.zone, lbl.CAPACITY_TYPE_ON_DEMAND) for t in types for s in ctx.backend.subnets]
    cheapest = min(candidates, key=pool_price)
    return pool_price(_node_pool(newest)) <= pool_price(cheapest) + 1e-9


def avoids_unavailable_pools(ctx: ScenarioContext) -> bool:
    """The spot-collapse convergence bar: every node launched AFTER the
    reclaim wave avoids the quarantined pools (a pre-wave survivor may
    legitimately keep running inside one), and at least one such
    replacement exists. The offering TTL outlives the scenario, so
    convergence cannot ride a quarantine expiry."""
    if ctx.reclaim_started_at is None:
        return False  # the wave has not fired yet
    provider = ctx.runtime.cloud_provider
    unavailable = getattr(provider, "unavailable", None)
    quarantined = unavailable.snapshot() if unavailable is not None else set()
    if not quarantined:
        return False  # the interruption feed never marked the reclaimed pools
    replacements = [
        n for n in ctx.kube.list_nodes() if n.metadata.creation_timestamp > ctx.reclaim_started_at
    ]
    if not replacements:
        return False
    return all(_node_pool(n) not in quarantined for n in replacements)


def _unschedulable_pod_seconds(samples: List[dict]) -> float:
    """Integral of pending pods over the sample timeline (pod-seconds):
    the user-visible cost of a capacity crunch even when nothing is lost."""
    total = 0.0
    for prev, cur in zip(samples, samples[1:]):
        total += prev["pending_pods"] * max(0.0, cur["t"] - prev["t"])
    return round(total, 3)


def _launch_failures_total() -> int:
    """Process-wide launch-failure counter sum (all reasons); run_one
    snapshots it at start and scores the delta."""
    from ..metrics import REGISTRY

    counter = REGISTRY.get("karpenter_provisioning_launch_failures_total")
    return int(sum(counter.values().values())) if counter is not None else 0


def _solver_latency_p95():
    """p95 of real Scheduler.solve wall-clock this run (flight.py summary,
    reset at run start); None when the run never solved."""
    import math

    value = flight.SOLVE_LATENCY.quantile(0.95)
    return None if math.isnan(value) else round(value, 6)


# flatness bound the soak settled predicate enforces when the incremental
# engine is on: the second-half solve p95 may not exceed twice the
# first-half p95 — O(delta) steady state means latency tracks the per-tick
# delta, not the grown cluster (generous enough for CPU-sim timing noise,
# far below the drift a per-pass full re-encode of a growing cluster shows)
SOAK_P95_FLATNESS_BOUND = 2.0


def _solver_latency_p95_flatness():
    """Late/early solve-latency ratio this run: p95 of the second half of
    the real Scheduler.solve observations over p95 of the first half. ~1.0
    means flat — the incremental engine's O(delta) steady-state claim as
    the cluster grows at fixed per-tick delta. None when the run solved too
    little to window (fewer than 8 observations)."""
    obs = flight.SOLVE_LATENCY.observations()
    if len(obs) < 8:
        return None

    def p95(values):
        ordered = sorted(values)
        return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]

    early, late = p95(obs[: len(obs) // 2]), p95(obs[len(obs) // 2 :])
    if early <= 0.0:
        return None
    return round(late / early, 4)


def _incremental_delta_passes() -> int:
    """Process-wide count of incremental-engine delta passes — provision
    passes whose encode+fill the resident state skipped
    (solver/incremental.py). run_one snapshots this at start and scores the
    run's delta as `encode_skipped_passes`; reads through the registry so
    a host-loop run that never imported the engine scores 0."""
    from ..metrics import REGISTRY

    counter = REGISTRY.get("karpenter_solver_incremental_passes_total")
    return int(counter.value(kind="delta")) if counter is not None else 0


def breaker_reclosed(ctx: ScenarioContext) -> bool:
    """The device-fault-storm convergence bar: at least one planned fault
    fired (the plan carries one spec per dispatch flavor, so only the active
    flavor's triggers are consumable), repeated faults actually opened the
    circuit breaker (the device attempt stopped being paid), and a half-open
    recovery probe has since re-admitted the fast path — CLOSED at
    convergence, not permanently abandoned."""
    plan = solver_faults.FAULTS.plan
    if plan is None or plan.fired() < 1:
        return False
    breaker = solver_faults.BREAKER
    if breaker.opened_total < 1 or breaker.state != solver_faults.STATE_CLOSED:
        return False
    # the breaker trip must have produced an incident capsule: the storm's
    # acceptance bar includes the evidence, not just the recovery
    return bool(capsule.CAPSULE.fingerprints().get(capsule.TRIGGER_BREAKER_OPEN))


def hbm_degraded_settled(ctx: ScenarioContext) -> bool:
    """The hbm-pressure convergence bar: the planned HBM faults fired, THIS
    run's chunked-solve rung absorbed the pressure (the counter is process-
    lifetime monotonic — score the delta over the run-start stamp, or a
    prior run in the same process pre-satisfies the bar), and the breaker
    NEVER opened — memory pressure is degradation, not an outage."""
    plan = solver_faults.FAULTS.plan
    if plan is None or plan.fired() < 1:
        return False
    chunked = solver_faults.DEGRADED_SOLVES.value(rung=solver_faults.RUNG_CHUNKED) - ctx.solver_chunked_at_start
    breaker = solver_faults.BREAKER
    return chunked >= 1 and breaker.opened_total == 0 and breaker.state == solver_faults.STATE_CLOSED


def leader_flap_settled(ctx: ScenarioContext) -> bool:
    """The leader-flap-storm convergence bar: both steals actually landed
    and were recovered from (each steal bumps lease_transitions once, each
    rightful re-acquisition bumps again -> >= 4), the runtime's elector
    holds the lease AND its gate is open again, no client token ever
    EXECUTED two launches (the two-leader witness), and the drift rollout
    the flaps interrupted still finished under its budget."""
    elector = getattr(ctx.runtime, "elector", None)
    if elector is None or not elector.is_leader():
        return False
    lease = ctx.kube.get("Lease", elector.name, elector.namespace)
    if lease is None or lease.spec.holder_identity != elector.identity:
        return False
    if (lease.spec.lease_transitions or 0) < 4:
        return False
    if ctx.backend.double_launches():
        return False
    return drift_settled(ctx)


def watch_gap_settled(ctx: ScenarioContext) -> bool:
    """The watch-gap-storm convergence bar: the planned conflict storm
    actually fired, and the chaos history shows both gap windows opened and
    CLOSED with at least one forced compaction — so converging with zero
    informer divergences proves the replay/relist repair ran, not a run
    where the weather never arrived."""
    plan = kube_chaos.KUBE_CHAOS.plan
    if plan is None or plan.fired() < 1:
        return False
    history = plan.history()
    gap_ends = sum(1 for h in history if h.get("action") == "watch-gap-end")
    compactions = sum(1 for h in history if h.get("action") == "compact")
    return gap_ends >= 2 and compactions >= 1


def soak_settled(
    ctx: ScenarioContext, schedule: ChaosSchedule, require_delta_passes: int = 0, require_capsules: int = 0,
    require_solver_faults: int = 0,
) -> bool:
    """The soak convergence bar: the chaos schedule fully delivered (a run
    the weather never reached proves nothing), the solver breaker re-closed
    (a fault storm that permanently abandoned the device path is not
    'settled'), and the invariant monitor confirmed ZERO violations — the
    leak witnesses are the whole point of the tier."""
    if schedule.injected_total() < len(schedule.events):
        return False
    if solver_faults.BREAKER.state != solver_faults.STATE_CLOSED:
        return False
    if getattr(ctx.runtime.options, "solver_incremental", False):
        # the soak tier runs the incremental engine: settling additionally
        # requires that it ENGAGED (delta passes this run — a soak where
        # every pass fell back to a full re-encode would pass the invariant
        # bar while silently losing the O(delta) property) and that solve
        # latency stayed FLAT as the cluster grew (late-half p95 within
        # SOAK_P95_FLATNESS_BOUND of the early half; None = too few solves
        # to window). The engagement floor is per-scenario: the full soak
        # grows a cluster where delta passes MUST dominate, while the
        # mini-soak's 1-2-view cluster legitimately rides the bulk-
        # fallback fulls (its dirty fraction can never sit under the
        # threshold), so it pins only the flatness bound
        if _incremental_delta_passes() - ctx.incremental_delta_at_start < require_delta_passes:
            return False
        flat = _solver_latency_p95_flatness()
        if flat is not None and flat > SOAK_P95_FLATNESS_BOUND:
            return False
    if solver_faults.faults_total() - ctx.solver_faults_at_start < require_solver_faults:
        # the port's evidence of a seeded solver fault: the held batch is
        # classified and counted (and journaled as a `solver` event); the
        # reference's host-rung capsule has no counterpart, since no rung
        # takes the batch off the device
        return False
    if capsule.CAPSULE.captures_total() < require_capsules:
        # the soak's seeded solver faults must leave evidence behind: the
        # full soak demands at least one incident capsule (the host-rung
        # capture from the seeded compile faults); the mini-soak's shorter
        # schedule keeps the default of zero
        return False
    if getattr(ctx.runtime.options, "residency_audit_interval", 0) > 0:
        # the residency auditor rode the soak: it must have actually audited
        # (>= 1 executed audit), and — since a soak plans no corruption
        # specs — divergences pin at EXACTLY zero. Compressed hours of churn
        # with byte-equal residency is the auditor's specificity witness:
        # the storm scenario proves it catches real corruption, the soak
        # proves it never cries wolf
        if solver_audit.audit_passes_total() - ctx.audit_passes_at_start < 1:
            return False
        if solver_audit.divergences_total() - ctx.residency_divergences_at_start != 0:
            return False
    return not invariants.MONITOR.violations()


def residency_settled(ctx: ScenarioContext) -> bool:
    """The residency-divergence-storm convergence bar: both seeded
    corruptions actually fired (a run the injections never reached proves
    nothing), the auditor detected EXACTLY one divergence per injection
    (none missed, none spurious), every divergence healed (invalidate with
    reason 'audit' forced the byte-equal full re-encode path), at least one
    clean audit has run since the last divergence (the rebuilt resident
    state re-verified against cluster truth — the placement-parity
    witness), and each divergence kind left its own capsule behind."""
    plan = solver_faults.FAULTS.plan
    if plan is None or plan.corruptions_fired() < 2:
        return False
    divergences = solver_audit.divergences_total() - ctx.residency_divergences_at_start
    heals = solver_audit.heals_total() - ctx.residency_heals_at_start
    if divergences != plan.corruptions_fired() or heals != divergences:
        return False
    auditor = getattr(ctx.runtime, "auditor", None)
    if auditor is None or auditor.clean_streak < 1:
        return False
    # two injections of different kinds -> two distinct fingerprints (the
    # capsule detail is {kinds, rows}, transport-stable by construction)
    return len(capsule.CAPSULE.fingerprints().get(capsule.TRIGGER_RESIDENCY, ())) >= 2


def _lost_pods(ctx: ScenarioContext) -> int:
    """Pods the cluster failed: unbound, or bound to a node whose backing
    instance is gone / whose node object vanished."""
    lost = 0
    for pod in live_pods(ctx.kube):
        if not pod.spec.node_name:
            lost += 1
            continue
        node = ctx.kube.get_node(pod.spec.node_name)
        if node is None or not ctx.backend.instance_exists(node.spec.provider_id.split("///", 1)[-1]):
            lost += 1
    return lost


def _converged(ctx: ScenarioContext, scenario: Scenario) -> bool:
    pods = live_pods(ctx.kube)
    if len(pods) != ctx.desired or any(not p.spec.node_name for p in pods):
        return False
    for node in ctx.kube.list_nodes():
        if not ctx.backend.instance_exists(node.spec.provider_id.split("///", 1)[-1]):
            return False  # a node object survives its dead instance
    if _leaked_instances(ctx):
        return False  # an instance survives with no node pointing at it
    if _lost_pods(ctx):
        return False
    if ctx.backend.notifications.depth() != 0:
        return False
    if COHERENCE.compare_registered():
        return False  # the informer caches have not caught the store yet
    return scenario.settled is None or scenario.settled(ctx)


class CampaignRunner:
    def __init__(
        self,
        out_dir: str = ".",
        transports=TRANSPORTS,
        sample_period: float = 0.4,
        convergence_timeout: float = 60.0,
        journal_dir: Optional[str] = None,
        device: str = "cuda",
    ):
        self.device = str(resolve_device(device))
        self.out_dir = out_dir
        self.transports = tuple(transports)
        self.sample_period = sample_period
        self.convergence_timeout = convergence_timeout
        # when set, each run spools its lifecycle journal to
        # <journal_dir>/JOURNAL_<scenario>_<transport>.jsonl — the captured
        # arrival trace ReplayTrace replays (the SCENARIO artifacts stay the
        # committed record; journals are capture output, not comparison data)
        self.journal_dir = journal_dir

    # -- one scenario on one transport ----------------------------------------

    def run_one(self, scenario: Scenario, transport: str) -> dict:
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; one of {TRANSPORTS}")
        slo.SLO.reset()
        flight.FLIGHT.reset()  # per-run solver-latency quantiles + records
        journal.JOURNAL.reset()  # per-run lifecycle events + waterfalls
        capsule.CAPSULE.reset()  # per-run captures + dedupe/debounce state
        # solver fault domain (solver/faults.py): each run starts from a
        # CLOSED breaker and scores only its own fault/degradation deltas;
        # a device-chaos scenario installs its seeded FaultPlan for the
        # whole run so both transports inject the identical fault sequence
        solver_faults.BREAKER.reset()
        faults_at_start = solver_faults.faults_total()
        degraded_at_start = solver_faults.degraded_total()
        # ONE master seed per scenario (utils/seeds.py): every seeded
        # consumer below — the solver plan, the kube plan, the stand-in's
        # jitter — derives from scenario.seed, and the derivation lands in
        # provenance, so the whole run replays from one number
        derived_seeds = scenario.derived_seeds()
        if scenario.fault_specs:
            solver_faults.FAULTS.install(
                solver_faults.FaultPlan.from_specs(scenario.fault_specs, seed=derived_seeds["fault_seed"])
            )
        # residency auditor (solver/audit.py): each Runtime builds its own,
        # with the sampling knobs passed below (shadow_every=1 — scenario
        # clusters are small, so every audit is a full shadow and detection
        # is same-pass deterministic; the derived audit seed makes both
        # transports draw identical samples)
        kube_conflicts_at_start = kube_chaos.conflicts_total()
        kube = KubeCluster()
        backend = CloudBackend(clock=kube.clock)
        backend.notifications.visibility_timeout = 1.0
        service = None
        cloud = backend
        if transport == "http":
            from ..cloudprovider.simulated import CloudAPIClient, CloudAPIService

            service = CloudAPIService(backend=backend).start()
            cloud = CloudAPIClient(service.url)
        provider = SimulatedCloudProvider(backend=cloud, kube=kube, clock=kube.clock)
        if scenario.offering_ttl is not None:
            # crunch scenarios need the quarantine to expire (or outlive the
            # run) on the SCENARIO's timescale, not the production default
            provider.unavailable.ttl = scenario.offering_ttl

        def runtime_factory() -> Runtime:
            # each (re)boot is a FRESH control plane over the same cluster +
            # cloud: new state cache, new ledger, new loops — recovery is the
            # startup reconstruction, never shared memory. gc runs on a tight
            # interval with a short registration grace so crash leftovers
            # reconcile within the scenario's convergence window
            return Runtime(
                kube=kube,
                cloud_provider=provider,
                device=self.device,
                audit_seed=derived_seeds["audit_seed"],
                audit_shadow_every=1,
                options=Options(
                    # the leader-flap scenarios elect for real (and the
                    # LeaseSteal primitive deposes); everything else skips
                    # election as before. Lease timing is scenario-scale so
                    # a stolen lease expires — and the rightful leader
                    # re-acquires + recovers — inside the run window
                    leader_elect=scenario.leader_elect,
                    lease_duration=1.5,
                    lease_renew_period=0.25,
                    # the informer-coherence witness runs live against every
                    # scenario's state cache; the runner also requires a
                    # clean compare for convergence and scores the teardown
                    # final_check as `informer_divergences`
                    coherence_interval=0.5,
                    # the device-chaos scenarios run the dense device path
                    # (min_batch=1: every provisioning batch dispatches, so
                    # the fault-injection seam sits under real traffic); all
                    # other scenarios keep the host loop
                    dense_solver_enabled=scenario.dense_solver,
                    dense_min_batch=1,
                    # the soak tier additionally runs the incremental solve
                    # engine (solver/incremental.py): settling then requires
                    # delta passes taken + a flat solve-latency p95
                    solver_incremental=scenario.solver_incremental,
                    # the residency storm (and the soak's healthy pin) audit
                    # the resident state on the scenario's cadence; restarts
                    # re-wire interval + clock without clobbering the
                    # campaign's pre-seeded sampling knobs above
                    residency_audit_interval=scenario.residency_audit_interval,
                    solver_breaker_threshold=scenario.solver_breaker_threshold,
                    solver_breaker_backoff=scenario.solver_breaker_backoff,
                    solver_hbm_budget_bytes=scenario.solver_hbm_budget_bytes,
                    batch_max_duration=0.3,
                    batch_idle_duration=0.05,
                    interruption_queue="interruptions",
                    interruption_poll_interval=0.2,
                    enable_slo=True,
                    # solver telemetry scores the steady-state property:
                    # recompiles_total (must be 0 for a settled cluster
                    # re-solving under churn) + solver-latency p95
                    enable_solver_telemetry=True,
                    # the lifecycle journal decomposes every pod's pending
                    # latency into waterfall segments (scored below, with
                    # the conservation invariant enforced) and records the
                    # arrival trace replay builds on
                    enable_journal=True,
                    # incident capsules ride every scenario: chaos runs
                    # must capture their evidence bundles (scored below),
                    # healthy runs must capture exactly none
                    enable_capsules=True,
                    # per-kind capture debounce override: the residency
                    # storm needs BOTH of its distinct divergence captures,
                    # which land closer together than the production default
                    **(
                        {"capsule_debounce_seconds": scenario.capsule_debounce_seconds}
                        if scenario.capsule_debounce_seconds is not None
                        else {}
                    ),
                    gc_interval=1.0,
                    gc_registration_grace=3.0,
                    # scenario timescales are seconds: a parked pod must
                    # re-probe within the run, not 10s later
                    ice_backoff_seconds=1.5,
                ),
            )

        runtime = runtime_factory()
        if self.journal_dir is not None:
            os.makedirs(self.journal_dir, exist_ok=True)
            journal.JOURNAL.set_spool(
                os.path.join(self.journal_dir, f"JOURNAL_{scenario.name}_{transport}.jsonl")
            )
        provisioner = _provisioner(scenario)
        kube.create(provisioner)
        ctx = ScenarioContext(
            kube, backend, runtime, service=service, pod_cpu=scenario.pod_cpu, runtime_factory=runtime_factory
        )
        ctx.solver_chunked_at_start = solver_faults.DEGRADED_SOLVES.value(rung=solver_faults.RUNG_CHUNKED)
        ctx.solver_faults_at_start = faults_at_start
        stand_in = WorkloadStandIn(ctx, jitter_seed=derived_seeds["standin_jitter_seed"])
        reclaim_thread = threading.Thread(
            target=self._reclaimer, args=(ctx,), name="cloud-reclaimer", daemon=True
        )
        samples: List[dict] = []
        violations = 0
        launch_failures_at_start = _launch_failures_total()
        recompiles_at_start = flight.FLIGHT.compilations_total()
        # incremental-engine pass counters are process-lifetime monotonic
        # (a prior incremental run in the same process would pre-satisfy
        # the soak engaged bar) — stamp run-start and score the delta
        incremental_delta_at_start = _incremental_delta_passes()
        ctx.incremental_delta_at_start = incremental_delta_at_start
        # residency-auditor counters are process-lifetime monotonic too:
        # stamp run-start so scores and settled predicates see THIS run's
        # divergence/heal/audit deltas
        ctx.residency_divergences_at_start = solver_audit.divergences_total()
        ctx.residency_heals_at_start = solver_audit.heals_total()
        ctx.audit_passes_at_start = solver_audit.audit_passes_total()
        start = time.monotonic()
        try:
            # control-plane fault domain (kube/chaos.py): the seeded
            # KubeFaultPlan arms INSIDE the try — the setup writes above
            # (provisioner create, runtime assembly) run clean, and a fault
            # that kills the run can never leak an armed plan into the next
            # scenario (the finally always disarms). Both transports inject
            # the identical fault sequence; every run scores its own delta
            if scenario.kube_fault_specs:
                kube_chaos.KUBE_CHAOS.install(
                    kube_chaos.KubeFaultPlan.from_specs(scenario.kube_fault_specs, seed=derived_seeds["kube_fault_seed"])
                )
            runtime.start()
            # the invariant monitor (invariants.py) arms AFTER the runtime
            # attached its watchers: the armed state is the healthy baseline
            # (crash/restart cycles are net-zero detach/attach by contract),
            # and every later sample — one per runner tick, ~one compressed
            # minute at soak compression — hunts growth above it. Memory is
            # traced only on the soak tier: tracemalloc taxes every
            # allocation, and the short storms have nothing to slow-leak
            invariants.MONITOR.arm(
                kube, backend=backend, clock=kube.clock, trace_memory=isinstance(scenario, Soak)
            )
            stand_in.start()
            reclaim_thread.start()
            ctx.desired = scenario.desired
            workers = []
            for primitive in scenario.primitives:
                thread = threading.Thread(
                    target=self._run_primitive, args=(ctx, primitive), name=f"primitive-{type(primitive).__name__}", daemon=True
                )
                thread.start()
                workers.append(thread)

            def timeline_live() -> bool:
                return time.monotonic() - start < scenario.duration or any(w.is_alive() for w in workers)

            while timeline_live():
                violations += self._sample(ctx, provisioner, samples, start)
                time.sleep(self.sample_period)
            deadline = time.monotonic() + self.convergence_timeout
            converged = False
            while time.monotonic() < deadline:
                violations += self._sample(ctx, provisioner, samples, start)
                if _converged(ctx, scenario):
                    converged = True
                    break
                time.sleep(self.sample_period)
            # final accounting: fresh cost gauges + an explicit drift solve
            # (through ctx.runtime — a crash scenario's live control plane is
            # the latest successor, not the Runtime this frame started with)
            ctx.runtime.slo_metrics.scrape()
            ctx.runtime.slo_metrics.compute_drift()
            violations += self._sample(ctx, provisioner, samples, start)
            snapshot = slo.SLO.snapshot()
            # the conservation invariant, enforced at emit time like the
            # schema: every completed pod's segments must sum to the pending
            # duration the SLO accountant independently observed
            conservation = journal.JOURNAL.conservation_errors()
            if conservation:
                raise AssertionError(
                    f"[{scenario.name}/{transport}] waterfall conservation violated: {conservation[:5]}"
                )
            # the teardown coherence check, the zero-lock-cycles analog:
            # after the run quiesces every informer cache must deep-match
            # the store; divergences still standing after the settle window
            # are scored (and pinned at zero by the chaos suites)
            divergences = COHERENCE.final_check(timeout=5.0)
            # the invariant monitor's final round + report: the slow-leak
            # witnesses (thread stragglers, watch growth, ring budgets, heap
            # slope) become scored artifact keys next to lost/leaked/budget
            invariants.MONITOR.sample()
            invariant_report = invariants.MONITOR.report()
            schedules = [p for p in scenario.primitives if isinstance(p, ChaosSchedule)]
            solver_injected = int(solver_faults.FAULTS.fired())
            # residency-integrity accounting: this run's divergence/heal/
            # audit deltas. A divergence on a run with NO corruption specs
            # is a REAL resident-state integrity bug (the auditor compared
            # against freshly re-encoded truth and lost) — fail the run
            # loudly, exactly like a conservation violation
            residency_divergences = int(solver_audit.divergences_total() - ctx.residency_divergences_at_start)
            residency_heals = int(solver_audit.heals_total() - ctx.residency_heals_at_start)
            audit_passes = int(solver_audit.audit_passes_total() - ctx.audit_passes_at_start)
            corruption_planned = any(
                spec.get("kind") in solver_faults.CORRUPTION_KINDS for spec in (scenario.fault_specs or ())
            )
            if residency_divergences and not corruption_planned:
                raise AssertionError(
                    f"[{scenario.name}/{transport}] residency auditor found {residency_divergences}"
                    f" divergence(s) on a run with no corruption specs: resident state diverged from truth"
                )
            kube_injected = int(kube_chaos.KUBE_CHAOS.fired())
            duration_wall = time.monotonic() - start
            compressed = scenario.compressed_span if isinstance(scenario, Soak) and scenario.compressed_span > 0 else duration_wall
            pods = live_pods(kube)
            run = {
                "transport": transport,
                "duration_seconds": round(duration_wall, 3),
                "converged": converged,
                "scores": {
                    "pending_latency_seconds": snapshot["pod_pending_latency_seconds"],
                    "node_ready_seconds": snapshot["node_ready_seconds"],
                    "cost_per_hour": snapshot["cost"]["cluster_cost_per_hour"],
                    "ideal_cost_per_hour": snapshot["cost"]["ideal_cost_per_hour"],
                    "cost_drift_ratio": snapshot["cost"]["cost_drift_ratio"],
                    "lost_pods": _lost_pods(ctx),
                    "leaked_instances": _leaked_instances(ctx),
                    "budget_violations": violations,
                    "pods_desired": ctx.desired,
                    "pods_bound": sum(1 for p in pods if p.spec.node_name),
                    "nodes_churned": snapshot["churn"]["nodes_churned"],
                    "pods_displaced": snapshot["churn"]["pods_displaced"],
                    "restarts": ctx.restarts,
                    "launch_failures": _launch_failures_total() - launch_failures_at_start,
                    "unschedulable_pod_seconds": _unschedulable_pod_seconds(samples),
                    "recompiles_total": flight.FLIGHT.compilations_total() - recompiles_at_start,
                    "solver_latency_p95_seconds": _solver_latency_p95(),
                    # incremental-engine engagement + the O(delta) flatness
                    # witness (late/early p95 ratio; None when the run
                    # solved too little to window) — scored on every run,
                    # asserted by the soak settled predicate
                    "encode_skipped_passes": int(_incremental_delta_passes() - incremental_delta_at_start),
                    "solver_latency_p95_flatness": _solver_latency_p95_flatness(),
                    "waterfall": journal.JOURNAL.segment_quantiles(),
                    "solver_faults_total": int(solver_faults.faults_total() - faults_at_start),
                    "degraded_solves_total": int(solver_faults.degraded_total() - degraded_at_start),
                    "solver_faults_injected": int(solver_faults.FAULTS.fired()),
                    "breaker_state": solver_faults.BREAKER.state,
                    "kube_conflicts_total": int(kube_chaos.conflicts_total() - kube_conflicts_at_start),
                    "kube_faults_injected": kube_injected,
                    "informer_divergences": len(divergences),
                    "double_launches": int(ctx.backend.double_launches()),
                    "leaked_threads": int(invariant_report["leaked_threads"]),
                    "leaked_watches": int(invariant_report["leaked_watches"]),
                    "rss_growth_slope": invariant_report["rss_growth_slope"],
                    "invariant_violations": len(invariant_report["violations"]),
                    "chaos_injected_total": int(
                        sum(s.injected_total() for s in schedules) + solver_injected + kube_injected
                    ),
                    "chaos_history_digest": schedules[0].history_digest() if schedules else None,
                    "compressed_seconds": round(compressed, 3),
                    # incident-capsule scores (capsule.py): evidence bundles
                    # captured this run (chaos scenarios require >=1 via
                    # their settled predicates; healthy scenarios pin 0)
                    # and the per-trigger fingerprint lists — equal maps
                    # across transports pin the capture-determinism witness
                    "capsules_captured": int(capsule.CAPSULE.captures_total()),
                    "capsule_triggers": capsule.CAPSULE.fingerprints(),
                    # residency-auditor scores (solver/audit.py): healthy
                    # runs pin divergences at 0 (asserted above); the storm
                    # scenario's settled predicate requires divergences ==
                    # injections and heals == divergences
                    "residency_divergences": residency_divergences,
                    "residency_heals": residency_heals,
                    "audit_passes": audit_passes,
                },
                "samples": samples,
            }
            log.info(
                "[%s/%s] converged=%s pods=%d/%d lost=%d leaked=%d drift=%.3f violations=%d restarts=%d in %.1fs",
                scenario.name, transport, converged, run["scores"]["pods_bound"], ctx.desired,
                run["scores"]["lost_pods"], run["scores"]["leaked_instances"], run["scores"]["cost_drift_ratio"],
                violations, ctx.restarts, run["duration_seconds"],
            )
            return run
        finally:
            ctx.stop.set()
            # only join threads that actually started: runtime.start() can
            # raise before they do, and join() on an unstarted Thread raises
            # RuntimeError — masking the real startup failure
            for thread in (stand_in, reclaim_thread):
                if thread.ident is not None:
                    thread.join(timeout=3)
            ctx.runtime.stop()  # the latest successor, if a crash primitive rotated it
            if service is not None:
                service.stop()
            # the Runtime enabled the process-wide accountant; a finished
            # run must not leave accounting on for unrelated work (the next
            # run_one re-enables through its own Runtime)
            slo.SLO.disable()
            flight.FLIGHT.disable()
            journal.JOURNAL.set_spool(None)  # close (and keep) the capture
            journal.JOURNAL.disable()
            capsule.CAPSULE.disable()
            solver_faults.FAULTS.clear()  # never leak a fault plan past its run
            kube.chaos_watch_gap_end()  # a gap leaked past its run wedges nothing
            kube_chaos.KUBE_CHAOS.clear()
            invariants.MONITOR.disarm()  # ends the window; tracemalloc off

    @staticmethod
    def _run_primitive(ctx: ScenarioContext, primitive) -> None:
        if ctx.stop.wait(timeout=primitive.offset):
            return
        try:
            primitive.run(ctx)
        except Exception:  # noqa: BLE001 - one primitive must not kill the scenario
            log.exception("primitive %s failed", type(primitive).__name__)

    @staticmethod
    def _reclaimer(ctx: ScenarioContext) -> None:
        # the cloud makes good on its interruption warnings
        while not ctx.stop.wait(timeout=0.2):
            ctx.backend.reclaim_due_instances()

    def _sample(self, ctx: ScenarioContext, provisioner, samples: List[dict], start: float) -> int:
        """Append one timeline sample; returns 1 when voluntary disruption
        exceeds the provisioner's active budget (the budget-violation
        score), else 0. The check is TWO-WITNESS: the in-memory ledger AND
        an independent scan of the API for nodes carrying the durable
        karpenter.sh/disrupting marker mid-drain — so a restart that lost
        the ledger (or rebuilt it wrong) cannot hide an over-budget drain."""
        in_flight = 0
        if ctx.runtime.disruption is not None:
            in_flight = ctx.runtime.disruption.tracker.total_in_flight()
        nodes = ctx.kube.list_nodes()
        scanned = sum(
            1 for n in nodes
            if lbl.DISRUPTING_ANNOTATION in n.metadata.annotations and n.metadata.deletion_timestamp is not None
        )
        owned = sum(1 for n in nodes if n.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) == provisioner.name)
        limit = allowed_disruptions(provisioner, owned, ctx.kube.clock.now())
        violated = limit is not None and max(in_flight, scanned) > limit
        # the invariant monitor rides the sample cadence: ~one round per
        # 0.4s of wall time, which at soak compression is about one round
        # per compressed minute — the "sample every N compressed minutes"
        # contract without a second timer
        invariants.MONITOR.sample()
        # the capsule engine polls on the same cadence (drains the trigger
        # bus + runs the burn-rate monitor) so captures exist BEFORE the
        # settled predicates that require them are checked
        capsule.CAPSULE.poll()
        samples.append(
            {
                "t": round(time.monotonic() - start, 3),
                "pending_pods": len(ctx.kube.pending_pods()),
                "nodes": len(nodes),
                "cost_per_hour": round(slo.CLUSTER_COST.value(), 6),
                "disrupting": in_flight,
                # informational: the rolling solve p95 at this sample — the
                # timeline behind the scored flatness ratio
                "solver_p95": _solver_latency_p95(),
            }
        )
        return 1 if violated else 0

    # -- the campaign ----------------------------------------------------------

    def run(self, scenarios: List[Scenario]) -> List[dict]:
        docs = []
        os.makedirs(self.out_dir, exist_ok=True)
        for scenario in scenarios:
            doc = {
                "scenario": scenario.name,
                "description": scenario.description,
                "provenance": provenance_block(scenario.config()),
                "runs": [self.run_one(scenario, transport) for transport in self.transports],
            }
            errors = scenario_doc_errors(doc)
            if errors:
                raise AssertionError(f"scenario {scenario.name} emitted an invalid document: {errors}")
            # the capture-determinism witness: the same scenario on every
            # transport must trip the same triggers with byte-identical
            # fingerprints (details carry only transport-stable fields)
            trigger_maps = [run["scores"]["capsule_triggers"] for run in doc["runs"]]
            if any(t != trigger_maps[0] for t in trigger_maps[1:]):
                raise AssertionError(
                    f"scenario {scenario.name} captured different capsules across transports: {trigger_maps}"
                )
            path = os.path.join(self.out_dir, f"SCENARIO_{scenario.name}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            log.info("wrote %s", path)
            docs.append(doc)
        return docs


# -- the standard campaigns ----------------------------------------------------


def default_campaign() -> List[Scenario]:
    """The five composed production shapes the roadmap asked for, each
    exercising a different Runtime subsystem end to end."""
    return [
        Scenario(
            name="pod_burst",
            desired=0,
            duration=4.0,
            primitives=[Burst(offset=0.2, count=28)],
            description="cold burst: 28 replicas land at once on an empty cluster",
        ),
        Scenario(
            name="diurnal_ramp",
            desired=0,  # the ramp owns the load (its contribution starts at base)
            duration=10.0,
            primitives=[DiurnalRamp(offset=0.5, base=6, peak=22, period=8.0, cycles=1)],
            description="half-cosine day: 6 -> 28 -> 6 replicas over one period",
        ),
        Scenario(
            name="spot_reclaim_wave",
            desired=24,
            duration=9.0,
            instance_types=["general-4x8"],  # ~7 pods/node -> a real fleet to storm
            primitives=[SpotReclaimWave(offset=4.0, fraction=0.6, warning_seconds=1.5)],
            description="correlated spot loss: most of the populated fleet reclaimed on a short warning",
        ),
        Scenario(
            name="drift_rollout_storm",
            desired=14,
            duration=10.0,
            budget_nodes="40%",
            instance_types=["general-4x8"],  # several nodes, so 40% floors to >= 1
            settled=drift_settled,
            primitives=[Burst(offset=2.0, count=8), DriftRollout(offset=4.0)],
            description="provisioner label rollout mid-burst: every node drifts, replaced under a 40% budget",
        ),
        Scenario(
            name="diurnal_ramp_consolidated",
            desired=0,
            duration=10.0,
            consolidation=True,
            ttl_seconds_after_empty=None,  # mutually exclusive with consolidation
            instance_types=["general-4x8"],  # several small nodes: consolidation has bins to merge
            settled=consolidated_settled,
            primitives=[DiurnalRamp(offset=0.5, base=6, peak=22, period=8.0, cycles=1)],
            description=(
                "the diurnal finding, closed: same half-cosine day with consolidation enabled — "
                "post-ramp stranded capacity is consolidated away until cost drift is pinned <= 1.5x"
            ),
        ),
        Scenario(
            name="crash_storm",
            desired=16,
            duration=12.0,
            budget_nodes="40%",
            instance_types=["general-4x8"],
            settled=drift_settled,
            primitives=[
                Burst(offset=0.3, count=10),
                ProcessCrash(offset=0.9),  # mid-provision: the burst is still launching
                SpotReclaimWave(offset=3.0, fraction=0.5, warning_seconds=1.5),
                DriftRollout(offset=4.5),
                ProcessCrash(offset=5.5),  # mid-disruption: the rollout is mid-replacement
                ProcessCrash(offset=8.0, times=1),
            ],
            description=(
                "burst + reclaim wave + drift rollout with the control plane kill -9'd three times "
                "mid-provision/mid-disruption: startup reconstruction + the GC sweep must converge to "
                "zero leaked instances, zero lost pods, budgets intact"
            ),
        ),
        Scenario(
            name="capacity_crunch",
            desired=0,
            duration=10.0,
            instance_types=["general-4x8"],
            offering_ttl=2.0,
            settled=capacity_recovered,
            primitives=[
                # phase 1 — the cheapest pool (zone-c spot) holds ONE more
                # launch: the burst exhausts it mid-flight, the fleet items
                # fall through to next-cheapest spot zones (partial
                # fulfillment) and the skipped pool quarantines
                PoolCapacity(offset=0.0, instance_type="general-4x8", zones=["zone-c"], capacity_types=["spot"], capacity=1),
                Burst(offset=0.4, count=26),
                # phase 2 — the TOTAL wall: every pool of the only allowed
                # type is exhausted, so the next burst's launches fail with
                # typed ICEs, the bounded re-solve escalates to
                # pod-unschedulable (events + decision records + backoff)
                PoolCapacity(offset=2.6, instance_type="general-4x8", capacity=0),
                Burst(offset=3.0, count=7),
                # phase 3 — capacity returns everywhere; parked pods
                # re-probe on their backoff, quarantines expire, and the
                # last launches land back in the cheapest pool
                PoolCapacity(offset=5.0, instance_type="general-4x8", capacity=None),
            ],
            description=(
                "the cheapest pool exhausts mid-burst (fallback to next-cheapest offering), then "
                "every pool walls off (typed ICE -> bounded re-solve -> unschedulable + backoff): "
                "nothing is lost, and the exhausted pool is re-selected after its TTL expires"
            ),
        ),
        Scenario(
            name="spot_collapse",
            desired=21,
            duration=9.0,
            instance_types=["general-4x8"],
            offering_ttl=300.0,  # outlives the run: convergence cannot ride an expiry
            settled=avoids_unavailable_pools,
            primitives=[SpotReclaimWave(offset=3.0, fraction=0.7, warning_seconds=1.5)],
            description=(
                "correlated spot loss with the reclaimed pools quarantined by the interruption "
                "controller: every replacement must route AROUND the collapsing pools (other-zone "
                "spot or on-demand), never back into them"
            ),
        ),
        Scenario(
            name="device_fault_storm",
            desired=0,
            duration=7.0,
            dense_solver=True,
            solver_breaker_threshold=3,
            solver_breaker_backoff=1.5,
            # the plan speaks the typed taxonomy: the first three dispatches
            # (the "plain" seam, consulted before every unsplit bucket
            # choice) die with a device-lost fault — three consecutive
            # classified faults is exactly the breaker threshold, so the
            # fourth burst is HELD against an OPEN breaker (no encode, no
            # launch) until the backoff ends and the half-open recovery
            # probe solves it. On the card K1's own seam ("cuda") is
            # consulted after "plain", so its three faults fail the first
            # probes and re-open the breaker before one closes it. A run over
            # a solver mesh consults "sharded" in place of "plain"
            fault_specs=[
                {"kind": "device-lost", "entry": "plain", "nth": 1, "count": 3},
                {"kind": "device-lost", "entry": "sharded", "nth": 1, "count": 3},
                {"kind": "device-lost", "entry": "cuda", "nth": 1, "count": 3},
            ],
            settled=breaker_reclosed,
            primitives=[
                Burst(offset=0.3, count=5),
                Burst(offset=1.3, count=5),
                Burst(offset=2.3, count=5),
                Burst(offset=3.5, count=5),  # breaker OPEN: held until the probe, no device attempt
                Burst(offset=5.5, count=4),  # after backoff: the half-open recovery probe
            ],
            description=(
                "typed device-lost faults on three consecutive solves trip the solver circuit "
                "breaker (every batch held, no device attempt paid), then a half-open recovery "
                "probe re-admits the device path and solves the held batch: converge with zero "
                "lost pods and the breaker CLOSED"
            ),
        ),
        Scenario(
            name="hbm_pressure",
            desired=0,
            duration=6.0,
            dense_solver=True,
            # a ~1 KiB budget is below any real dispatch surface, so once
            # the card's memory peak covers the resident catalog, every solve
            # splits PRE-EMPTIVELY — the budget rung. An injected HBM fault
            # (at "plain" on an unsplit dispatch, at K1's "cuda" seam on
            # either half of a split) holds the batch for a retry; two in a
            # row stay under the breaker's threshold of three
            solver_hbm_budget_bytes=1024,
            fault_specs=[
                {"kind": "hbm", "entry": "plain", "nth": 1, "count": 2},
                {"kind": "hbm", "entry": "sharded", "nth": 1, "count": 2},
                {"kind": "hbm", "entry": "cuda", "nth": 1, "count": 2},
            ],
            settled=hbm_degraded_settled,
            primitives=[
                Burst(offset=0.3, count=8),
                Burst(offset=2.0, count=8),
                Burst(offset=3.8, count=8),
            ],
            description=(
                "injected HBM faults plus a pre-solve HBM budget: each faulted batch is held and "
                "retried, the budget splits the bucket choice over a smaller device surface, nothing "
                "is lost, and the breaker never opens — memory pressure degrades, it does not outage"
            ),
        ),
        Scenario(
            name="leader_flap_storm",
            desired=12,
            duration=11.0,
            budget_nodes="40%",
            instance_types=["general-4x8"],
            leader_elect=True,
            # two injected renew failures on top of the steals: a transport
            # blip mid-run must flap (pause -> re-renew -> recover) without
            # waiting out the lease, and the steals land in the same plan
            # history as the seeded triggers (the determinism witness)
            kube_fault_specs=[{"fault": "lease-lost", "verb": "lease-renew", "nth": 10, "count": 2}],
            settled=leader_flap_settled,
            primitives=[
                Burst(offset=0.3, count=8),
                DriftRollout(offset=2.0),
                LeaseSteal(offset=3.2),  # mid-rollout: replacements in flight
                LeaseSteal(offset=6.5),  # again, after the first recovery
            ],
            description=(
                "the lease is stolen twice mid-drift-rollout: the deposed leader's loops pause "
                "before the thief's (never-renewed) lease expires, the rightful leader re-acquires "
                "and runs recovery BEFORE acting, the rollout finishes under its 40% budget, and "
                "the client-token ledger proves no logical launch ever executed twice"
            ),
        ),
        Scenario(
            name="watch_gap_storm",
            desired=0,
            duration=10.0,
            instance_types=["general-4x8"],
            # a seeded conflict storm on node registration: the 2nd and 3rd
            # node creates 409 — the provisioner absorbs them (counted, not
            # swallowed), the instance briefly orphans, and the GC sweep
            # reconciles it while the watch chaos below runs
            kube_fault_specs=[{"fault": "conflict", "verb": "create", "obj_kind": "Node", "nth": 2, "count": 2}],
            settled=watch_gap_settled,
            primitives=[
                Burst(offset=0.3, count=12),
                WatchGap(offset=1.0, duration=0.8, compact=True),  # 410 Gone: relist diff
                Burst(offset=1.2, count=6),  # lands INSIDE the compacted gap
                WatchGap(offset=3.5, duration=0.6),  # plain drop: replay from the buffer
                Burst(offset=4.6, count=6),
            ],
            description=(
                "bursts under control-plane weather: watch streams killed mid-burst (reconnect-"
                "from-RV replay), a forced journal compaction (410 Gone -> relist diff, deletes "
                "included), and a seeded 409 storm on node registration — the informer-coherence "
                "witness must find ZERO divergences at teardown and nothing may be lost or leaked"
            ),
        ),
        Scenario(
            name="throttled_control_plane",
            desired=0,
            duration=8.0,
            primitives=[
                Burst(offset=0.2, count=18),
                TransportChaos(offset=0.6, latency_seconds=0.12, duration=4.0, delayed_requests=60, throttled_requests=10),
            ],
            description="burst under a degraded cloud API: injected latency + 429 throttling",
        ),
        Scenario(
            name="residency_divergence_storm",
            desired=0,
            duration=10.0,
            dense_solver=True,
            solver_incremental=True,
            residency_audit_interval=1,  # every real pass audited
            capsule_debounce_seconds=0.0,  # both divergences captured, not debounced
            instance_types=["general-4x8"],
            # the seeded corruption pair (solver/faults.py): flip one value
            # in the resident HOST mirror at the first resident pass — the
            # same-pass full shadow detects it as row-drift before the fill
            # consumes the encoding — then suppress the 11th pod-level
            # DeltaJournal record: the OUT-OF-BAND bind at t=4.8 below
            # (8 burst binds + t=2.0 + t=3.4 = records 1-10, so 11 is the
            # interloper). It must be out-of-band — the engine rebases its
            # OWN placements into the mirror before the record matters, so a
            # suppressed solver-planned bind is undetectable by design. The
            # 0.1-cpu pod lands on the burst-filled first node (0.4 cpu
            # spare, too tight for the stand-in's 0.5-cpu replicas), so that
            # node's journal window stays silent and the NEXT pass's audit
            # classifies the stale mirror row missed-delta, not row-drift
            fault_specs=[
                {"kind": "corrupt-row", "entry": "resident-row", "nth": 1},
                {"kind": "suppress-delta", "entry": "journal-record", "nth": 11},
            ],
            settled=residency_settled,
            primitives=[
                Burst(offset=0.3, count=8),  # builds the fleet; the engine warms to resident
                Burst(offset=2.0, count=1),  # single binds from here on: each pass's journal
                Burst(offset=3.4, count=1),  # traffic is exactly one record — no sibling masking
                OutOfBandBind(offset=4.8, cpu=0.1),  # the suppressed record (see fault_specs)
                Burst(offset=6.2, count=1),  # the detection pass: audit sees the stale row
                Burst(offset=7.6, count=1),  # post-heal pass: the clean-audit parity witness
            ],
            description=(
                "seeded resident-state corruption under churn: a host-mirror row flip and a "
                "suppressed delta-journal record — the auditor must detect exactly one divergence "
                "per injection (row-drift, then missed-delta), heal each by forcing the byte-equal "
                "full re-encode, re-verify clean, and leave one capsule per divergence kind, with "
                "zero lost pods"
            ),
        ),
        chaos_soak_scenario(),
    ]


def chaos_soak_scenario(seed: int = 11) -> Soak:
    """The standing soak: 75 minutes of diurnal arrivals compressed 150x
    into a ~30s run, under a low-rate cross-domain ChaosSchedule drawn from
    the scenario's ONE master seed — pool exhaustions with paired restores,
    reclaim waves, API latency, watch gaps/compactions, the odd kill -9,
    plus seeded solver and kube verb triggers. The invariant monitor
    samples every ~compressed-minute; convergence requires the schedule
    fully delivered, the breaker re-closed, and ZERO invariant violations.
    Every future perf PR must survive this for compressed hours, not
    seconds."""
    import functools

    schedule = ChaosSchedule(
        offset=1.0,
        seed=split_seed(seed, "chaos.schedule"),
        events_count=16,
        horizon=24.0,
        instance_type="general-4x8",
        solver_faults=2,
        kube_faults=3,
    )
    trace = diurnal_trace(seed, span_seconds=4500.0, arrivals=60, compress=150.0, offset=0.5)
    return Soak(
        name="chaos_soak",
        desired=0,  # the replayed trace owns the load
        duration=34.0,
        seed=seed,
        compress=150.0,
        compressed_span=4500.0,
        instance_types=["general-4x8"],
        dense_solver=True,  # the solver seam must sit under real dispatch
        # device-resident incremental engine under the chaos weather: the
        # settled predicate then also demands delta passes + flat p95
        solver_incremental=True,
        # the residency auditor rides every pass of the soak: with no
        # corruption specs planned, soak_settled pins divergences at
        # exactly zero — the specificity half of the auditor's proof
        residency_audit_interval=1,
        fault_specs=schedule.solver_specs(),
        kube_fault_specs=schedule.kube_specs(),
        # the seeded solver faults must leave evidence: counted faults in the
        # port (a held batch), where the reference requires its host-rung
        # capsule
        settled=functools.partial(soak_settled, schedule=schedule, require_delta_passes=1, require_solver_faults=1),
        primitives=[trace, schedule],
        description=(
            "the soak tier: 75 compressed minutes of diurnal load replayed 150x under a "
            "seeded cross-domain chaos schedule spanning all three fault seams, with the "
            "invariant monitor sampling leak witnesses every compressed minute — converge "
            "with zero lost pods, zero leaked threads/watches, zero invariant violations"
        ),
    )


def mini_soak_scenario(seed: int = 5, extra_events: Optional[List[dict]] = None) -> Soak:
    """The tier-1 soak shape: 60 compressed seconds (20x over a ~3s replay)
    under a 3-event cross-domain schedule — one pool exhaustion (cloud),
    one watch gap (kube), the paired restore — plus one seeded solver
    trigger and one seeded kube trigger from the same master seed.
    `extra_events` appends imported events (the seeded negative control
    injects its watch-leak through it)."""
    import functools

    events = [
        {"index": 0, "offset": 0.6, "domain": "cloud", "action": "pool-exhaust",
         "params": {"instance_type": "general-4x8", "zone": "zone-c", "capacity_type": "spot", "capacity": 0}},
        {"index": 1, "offset": 1.2, "domain": "kube", "action": "watch-gap",
         "params": {"duration": 0.4, "compact": True}},
        {"index": 2, "offset": 1.8, "domain": "cloud", "action": "pool-restore",
         "params": {"instance_type": "general-4x8", "zone": "zone-c", "capacity_type": "spot"}},
    ]
    for i, extra in enumerate(extra_events or []):
        events.append(dict(extra, index=len(events)))
    schedule = ChaosSchedule(
        offset=0.3,
        seed=split_seed(seed, "chaos.schedule"),
        solver_faults=1,
        kube_faults=1,
        imported=events,
    )
    trace = diurnal_trace(seed, span_seconds=60.0, arrivals=10, compress=20.0, offset=0.3)
    return Soak(
        name="mini_soak",
        desired=0,
        duration=4.5,
        seed=seed,
        compress=20.0,
        compressed_span=60.0,
        instance_types=["general-4x8"],
        dense_solver=True,
        solver_incremental=True,  # same engine wiring as the full soak
        residency_audit_interval=1,  # and the same zero-divergence pin
        fault_specs=schedule.solver_specs(),
        kube_fault_specs=schedule.kube_specs(),
        settled=functools.partial(soak_settled, schedule=schedule),
        primitives=[trace, schedule],
        description=(
            "tier-1 mini-soak: 60 compressed seconds of diurnal replay under a 3-event "
            "cross-domain schedule with seeded solver + kube triggers; zero leaked "
            "threads/watches and zero invariant violations on both transports"
        ),
    )


def smoke_campaign() -> List[Scenario]:
    """The tier-1 shape: one tiny composed scenario (burst + a one-node
    reclaim) that still crosses every scored surface in a few seconds."""
    return [
        Scenario(
            name="smoke_burst",
            desired=0,
            duration=2.5,
            primitives=[Burst(offset=0.1, count=8), SpotReclaimWave(offset=1.2, fraction=0.34, warning_seconds=0.8, max_victims=1)],
            description="tier-1 smoke: small burst + single spot reclaim",
        )
    ]


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="karpenter-tpu-torch-campaign")
    parser.add_argument("--out", default=".", help="directory for SCENARIO_*.json artifacts")
    parser.add_argument("--transports", default=",".join(TRANSPORTS), help="comma-separated: inprocess,http")
    parser.add_argument("--smoke", action="store_true", help="run the tier-1 smoke campaign instead of the full one")
    parser.add_argument("--scenarios", default="", help="comma-separated subset of scenario names")
    parser.add_argument(
        "--journal-dir", default=None,
        help="spool each run's lifecycle journal to JOURNAL_<scenario>_<transport>.jsonl here (replay capture)",
    )
    args = parser.parse_args(argv)
    scenarios = smoke_campaign() if args.smoke else default_campaign()
    if args.scenarios:
        wanted = set(args.scenarios.split(","))
        scenarios = [s for s in scenarios if s.name in wanted]
        if not scenarios:
            parser.error(f"no scenario matches {sorted(wanted)}")
    runner = CampaignRunner(out_dir=args.out, transports=tuple(args.transports.split(",")), journal_dir=args.journal_dir)
    docs = runner.run(scenarios)
    summary = {
        doc["scenario"]: {
            run["transport"]: {
                "converged": run["converged"],
                "lost_pods": run["scores"]["lost_pods"],
                "budget_violations": run["scores"]["budget_violations"],
                "cost_drift_ratio": run["scores"]["cost_drift_ratio"],
            }
            for run in doc["runs"]
        }
        for doc in docs
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
