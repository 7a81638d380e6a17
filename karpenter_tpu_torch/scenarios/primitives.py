"""Scenario primitives: composable load/chaos generators for a live Runtime.

Each primitive drives ONE aspect of production pressure against the running
Runtime + simulated cloud — traffic shape (bursts, diurnal ramps), capacity
loss (spot reclaim waves), config churn (drift rollouts mid-storm), and
degraded infrastructure (injected transport latency / apiserver throttling).
A `Scenario` composes several primitives on a shared timeline; the campaign
runner (campaign.py) executes them against a real Runtime on either
transport and scores the outcome.

These generalize the hand-rolled seams of the interruption-storm and
disruption-storm tests: the workload stand-in (standin.py) plays kubelet /
kube-scheduler / ReplicaSet, primitives mutate the desired replica count and
the cloud, and the Runtime does everything else.

The port's copy of karpenter_tpu/scenarios/primitives.py; ScenarioContext
also stamps the run's classified solver faults (the soak's evidence bar).
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..api import labels as lbl
from ..logsetup import get_logger

log = get_logger("scenarios")


class ScenarioContext:
    """Everything a primitive may touch while a scenario runs."""

    def __init__(self, kube, backend, runtime, service=None, pod_cpu: float = 0.5, runtime_factory=None):
        self.kube = kube
        self.backend = backend  # the in-process CloudBackend (faults/reclaims)
        self.runtime = runtime
        self.service = service  # CloudAPIService on the http transport, else None
        self.pod_cpu = pod_cpu
        # crash/restart seam: builds a FRESH (un-started) Runtime over the
        # same kube + cloud — what the ProcessCrash primitive restarts into
        self.runtime_factory = runtime_factory
        self.restarts = 0
        # stamped by SpotReclaimWave: kube-clock instant the wave fired, so
        # predicates can scope assertions to REPLACEMENT nodes (a survivor
        # legitimately keeps running inside a quarantined pool)
        self.reclaim_started_at: Optional[float] = None
        # stamped by the campaign runner at run start: the process-lifetime
        # chunked-rung counter is monotonic, so settled predicates must
        # score this run's delta, not the absolute (a prior run in the same
        # process would pre-satisfy the bar)
        self.solver_chunked_at_start = 0
        # and the classified solver faults (the soak's evidence bar)
        self.solver_faults_at_start = 0
        # same run-start stamping for the incremental engine's monotonic
        # delta-pass counter (the soak settled predicate scores the delta)
        self.incremental_delta_at_start = 0
        # run-start stamps for the residency auditor's monotonic counters
        # (solver/audit.py): scores and settled predicates read this run's
        # divergence/heal/audit deltas, not process-lifetime absolutes
        self.residency_divergences_at_start = 0
        self.residency_heals_at_start = 0
        self.audit_passes_at_start = 0
        self.stop = threading.Event()
        self._lock = threading.Lock()
        self._desired = 0

    def crash_runtime(self) -> None:
        """Kill the live control plane and boot a successor: the old
        Runtime's threads halt with no graceful cleanup (its ledger, command
        queue, and dedupe memory die with it), then a new Runtime runs its
        startup reconstruction — resync, ledger recovery, GC sweep — against
        whatever the crash left behind."""
        if self.runtime_factory is None:
            raise RuntimeError("scenario context has no runtime_factory; crash/restart unavailable")
        old = self.runtime
        old.crash()
        successor = self.runtime_factory()
        self.runtime = successor
        successor.start()
        with self._lock:
            self.restarts += 1
        log.info("process crash #%d: control plane restarted", self.restarts)

    @property
    def desired(self) -> int:
        with self._lock:
            return self._desired

    @desired.setter
    def desired(self, value: int) -> None:
        with self._lock:
            self._desired = max(0, int(value))

    def add_desired(self, delta: int) -> int:
        """Atomic relative adjustment: primitives run on their own threads,
        so `ctx.desired = ctx.desired + n` is a torn read-modify-write when
        two of them fire together (a Burst during a DiurnalRamp step)."""
        with self._lock:
            self._desired = max(0, self._desired + int(delta))
            return self._desired

    def sleep(self, seconds: float) -> bool:
        """Interruptible sleep; True when the scenario was stopped."""
        return self.stop.wait(timeout=seconds)


@dataclass
class Primitive:
    """Base: `offset` schedules the primitive on the scenario timeline."""

    offset: float = 0.0

    def run(self, ctx: ScenarioContext) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def config(self) -> dict:
        return {"kind": type(self).__name__, **{k: v for k, v in vars(self).items() if not k.startswith("_")}}


@dataclass
class Burst(Primitive):
    """Raise the desired replica count by `count` in one step — the sharp
    edge of a deploy or an HPA overreaction."""

    count: int = 10

    def run(self, ctx: ScenarioContext) -> None:
        log.info("burst: desired -> %d", ctx.add_desired(self.count))


@dataclass
class ScaleTo(Primitive):
    """Set the desired replica count absolutely (ramp-down included)."""

    count: int = 0

    def run(self, ctx: ScenarioContext) -> None:
        ctx.desired = self.count


@dataclass
class OutOfBandBind(Primitive):
    """Create a pod already BOUND to live capacity, bypassing both the
    provisioner and the stand-in scheduler — the way a second scheduler, a
    static pod, or a manual bind lands in the informer. The solver never
    planned this placement, so the incremental engine's resident mirror can
    only learn it from the DeltaJournal record — which makes this the one
    bind whose SUPPRESSED record is detectable (suppressing a solver-planned
    bind is a no-op: the engine rebases its own placements into the mirror
    before the record ever matters). The residency storm aims its
    dropped-delta injection here."""

    cpu: float = 0.1
    app: str = "oob"

    def run(self, ctx: ScenarioContext) -> None:
        from .standin import pod_cpu_request, workload_pod

        for node in ctx.kube.list_nodes():
            if node.spec.unschedulable or node.metadata.deletion_timestamp is not None or not node.ready():
                continue
            used = sum(pod_cpu_request(p) for p in ctx.kube.pods_on_node(node.name))
            if node.status.allocatable.get("cpu", 0.0) - used < self.cpu:
                continue
            pod = workload_pod(self.cpu, app=self.app)
            pod.spec.node_name = node.name
            pod.status.phase = "Running"
            pod.status.conditions = []
            ctx.kube.create(pod)
            # the ReplicaSet stand-in reconciles ALL live pods against
            # `desired`: account for the interloper or the next tick would
            # evict a scenario replica to compensate
            ctx.add_desired(1)
            log.info(
                "out-of-band bind: %s -> %s (%.2f cpu, no solver involvement)",
                pod.metadata.name, node.name, self.cpu,
            )
            return
        log.warning("out-of-band bind found no schedulable spare capacity; skipped")


@dataclass
class DiurnalRamp(Primitive):
    """Traffic follows a half-cosine day: base -> base+peak -> base over
    `period` seconds, re-evaluated every `step`. `cycles` repeats it.

    The ramp owns only its own CONTRIBUTION to the desired count (applied
    through atomic deltas), so composing it with a concurrent Burst adds the
    two loads instead of the ramp's next step erasing the burst."""

    base: int = 5
    peak: int = 20
    period: float = 8.0
    step: float = 0.25
    cycles: int = 1

    def run(self, ctx: ScenarioContext) -> None:
        contribution = 0

        def set_contribution(value: int) -> None:
            nonlocal contribution
            ctx.add_desired(value - contribution)
            contribution = value

        start = time.monotonic()
        total = self.period * self.cycles
        while not ctx.stop.is_set():
            t = time.monotonic() - start
            if t >= total:
                break
            phase = (t % self.period) / self.period
            set_contribution(self.base + int(round(self.peak * 0.5 * (1 - math.cos(2 * math.pi * phase)))))
            if ctx.sleep(self.step):
                return
        set_contribution(self.base)


@dataclass
class PoolCapacity(Primitive):
    """Give every (zone x capacity-type) pool of `instance_type` FINITE
    remaining capacity (`capacity` launches each; 0 = exhausted now), or
    restore them to infinite with capacity=None — the capacity-crunch seam.
    `capacity_types`/`zones` narrow the affected pools (e.g. collapse only
    the spot side of a type)."""

    instance_type: str = ""
    capacity: Optional[int] = None
    zones: Optional[List[str]] = None  # default: every backend zone
    capacity_types: Optional[List[str]] = None  # default: spot + on-demand

    def run(self, ctx: ScenarioContext) -> None:
        zones = self.zones or [s.zone for s in ctx.backend.subnets]
        capacity_types = self.capacity_types or ["spot", "on-demand"]
        for zone in zones:
            for ct in capacity_types:
                ctx.backend.set_pool_capacity(self.instance_type, zone, ct, self.capacity)
        log.info(
            "pool capacity: %s -> %s across %d pool(s)",
            self.instance_type,
            "infinite" if self.capacity is None else self.capacity,
            len(zones) * len(capacity_types),
        )


@dataclass
class SpotReclaimWave(Primitive):
    """Interrupt a fraction of populated nodes at once with a short reclaim
    window — the correlated spot-capacity loss shape. The campaign's
    reclaimer thread makes the cloud good on the warnings."""

    fraction: float = 0.5
    warning_seconds: float = 1.5
    max_victims: int = 8

    def run(self, ctx: ScenarioContext) -> None:
        populated = [n for n in ctx.kube.list_nodes() if ctx.kube.pods_on_node(n.name)]
        victims = populated[: max(1, min(self.max_victims, int(len(populated) * self.fraction)))]
        ids = [n.spec.provider_id.split("///", 1)[-1] for n in victims]
        log.info("spot reclaim wave: interrupting %d/%d nodes", len(ids), len(populated))
        ctx.reclaim_started_at = ctx.kube.clock.now()
        for instance_id in ids:
            ctx.backend.interrupt_spot_instance(instance_id, warning_seconds=self.warning_seconds)


@dataclass
class DriftRollout(Primitive):
    """Mutate the provisioner spec mid-storm (a label rollout): every
    existing node's stamped provisioner-hash goes stale, the disruption
    orchestrator's drift method replaces them under the budget."""

    provisioner: str = "default"
    label_key: str = "rollout"
    label_value: str = "v2"

    def run(self, ctx: ScenarioContext) -> None:
        provisioner = ctx.kube.get("Provisioner", self.provisioner, namespace="")
        if provisioner is None:
            log.warning("drift rollout: provisioner %s not found", self.provisioner)
            return
        provisioner.spec.labels[self.label_key] = self.label_value
        ctx.kube.update(provisioner)
        log.info("drift rollout: provisioner %s labeled %s=%s", self.provisioner, self.label_key, self.label_value)


@dataclass
class TransportChaos(Primitive):
    """Degrade the cloud control plane for `duration` seconds: sustained
    API latency on the in-process transport, plus per-request delay and 429
    throttling on the HTTP transport (apiclient retries with backoff)."""

    latency_seconds: float = 0.15
    duration: float = 3.0
    delayed_requests: int = 40
    throttled_requests: int = 8

    def run(self, ctx: ScenarioContext) -> None:
        log.info("transport chaos: +%.0fms API latency for %.1fs", self.latency_seconds * 1000, self.duration)
        ctx.backend.inject_api_latency(self.latency_seconds)
        if ctx.service is not None:
            ctx.service.delay_next(self.delayed_requests, self.latency_seconds)
            ctx.service.throttle_next(self.throttled_requests)
        ctx.sleep(self.duration)
        ctx.backend.inject_api_latency(0.0)


@dataclass
class WatchGap(Primitive):
    """Kill the informers' watch delivery for `duration` seconds — the
    control-plane fault domain's connection-drop shape. On the in-memory
    transport the gap buffers dispatch (a killed stream's events wait in
    the server journal); with `compact=True` a forced journal compaction
    fires mid-gap, so closing the gap delivers a relist diff instead of a
    replay — the 410-Gone path. The gap ALWAYS closes, even when the
    scenario is stopped mid-gap (a gap leaking past its run would wedge
    every later scenario on the shared store)."""

    duration: float = 0.8
    compact: bool = False

    def run(self, ctx: ScenarioContext) -> None:
        log.info("watch gap: %.1fs%s", self.duration, " + forced compaction" if self.compact else "")
        ctx.kube.chaos_watch_gap_begin()
        try:
            if self.compact:
                if not ctx.sleep(self.duration / 2):
                    ctx.kube.chaos_compact()
                    ctx.sleep(self.duration / 2)
            else:
                ctx.sleep(self.duration)
        finally:
            ctx.kube.chaos_watch_gap_end()


@dataclass
class LeaseSteal(Primitive):
    """Steal the leader-election lease out from under the live control
    plane: a legal competing CAS overwrites the holder, the deposed leader
    must pause its singleton loops on its next renew round, and — since the
    thief never renews — a real candidate re-acquires after the lease
    duration and runs recovery before acting. The leader-flap storm fires
    this twice mid-drift-rollout."""

    thief: str = "chaos-thief"

    def run(self, ctx: ScenarioContext) -> None:
        from ..kube.leaderelection import steal_lease

        elector = getattr(ctx.runtime, "elector", None)
        if elector is None:
            log.warning("lease steal: runtime has no elector")
            return
        stolen = steal_lease(ctx.kube, identity=self.thief, name=elector.name, namespace=elector.namespace)
        log.info("lease steal by %s: %s", self.thief, "landed" if stolen else "no lease to steal")


@dataclass
class ProcessCrash(Primitive):
    """Kill -9 the control plane `times` times, `interval` seconds apart,
    starting at `offset` — timed by the composer to land mid-provision or
    mid-disruption. Each crash tears down the live Runtime with no graceful
    cleanup and boots a successor through its startup reconstruction
    (cluster resync, disruption-ledger recovery, GC sweep). Everything the
    scenario scores — zero leaked instances, zero lost pods, budget
    invariants — must hold ACROSS the restarts, which is the whole point."""

    times: int = 1
    interval: float = 2.0

    def run(self, ctx: ScenarioContext) -> None:
        for i in range(self.times):
            if i and ctx.sleep(self.interval):
                return
            ctx.crash_runtime()


@dataclass
class Scenario:
    """A named composition of primitives on one timeline."""

    name: str
    desired: int  # starting replica count (the stand-in reconciles to it)
    duration: float  # timeline length before the convergence wait begins
    primitives: List[Primitive] = field(default_factory=list)
    pod_cpu: float = 0.5
    budget_nodes: Optional[str] = None  # e.g. "40%" -> spec.disruption.budgets
    # restricting the provisioner to small shapes spreads the workload over
    # several nodes — what makes percentage budgets and reclaim fractions
    # meaningful (22 pods on one 96-cpu node give a 30% budget of zero)
    instance_types: Optional[List[str]] = None
    ttl_seconds_after_empty: Optional[float] = 2.0
    # spec.consolidation.enabled on the provisioner (mutually exclusive with
    # ttlSecondsAfterEmpty — set that to None when enabling this): the
    # consolidation-on diurnal variant pins the post-ramp cost drift
    consolidation: bool = False
    # override for the provider's unavailable-offerings TTL: the
    # capacity-crunch scenarios need the quarantine to expire (and the
    # exhausted pool to be re-selected) INSIDE the scenario window, or —
    # for the spot-collapse variant — to outlive it
    offering_ttl: Optional[float] = None
    # extra convergence condition beyond "every pod bound to live capacity"
    # (e.g. the drift scenario waits until no node carries a stale spec
    # hash); not part of the config hash — predicates describe WHEN the run
    # may stop, not WHAT it did
    settled: Optional[Callable[[ScenarioContext], bool]] = None
    # solver fault-domain seams (solver/faults.py): dense_solver=True runs
    # the scenario's Runtime with the dense device path on (min_batch=1, so
    # every provisioning batch dispatches); fault_specs is a list of
    # FaultSpec dicts installed as a seeded FaultPlan for the whole run —
    # the device-chaos scenarios inject exactly the typed fault class they
    # claim to test, deterministically. The breaker/budget knobs mirror the
    # --solver-breaker-threshold / --solver-breaker-backoff /
    # --solver-hbm-budget runtime flags on the scenario's timescale.
    dense_solver: bool = False
    # incremental solve engine (solver/incremental.py, --solver-incremental):
    # the scenario's Runtime keeps the warm-view encoding device-resident
    # across provision passes and applies journal deltas in place. The soak
    # tier runs with it ON — its settled predicate then requires the engine
    # to have ENGAGED (delta passes taken) and the solve-latency p95 to stay
    # FLAT as the cluster grows at fixed per-tick delta
    solver_incremental: bool = False
    fault_specs: Optional[List[dict]] = None
    # residency auditor (solver/audit.py, --residency-audit-interval): audit
    # every Nth incremental pass against re-encoded cluster truth; 0 = off.
    # Scenarios that turn it on score residency_divergences/heals/audit_passes
    # — healthy runs pin divergences at 0, the storm requires them to equal
    # its injections
    residency_audit_interval: int = 0
    # per-kind capsule capture debounce override (None = the campaign's
    # default): the residency storm injects two distinct corruptions close
    # together and needs BOTH residency-divergence captures inside its window
    capsule_debounce_seconds: Optional[float] = None
    # seed fan-out (utils/seeds.py): `seed` is the ONE master knob — the
    # solver fault seed, the kube fault seed, the stand-in's jitter, and a
    # chaos schedule's streams all derive from it splitmix-style, so two
    # runs of any scenario are reproducible from one number. The per-seam
    # overrides (None = derive) exist for unit tests that pin one seam; a
    # scenario that sets them independently re-opens the drift this closes.
    seed: int = 0
    fault_seed: Optional[int] = None
    solver_breaker_threshold: int = 3
    solver_breaker_backoff: float = 1.5
    solver_hbm_budget_bytes: int = 0
    # control-plane fault-domain seams (kube/chaos.py): kube_fault_specs is
    # a list of KubeFaultSpec dicts installed as a seeded KubeFaultPlan for
    # the whole run (conflict storms, stale reads, watch drops — injected
    # deterministically on the kube verb boundaries); leader_elect runs the
    # scenario's Runtime behind real Lease election (with the campaign's
    # short lease timing) so LeaseSteal primitives have a leader to depose
    kube_fault_specs: Optional[List[dict]] = None
    kube_fault_seed: Optional[int] = None
    leader_elect: bool = False
    description: str = ""

    def derived_seeds(self) -> dict:
        """Every consumer seed, fanned out from the master (or pinned by an
        explicit override) — recorded in provenance so the artifact itself
        says how to reproduce the run."""
        from ..utils.seeds import split_seed

        return {
            "fault_seed": self.fault_seed if self.fault_seed is not None else split_seed(self.seed, "solver.faults"),
            "kube_fault_seed": (
                self.kube_fault_seed if self.kube_fault_seed is not None else split_seed(self.seed, "kube.chaos")
            ),
            "standin_jitter_seed": split_seed(self.seed, "standin.jitter"),
            "chaos_schedule_seed": split_seed(self.seed, "chaos.schedule"),
            "audit_seed": split_seed(self.seed, "solver.audit"),
        }

    def config(self) -> dict:
        """The provenance config-hash payload: everything that shapes the
        run, so two SCENARIO artifacts are comparable iff hashes match."""
        return {
            "name": self.name,
            "kind": "standard",
            "seed": self.seed,
            "derived_seeds": self.derived_seeds(),
            "desired": self.desired,
            "duration": self.duration,
            "pod_cpu": self.pod_cpu,
            "budget_nodes": self.budget_nodes,
            "instance_types": self.instance_types,
            "ttl_seconds_after_empty": self.ttl_seconds_after_empty,
            "consolidation": self.consolidation,
            "offering_ttl": self.offering_ttl,
            "dense_solver": self.dense_solver,
            "solver_incremental": self.solver_incremental,
            "residency_audit_interval": self.residency_audit_interval,
            "capsule_debounce_seconds": self.capsule_debounce_seconds,
            "fault_specs": self.fault_specs,
            "fault_seed": self.fault_seed,
            "solver_breaker_threshold": self.solver_breaker_threshold,
            "solver_breaker_backoff": self.solver_breaker_backoff,
            "solver_hbm_budget_bytes": self.solver_hbm_budget_bytes,
            "kube_fault_specs": self.kube_fault_specs,
            "kube_fault_seed": self.kube_fault_seed,
            "leader_elect": self.leader_elect,
            "primitives": [p.config() for p in self.primitives],
        }
