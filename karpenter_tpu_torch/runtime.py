"""Runtime bootstrap: assemble and run the full controller manager.

Equivalent of pkg/controllers/controllers.go:86-248 — builds the cloud
provider (wrapped in the metrics decorator), cluster-state cache, and every
controller; registers admission; runs reconciliation loops on threads with
leader-election gating for the singleton loops (provisioning, lifecycle,
disruption, gc, pricing refresh, interruption); answers the health and
readiness probes and feeds the metrics registry and the recorders.

Leader election in a single-process in-memory deployment degenerates to a
local lock, but the gating seam is identical: followers run the state cache
and webhooks, only the leader provisions/consolidates (controllers.go:104).

The port's copy of karpenter_tpu/runtime.py. The dense solver runs on the
card (`device="cuda"`, the default; "cpu" runs the plain versions of the
kernels): with dense_min_batch <= 0 the crossover is measured at boot by
timing K1's probe round trip. The recorders run as in the reference: the
flight recorder, the lifecycle journal, incident capsules, the SLO
accountant and its scraper (whose ideal repack is a dense solve on the
card), live profiling, the thread census, the invariant monitor and the
informer-coherence witness. The solver fault domain (solver/faults.py) is
configured as in the reference: the process-wide circuit breaker takes the
options' threshold and backoff and this runtime's clock, and the dense
solver the HBM budget (its split launches K1 on each half of the bucket
axis; nothing falls back from the card).

Two deliberate differences from the reference (ROADMAP C), so that no
failure hides behind a log line: a loop (or the post-election recovery)
that raises ends, `healthy()` turns false and `stop()` re-raises the first
such exception; the reference's recovery logs a failure and opens the gate
anyway.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import webhooks
from .cloudprovider.metrics import decorate
from .cloudprovider.types import CloudProvider
from .config import Config, watch_config
from .controllers.consolidation import ConsolidationController
from .controllers.counter import CounterController
from .controllers.metrics import NodeMetricsScraper, PodMetricsController, ProvisionerMetricsController
from .controllers.node import NodeController
from .controllers.provisioning import ProvisionerController, ProvisioningReconciler
from .controllers.state.cluster import Cluster
from .controllers.termination import TerminationController
from .events import DedupeRecorder, Recorder
from .kube.cluster import KubeCluster
from .logsetup import configure as configure_logging, get_logger, set_level
from .capsule import CAPSULE
from .flight import FLIGHT
from .journal import JOURNAL
from .metrics import REGISTRY
from .slo import SLO
from .solver.faults import BREAKER, SolverFault, ends_the_loop
from .tracing import TRACER
from .utils.options import Options

log = get_logger("runtime")

@dataclass
class Runtime:
    kube: KubeCluster
    cloud_provider: CloudProvider
    options: Options = field(default_factory=Options)
    dense_solver: object = None
    device: str = "cuda"
    # the residency auditor's sampled-draw seed and full-shadow cadence
    # (None: the module default); a harness that restarts the Runtime
    # passes the same values to every successor
    audit_seed: int = 0
    audit_shadow_every: Optional[int] = None

    def __post_init__(self):
        configure_logging(self.options.log_level)
        if self.options.enable_lock_witness:
            # must flip BEFORE any component constructs its locks below:
            # witnessing happens at lock creation, and a disabled witness
            # hands out plain (never-wrapped) locks
            from .analysis.witness import WITNESS

            WITNESS.enable()
        if self.options.enable_tracing:
            # the process-wide tracer (tracing.py): spans from every
            # controller pass land in one bounded ring served over
            # /debug/traces on the metrics port
            TRACER.enable(capacity=self.options.trace_ring_size)
        if self.options.enable_solver_telemetry:
            # the solver flight recorder (flight.py): per-solve shape/phase
            # records, kernel-build attribution, device-memory gauges —
            # served over /debug/solver on the metrics port
            FLIGHT.enable(capacity=self.options.flight_ring_size)
        # solver circuit breaker (solver/faults.py): tune the process-wide
        # breaker and re-wire its clock to this runtime's seam WITHOUT
        # resetting state — the device is the same device across restarts,
        # so a crash/restart inherits the open/closed history
        BREAKER.configure(
            threshold=self.options.solver_breaker_threshold,
            backoff=self.options.solver_breaker_backoff,
            clock=self.kube.clock,
        )
        if self.options.enable_journal:
            # the lifecycle journal (journal.py): pod/node transition stream
            # + the pending-latency waterfall over /debug/journal and
            # /debug/waterfall. The watch hooks attach below, AFTER the kube
            # backend exists but BEFORE the SLO accountant's (the journal's
            # bound handler must complete a pod's waterfall before the SLO
            # hook cross-feeds the observed pending duration into it)
            JOURNAL.enable(capacity=self.options.journal_ring_size)
            if self.options.journal_spool:
                JOURNAL.set_spool(self.options.journal_spool, self.options.journal_spool_max_bytes)
            JOURNAL.attach(self.kube)
        if self.options.enable_capsules:
            # incident capsules (capsule.py): the typed trigger bus + the
            # SLO burn-rate monitor freeze every telemetry ring into one
            # evidence bundle at /debug/capsules; enabled AFTER the rings
            # it snapshots, clocked by this runtime's seam, polled by the
            # metrics loop below
            CAPSULE.enable(
                spool=self.options.capsule_spool or None,
                spool_max_bytes=self.options.capsule_spool_max_bytes,
                debounce_seconds=self.options.capsule_debounce_seconds,
                clock=self.kube.clock,
            )
        self.config = Config(self.options.batch_max_duration, self.options.batch_idle_duration, self.options.log_level)
        # live log-level reload, the config-logging ConfigMap analog
        # (controllers.go:240-248): a config update re-levels the tree
        self.config.on_change(lambda cfg: set_level(cfg.log_level))
        # live settings from the karpenter-global-settings ConfigMap; keep
        # the unsubscriber — watches dispatch synchronously on the shared
        # cluster, so a stopped/crashed Runtime must detach what it attached
        self._config_unwatch = watch_config(self.kube, self.config)
        self.recorder = DedupeRecorder(Recorder(), clock=self.kube.clock)
        self.cloud_provider = decorate(self.cloud_provider)
        webhooks.register(self.kube, self.cloud_provider)
        self.cluster = Cluster(self.kube, self.cloud_provider, clock=self.kube.clock)
        # the residency auditor (--residency-audit-interval): it audits the
        # dense solver's incremental engine, and /debug/residency serves it
        # with or without a dense solver
        self.auditor = None
        if self.options.residency_audit_interval > 0:
            from .solver.audit import ResidencyAuditor

            self.auditor = ResidencyAuditor(
                seed=self.audit_seed, interval=self.options.residency_audit_interval, shadow_every=self.audit_shadow_every
            )
        if self.dense_solver is None and self.options.dense_solver_enabled:
            from .solver import DenseSolver

            min_batch = self.options.dense_min_batch
            if min_batch <= 0:  # auto: time K1's probe round trip once
                from .solver.dense import measure_dense_crossover

                min_batch = measure_dense_crossover(device=self.device)
            incremental = None
            if self.options.solver_incremental:
                # incremental solve engine (--solver-incremental): fed by the
                # cluster state mirror's delta journal, so the engine and the
                # views it rebases read the same source of truth
                from .solver.incremental import IncrementalEngine

                incremental = IncrementalEngine(self.cluster.delta_journal, device=self.device)
            self.dense_solver = DenseSolver(
                min_batch=min_batch, device=self.device, incremental=incremental, auditor=self.auditor,
                hbm_budget_bytes=self.options.solver_hbm_budget_bytes,
            )
        remote_solver = None
        if self.options.solver_service_address:
            from .service.client import SolverClient

            remote_solver = SolverClient(self.options.solver_service_address, timeout=self.options.solver_service_timeout)
        # leadership gate (leader-flap hardening): the singleton loops —
        # provisioning included — consult this event before acting; it is
        # set only while this runtime holds the lease AND its post-(re)gain
        # recovery has finished, so a displaced leader's loops pause before
        # any successor's recovery acts and a re-elected leader reconstructs
        # before it provisions. The epoch counter (written only by the
        # elector thread) fences a recovery that outlived its leadership:
        # a gate must never open for a term that already ended
        self._leader_active = threading.Event()
        self._leader_epoch = 0
        self._recovery_thread: Optional[threading.Thread] = None
        # serializes the recovery thread's check-and-open against the lost
        # callback's bump-and-close
        from .analysis.witness import WITNESS as _WITNESS

        self._gate_lock = _WITNESS.lock("runtime.leader-gate")
        self.provisioner = ProvisionerController(
            self.kube, self.cluster, self.cloud_provider, config=self.config,
            recorder=self.recorder, dense_solver=self.dense_solver,
            remote_solver=remote_solver, clock=self.kube.clock,
            ice_backoff_seconds=self.options.ice_backoff_seconds,
            leader_check=self._may_act if self.options.leader_elect else None,
        )
        self.reconciler = ProvisioningReconciler(self.kube, self.provisioner)
        self.node_controller = NodeController(
            self.kube, self.cluster, self.cloud_provider, clock=self.kube.clock,
            # with the disruption orchestrator on, emptiness/expiration are
            # pure candidate sources — the orchestrator owns every voluntary
            # deletion (budgets + the validated command queue)
            delegate_disruption=self.options.disruption_enabled,
        )
        self.termination = TerminationController(self.kube, self.cloud_provider, self.recorder, clock=self.kube.clock)
        self.counter = CounterController(self.kube, self.cluster)
        # the crash-consistency sweep (controllers/gc): cloud instances vs
        # node objects, both directions, at startup and on an interval
        from .controllers.gc import GarbageCollectionController

        self.gc = GarbageCollectionController(
            self.kube, self.cluster, self.cloud_provider, termination=self.termination,
            clock=self.kube.clock, registration_grace=self.options.gc_registration_grace,
        )
        self.consolidation = ConsolidationController(
            self.kube, self.cluster, self.cloud_provider, self.provisioner, self.recorder, clock=self.kube.clock
        )
        # the unified disruption orchestrator: consolidation participates as
        # a candidate source; the orchestrator owns budgets, validation, and
        # execution of ALL voluntary disruption (interruption stays separate
        # — involuntary capacity loss is never budget-limited)
        self.disruption = None
        if self.options.disruption_enabled:
            from .controllers.disruption import DisruptionController

            self.disruption = DisruptionController(
                self.kube, self.cluster, self.cloud_provider, self.provisioner,
                consolidation=self.consolidation, termination=self.termination,
                recorder=self.recorder, clock=self.kube.clock,
            )
        # interruption subsystem: enabled by --interruption-queue against a
        # provider that exposes a notification source (the metrics decorator
        # forwards notification_source to the inner provider); the reference
        # gates its SQS controllers on aws.interruptionQueueName the same way
        self.interruption = None
        if self.options.interruption_queue:
            source_fn = getattr(self.cloud_provider, "notification_source", None)
            source = source_fn() if source_fn is not None else None
            if source is None:
                log.warning(
                    "--interruption-queue=%s set but provider %s exposes no notification source; disabled",
                    self.options.interruption_queue, self.cloud_provider.name(),
                )
            else:
                from .controllers.interruption import InterruptionController

                self.interruption = InterruptionController(
                    self.kube, self.cluster, self.provisioner, source,
                    termination=self.termination, recorder=self.recorder, clock=self.kube.clock,
                    # offering-health feed: a reclaimed spot pool is
                    # quarantined before the proactive replacement solve
                    # (the metrics decorator forwards the provider hook)
                    cloud_provider=self.cloud_provider,
                )
        self.pod_metrics = PodMetricsController(self.kube)
        self.provisioner_metrics = ProvisionerMetricsController(self.kube)
        self.node_metrics = NodeMetricsScraper(self.cluster)
        # SLO accounting (slo.py): watch-driven pending/ready latency plus
        # the cost scraper below, behind --enable-slo. The watch hooks are
        # only attached when enabled, so a disabled runtime's bind path
        # carries no SLO dispatch at all (disabled == free, like tracing)
        from .controllers.metrics import SLOScraper

        self.slo = SLO
        self.slo_metrics = SLOScraper(
            self.kube, self.cluster, self.cloud_provider, provisioner_controller=self.provisioner
        )
        if self.options.enable_slo:
            SLO.enable()
            SLO.attach(self.kube)
        # restart state reconstruction, phase 1: re-list the API into the
        # state cache (the informer re-list), so a successor process starts
        # from the API's truth
        self.cluster.resync()
        import socket
        import uuid

        from .kube.coherence import COHERENCE
        from .kube.leaderelection import LeaseElector

        # hostname + random suffix, the client-go identity recipe — unique
        # across processes (id(self) is a heap address and can collide)
        identity = f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}"
        self.elector = LeaseElector(
            self.kube, identity=identity, clock=self.kube.clock,
            lease_duration=self.options.lease_duration,
            renew_period=self.options.lease_renew_period,
        )
        # informer-coherence witness: this runtime's state cache is under
        # deep-compare for its whole life (the periodic loop only runs when
        # --coherence-interval > 0, but registration is what lets harnesses
        # run the teardown final_check); a stopped/crashed runtime
        # deregisters in _detach_watchers
        self._coherence_name = f"state.cluster/{identity}"
        COHERENCE.register(self._coherence_name, self.cluster)
        # thread census (invariants.py): every thread this runtime spawns —
        # control loops, the provisioner batcher thread, the elector, the
        # leader-recovery task — registers under this owner; stop()/crash()
        # join-with-timeout then release(), and anything still alive at
        # release is a straggler the invariant monitor counts until it dies
        self._census_owner = f"runtime/{identity}"
        # the invariant monitor loop (--invariants-interval): arm against
        # this runtime's backend and sample on the interval. The generation
        # token scopes the teardown: a stopped runtime disarms only the
        # window IT armed, never a successor's
        self._invariants_generation = None
        if self.options.invariants_interval > 0:
            from .invariants import MONITOR

            self._invariants_generation = MONITOR.arm(self.kube, clock=self.kube.clock)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # exceptions that ended a loop or the recovery, first first
        self._errors: List[Exception] = []
        # passes run by this runtime, by controller (the registry's
        # histogram below is process-wide)
        self.passes: Dict[str, int] = {}
        self.solve_duration = REGISTRY.histogram(
            "karpenter_allocation_controller_scheduling_duration_seconds",
            "Duration of provisioning scheduling rounds",
        )
        # one observation (and one span, when tracing is on) per controller
        # pass — the controller-runtime reconcile histogram analog; the
        # provisioning controller feeds the same family from its own round
        self.reconcile_duration = REGISTRY.histogram(
            "karpenter_reconcile_duration_seconds",
            "Duration of controller reconcile passes",
            ("controller",),
        )

    def _pass(self, controller: str, fn):
        """One reconcile pass of one controller: a span (trace root when no
        ambient trace) + the per-controller duration histogram. Idle passes
        (no child spans) are not retained — at ~3 empty traces/sec from the
        lifecycle loop they would evict every interesting trace from the
        bounded ring within minutes; the histogram still observes them."""
        self.passes[controller] = self.passes.get(controller, 0) + 1
        with TRACER.span("reconcile", controller=controller, drop_childless=True):
            with self.reconcile_duration.time(controller=controller):
                return fn()

    # -- health --------------------------------------------------------------

    @property
    def error(self) -> Optional[Exception]:
        """The first exception that ended a loop (the provisioner's batch
        loop included) or the post-election recovery; None while all run."""
        if self._errors:
            return self._errors[0]
        return self.provisioner.error

    def healthy(self) -> bool:
        return not self._stop.is_set() and self.error is None

    def ready(self) -> bool:
        return self.cluster.synchronized()

    def threads(self) -> List[threading.Thread]:
        """Every thread this runtime started: the loops, the provisioner's
        batch loop, the elector and the recovery task."""
        extra = [self.provisioner.thread, self.elector.thread, self._recovery_thread]
        return self._threads + [t for t in extra if t is not None]

    # -- lifecycle -------------------------------------------------------------

    def _may_act(self) -> bool:
        """The leadership gate the singleton loops consult before every
        pass. True while this runtime holds the lease and its post-gain
        recovery has completed; always True without leader election."""
        return self._leader_active.is_set()

    def _recover(self) -> None:
        """Restart/flap reconstruction, phases 2+3, leader-only (followers
        hold no ledger and must not race the leader's sweep): rebuild the
        disruption ledger / reap-or-adopt from durable markers, then run the
        startup GC sweep so crash leftovers reconcile BEFORE the control
        loops resume acting."""
        if self.disruption is not None:
            self._pass("disruption-recovery", self.disruption.recover)
        self._pass("gc", self.gc.reconcile)

    def _on_leadership_gained(self) -> None:
        """Elector callback, every transition INTO leadership: recovery runs
        on its own thread before the gate opens (a slow ledger rebuild must
        not starve the elector's renew loop). The epoch captured here fences
        the gate: if leadership was lost while recovery ran, the gate stays
        closed. A recovery that raises leaves the gate closed and the
        runtime unhealthy."""
        epoch = self._leader_epoch

        def recover_then_open() -> None:
            self._recover()
            with self._gate_lock:
                # atomic vs _on_leadership_lost, which bumps the epoch and
                # clears the gate under this same lock
                if self._leader_epoch == epoch and self.elector.is_leader():
                    self._leader_active.set()
                else:
                    log.warning("leadership lost during recovery; gate stays closed for the ended term")

        from .invariants import CENSUS

        thread = threading.Thread(
            target=self._guarded(recover_then_open, "leader-recovery"), name="leader-recovery", daemon=True
        )
        with self._gate_lock:
            # published only once started, and never after the shutdown set
            # the stop flag (under this lock): _shutdown joins a started
            # thread or none
            if self._stop.is_set():
                return
            CENSUS.register(self._census_owner, thread)
            thread.start()
            self._recovery_thread = thread

    def _on_leadership_lost(self) -> None:
        """Elector callback, on the lost transition: close the gate FIRST —
        the old leader's loops must pause before any successor's recovery
        acts, and the next gain re-runs recovery before re-opening."""
        with self._gate_lock:
            self._leader_epoch += 1
            self._leader_active.clear()
        log.warning("leadership lost: singleton loops paused until re-elected")

    def start(self) -> None:
        from .invariants import CENSUS

        if self.options.leader_elect:
            # Lease-based election (controllers.go:104-106): block until this
            # runtime holds karpenter-leader-election and has recovered; a
            # recovery that raised (or a stop) returns early
            log.info("leader election: %s campaigning", self.elector.identity)
            self.elector.start(
                on_started_leading=self._on_leadership_gained,
                on_stopped_leading=self._on_leadership_lost,
            )
            CENSUS.register(self._census_owner, self.elector.thread)
            while not self.elector.wait_for_leadership(timeout=0.5):
                if self._stop.is_set():
                    return
            log.info("leader election won by %s", self.elector.identity)
            while not self._leader_active.wait(timeout=0.5):
                if self._stop.is_set() or self._errors:
                    return
        log.info(
            "runtime starting: provider=%s dense_solver=%s batch window idle=%.2fs max=%.2fs",
            self.cloud_provider.name(),
            self.dense_solver.device if self.dense_solver is not None else None,
            self.config.batch_idle_duration, self.config.batch_max_duration,
        )
        if not self.options.leader_elect:
            # no election: this process is the only control plane — run the
            # startup reconstruction inline and open the gate permanently
            self._recover()
            self._leader_active.set()
        self.provisioner.start()
        CENSUS.register(self._census_owner, self.provisioner.thread)
        self._spawn(self._lifecycle_loop, "node-lifecycle")
        if self.options.gc_interval > 0:
            self._spawn(self._gc_loop, "gc")
        if self.disruption is not None:
            # the orchestrator loop REPLACES the consolidation loop: the
            # consolidation controller still evaluates, but as a candidate
            # source inside the orchestrator's budgeted, validated pass
            self._spawn(self._disruption_loop, "disruption")
        else:
            self._spawn(self._consolidation_loop, "consolidation")
        self._spawn(self._metrics_loop, "metrics-scraper")
        # leader-gated per pass (not merely at spawn): a leader whose lease
        # is stolen mid-run pauses these loops at their next tick
        self._spawn(self._pricing_loop, "pricing-refresh")
        if self.interruption is not None:
            # same leader gating: only the leader acts on interruption
            # notices (two replicas polling would double-provision)
            self._spawn(self._interruption_loop, "interruption")
        if self.options.coherence_interval > 0:
            self._spawn(self._coherence_loop, "coherence-witness")
        if self.options.invariants_interval > 0:
            self._spawn(self._invariants_loop, "invariant-monitor")

    def _shutdown(self, release_lease: bool) -> None:
        """The shared teardown: halt + join every runtime-owned thread
        (loops, provisioner, recovery, elector), detach the watchers, then
        release the census — any thread still alive after its join timeout
        is logged as a straggler and stays under the invariant monitor's
        watch until it dies."""
        from .invariants import CENSUS, MONITOR

        with self._gate_lock:
            self._stop.set()
        self._leader_active.clear()
        try:
            self.provisioner.stop()
        except Exception:  # noqa: BLE001 - kept in provisioner.error; stop() raises it after the teardown
            pass
        if self.provisioner.remote_solver is not None:
            self.provisioner.remote_solver.close()
        for thread in self._threads:
            thread.join(timeout=5)
        if self._recovery_thread is not None:
            self._recovery_thread.join(timeout=5)
        self.elector.stop(release=release_lease)
        self._detach_watchers()
        stragglers = CENSUS.release(self._census_owner)
        if stragglers:
            log.warning("runtime shutdown left straggler thread(s) alive: %s", stragglers)
        if self._invariants_generation is not None:
            MONITOR.disarm(self._invariants_generation)
            self._invariants_generation = None

    def stop(self) -> None:
        """Graceful stop: tear down, release the lease, then re-raise the
        first exception that ended a loop, if any."""
        self._shutdown(release_lease=True)
        if self.error is not None:
            raise self.error

    def crash(self) -> None:
        """Simulated process death: every loop halts with NO graceful
        cleanup — in-memory state (the budget ledger, the command queue, the
        interruption dedupe memory, nominations) is simply gone, exactly
        what a kill -9 leaves behind. The lease is NOT released (a real
        crash can't). Watch handlers ARE detached: in a real crash the
        process (and its in-memory subscriptions) dies with it."""
        self._shutdown(release_lease=False)

    def _detach_watchers(self) -> None:
        """Deregister every watch handler this Runtime's components attached
        to the shared KubeCluster: dispatch is synchronous on the mutating
        thread, so handlers surviving their Runtime would keep mirroring a
        dead control plane."""
        from .kube.coherence import COHERENCE

        COHERENCE.deregister(self._coherence_name)
        self.cluster.detach()
        self.reconciler.detach()
        if self._config_unwatch is not None:
            self._config_unwatch()
            self._config_unwatch = None

    def _guarded(self, target, name: str):
        """`target` as a thread body whose exception is kept (healthy()
        turns false, stop() re-raises it) instead of dying unseen."""

        def run() -> None:
            try:
                target()
            except Exception as exc:  # noqa: BLE001 - kept and re-raised by stop()
                log.exception("%s failed; the runtime is unhealthy", name)
                self._errors.append(exc)

        return run

    def _spawn(self, target, name: str) -> None:
        from .invariants import CENSUS

        thread = threading.Thread(target=self._guarded(target, f"{name} loop"), name=name, daemon=True)
        CENSUS.register(self._census_owner, thread)
        thread.start()
        self._threads.append(thread)

    def _lifecycle_loop(self) -> None:
        while not self._stop.wait(timeout=1.0):
            if not self._may_act():
                continue  # not (or no longer) the leader: pause, don't act
            self._pass("node", self.node_controller.reconcile_all)
            self._pass("termination", self.termination.reconcile_all)
            self._pass("counter", self.counter.reconcile_all)

    def _consolidation_loop(self) -> None:
        while not self._stop.wait(timeout=ConsolidationController.POLL_INTERVAL):
            if self._may_act() and self.consolidation.should_run():
                self._pass("consolidation", self._consolidate)

    def _consolidate(self):
        """The consolidation pass of a Runtime without the orchestrator
        (--disable-disruption). A solver fault in its what-if
        (solver/faults.py) ends the pass with no action and the next pass
        retries on the card, as the orchestrator's source does; a
        device-lost the card raised (faults.ends_the_loop) ends the loop."""
        try:
            return self.consolidation.process_cluster()
        except SolverFault as fault:
            if ends_the_loop(fault):
                raise
            self.consolidation.retry_next_pass()
            log.warning("consolidation held by a %s fault; the next pass retries: %s", fault.kind, fault)
            return None

    def _disruption_loop(self) -> None:
        from .controllers.disruption import DisruptionController

        while not self._stop.wait(timeout=DisruptionController.POLL_INTERVAL):
            if not self._may_act():
                continue
            self._pass("disruption", self.disruption.reconcile)

    def _gc_loop(self) -> None:
        while not self._stop.wait(timeout=self.options.gc_interval):
            if not self._may_act():
                continue
            self._pass("gc", self.gc.reconcile)

    def _metrics_loop(self) -> None:
        # never leader-gated: followers keep serving metrics and SLO gauges
        while not self._stop.wait(timeout=5.0):
            self._pass("pod-metrics", self.pod_metrics.scrape)
            self._pass("provisioner-metrics", self.provisioner_metrics.scrape)
            self._pass("node-metrics", self.node_metrics.scrape)
            if self.options.enable_slo:
                self._pass("slo-metrics", self.slo_metrics.scrape)
            if self.options.enable_capsules:
                # drain the trigger bus + run the burn-rate monitor; never
                # leader-gated — a follower's divergences are evidence too
                self._pass("capsule-poll", CAPSULE.poll)

    def _coherence_loop(self) -> None:
        from .kube.coherence import COHERENCE

        while not self._stop.wait(timeout=self.options.coherence_interval):
            self._pass("coherence", COHERENCE.check)

    def _invariants_loop(self) -> None:
        # never leader-gated: a follower leaks threads/watches exactly like
        # a leader, and the monitor is read-only over process state
        from .invariants import MONITOR

        while not self._stop.wait(timeout=self.options.invariants_interval):
            self._pass("invariants", MONITOR.sample)

    def _pricing_loop(self) -> None:
        while not self._stop.wait(timeout=self.options.pricing_refresh_period):
            if not self._may_act():
                continue
            self._pass("pricing", self.refresh_pricing_once)

    def _interruption_loop(self) -> None:
        # the receive itself long-polls (wait_seconds) while the transport
        # is healthy; a failed receive (-1) returns instantly, so THAT path
        # waits the full poll interval — otherwise an outage hot-spins
        while not self._stop.is_set():
            if not self._may_act():
                if self._stop.wait(timeout=0.1):
                    return
                continue
            received = self.interruption.poll_once(wait_seconds=self.options.interruption_poll_interval)
            pause = self.options.interruption_poll_interval if received < 0 else 0.05
            if received <= 0 and self._stop.wait(timeout=pause):
                return

    def refresh_pricing_once(self) -> bool:
        """One pricing-refresh tick against providers that support it (the
        metrics decorator forwards refresh_pricing to the inner provider;
        providers without price books are a no-op). Returns True when the
        books changed and the catalog was invalidated. A failed refresh is
        logged and retried next period: it runs no solve."""
        refresh = getattr(self.cloud_provider, "refresh_pricing", None)
        if refresh is None:
            return False
        try:
            return bool(refresh())
        except Exception as err:  # noqa: BLE001 - refresh must never kill the loop
            log.warning("pricing refresh failed (will retry next period): %s", err)
            return False

    # -- synchronous drive (tests / simulations) --------------------------------

    def reconcile_once(self) -> None:
        """One pass of every non-provisioning controller."""
        if self.interruption is not None:
            self._pass("interruption", self.interruption.poll_once)
        self._pass("node", self.node_controller.reconcile_all)
        self._pass("termination", self.termination.reconcile_all)
        self._pass("counter", self.counter.reconcile_all)
        self._pass("gc", self.gc.reconcile)
        if self.disruption is not None:
            self._pass("disruption", self.disruption.reconcile)
        elif self.consolidation.should_run():
            self._pass("consolidation", self._consolidate)
        self._pass("pod-metrics", self.pod_metrics.scrape)
        self._pass("provisioner-metrics", self.provisioner_metrics.scrape)
        self._pass("node-metrics", self.node_metrics.scrape)
        if self.options.enable_slo:
            self._pass("slo-metrics", self.slo_metrics.scrape)

    def provision_once(self):
        from .profiling import maybe_profile_round

        with maybe_profile_round(self.options.enable_profiling, "provision"):
            with self.solve_duration.time():
                return self.provisioner.trigger_and_wait()
