"""Runtime bootstrap: assemble and run the full controller manager.

Equivalent of pkg/controllers/controllers.go:86-248 — builds the
cluster-state cache and every controller; registers admission; runs
reconciliation loops on threads with leader-election gating for the
singleton loops (provisioning, lifecycle, disruption, gc, pricing refresh,
interruption); answers the health and readiness probes.

Leader election in a single-process in-memory deployment degenerates to a
local lock, but the gating seam is identical: followers run the state cache
and webhooks, only the leader provisions/consolidates (controllers.go:104).

The port's copy of karpenter_tpu/runtime.py. The dense solver runs on the
card (`device="cuda"`, the default; "cpu" runs the plain versions of the
kernels): with dense_min_batch <= 0 the crossover is measured at boot by
timing K1's probe round trip. Left out until their ROADMAP items come: the
cloud provider's metrics decorator, the registry histograms and trace
spans around each pass, the metrics loop and its scrapers, the SLO
accountant, flight recorder, journal and capsules, the lock witness, the
thread census and invariant monitor, the solver breaker (A8, A7) and the
informer-coherence witness (A7). Each option that would turn one of them
on, or set the breaker's threshold or backoff away from its default,
raises NotImplementedError at construction, naming its item.

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
from .cloudprovider.types import CloudProvider
from .config import Config, watch_config
from .controllers.consolidation import ConsolidationController
from .controllers.counter import CounterController
from .controllers.node import NodeController
from .controllers.provisioning import ProvisionerController, ProvisioningReconciler
from .controllers.state.cluster import Cluster
from .controllers.termination import TerminationController
from .events import DedupeRecorder, Recorder
from .kube.cluster import KubeCluster
from .logsetup import configure as configure_logging, get_logger, set_level
from .utils.options import Options

log = get_logger("runtime")

# option -> (is it on?, what it needs): each raises until its item is ported
_UNPORTED = (
    ("enable_tracing", lambda o: o.enable_tracing, "decision tracing (tracing.py, ROADMAP A8)"),
    ("enable_solver_telemetry", lambda o: o.enable_solver_telemetry, "the solver flight recorder (flight.py, ROADMAP A8)"),
    ("enable_journal", lambda o: o.enable_journal, "the lifecycle journal (journal.py, ROADMAP A8)"),
    ("enable_capsules", lambda o: o.enable_capsules, "incident capsules (capsule.py, ROADMAP A8)"),
    ("enable_slo", lambda o: o.enable_slo, "SLO accounting (slo.py, ROADMAP A8)"),
    ("enable_lock_witness", lambda o: o.enable_lock_witness, "the lock-order witness (analysis/witness.py, ROADMAP A8)"),
    ("enable_profiling", lambda o: o.enable_profiling, "live profiling (profiling.py, ROADMAP A8)"),
    ("invariants_interval", lambda o: o.invariants_interval > 0, "the invariant monitor (invariants.py, ROADMAP A8)"),
    ("coherence_interval", lambda o: o.coherence_interval > 0, "the informer-coherence witness (kube/coherence.py, ROADMAP A7)"),
    ("solver_hbm_budget_bytes", lambda o: o.solver_hbm_budget_bytes != 0, "the HBM-pressure chunked dispatch (solver/faults.py, ROADMAP A7)"),
    ("solver_breaker_threshold", lambda o: o.solver_breaker_threshold != Options.solver_breaker_threshold, "the solver circuit breaker (solver/faults.py, ROADMAP A7)"),
    ("solver_breaker_backoff", lambda o: o.solver_breaker_backoff != Options.solver_breaker_backoff, "the solver circuit breaker (solver/faults.py, ROADMAP A7)"),
)


def check_ported(options: Options) -> None:
    """Raise NotImplementedError for the first set option whose feature the
    port does not have yet."""
    for name, is_on, needs in _UNPORTED:
        if is_on(options):
            raise NotImplementedError(f"{name}: {needs} is not ported yet")


@dataclass
class Runtime:
    kube: KubeCluster
    cloud_provider: CloudProvider
    options: Options = field(default_factory=Options)
    dense_solver: object = None
    device: str = "cuda"

    def __post_init__(self):
        check_ported(self.options)
        configure_logging(self.options.log_level)
        self.config = Config(self.options.batch_max_duration, self.options.batch_idle_duration, self.options.log_level)
        # live log-level reload, the config-logging ConfigMap analog
        # (controllers.go:240-248): a config update re-levels the tree
        self.config.on_change(lambda cfg: set_level(cfg.log_level))
        # live settings from the karpenter-global-settings ConfigMap; keep
        # the unsubscriber — watches dispatch synchronously on the shared
        # cluster, so a stopped/crashed Runtime must detach what it attached
        self._config_unwatch = watch_config(self.kube, self.config)
        self.recorder = DedupeRecorder(Recorder(), clock=self.kube.clock)
        webhooks.register(self.kube, self.cloud_provider)
        self.cluster = Cluster(self.kube, self.cloud_provider, clock=self.kube.clock)
        if self.dense_solver is None and self.options.dense_solver_enabled:
            from .solver import DenseSolver

            min_batch = self.options.dense_min_batch
            if min_batch <= 0:  # auto: time K1's probe round trip once
                from .solver.dense import measure_dense_crossover

                min_batch = measure_dense_crossover(device=self.device)
            incremental = auditor = None
            if self.options.solver_incremental:
                # incremental solve engine (--solver-incremental): fed by the
                # cluster state mirror's delta journal, so the engine and the
                # views it rebases read the same source of truth
                from .solver.incremental import IncrementalEngine

                incremental = IncrementalEngine(self.cluster.delta_journal, device=self.device)
            if self.options.residency_audit_interval > 0:
                from .solver.audit import ResidencyAuditor

                auditor = ResidencyAuditor(interval=self.options.residency_audit_interval)
            self.dense_solver = DenseSolver(
                min_batch=min_batch, device=self.device, incremental=incremental, auditor=auditor
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
        self._gate_lock = threading.Lock()
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
        # provider that exposes a notification source; the reference gates
        # its SQS controllers on aws.interruptionQueueName the same way
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
                    cloud_provider=self.cloud_provider,
                )
        # restart state reconstruction, phase 1: re-list the API into the
        # state cache (the informer re-list), so a successor process starts
        # from the API's truth
        self.cluster.resync()
        import socket
        import uuid

        from .kube.leaderelection import LeaseElector

        # hostname + random suffix, the client-go identity recipe — unique
        # across processes (id(self) is a heap address and can collide)
        identity = f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}"
        self.elector = LeaseElector(
            self.kube, identity=identity, clock=self.kube.clock,
            lease_duration=self.options.lease_duration,
            renew_period=self.options.lease_renew_period,
        )
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # exceptions that ended a loop or the recovery, first first
        self._errors: List[Exception] = []
        # passes run, by controller (the reconcile histogram's plain tally)
        self.passes: Dict[str, int] = {}

    def _pass(self, controller: str, fn):
        """One reconcile pass of one controller."""
        self.passes[controller] = self.passes.get(controller, 0) + 1
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

        self._recovery_thread = threading.Thread(
            target=self._guarded(recover_then_open, "leader-recovery"), name="leader-recovery", daemon=True
        )
        self._recovery_thread.start()

    def _on_leadership_lost(self) -> None:
        """Elector callback, on the lost transition: close the gate FIRST —
        the old leader's loops must pause before any successor's recovery
        acts, and the next gain re-runs recovery before re-opening."""
        with self._gate_lock:
            self._leader_epoch += 1
            self._leader_active.clear()
        log.warning("leadership lost: singleton loops paused until re-elected")

    def start(self) -> None:
        if self.options.leader_elect:
            # Lease-based election (controllers.go:104-106): block until this
            # runtime holds karpenter-leader-election and has recovered; a
            # recovery that raised (or a stop) returns early
            self.elector.start(
                on_started_leading=self._on_leadership_gained,
                on_stopped_leading=self._on_leadership_lost,
            )
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
        # leader-gated per pass (not merely at spawn): a leader whose lease
        # is stolen mid-run pauses these loops at their next tick
        self._spawn(self._pricing_loop, "pricing-refresh")
        if self.interruption is not None:
            # same leader gating: only the leader acts on interruption
            # notices (two replicas polling would double-provision)
            self._spawn(self._interruption_loop, "interruption")

    def _shutdown(self, release_lease: bool) -> None:
        """The shared teardown: halt + join every runtime-owned thread
        (loops, provisioner, recovery, elector) and detach the watchers."""
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
        stragglers = [t.name for t in self.threads() if t.is_alive()]
        if stragglers:
            log.warning("runtime shutdown left straggler thread(s) alive: %s", stragglers)

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
        thread = threading.Thread(target=self._guarded(target, f"{name} loop"), name=name, daemon=True)
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
                self._pass("consolidation", self.consolidation.process_cluster)

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
        """One pricing-refresh tick against providers that support it
        (providers without price books are a no-op). Returns True when the
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
            self._pass("consolidation", self.consolidation.process_cluster)

    def provision_once(self):
        return self.provisioner.trigger_and_wait()
