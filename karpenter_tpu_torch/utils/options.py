"""Runtime options: CLI flags with environment fallback.

Equivalent of pkg/utils/options/options.go — ports, client budgets,
profiling, provider tuning — validated at boot.

The port's copy of karpenter_tpu/utils/options.py, whole: every flag and its
environment fallback. The Runtime (runtime.py) raises NotImplementedError,
naming the ROADMAP item, for each option whose feature the port has not
brought over yet (the telemetry switches, the coherence and invariant
loops, the HBM budget, the solver breaker's threshold and backoff) when it
is set away from its default. The one exception is --metrics-port, which
the sidecar deployment passes: nothing binds it until /metrics is ported
(ROADMAP A8), and the controller entry point logs a warning saying so at
boot.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import List, Optional

# The host-loop/device crossover, canonical for every routing site: the
# Options default below, DenseSolver's own default, and the provisioner's
# remote-sidecar gate all read this one constant. This is the reference's
# value; it has not been measured for this port. A deployment measures its
# own with solver/dense.py:measure_dense_crossover (the Runtime does, with
# dense_min_batch=0) and passes it to DenseSolver as min_batch.
DENSE_MIN_BATCH_DEFAULT = 320


@dataclass
class Options:
    metrics_port: int = 8080
    health_probe_port: int = 8081
    kube_client_qps: float = 200.0
    kube_client_burst: int = 300
    enable_profiling: bool = False
    # decision tracing (tracing.py): spans per controller pass + per-pod
    # decision records, served on /debug/traces and /debug/decisions over
    # the metrics port. Off by default — disabled tracing is a true no-op
    enable_tracing: bool = False
    trace_ring_size: int = 256  # completed traces retained (bounded ring)
    # SLO accounting (slo.py): pod-pending-latency / time-to-ready summaries,
    # cluster $/hr + cost-drift gauges, churn counters, served on /debug/slo
    # over the metrics port. Off by default — disabled SLO accounting is a
    # true no-op on the watch hot path (same bar as tracing)
    enable_slo: bool = False
    # lock-order witness (analysis/witness.py): every lock created through
    # WITNESS after enabling records acquisition order, contention, and hold
    # times; cycles (potential deadlocks) surface on /debug/locks and the
    # karpenter_lockwitness_* families. Off by default — disabled means the
    # shared classes get PLAIN threading locks, zero wrapper overhead
    enable_lock_witness: bool = False
    # solver flight recorder (flight.py): per-solve shape/phase records, XLA
    # compile-churn attribution, HBM gauges, served on /debug/solver over
    # the metrics port. Off by default — disabled telemetry is a true no-op
    # on the solve path (same bar as tracing)
    enable_solver_telemetry: bool = False
    flight_ring_size: int = 128  # per-solve records retained (bounded ring)
    # lifecycle journal (journal.py): pod/node transition stream + the
    # pending-latency waterfall, served on /debug/journal and /debug/waterfall
    # over the metrics port. Off by default — a disabled journal is a true
    # no-op: no ring, no watch hooks, one attribute read per event site
    enable_journal: bool = False
    journal_ring_size: int = 8192  # lifecycle events retained (bounded ring)
    # append-only JSONL spool for the journal (the on-disk trace format the
    # replay harness consumes); empty = in-memory only. The spool is
    # size-bounded: live + one rotation never exceed journal_spool_max_bytes
    journal_spool: str = ""
    journal_spool_max_bytes: int = 16 * 2**20
    leader_elect: bool = True
    # lease-election timing (kube/leaderelection.py): how long a lost holder
    # blocks successors, and how often a candidate tries to acquire/renew —
    # the controller-runtime 15s/2s defaults; chaos harnesses shrink both so
    # a stolen lease flaps inside the scenario window
    lease_duration: float = 15.0
    lease_renew_period: float = 2.0
    # informer-coherence witness (kube/coherence.py): period of the
    # deep-compare of every registered informer cache against the
    # authoritative store. <= 0 (the default) disables the loop — the cache
    # is still registered, so harnesses can run final_check() at teardown
    coherence_interval: float = 0.0
    # invariant monitor (invariants.py): period of the leak-witness sample
    # loop (thread census stragglers, watch-subscription growth, bounded
    # ring/spool budgets, folded lock/coherence/double-launch witnesses),
    # served at /debug/invariants. <= 0 (the default) disables the loop and
    # leaves the process-wide monitor disarmed for harnesses to drive
    invariants_interval: float = 0.0
    batch_max_duration: float = 10.0
    batch_idle_duration: float = 1.0
    dense_solver_enabled: bool = True
    # below this batch size the exact host loop is faster and cheaper than a
    # device dispatch. 0 (the default) = measure the dispatch round trip at
    # startup and derive the crossover for THIS deployment's device link
    # (solver/dense.py measure_dense_crossover); a positive value pins it
    dense_min_batch: int = 0
    cluster_name: str = ""
    log_level: str = "info"
    # period of the leader-only pricing refresh loop (pricing.go:76-393 runs
    # OD and spot updaters on election; one TTL here covers both books)
    pricing_refresh_period: float = 300.0
    solver_service_address: str = ""  # host:port of the gRPC solver sidecar (empty = in-process)
    solver_service_timeout: float = 30.0
    # name of the cloud-side interruption queue (the aws.interruptionQueueName
    # settings analog). Non-empty enables the interruption controller's
    # leader-gated poll loop against the provider's notification source
    interruption_queue: str = ""
    # long-poll wait per receive; the loop re-polls immediately after a
    # non-empty batch, so this only paces the idle case
    interruption_poll_interval: float = 2.0
    # the unified disruption orchestrator (controllers/disruption): owns all
    # voluntary disruption — emptiness, expiration, drift, consolidation —
    # behind per-provisioner budgets and a validated command queue. Disabling
    # falls back to the legacy per-controller paths (consolidation loop +
    # node-controller TTL deletes) with no budgets or drift detection
    disruption_enabled: bool = True
    # URL of a Kubernetes apiserver (http://host:port). Empty = the in-memory
    # simulation backend; set (or KUBERNETES_APISERVER_URL) = the real-protocol
    # HTTP client (kube/client.py) with the QPS/burst budget above
    apiserver_url: str = ""
    # period of the GC reconciliation sweep (controllers/gc): cloud instances
    # vs node objects, both directions; the first sweep runs at startup so a
    # restarted controller reconciles crash leftovers before provisioning
    # resumes. <= 0 disables the loop (the startup sweep still runs)
    gc_interval: float = 15.0
    # how long a launched instance may exist unregistered before the sweep
    # treats it as an orphan (the legitimate launch->register window)
    gc_registration_grace: float = 30.0
    # capacity-failure escalation (controllers/provisioning): how long a pod
    # whose every launch/re-solve attempt hit insufficient capacity sits out
    # of the batch before re-probing — below the unavailable-offering TTL so
    # recovery is noticed, above the batch window so a total crunch cannot
    # hot-loop the solver into the wall
    ice_backoff_seconds: float = 10.0
    # solver fault domain (solver/faults.py): pre-solve HBM-pressure budget —
    # when the flight recorder's HBM-peak gauge exceeds this many bytes the
    # dense dispatch chunks pre-emptively instead of building the full
    # [B, T] surface (0 = no budget; requires --enable-solver-telemetry for
    # the gauge to be live)
    solver_hbm_budget_bytes: int = 0
    # the solver circuit breaker: this many CONSECUTIVE classified device
    # faults short-circuit the device attempt entirely (the exact host loop
    # owns every batch), and after the backoff the next real solve runs a
    # half-open recovery probe that re-admits the fast path on success
    solver_breaker_threshold: int = 3
    solver_breaker_backoff: float = 30.0
    # incremental solve engine (solver/incremental.py): keep the warm-view
    # encoding + device headroom surface resident across provision passes
    # and apply the cluster state journal's delta instead of re-encoding —
    # O(changes) steady state with byte-equal fallback to the fresh-encode
    # path on catalog changes, journal gaps, and fault invalidations
    solver_incremental: bool = False
    # residency auditor (solver/audit.py): every Nth incremental provision
    # pass re-encodes a seeded sample of view rows (plus a periodic full
    # shadow under a byte budget) from cluster truth and compares host
    # mirror, device-buffer rows, and the availability cube against the
    # engine's resident state; divergence triggers a residency-divergence
    # capsule and auto-heals by forcing the fresh full re-encode path.
    # 0 (the default) disables the auditor entirely
    residency_audit_interval: int = 0
    # incident capsules (capsule.py): triggered cross-subsystem evidence
    # capture — breaker opens, host-rung falls, conservation violations,
    # steady-state recompiles, lock cycles, invariant breaches, and the
    # multi-window SLO burn-rate monitor each freeze every telemetry ring
    # into one CAPSULE_<trigger>_<seq>.json bundle at /debug/capsules;
    # capsule_spool lands them on disk under a byte budget (the journal's
    # rotation discipline), capsule_debounce_seconds rate-limits per
    # trigger kind
    enable_capsules: bool = False
    capsule_spool: str = ""
    capsule_spool_max_bytes: int = 32 * 2**20
    capsule_debounce_seconds: float = 30.0

    def validate(self) -> List[str]:
        errs = []
        if not (0 < self.metrics_port < 65536):
            errs.append(f"invalid metrics port {self.metrics_port}")
        if not (0 < self.health_probe_port < 65536):
            errs.append(f"invalid health probe port {self.health_probe_port}")
        if self.kube_client_qps <= 0:
            errs.append("kube client qps must be positive")
        if self.batch_idle_duration <= 0 or self.batch_max_duration < self.batch_idle_duration:
            errs.append("batch durations must satisfy 0 < idle <= max")
        if self.pricing_refresh_period <= 0:
            errs.append("pricing refresh period must be positive")
        if self.lease_duration <= 0 or self.lease_renew_period <= 0:
            errs.append("lease duration and renew period must be positive")
        if self.lease_renew_period >= self.lease_duration:
            errs.append("lease renew period must be shorter than the lease duration")
        if self.interruption_poll_interval <= 0:
            errs.append("interruption poll interval must be positive")
        if self.gc_registration_grace < 0:
            errs.append("gc registration grace must be non-negative")
        if self.ice_backoff_seconds <= 0:
            errs.append("ice backoff must be positive")
        if self.solver_hbm_budget_bytes < 0:
            errs.append("solver hbm budget must be non-negative")
        if self.solver_breaker_threshold < 1:
            errs.append("solver breaker threshold must be >= 1")
        if self.solver_breaker_backoff <= 0:
            errs.append("solver breaker backoff must be positive")
        if self.residency_audit_interval < 0:
            errs.append("residency audit interval must be non-negative")
        if self.trace_ring_size <= 0:
            errs.append("trace ring size must be positive")
        if self.flight_ring_size <= 0:
            errs.append("flight ring size must be positive")
        if self.journal_ring_size <= 0:
            errs.append("journal ring size must be positive")
        if self.journal_spool_max_bytes <= 0:
            errs.append("journal spool max bytes must be positive")
        if self.capsule_spool_max_bytes <= 0:
            errs.append("capsule spool max bytes must be positive")
        if self.capsule_debounce_seconds < 0:
            errs.append("capsule debounce must be non-negative")
        from ..logsetup import is_valid_level

        if not is_valid_level(self.log_level):
            errs.append(f"invalid log level {self.log_level!r}")
        return errs


def _env(name: str, default):
    value = os.environ.get(name)
    if value is None:
        return default
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes")
    try:
        return type(default)(value)
    except ValueError:
        raise SystemExit(f"karpenter-tpu: error: invalid value for ${name}: {value!r}")


def parse(argv: Optional[List[str]] = None) -> Options:
    defaults = Options()
    parser = argparse.ArgumentParser(prog="karpenter-tpu")
    parser.add_argument("--metrics-port", type=int, default=_env("METRICS_PORT", defaults.metrics_port))
    parser.add_argument("--health-probe-port", type=int, default=_env("HEALTH_PROBE_PORT", defaults.health_probe_port))
    parser.add_argument("--kube-client-qps", type=float, default=_env("KUBE_CLIENT_QPS", defaults.kube_client_qps))
    parser.add_argument("--kube-client-burst", type=int, default=_env("KUBE_CLIENT_BURST", defaults.kube_client_burst))
    parser.add_argument("--enable-profiling", action="store_true", default=_env("ENABLE_PROFILING", defaults.enable_profiling))
    parser.add_argument("--enable-tracing", action="store_true", default=_env("ENABLE_TRACING", defaults.enable_tracing))
    parser.add_argument("--enable-slo", action="store_true", default=_env("ENABLE_SLO", defaults.enable_slo))
    parser.add_argument("--enable-lock-witness", action="store_true", default=_env("ENABLE_LOCK_WITNESS", defaults.enable_lock_witness))
    parser.add_argument("--enable-solver-telemetry", action="store_true", default=_env("ENABLE_SOLVER_TELEMETRY", defaults.enable_solver_telemetry))
    parser.add_argument("--enable-journal", action="store_true", default=_env("ENABLE_JOURNAL", defaults.enable_journal))
    parser.add_argument("--trace-ring-size", type=int, default=_env("TRACE_RING_SIZE", defaults.trace_ring_size))
    parser.add_argument("--flight-ring-size", type=int, default=_env("FLIGHT_RING_SIZE", defaults.flight_ring_size))
    parser.add_argument("--journal-ring-size", type=int, default=_env("JOURNAL_RING_SIZE", defaults.journal_ring_size))
    parser.add_argument("--journal-spool", default=_env("JOURNAL_SPOOL", defaults.journal_spool))
    parser.add_argument("--journal-spool-max-bytes", type=int, default=_env("JOURNAL_SPOOL_MAX_BYTES", defaults.journal_spool_max_bytes))
    parser.add_argument("--enable-capsules", action="store_true", default=_env("ENABLE_CAPSULES", defaults.enable_capsules))
    parser.add_argument("--capsule-spool", default=_env("CAPSULE_SPOOL", defaults.capsule_spool))
    parser.add_argument("--capsule-spool-max-bytes", type=int, default=_env("CAPSULE_SPOOL_MAX_BYTES", defaults.capsule_spool_max_bytes))
    parser.add_argument("--capsule-debounce-seconds", type=float, default=_env("CAPSULE_DEBOUNCE_SECONDS", defaults.capsule_debounce_seconds))
    parser.add_argument("--no-leader-elect", dest="leader_elect", action="store_false", default=_env("LEADER_ELECT", defaults.leader_elect))
    parser.add_argument("--lease-duration", type=float, default=_env("LEASE_DURATION", defaults.lease_duration))
    parser.add_argument("--lease-renew-period", type=float, default=_env("LEASE_RENEW_PERIOD", defaults.lease_renew_period))
    parser.add_argument("--coherence-interval", type=float, default=_env("COHERENCE_INTERVAL", defaults.coherence_interval))
    parser.add_argument("--invariants-interval", type=float, default=_env("INVARIANTS_INTERVAL", defaults.invariants_interval))
    parser.add_argument("--batch-max-duration", type=float, default=_env("BATCH_MAX_DURATION", defaults.batch_max_duration))
    parser.add_argument("--batch-idle-duration", type=float, default=_env("BATCH_IDLE_DURATION", defaults.batch_idle_duration))
    parser.add_argument("--disable-dense-solver", dest="dense_solver_enabled", action="store_false", default=_env("DENSE_SOLVER_ENABLED", defaults.dense_solver_enabled))
    parser.add_argument("--dense-min-batch", type=int, default=_env("DENSE_MIN_BATCH", defaults.dense_min_batch))
    parser.add_argument("--cluster-name", default=_env("CLUSTER_NAME", defaults.cluster_name))
    parser.add_argument("--log-level", default=_env("LOG_LEVEL", defaults.log_level))
    parser.add_argument("--solver-service-address", default=_env("SOLVER_SERVICE_ADDRESS", defaults.solver_service_address))
    parser.add_argument("--solver-service-timeout", type=float, default=_env("SOLVER_SERVICE_TIMEOUT", defaults.solver_service_timeout))
    parser.add_argument("--pricing-refresh-period", type=float, default=_env("PRICING_REFRESH_PERIOD", defaults.pricing_refresh_period))
    parser.add_argument("--interruption-queue", dest="interruption_queue", default=_env("INTERRUPTION_QUEUE", defaults.interruption_queue))
    parser.add_argument("--interruption-poll-interval", type=float, default=_env("INTERRUPTION_POLL_INTERVAL", defaults.interruption_poll_interval))
    parser.add_argument("--ice-backoff-seconds", type=float, default=_env("ICE_BACKOFF_SECONDS", defaults.ice_backoff_seconds))
    parser.add_argument("--solver-hbm-budget", dest="solver_hbm_budget_bytes", type=int, default=_env("SOLVER_HBM_BUDGET", defaults.solver_hbm_budget_bytes))
    parser.add_argument("--solver-breaker-threshold", type=int, default=_env("SOLVER_BREAKER_THRESHOLD", defaults.solver_breaker_threshold))
    parser.add_argument("--solver-breaker-backoff", type=float, default=_env("SOLVER_BREAKER_BACKOFF", defaults.solver_breaker_backoff))
    parser.add_argument("--solver-incremental", dest="solver_incremental", action="store_true", default=_env("SOLVER_INCREMENTAL", defaults.solver_incremental))
    parser.add_argument("--residency-audit-interval", type=int, default=_env("RESIDENCY_AUDIT_INTERVAL", defaults.residency_audit_interval))
    parser.add_argument("--disable-disruption", dest="disruption_enabled", action="store_false", default=_env("DISRUPTION_ENABLED", defaults.disruption_enabled))
    parser.add_argument("--apiserver-url", default=_env("KUBERNETES_APISERVER_URL", defaults.apiserver_url))
    parser.add_argument("--gc-interval", type=float, default=_env("GC_INTERVAL", defaults.gc_interval))
    parser.add_argument("--gc-registration-grace", type=float, default=_env("GC_REGISTRATION_GRACE", defaults.gc_registration_grace))
    namespace = parser.parse_args(argv)
    options = Options(**vars(namespace))
    errs = options.validate()
    if errs:
        parser.error("; ".join(errs))
    return options
