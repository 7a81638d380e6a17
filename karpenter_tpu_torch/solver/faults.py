"""Solver fault domain: typed device-failure taxonomy, deterministic fault
injection, and the circuit breaker that holds the batch.

The port's copy of karpenter_tpu/solver/faults.py. Its parts:

- **taxonomy** — `SolverCompileError` / `SolverHbmExhaustedError` /
  `SolverKernelError` / `SolverDeviceLostError`, plus `classify(exc)`
  mapping raw exception surfaces into it. It keeps the reference's XLA and
  Pallas marks and adds the CUDA and torch surfaces: a
  `torch.cuda.OutOfMemoryError`, `cudaErrorMemoryAllocation` or "out of
  memory" is `hbm`; an illegal memory access, a device-side assert, an
  unspecified launch failure or a misaligned address (the CUDA context
  stays broken after each) is `device-lost`; a failed nvcc/ptxas build
  (`ops/_cuda_build.KernelBuildError`) is `compile`; any other launch error
  of K1 or K2 (the wrappers name the CUDA error) is `kernel`. Everything
  else is None, as in the reference.
- **injection seam** — `FaultPlan` + the process-wide `FAULTS` injector:
  seeded, per-entry-name, nth-call triggers consulted at every dispatch
  seam: 'plain' (the dense solve's bucket choice), 'sharded' (the same
  choice over a solver mesh, parallel/), 'cuda' (each K1 launch,
  ops/bucket_cost.py: the counterpart of the reference's 'pallas'),
  'chunk' (each half of a budget split), 'warmfill' (K2's surface) and
  'rebase' (the incremental engine's device rebase); corruption kinds at
  the state seams 'resident-row', 'journal-record' and 'rebase'. Unset, a
  seam is one attribute read; installed, the same seed + plan produce the
  identical fault sequence on every run. Simulation re-solves
  (consolidation / SLO what-ifs) bypass the injector.
- **accounting** — `karpenter_solver_faults_total{kind}` counts every
  fault once (`count_fault`), `karpenter_solver_degraded_solves_total{rung}`
  the budget split; the dense solver stamps both on its flight records and
  journals them as `solver` events.
- **circuit breaker** — `SolverCircuitBreaker` (process-wide `BREAKER`):
  `threshold` CONSECUTIVE classified device faults open it, and after
  `backoff` seconds (clock-seam timed) the next REAL solve runs the
  half-open recovery probe — success closes it, failure re-opens it.
  Simulation solves share the state but never trip, probe or reset it.

The port's semantics, rung by rung. The reference's fault domain is a
fallback ladder; the port's no-fallback rule forbids every rung that moves
work off the card, so:

- *Flavor retirement* (a kernel fault retires Pallas to plain jnp): not
  ported. The fault is classified, counted, journaled and raised; K1 never
  gives way to its plain version on the card. `RUNG_FLAVOR` is never
  emitted.
- *HBM fault -> chunked re-dispatch from an `except`*: not ported. The
  fault is classified, counted, raised and recorded into the breaker.
- *Pre-solve budget* (`--solver-hbm-budget` against the flight recorder's
  `torch.cuda.memory_stats` peak): ported. The split is decided before any
  launch and launches K1 on each half of the bucket axis; each bucket's
  argmin is its own, so the concatenated [3, B] is bit-equal to one
  unsplit launch. It counts `degraded_solves{rung="chunked"}` and
  invalidates the incremental engine's state ('fault-chunked'). Under a
  solver mesh the peak is read on every card of this process's blocks, and
  a solve over the budget splits on the solver's card and skips the mesh
  for that solve only, as the reference does (`mesh = None` for the solve).
- *A fault in the device attempt -> host rung*: `presolve` records the
  fault into `BREAKER` and re-raises the typed `SolverFault`. There is no
  host rung: `RUNG_HOST` and the host-rung capsule are never emitted.
- *Open breaker -> the host loop takes the batch*: `presolve` raises
  `SolverBreakerOpenError` (kind `device-lost` or the last fault's) before
  any encode or launch; a real solve also voids the incremental state
  ('fault-breaker') and journals `degraded`/`breaker-open`.
- *The scheduler boundary* counts a fault no seam counted (`unclassified`
  where classify has no name for it) and re-raises.
- *The rebase*: a classified fault is counted, voids residency
  ('fault-device') and is raised typed; an unclassified one is raised.
- *The controllers* hold the work on a `SolverFault`: the provisioner's
  pods stay Pending and its loop re-arms at the breaker's reopen time, an
  orchestrator pass (or the Runtime's own consolidation pass) ends with no
  action, an interruption message is left for redelivery, the SLO
  scraper's ideal repack leaves its gauges and retries the epoch. Every
  other exception still ends the loop, and so does a device-lost the card
  raised (`ends_the_loop`): its CUDA context stays broken, so only a
  restart recovers the card, and the loop's end turns healthy() false.

A fault stops the batch, the batch waits, and the next attempt runs on the
card.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from ..analysis.guards import guarded_by
from ..analysis.witness import WITNESS
from ..capsule import CAPSULE, TRIGGER_BREAKER_OPEN
from ..journal import JOURNAL
from ..logsetup import get_logger
from ..metrics import REGISTRY
from ..ops._cuda_build import KernelBuildError
from ..utils.clock import Clock

log = get_logger("solver.faults")

# -- the taxonomy ---------------------------------------------------------------

KIND_COMPILE = "compile"
KIND_HBM = "hbm"
KIND_KERNEL = "kernel"
KIND_DEVICE_LOST = "device-lost"
KIND_UNCLASSIFIED = "unclassified"

KINDS = (KIND_COMPILE, KIND_HBM, KIND_KERNEL, KIND_DEVICE_LOST, KIND_UNCLASSIFIED)

# the reference's ladder rungs, in escalation order: retire the kernel/mesh
# flavor, chunk the dispatch surface under HBM pressure, hand the batch to
# the host loop. The port emits only 'chunked' (the pre-solve budget split);
# the other two stay as labels so the metric's label set is the reference's
RUNG_FLAVOR = "flavor"
RUNG_CHUNKED = "chunked"
RUNG_HOST = "host"
RUNGS = (RUNG_FLAVOR, RUNG_CHUNKED, RUNG_HOST)


class SolverFault(RuntimeError):
    """Base of the typed device-failure family (the solver-side analog of
    cloudprovider/errors.py). `kind` is the metric label; `counted` turns
    true once karpenter_solver_faults_total has counted it (count_fault)."""

    kind = KIND_UNCLASSIFIED
    counted = False
    # true on a fault a FaultPlan raised (FaultPlan.check): a simulated
    # device fault, whatever its kind, never ends a loop (ends_the_loop)
    injected = False


class SolverCompileError(SolverFault):
    """A kernel failed to BUILD (nvcc/ptxas; XLA/Mosaic lowering or
    compilation in the reference): retrying the same dispatch cannot
    succeed."""

    kind = KIND_COMPILE


class SolverHbmExhaustedError(SolverFault):
    """The device ran out of memory (a CUDA OOM, RESOURCE_EXHAUSTED): the
    same work in smaller pieces can still succeed — which is what the
    pre-solve budget split plans for, before any launch."""

    kind = KIND_HBM


class SolverKernelError(SolverFault):
    """A built kernel failed to launch or run (a CUDA launch error of K1 or
    K2; INTERNAL or a Pallas/Mosaic runtime fault in the reference): the
    kernel is suspect, not the device."""

    kind = KIND_KERNEL


class SolverDeviceLostError(SolverFault):
    """The device (or its transport) is gone — a broken CUDA context (an
    illegal address, a device-side assert), a dead backend, a lost
    connection. Nothing dispatched this pass can succeed."""

    kind = KIND_DEVICE_LOST


class SolverBreakerOpenError(SolverFault):
    """The circuit breaker is open: the solve did not attempt the device and
    holds its batch until the half-open probe (no host loop takes it).
    `kind` is the last fault's that opened it (`device-lost` when none is
    recorded). Not a device fault: nothing counts it into the taxonomy."""

    counted = True

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind or KIND_DEVICE_LOST


_FAULT_BY_KIND = {
    KIND_COMPILE: SolverCompileError,
    KIND_HBM: SolverHbmExhaustedError,
    KIND_KERNEL: SolverKernelError,
    KIND_DEVICE_LOST: SolverDeviceLostError,
}

# state-corruption kinds: unlike the raising taxonomy above, these never
# raise — a fired corruption spec tells ITS seam to silently damage the
# incremental engine's resident state (flip a resident row, suppress a
# DeltaJournal record, perturb the donated device buffer), so the
# residency auditor's detection claims are provable against a known,
# seeded, history-witnessed injection rather than vacuous on healthy runs
KIND_CORRUPT_ROW = "corrupt-row"
KIND_SUPPRESS_DELTA = "suppress-delta"
KIND_CORRUPT_DEVICE = "corrupt-device"
CORRUPTION_KINDS = (KIND_CORRUPT_ROW, KIND_SUPPRESS_DELTA, KIND_CORRUPT_DEVICE)

# textual signatures per kind, checked in order: HBM first (an OOM message
# often also says INTERNAL), device-lost before compile/kernel (a dead
# backend wraps whatever it was doing when it died; a broken CUDA context's
# message says "kernel" and "compile" too). The reference's XLA/Pallas
# vocabulary, then the CUDA runtime's (error names and their strings, as
# the kernel wrappers and torch report them).
_HBM_MARKS = (
    "resource_exhausted", "resource exhausted", "out of memory", "oom", "hbm",
    "cudaerrormemoryallocation",
)
# bare common words ("internal", "aborted", "unavailable") would reclassify
# ordinary software bugs raised inside the dispatch seams as device
# faults and feed them to the breaker — the gRPC status vocabulary always
# arrives colon-anchored ("UNAVAILABLE: socket closed"), so anchor those
_DEVICE_LOST_MARKS = (
    "device lost",
    "unavailable:",
    "socket closed",
    "connection reset",
    "failed to connect",
    "dead backend",
    "backend was destroyed",
    "halted",
    "aborted:",
    "illegal memory access",
    "illegal address",
    "device-side assert",
    "unspecified launch failure",
    "misaligned address",
    "cudaerrorlaunchfailure",
    "cudaerrorillegaladdress",
    "cudaerrorassert",
    "cudaerrormisalignedaddress",
)
_COMPILE_MARKS = ("compilation", "compile", "lowering", "unimplemented", "nvcc", "ptxas")
_KERNEL_MARKS = ("internal:", "internal error", "pallas", "mosaic", "kernel", "cudaerror")


def classify(exc: BaseException) -> Optional[SolverFault]:
    """Map a raw device-path exception into the typed family; an already-
    typed fault passes through. None means UNCLASSIFIED — the caller counts
    it distinctly and re-raises it, so a new failure mode cannot hide."""
    if isinstance(exc, SolverFault):
        return exc
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return SolverHbmExhaustedError(str(exc) or type(exc).__name__)
    if isinstance(exc, KernelBuildError):
        # nvcc's diagnostics are free text: the type decides, not the marks
        return SolverCompileError(str(exc))
    text = f"{type(exc).__name__}: {exc}".lower()
    for marks, cls in (
        (_HBM_MARKS, SolverHbmExhaustedError),
        (_DEVICE_LOST_MARKS, SolverDeviceLostError),
        (_COMPILE_MARKS, SolverCompileError),
        (_KERNEL_MARKS, SolverKernelError),
    ):
        if any(mark in text for mark in marks):
            return cls(str(exc) or type(exc).__name__)
    return None


# -- metrics (registered at import so gen_docs sees the families) ---------------

SOLVER_FAULTS = REGISTRY.counter(
    "karpenter_solver_faults_total",
    "Classified solver device faults by taxonomy kind (compile, hbm, kernel,"
    " device-lost; 'unclassified' = a failure classify() could not map — a new"
    " failure mode, counted and raised like every other).",
    ("kind",),
)
DEGRADED_SOLVES = REGISTRY.counter(
    "karpenter_solver_degraded_solves_total",
    "Dense solves that took a degradation-ladder rung: 'chunked' (the"
    " pre-solve HBM budget split K1's launch over halves of the bucket axis);"
    " 'flavor' and 'host' are the JAX package's rungs, never taken here.",
    ("rung",),
)
BREAKER_TRANSITIONS = REGISTRY.counter(
    "karpenter_solver_breaker_transitions_total",
    "Solver circuit-breaker state transitions, by the state entered.",
    ("state",),
)
BREAKER_STATE = REGISTRY.gauge(
    "karpenter_solver_breaker_state",
    "Current solver circuit-breaker state: 0 = closed (device path admitted),"
    " 1 = half-open (recovery probe in flight), 2 = open (batches held).",
)


def ends_the_loop(fault: SolverFault) -> bool:
    """Is this fault one no retry in this process can get past? A
    device-lost the card raised (not a plan's, not an open breaker's hold)
    leaves the CUDA context broken, and every later call on it fails: the
    loop that meets it ends, as on any unclassified exception, so healthy()
    turns false and a restart gets a fresh context. Every other
    SolverFault holds the work for a retry on the card."""
    return fault.kind == KIND_DEVICE_LOST and not fault.injected and not isinstance(fault, SolverBreakerOpenError)


def count_fault(fault: SolverFault) -> None:
    """Count one fault into karpenter_solver_faults_total, once: whichever
    seam it passes on its way out (the rebase, the dense solve, the
    scheduler boundary) counts it first, and the others see it counted."""
    if not fault.counted:
        fault.counted = True
        SOLVER_FAULTS.inc(kind=fault.kind)


def faults_total() -> int:
    """Sum of the classified-fault counter across kinds (score surface)."""
    return int(sum(SOLVER_FAULTS.values().values()))


def degraded_total() -> int:
    """Sum of the degraded-solve counter across rungs (score surface)."""
    return int(sum(DEGRADED_SOLVES.values().values()))


# -- deterministic fault injection ----------------------------------------------


@dataclass
class FaultSpec:
    """One planned trigger. `entry` names the dispatch boundary ('plain',
    'sharded', 'cuda', 'chunk', 'warmfill', 'rebase', or '*' — corruption
    kinds target the state seams 'resident-row', 'journal-record',
    'rebase'); `nth` fires on the nth matching call (1-based) for `count`
    consecutive matching calls; with `nth` None, `probability` draws a
    seeded coin per matching call — still fully deterministic for a given
    (plan, seed, call sequence)."""

    kind: str
    entry: str = "*"
    nth: Optional[int] = None
    count: int = 1
    probability: float = 0.0

    def __post_init__(self):
        if self.kind not in _FAULT_BY_KIND and self.kind not in CORRUPTION_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {sorted((*_FAULT_BY_KIND, *CORRUPTION_KINDS))}"
            )
        if self.nth is not None and self.nth < 1:
            raise ValueError("nth is 1-based")
        if not (0.0 <= self.probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")


@guarded_by("_lock", "_calls", "_spec_calls", "_history")
class FaultPlan:
    """A seeded, deterministic schedule of device faults. Same plan + same
    seed + same dispatch sequence -> identical fault sequence, byte for
    byte — the property the determinism tests pin on both dispatch
    flavors."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = WITNESS.lock("solver.faults")
        self._calls = 0
        self._spec_calls = [0] * len(self.specs)
        self._history: List[dict] = []

    @classmethod
    def from_specs(cls, specs: Sequence[dict], seed: int = 0) -> "FaultPlan":
        return cls([FaultSpec(**spec) for spec in specs], seed=seed)

    def _consult(self, entry: str, corruption: bool) -> Optional[FaultSpec]:
        """Shared trigger logic: one plan call against either the raising
        taxonomy specs (dispatch boundaries) or the corruption specs (state
        seams). A spec's per-match counter only advances at ITS seam family,
        so mixing both families in one plan stays deterministic."""
        fire: Optional[FaultSpec] = None
        with self._lock:
            self._calls += 1
            call = self._calls
            for i, spec in enumerate(self.specs):
                if (spec.kind in CORRUPTION_KINDS) != corruption:
                    continue
                if spec.entry != "*" and spec.entry != entry:
                    continue
                self._spec_calls[i] += 1
                matched = self._spec_calls[i]
                if spec.nth is not None:
                    hit = spec.nth <= matched < spec.nth + spec.count
                else:
                    # one seeded draw per matching call per spec, consumed
                    # whether or not it fires — the sequence is a pure
                    # function of (seed, dispatch order)
                    hit = self._rng.random() < spec.probability
                if hit and fire is None:
                    fire = spec
            if fire is not None:
                self._history.append({"call": call, "entry": entry, "kind": fire.kind})
        return fire

    def check(self, entry: str) -> None:
        """Consult the plan at one dispatch-boundary call; raises the
        planned typed fault when a trigger fires (first matching spec
        wins)."""
        fire = self._consult(entry, corruption=False)
        if fire is not None:
            fault = _FAULT_BY_KIND[fire.kind](f"injected {fire.kind} fault at dispatch entry {entry!r}")
            fault.injected = True
            raise fault

    def corrupt(self, entry: str) -> Optional[str]:
        """Consult the plan at one state seam; returns the corruption kind
        to apply (never raises — the seam damages its own state silently,
        which is the whole point: the auditor must FIND it). Fired triggers
        land in the same determinism `history()` as the raising kinds."""
        fire = self._consult(entry, corruption=True)
        return fire.kind if fire is not None else None

    def corruptions_fired(self) -> int:
        """Fired corruption triggers only (the storm scenario's
        divergences == injections bar)."""
        with self._lock:
            return sum(1 for h in self._history if h["kind"] in CORRUPTION_KINDS)

    def history(self) -> List[dict]:
        """The fired triggers, in dispatch order (determinism witness)."""
        with self._lock:
            return [dict(h) for h in self._history]

    def fired(self) -> int:
        with self._lock:
            return len(self._history)


class FaultInjector:
    """Process-wide seam the dispatch boundaries consult. No plan installed
    (production) = one attribute read per dispatch; `install()` arms a
    FaultPlan, `clear()` disarms. The solver marks simulation-mode solves
    per thread (`set_simulation`) so every boundary on that thread — dense
    dispatch, the ops kernels, the warm-fill surface — bypasses the plan
    without plumbing a flag through each call."""

    def __init__(self):
        self._plan: Optional[FaultPlan] = None
        self._local = threading.local()

    @property
    def plan(self) -> Optional[FaultPlan]:
        return self._plan

    def install(self, plan: FaultPlan) -> None:
        self._plan = plan
        # the journal's mutator seam lives in ir/delta.py, which imports
        # nothing from this package (it must stay a leaf): arm its module
        # hook ONLY when the plan actually carries suppress-delta specs, so
        # every other plan leaves record() at one module-global read
        if any(spec.kind == KIND_SUPPRESS_DELTA for spec in plan.specs):
            from ..ir import delta as ir_delta

            # only pod-level records are suppressible: a dropped NODE_ADDED/
            # NODE_REMOVED is invisible (the engine diffs the row set without
            # the journal), so suppressing one would spend a trigger on an
            # injection no auditor could ever detect
            ir_delta.set_corrupt_seam(
                lambda node, kind: kind in (ir_delta.POD_BOUND, ir_delta.POD_REMOVED)
                and self.corrupt("journal-record") == KIND_SUPPRESS_DELTA
            )
        log.info("solver fault plan installed: %d spec(s), seed %d", len(plan.specs), plan.seed)

    def clear(self) -> None:
        self._plan = None
        from ..ir import delta as ir_delta

        ir_delta.set_corrupt_seam(None)

    def fired(self) -> int:
        plan = self._plan
        return plan.fired() if plan is not None else 0

    def corruptions_fired(self) -> int:
        plan = self._plan
        return plan.corruptions_fired() if plan is not None else 0

    def set_simulation(self, simulation: bool) -> None:
        """Mark THIS thread's in-flight solve as a simulation re-solve
        (consolidation / SLO what-if): injected faults target the real
        provisioner's dispatch sequence — a what-if consuming triggers
        would make every plan nondeterministic."""
        self._local.simulation = bool(simulation)

    def check(self, entry: str, simulation: Optional[bool] = None) -> None:
        plan = self._plan
        if plan is None:
            return
        if simulation is None:
            simulation = getattr(self._local, "simulation", False)
        if simulation:
            return
        plan.check(entry)

    def corrupt(self, entry: str, simulation: Optional[bool] = None) -> Optional[str]:
        """State-seam mirror of check(): returns the corruption kind to
        apply at `entry`, or None. Same no-plan fast path, same per-thread
        simulation bypass."""
        plan = self._plan
        if plan is None:
            return None
        if simulation is None:
            simulation = getattr(self._local, "simulation", False)
        if simulation:
            return None
        return plan.corrupt(entry)


FAULTS = FaultInjector()


# -- the circuit breaker --------------------------------------------------------

STATE_CLOSED = "closed"
STATE_HALF_OPEN = "half-open"
STATE_OPEN = "open"
_STATE_GAUGE = {STATE_CLOSED: 0.0, STATE_HALF_OPEN: 1.0, STATE_OPEN: 2.0}

DEFAULT_BREAKER_THRESHOLD = 3
DEFAULT_BREAKER_BACKOFF = 30.0


@guarded_by("_lock", "state", "consecutive", "opened_total", "_open_until", "last_fault_kind")
class SolverCircuitBreaker:
    """Consecutive-fault breaker over the solver's device path with
    half-open recovery probes. While it is open a real solve holds its
    batch (presolve raises SolverBreakerOpenError); `retry_at()` says when
    the probe is due. Clock-seam timed (FakeClock drives the
    backoff deterministically in tests); state transitions are counted
    (`karpenter_solver_breaker_transitions_total{state}`) and journaled as
    `solver` events when the journal is enabled."""

    def __init__(self, threshold: int = DEFAULT_BREAKER_THRESHOLD, backoff: float = DEFAULT_BREAKER_BACKOFF):
        self._lock = WITNESS.lock("solver.breaker")
        self.threshold = threshold
        self.backoff = backoff
        self.clock: Clock = Clock()
        self.state = STATE_CLOSED
        self.consecutive = 0
        self.opened_total = 0
        self.last_fault_kind = ""
        self._open_until = 0.0

    def configure(self, threshold: Optional[int] = None, backoff: Optional[float] = None, clock: Optional[Clock] = None) -> None:
        """(Re)tune without resetting state: a restarted Runtime re-wires
        its clock and thresholds but inherits the process's breaker history
        (the device is the same device across restarts). Adopts a witnessed
        lock when the witness came up after import, so the breaker joins
        the lock-order graph the chaos suites assert acyclic."""
        if WITNESS.enabled and isinstance(self._lock, threading.Lock().__class__):
            # constructed before the witness came up: swap in a witnessed
            # lock (configure runs at Runtime assembly, before any solve
            # can hold it — the flight-recorder enable() pattern)
            self._lock = WITNESS.lock("solver.breaker")
        with self._lock:
            if threshold is not None:
                self.threshold = max(1, int(threshold))
            if backoff is not None:
                self.backoff = float(backoff)
        if clock is not None:
            self.clock = clock

    def reset(self) -> None:
        """Back to CLOSED with zeroed counters (per-run harness reset)."""
        with self._lock:
            self.state = STATE_CLOSED
            self.consecutive = 0
            self.opened_total = 0
            self.last_fault_kind = ""
            self._open_until = 0.0
        BREAKER_STATE.set(_STATE_GAUGE[STATE_CLOSED])

    def _transition_locked(self, state: str) -> None:
        self.state = state
        BREAKER_TRANSITIONS.inc(state=state)
        BREAKER_STATE.set(_STATE_GAUGE[state])
        if JOURNAL.enabled:
            JOURNAL.solver_event("breaker", f"breaker-{'opened' if state == STATE_OPEN else state}")
        if state == STATE_OPEN and CAPSULE.enabled:
            # enqueue-only while this lock is held: the capsule engine
            # captures later, in poll(), without the breaker lock — the
            # breaker->capsule edge stays a leaf in the lock-order graph
            CAPSULE.trigger(TRIGGER_BREAKER_OPEN, fault_kind=self.last_fault_kind, threshold=self.threshold)
        log.warning("solver circuit breaker -> %s (consecutive=%d threshold=%d)", state, self.consecutive, self.threshold)

    def admit(self, simulation: bool = False) -> bool:
        """May this solve attempt the device path? CLOSED admits everyone;
        OPEN denies until the backoff expires, then the first REAL solve
        becomes the half-open recovery probe (simulation solves share the
        open/closed answer but never ride — or become — the probe)."""
        with self._lock:
            if self.state == STATE_CLOSED:
                return True
            if self.state == STATE_OPEN and self.clock.now() >= self._open_until:
                if simulation:
                    return False  # a what-if must not spend the recovery probe
                self._transition_locked(STATE_HALF_OPEN)
                return True
            if self.state == STATE_HALF_OPEN:
                return not simulation
            return False

    def record_fault(self, kind: str, simulation: bool = False) -> None:
        """One classified device fault that ended a solve's device attempt.
        Simulation solves never trip the breaker (cross-loop interference:
        the scraper's what-if would open the real provisioner's path)."""
        if simulation:
            return
        with self._lock:
            self.last_fault_kind = kind
            if self.state == STATE_HALF_OPEN:
                # the probe failed: back to OPEN for another backoff
                self._open_until = self.clock.now() + self.backoff
                self.opened_total += 1
                self._transition_locked(STATE_OPEN)
                return
            self.consecutive += 1
            if self.state == STATE_CLOSED and self.consecutive >= self.threshold:
                self._open_until = self.clock.now() + self.backoff
                self.opened_total += 1
                self._transition_locked(STATE_OPEN)

    def record_success(self, simulation: bool = False) -> None:
        """A solve's device attempt succeeded (one launch or the budget
        split's two)."""
        if simulation:
            return
        with self._lock:
            self.consecutive = 0
            if self.state == STATE_HALF_OPEN:
                self._transition_locked(STATE_CLOSED)

    def retry_at(self) -> float:
        """The breaker clock's instant at which an OPEN breaker admits its
        recovery probe; 0.0 while it is closed or half-open (admitted now).
        A held batch re-arms for max(now, this)."""
        with self._lock:
            return self._open_until if self.state == STATE_OPEN else 0.0

    def snapshot(self) -> dict:
        """The /debug/solver breaker block."""
        with self._lock:
            now = self.clock.now()
            return {
                "state": self.state,
                "threshold": self.threshold,
                "backoff_seconds": self.backoff,
                "consecutive_faults": self.consecutive,
                "opened_total": self.opened_total,
                "last_fault_kind": self.last_fault_kind,
                "reopen_probe_in_seconds": (
                    round(max(0.0, self._open_until - now), 3) if self.state == STATE_OPEN else 0.0
                ),
            }


BREAKER = SolverCircuitBreaker()
