"""Solver flight recorder: per-solve telemetry for the device runtime.

The solve headline scores how fast a solve is; tracing says where one
solve's wall-clock went. Neither observes the *device runtime* underneath:
whether a solve built a kernel, or what the solve left allocated on the
card. This module is that instrument: "a settled cluster re-solving under
churn builds nothing" has to be a measurable property.

Three instruments, one bounded ring:

- **per-solve records** — every dense presolve appends one `SolveRecord`:
  pod/group/bucket/type/zone cardinalities, the dispatch flavor ("cuda"
  where K1 or K2 launched on the card, "plain" where K1's plain version ran
  on the CPU, "sharded" where the bucket choice ran over a solver mesh,
  "none" where no bucket choice ran) and its padded vs actual
  shapes (with padding-waste %), every `DenseSolveStats` phase delta
  (encode/fill/device/mask/assemble/commit), fill routing, and the
  build/memory attribution below. Served at `/debug/solver` (index +
  `?id=` detail, 404-shaped JSON like the tracing routes).
- **kernel-build churn** — the port's kernels are built by nvcc at first
  use (ops/_cuda_build.py, the one place nvcc runs), which calls this
  module's listener once per build. The tally counts builds and their
  seconds (`karpenter_jax_compilations_total{fn}` with the kernel
  library's name as `{fn}`, and `karpenter_jax_compile_seconds_total`: the
  family names are the JAX package's, so dashboards line up). A record's
  `recompile` is true when a build ran inside its solve window, and the
  build is attributed to the *dimension that changed shape* since the
  previous solve. Torch programs keep no executable cache, so there is
  nothing like the JAX package's per-entry `_cache_size()` polling:
  `register_jit_entry` is not ported.
- **device memory** — per-solve snapshots of the solver's device:
  on `cuda`, `torch.cuda.memory_stats(device)`'s
  `allocated_bytes.all.peak` and `allocated_bytes.all.current` (the
  caching allocator's bytes handed to tensors). The recorder resets the
  high-water mark after each record's snapshot, on the solver's card and on
  the cards of its mesh's blocks, so a record's peak is its own solve's
  (from the previous record on), and the dense solver's
  `--solver-hbm-budget` check reads the peak of the solve in flight. The
  JAX package's peak is the process's. A solver on the CPU reports (0,
  0). Exported as `karpenter_solver_hbm_peak_bytes` /
  `karpenter_solver_hbm_live_bytes` and stamped on each record.

The port's copy of karpenter_tpu/flight.py. The steady-recompile capsule
cross-check reads the port's own committed contract,
karpenter_tpu_torch/analysis/solver_contracts.json (analysis/contracts.py):
a build of a kernel library after its first, attributed to a shape change,
fires a `steady-recompile` capsule. The JAX package's SOLVER_CONTRACTS.json
describes its XLA programs and is never read.

Design constraints match tracing.py exactly:

- **disabled == free**: OFF by default; the ring allocates on `enable()`,
  never before, and every hot-path hook is one attribute read when
  disabled. The dense solver snapshots stats only when enabled.
- **zero deps, bounded memory**: the ring is a bounded deque (default 128
  records); overflow evicts oldest and counts into
  `karpenter_flight_records_dropped`.
- **one read surface**: `/debug/solver` on the metrics listener (wired
  behind `--enable-solver-telemetry` in cmd/controller.py); the same
  families export through `/metrics` for scrapers.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .analysis.guards import guarded_by
from .analysis.witness import WITNESS
from .capsule import CAPSULE, TRIGGER_STEADY_RECOMPILE
from .logsetup import get_logger
from .metrics import REGISTRY

log = get_logger("flight")

DEFAULT_RING = 128


# the committed solver contract (analysis/solver_contracts.json in the
# package), loaded once per process for the capsule engine's
# steady-recompile cross-check; None (missing file) disables the check
# rather than firing
_CONTRACT_DOC: Optional[dict] = None
_CONTRACT_DOC_LOADED = False


def _committed_contracts() -> Optional[dict]:
    global _CONTRACT_DOC, _CONTRACT_DOC_LOADED
    if not _CONTRACT_DOC_LOADED:
        import os

        from .analysis import contracts as _contracts

        _CONTRACT_DOC = _contracts.load_committed(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        _CONTRACT_DOC_LOADED = True
    return _CONTRACT_DOC


# registered at import so gen_docs sees the families without a live recorder
COMPILATIONS = REGISTRY.counter(
    "karpenter_jax_compilations_total",
    "Kernel builds (nvcc) observed by the solver flight recorder, by kernel"
    " library ('other' = a build counted without a library name).",
    ("fn",),
)
COMPILE_SECONDS = REGISTRY.counter(
    "karpenter_jax_compile_seconds_total",
    "Seconds spent in kernel builds (nvcc), as ops/_cuda_build.py timed them.",
)
HBM_PEAK = REGISTRY.gauge(
    "karpenter_solver_hbm_peak_bytes",
    "Peak device-memory bytes reported at the last recorded solve"
    " (device memory_stats, or the live-array total where unavailable).",
)
HBM_LIVE = REGISTRY.gauge(
    "karpenter_solver_hbm_live_bytes",
    "Live device-memory bytes at the last recorded solve.",
)
RECORDS_STORED = REGISTRY.gauge(
    "karpenter_flight_records_stored", "Per-solve records currently held in the flight-recorder ring"
)
RECORDS_DROPPED = REGISTRY.counter(
    "karpenter_flight_records_dropped", "Per-solve records evicted from the bounded flight-recorder ring"
)
SOLVE_LATENCY = REGISTRY.summary(
    "karpenter_solver_solve_duration_seconds",
    "Wall-clock of real (non-simulation) Scheduler.solve calls while solver telemetry is enabled.",
    objectives=(0.5, 0.95, 0.99),
)

@guarded_by("_lock", "events", "seconds", "by_fn", "_registered")
class _CompileTally:
    """Process-wide kernel-build tally. ops/_cuda_build.py calls its
    listeners once per nvcc build; exactly ONE listener is ever installed
    (on the first recorder enable) and it feeds this shared tally + the
    COMPILE_SECONDS family exactly once per build — a second enabled
    recorder (tests construct fresh instances in one process) reads the
    same tally instead of double-counting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._registered = False
        self.events = 0
        self.seconds = 0.0
        self.by_fn: Dict[str, int] = {}

    def register_listener(self) -> None:
        with self._lock:
            if self._registered:
                return
            self._registered = True
        from .ops import _cuda_build

        _cuda_build.BUILD_LISTENERS.append(self.on_build)

    def on_build(self, name: str, seconds: float) -> None:
        with self._lock:
            self.events += 1
            self.seconds += seconds
            self.by_fn[name] = self.by_fn.get(name, 0) + 1
        COMPILE_SECONDS.inc(seconds)

    def snapshot(self) -> tuple:
        with self._lock:
            return self.events, self.seconds

    def builds_by_fn(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.by_fn)


_TALLY = _CompileTally()

# the shape-signature axes recompiles are attributed to, in report order
_SIGNATURE_DIMS = (
    "pods",
    "groups",
    "buckets",
    "types",
    "zones",
    "capacity_types",
    "resources",
    "buckets_padded",
    "types_padded",
)


@dataclass
class SolveRecord:
    """One dense solve, as the flight recorder saw it."""

    id: int
    timestamp: float  # epoch seconds
    signature: Dict[str, int]  # the _SIGNATURE_DIMS cardinalities
    dispatch: str  # cuda | plain | sharded | none (no device dispatch ran)
    padding_waste_pct: float  # 100 * padded-but-dead share of the dispatch surface
    phases: Dict[str, float]  # per-phase seconds, this solve only (stats delta)
    fill_routing: Dict[str, int]  # fills/pods via the vectorized vs host fill
    pods_committed: int = 0
    pods_to_host: int = 0
    duration_seconds: float = 0.0
    recompile: bool = False
    compiled_fns: Dict[str, int] = field(default_factory=dict)  # kernel library -> builds this solve
    # libraries never built in this process before this solve: their build
    # is the kernel's first (a path engaging for the first time), not a
    # rebuild of a changed source
    first_compiles: List[str] = field(default_factory=list)
    compile_seconds: float = 0.0
    # the dimensions whose cardinality changed vs the PREVIOUS recorded
    # solve — empty on a recompile with an unchanged signature (a new code
    # path compiled), ["cold-start"] when there was no previous solve
    recompile_attribution: List[str] = field(default_factory=list)
    hbm_peak_bytes: int = 0
    hbm_live_bytes: int = 0
    # solver fault domain (solver/faults.py): classified device faults this
    # solve hit (taxonomy kind -> count; a faulted solve's record is
    # completed as the fault is raised), the rung it took ("chunked", the
    # budget split), and the circuit-breaker state at record time — a
    # healthy solve records {}, [], "closed"
    faults: Dict[str, int] = field(default_factory=dict)
    rungs: List[str] = field(default_factory=list)
    breaker: str = "closed"

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "timestamp": self.timestamp,
            "signature": self.signature,
            "dispatch": self.dispatch,
            "padding_waste_pct": round(self.padding_waste_pct, 2),
            "phases": {k: round(v, 6) for k, v in self.phases.items()},
            "fill_routing": self.fill_routing,
            "pods_committed": self.pods_committed,
            "pods_to_host": self.pods_to_host,
            "duration_seconds": round(self.duration_seconds, 6),
            "recompile": self.recompile,
            "compiled_fns": self.compiled_fns,
            "first_compiles": self.first_compiles,
            "compile_seconds": round(self.compile_seconds, 6),
            "recompile_attribution": self.recompile_attribution,
            "hbm_peak_bytes": self.hbm_peak_bytes,
            "hbm_live_bytes": self.hbm_live_bytes,
            "faults": self.faults,
            "rungs": self.rungs,
            "breaker": self.breaker,
        }

    def summary(self) -> dict:
        """The /debug/solver index row."""
        return {
            "id": self.id,
            "timestamp": self.timestamp,
            "pods": self.signature.get("pods", 0),
            "buckets": self.signature.get("buckets", 0),
            "types": self.signature.get("types", 0),
            "dispatch": self.dispatch,
            "duration_seconds": round(self.duration_seconds, 6),
            "recompile": self.recompile,
            "recompile_attribution": self.recompile_attribution,
            "hbm_peak_bytes": self.hbm_peak_bytes,
            "faults": self.faults,
            "rungs": self.rungs,
            "breaker": self.breaker,
        }


@guarded_by("_lock", "_ring", "_next_id", "_prev_signature")
class FlightRecorder:
    """Bounded ring of per-solve records + the build/memory instruments."""

    def __init__(self, capacity: int = DEFAULT_RING):
        self._lock = WITNESS.lock("solver.flight")
        self.capacity = capacity
        self.enabled = False
        # allocated on enable(), never before — "disabled is a true no-op"
        self._ring: Optional[List[SolveRecord]] = None
        self._next_id = 0
        self._prev_signature: Optional[Dict[str, int]] = None

    # -- lifecycle -----------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None:
                self.capacity = capacity
            first = self._ring is None
            if first:
                self._ring = []
        if first and WITNESS.enabled:
            # first enable happens at Runtime construction, before any solve
            # holds the lock: adopt a witnessed lock so the ring joins the
            # lock-order graph the chaos suites assert acyclic
            self._lock = WITNESS.lock("solver.flight")
        _TALLY.register_listener()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop records and attribution state (per-run harness reset; the
        monotonic compile counters survive — consumers score deltas). The
        HBM gauges zero too: they mean "at the last recorded solve", and a
        stale reading from a previous run would otherwise pre-trip the
        solver's --solver-hbm-budget chunking before this run's first
        solve ever reaches the device."""
        with self._lock:
            if self._ring is not None:
                self._ring.clear()
            self._prev_signature = None
        RECORDS_STORED.set(0)
        SOLVE_LATENCY.clear()
        HBM_PEAK.set(0.0)
        HBM_LIVE.set(0.0)

    # -- build instruments -------------------------------------------------------

    def compilations_total(self) -> int:
        """Sum of the per-fn compile counter across labels (score surface)."""
        return int(sum(COMPILATIONS.values().values()))

    # -- HBM instrument --------------------------------------------------------

    @staticmethod
    def hbm_snapshot(device=None) -> tuple:
        """(peak_bytes, live_bytes) of the solver's device. On `cuda`:
        torch.cuda.memory_stats(device)'s allocated_bytes.all.peak and
        allocated_bytes.all.current, the caching allocator's count of bytes
        handed to tensors (its reserved-but-free blocks are not counted). A
        solver on the CPU — or no device, the records a harness completes
        by hand — reports (0, 0): the CPU has no device memory to account.
        A failure to read the card propagates."""
        import torch

        if device is None or torch.device(device).type != "cuda":
            return 0, 0
        stats = torch.cuda.memory_stats(device)
        return int(stats["allocated_bytes.all.peak"]), int(stats["allocated_bytes.all.current"])

    @staticmethod
    def reset_hbm_peak(device=None) -> None:
        """Restart the high-water mark hbm_snapshot() reads on a `cuda`
        device at the bytes allocated now (torch.cuda.reset_peak_memory_stats);
        a no-op for a solver on the CPU."""
        import torch

        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

    # -- the per-solve seam (dense.py) ----------------------------------------

    def begin_solve(self) -> Optional[dict]:
        """Snapshot the build tally at the head of a dense solve; the
        matching complete_solve() attributes everything that moved."""
        if not self.enabled:
            return None
        events, seconds = _TALLY.snapshot()
        return {"sizes": _TALLY.builds_by_fn(), "events": events, "seconds": seconds}

    def complete_solve(
        self,
        token: dict,
        signature: Dict[str, int],
        dispatch: Optional[dict],
        phases: Dict[str, float],
        fill_routing: Dict[str, int],
        pods_committed: int,
        pods_to_host: int,
        duration: float,
        faults: Optional[Dict[str, int]] = None,
        rungs: Optional[List[str]] = None,
        breaker: str = "closed",
        device=None,
        peak_devices=(),
    ) -> Optional[SolveRecord]:
        """Close the window begin_solve() opened: compute per-library build
        deltas, attribute them to the changed shape dimensions, snapshot
        `device`'s memory, and append the record to the ring. The memory
        peak restarts on `device` and on each of `peak_devices` (the cards of
        a solver mesh's blocks), so the next solve's budget check reads that
        solve's peak on all of them."""
        if not self.enabled or token is None:
            return None
        sizes = _TALLY.builds_by_fn()
        compiled = {
            name: sizes[name] - token["sizes"].get(name, 0)
            for name in sizes
            if sizes[name] > token["sizes"].get(name, 0)
        }
        tally_events, tally_seconds = _TALLY.snapshot()
        events = tally_events - token["events"]
        seconds = tally_seconds - token["seconds"]
        attributed = sum(compiled.values())
        if events > attributed:
            compiled["other"] = events - attributed
        for name, count in compiled.items():
            COMPILATIONS.inc(count, fn=name)
        peak, live = self.hbm_snapshot(device)
        for dev in dict.fromkeys([device, *peak_devices]):
            self.reset_hbm_peak(dev)
        HBM_PEAK.set(float(peak))
        HBM_LIVE.set(float(live))
        waste = 0.0
        surface = signature.get("buckets_padded", 0) * signature.get("types_padded", 0)
        if surface > 0:
            actual = signature.get("buckets", 0) * signature.get("types", 0)
            waste = 100.0 * (1.0 - actual / surface)
        with self._lock:
            if self._ring is None:
                return None
            attribution: List[str] = []
            if compiled:
                if self._prev_signature is None:
                    attribution = ["cold-start"]
                else:
                    attribution = [
                        dim
                        for dim in _SIGNATURE_DIMS
                        if signature.get(dim) != self._prev_signature.get(dim)
                    ]
            record = SolveRecord(
                id=self._next_id,
                timestamp=time.time(),
                signature={dim: int(signature.get(dim, 0)) for dim in _SIGNATURE_DIMS},
                dispatch=(dispatch or {}).get("flavor", "none"),
                padding_waste_pct=waste,
                phases=dict(phases),
                fill_routing=dict(fill_routing),
                pods_committed=pods_committed,
                pods_to_host=pods_to_host,
                duration_seconds=duration,
                recompile=bool(compiled),
                compiled_fns=compiled,
                first_compiles=sorted(
                    name for name in compiled if name != "other" and token["sizes"].get(name, 0) == 0
                ),
                compile_seconds=seconds,
                recompile_attribution=attribution,
                hbm_peak_bytes=peak,
                hbm_live_bytes=live,
                faults=dict(faults or {}),
                rungs=list(rungs or []),
                breaker=breaker,
            )
            self._next_id += 1
            self._prev_signature = dict(signature)
            self._ring.append(record)
            if len(self._ring) > self.capacity:
                del self._ring[0]
                RECORDS_DROPPED.inc()
            RECORDS_STORED.set(float(len(self._ring)))
        if CAPSULE.enabled and record.recompile and attribution and attribution != ["cold-start"]:
            # the steady-state recompile cross-check: a kernel library built
            # again after its first, on a shape change, contradicts the
            # committed contract (a library declares no varying axis) — that
            # IS the incident. A library's first build in this process is a
            # path engaging for the first time (record.first_compiles); the
            # kernels are built once per process, so a campaign's second
            # transport sees no build at all and needs no per-run exemption
            doc = _committed_contracts()
            if doc is not None:
                from .analysis.contracts import recompile_violations

                if recompile_violations([record], doc):
                    CAPSULE.trigger(TRIGGER_STEADY_RECOMPILE, attribution=sorted(attribution))
        return record

    def observe_solve_latency(self, seconds: float) -> None:
        """One observation per REAL Scheduler.solve (the scheduler gates on
        enabled + non-simulation before calling)."""
        SOLVE_LATENCY.observe(seconds)

    # -- read surface ----------------------------------------------------------

    def records(self) -> List[SolveRecord]:
        with self._lock:
            return list(self._ring) if self._ring is not None else []

    def last_record_id(self) -> Optional[int]:
        """Id of the newest recorded solve (the journal's per-pod `solved`
        events cross-link to it); None when nothing is recorded."""
        with self._lock:
            if not self._ring:
                return None
            return self._ring[-1].id

    def record_by_id(self, record_id: int) -> Optional[SolveRecord]:
        with self._lock:
            if self._ring is None:
                return None
            for record in self._ring:
                if record.id == record_id:
                    return record
        return None

    def snapshot(self) -> dict:
        """The /debug/solver index payload: newest-first record summaries
        plus the process-wide build tallies and the solver fault-domain
        state (taxonomy counters, degradation-ladder tallies, breaker)."""
        # imported lazily: solver/__init__ pulls in the full dense solver,
        # and this module must stay importable without it (gen_docs, tests)
        from .solver.faults import BREAKER, DEGRADED_SOLVES, SOLVER_FAULTS

        records = self.records()
        events, seconds = _TALLY.snapshot()
        return {
            "enabled": self.enabled,
            "records": [r.summary() for r in reversed(records)],
            "compilations_total": self.compilations_total(),
            "compile_events": events,
            "compile_seconds_total": round(seconds, 6),
            "compilations_by_fn": {
                (labels[0] or "other"): int(value) for labels, value in COMPILATIONS.values().items()
            },
            "hbm_peak_bytes": int(HBM_PEAK.value()),
            "hbm_live_bytes": int(HBM_LIVE.value()),
            "fault_domain": {
                "breaker": BREAKER.snapshot(),
                "faults_total": {
                    (labels[0] or "unclassified"): int(value) for labels, value in SOLVER_FAULTS.values().items()
                },
                "degraded_solves_total": {
                    (labels[0] or "unknown"): int(value) for labels, value in DEGRADED_SOLVES.values().items()
                },
            },
        }


# the process-wide instance (the TRACER analog): dense.py feeds it, the
# Runtime enables it behind --enable-solver-telemetry, bench enables directly
FLIGHT = FlightRecorder()


def enabled() -> bool:
    return FLIGHT.enabled


# -- HTTP route (ObservabilityServer extra routes) ----------------------------


def _json(status, payload) -> tuple:
    return status, "application/json; charset=utf-8", json.dumps(payload) + "\n"


def _solver_route(query: dict) -> tuple:
    raw_id = (query.get("id") or [None])[0]
    if raw_id is None:
        return _json(200, FLIGHT.snapshot())
    try:
        record_id = int(raw_id)
    except ValueError:
        return _json(404, {"error": f"solve id {raw_id!r} is not an integer", "status": 404})
    record = FLIGHT.record_by_id(record_id)
    if record is None:
        return _json(404, {"error": f"solve record {record_id} not found", "status": 404})
    return _json(200, record.to_dict())


def routes() -> dict:
    """The flight-recorder read surface, served from the metrics listener
    alongside tracing/SLO (cmd/controller.py wires it behind
    --enable-solver-telemetry)."""
    return {"/debug/solver": _solver_route}


def route_descriptions() -> dict:
    """/debug-index descriptions, keyed like routes() (see tracing.py)."""
    return {
        "/debug/solver": "solver flight recorder: per-solve shapes/phases, kernel-build attribution, device memory, fault-domain breaker/ladder state; ?id= detail",
    }
