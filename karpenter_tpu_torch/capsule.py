"""Incident capsules: triggered cross-subsystem evidence capture.

Every telemetry layer in this repo is a bounded in-process ring (spans,
decisions, flight records, journal events, lock-witness edges): by the time
a human reads `/debug` after a mid-soak breaker trip, the evidence that
explains *why* has been overwritten. This module freezes the rings at the
moment of failure: a process-wide CAPSULE engine subscribes to a typed
trigger bus and, on trigger, snapshots every ring into one cross-linked
`CAPSULE_<trigger>_<seq>.json` bundle — recent traces, decision records, a
journal slice, flight records with recompile attribution, breaker/fault-
domain state, the lock graph, the SLO snapshot, and a full metrics dump,
joined by the trace/decision/flight/journal ids the layers already stamp.

Trigger vocabulary (the bus is typed; unknown kinds are rejected):

- **breaker-open** — the solver circuit breaker transitioned to OPEN
  (solver/faults.py emits from inside the transition).
- **host-rung** — the fault ladder fell all the way to the host fallback
  (solver/dense.py emits once per solve).
- **steady-recompile** — a recompile whose attribution is entirely
  declared-STATIC axes per the committed solver contract (flight.py runs
  the contracts.recompile_violations cross-check per recompile record).
- **conservation-violation** — the journal's waterfall conservation
  invariant failed for a pod (polled).
- **lock-cycle** — the lock witness observed a cyclic acquisition order
  (polled).
- **invariant-breach** — the soak invariant monitor confirmed a violation
  (polled).
- **slo-burn** — the multi-window burn-rate monitor below fired (polled).

**Burn-rate monitor**: fast/slow windows over the pending-latency SLO
(violating-sample fraction over the last N observations, per provisioner,
worst series wins) and a poll-sampled cost-drift series. Burn rate =
violating fraction / error budget, exported as
`karpenter_slo_burn_rate{slo,window}`; the trigger fires only when BOTH
windows burn at or above the threshold (the classic fast-AND-slow
multiwindow rule: fast catches the cliff, slow filters the blip).

Capture discipline (the part that keeps this subsystem honest):

- **disabled == free**: OFF by default; every ring and map allocates on
  `enable()`, never before, and `trigger()` is one attribute read when
  disabled (the tracing overhead bar applies).
- **enqueue-only trigger**: emit sites call `trigger()` while holding
  their own witnessed locks (the breaker emits from `_transition_locked`),
  so `trigger()` only appends to a bounded queue under the capsule lock —
  the breaker->capsule edge stays a leaf. `poll()` drains the queue and
  BUILDS capsule documents with NO capsule lock held (building acquires
  the tracer/journal/flight/breaker locks), then stores the finished
  document under the capsule lock without acquiring anything else. No
  cycle is possible by construction, and the lock witness checks anyway.
- **debounced + deduped**: per-kind debounce through the clock seam, and a
  16-hex fingerprint over the canonical (kind, stable-detail) JSON — the
  same incident re-observed produces the same fingerprint on every
  transport (the cross-transport determinism witness campaigns score) and
  is captured once. Suppressions are counted by reason.
- **size-bounded spool**: one file per capsule under the configured
  directory; the journal's rotation-budget discipline applies (never more
  than the budget on disk — oldest capsule evicted first, evictions
  counted) and a dead disk disables spooling without killing capture (the
  in-memory ring keeps serving `/debug/capsules`).

The port's copy of karpenter_tpu/capsule.py. The solver fault domain
(solver/faults.py) emits breaker-open from inside the breaker's transition
and fills the `fault_domain` block; nothing emits host-rung, since the port
has no host rung. The steady-recompile trigger needs a committed solver
contract (flight.py, ROADMAP A13).
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from .analysis.guards import guarded_by
from .analysis.witness import WITNESS
from .logsetup import get_logger
from .metrics import REGISTRY
from .utils.clock import Clock

log = get_logger("capsule")

# -- trigger vocabulary -------------------------------------------------------

TRIGGER_BREAKER_OPEN = "breaker-open"
TRIGGER_HOST_RUNG = "host-rung"
TRIGGER_STEADY_RECOMPILE = "steady-recompile"
TRIGGER_CONSERVATION = "conservation-violation"
TRIGGER_LOCK_CYCLE = "lock-cycle"
TRIGGER_INVARIANT = "invariant-breach"
TRIGGER_SLO_BURN = "slo-burn"
TRIGGER_RESIDENCY = "residency-divergence"

TRIGGERS = (
    TRIGGER_BREAKER_OPEN,
    TRIGGER_HOST_RUNG,
    TRIGGER_STEADY_RECOMPILE,
    TRIGGER_CONSERVATION,
    TRIGGER_LOCK_CYCLE,
    TRIGGER_INVARIANT,
    TRIGGER_SLO_BURN,
    TRIGGER_RESIDENCY,
)

# the capsule document's required top-level blocks (capsule_errors gates
# every document before it lands in the ring or on disk)
CAPSULE_KEYS = (
    "capsule",
    "traces",
    "decisions",
    "journal",
    "flight",
    "fault_domain",
    "locks",
    "slo",
    "burn_rate",
    "invariants",
    "metrics",
)
CAPSULE_META_KEYS = ("id", "seq", "trigger", "fingerprint", "detail", "t")

# capture bounds: a capsule is evidence, not an archive — each block takes
# the newest slice its ring serves, bounded so one capsule stays cheap
CAPTURE_TRACES = 50
CAPTURE_TREES = 10
CAPTURE_DECISIONS = 100
CAPTURE_JOURNAL_EVENTS = 400
CAPTURE_FLIGHT_RECORDS = 50

DEFAULT_RING = 32
DEFAULT_QUEUE = 256
DEFAULT_SPOOL_MAX_BYTES = 32 * 2**20
DEFAULT_DEBOUNCE_SECONDS = 30.0

# burn-rate monitor defaults: objectives sit well above the committed
# healthy-scenario envelope (healthy pending p95 tops out ~3.6s, healthy
# cost drift peaks at 4.5 on diurnal_ramp) so healthy runs never burn
DEFAULT_PENDING_OBJECTIVE_SECONDS = 30.0
DEFAULT_COST_DRIFT_OBJECTIVE = 10.0
DEFAULT_ERROR_BUDGET = 0.10
DEFAULT_BURN_THRESHOLD = 1.0
DEFAULT_FAST_WINDOW = 20
DEFAULT_SLOW_WINDOW = 100
DEFAULT_MIN_SAMPLES = 10

SLO_PENDING = "pending_latency"
SLO_COST_DRIFT = "cost_drift"
BURN_WINDOWS = ("fast", "slow")

# registered at import so gen_docs sees the families without a live engine
CAPTURES = REGISTRY.counter(
    "karpenter_capsule_captures_total",
    "Incident capsules captured, by trigger kind.",
    ("trigger",),
)
SUPPRESSED = REGISTRY.counter(
    "karpenter_capsule_suppressed_total",
    "Capsule triggers suppressed before capture, by reason (debounce, duplicate, queue-full, invalid).",
    ("reason",),
)
SPOOL_EVICTIONS = REGISTRY.counter(
    "karpenter_capsule_spool_evictions_total",
    "Spooled capsule files evicted to stay inside the spool byte budget.",
)
SPOOL_BYTES = REGISTRY.gauge(
    "karpenter_capsule_spool_bytes",
    "Bytes of capsule files currently on disk in the spool directory.",
)
BURN_RATE = REGISTRY.gauge(
    "karpenter_slo_burn_rate",
    "Multi-window SLO burn rate (violating-sample fraction over the error budget; >=1 burns the budget).",
    ("slo", "window"),
)


def fingerprint(kind: str, detail: dict) -> str:
    """16-hex digest over the canonical (kind, detail) JSON. Details carry
    only transport-stable fields, so the same incident fingerprints
    identically across transports — the determinism witness campaigns
    assert."""
    blob = json.dumps({"trigger": kind, "detail": detail}, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def capsule_errors(doc) -> List[str]:
    """All structural problems with one capsule document; empty means
    valid (the self-check every capture passes before it lands)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["capsule must be a JSON object"]
    for key in CAPSULE_KEYS:
        if key not in doc:
            errs.append(f"missing top-level key {key!r}")
    meta = doc.get("capsule")
    if isinstance(meta, dict):
        for key in CAPSULE_META_KEYS:
            if key not in meta:
                errs.append(f"capsule block missing {key!r}")
        trigger = meta.get("trigger")
        if trigger is not None and trigger not in TRIGGERS:
            errs.append(f"capsule.trigger {trigger!r} is not one of {list(TRIGGERS)}")
        seq = meta.get("seq")
        if seq is not None and (not isinstance(seq, int) or isinstance(seq, bool) or seq < 0):
            errs.append("capsule.seq must be a non-negative int")
        fp = meta.get("fingerprint")
        if fp is not None and (
            not isinstance(fp, str) or len(fp) != 16 or any(c not in "0123456789abcdef" for c in fp)
        ):
            errs.append("capsule.fingerprint must be 16 lowercase hex characters")
        if not isinstance(meta.get("detail"), dict):
            errs.append("capsule.detail must be a dict")
    elif meta is not None:
        errs.append("capsule block must be a dict")
    for key in ("traces", "journal", "flight", "fault_domain", "locks", "slo", "burn_rate", "invariants"):
        block = doc.get(key)
        if block is not None and not isinstance(block, dict):
            errs.append(f"{key} block must be a dict, got {type(block).__name__}")
    decisions = doc.get("decisions")
    if decisions is not None and not isinstance(decisions, list):
        errs.append("decisions block must be a list")
    metrics_dump = doc.get("metrics")
    if metrics_dump is not None and not isinstance(metrics_dump, str):
        errs.append("metrics block must be the registry text dump (a string)")
    journal_block = doc.get("journal")
    if isinstance(journal_block, dict):
        events = journal_block.get("events")
        if not isinstance(events, list):
            errs.append("journal.events must be a list")
        else:
            last = None
            for i, event in enumerate(events):
                t = event.get("t") if isinstance(event, dict) else None
                if isinstance(t, (int, float)):
                    if last is not None and t < last:
                        errs.append(f"journal.events[{i}].t={t} goes backwards: the slice must be ascending")
                        break
                    last = t
    return errs


@guarded_by(
    "_lock",
    "_ring",
    "_queue",
    "_seq",
    "_fingerprints",
    "_last_capture",
    "_cost_samples",
    "_spool_files",
    "_spool_bytes",
    "_spool_dead",
)
class CapsuleEngine:
    """The process-wide capture engine (the TRACER/FLIGHT/JOURNAL singleton
    pattern): emit sites enqueue typed triggers, `poll()` turns them into
    schema-validated capsule documents."""

    def __init__(self, capacity: int = DEFAULT_RING):
        self._lock = WITNESS.lock("capsule.engine")
        self.capacity = capacity
        self.enabled = False
        self.clock: Clock = Clock()
        self.debounce_seconds = DEFAULT_DEBOUNCE_SECONDS
        # burn-rate configuration (overridable per enable() for tests)
        self.pending_objective = DEFAULT_PENDING_OBJECTIVE_SECONDS
        self.cost_objective = DEFAULT_COST_DRIFT_OBJECTIVE
        self.error_budget = DEFAULT_ERROR_BUDGET
        self.burn_threshold = DEFAULT_BURN_THRESHOLD
        self.fast_window = DEFAULT_FAST_WINDOW
        self.slow_window = DEFAULT_SLOW_WINDOW
        self.min_samples = DEFAULT_MIN_SAMPLES
        # spool configuration (directory-per-process, one file per capsule)
        self._spool_dir: Optional[str] = None
        self._spool_max_bytes = DEFAULT_SPOOL_MAX_BYTES
        # allocated on enable(), never before — "disabled is a true no-op"
        self._ring: Optional[OrderedDict] = None  # capsule id -> document
        self._queue: Optional[deque] = None  # enqueued (kind, detail) triggers
        self._seq = 0
        self._fingerprints: Optional[Dict[str, List[str]]] = None  # kind -> fps
        self._last_capture: Optional[Dict[str, float]] = None  # kind -> clock t
        self._cost_samples: Optional[deque] = None  # poll-sampled drift series
        self._spool_files: Optional[OrderedDict] = None  # filename -> bytes
        self._spool_bytes = 0
        self._spool_dead = False

    # -- lifecycle -----------------------------------------------------------

    def enable(
        self,
        spool: Optional[str] = None,
        spool_max_bytes: Optional[int] = None,
        debounce_seconds: Optional[float] = None,
        clock: Optional[Clock] = None,
        pending_objective: Optional[float] = None,
        cost_objective: Optional[float] = None,
        error_budget: Optional[float] = None,
        burn_threshold: Optional[float] = None,
        fast_window: Optional[int] = None,
        slow_window: Optional[int] = None,
        min_samples: Optional[int] = None,
    ) -> None:
        with self._lock:
            first = self._ring is None
            if first:
                self._ring = OrderedDict()
                self._queue = deque(maxlen=DEFAULT_QUEUE)
                self._fingerprints = {}
                self._last_capture = {}
                self._cost_samples = deque(maxlen=max(self.slow_window, slow_window or 0))
                self._spool_files = OrderedDict()
        if first and WITNESS.enabled:
            # first enable happens at Runtime construction, before any emit
            # site holds the lock: adopt a witnessed lock so the engine
            # joins the lock-order graph the chaos suites assert acyclic
            self._lock = WITNESS.lock("capsule.engine")
        if clock is not None:
            self.clock = clock
        if debounce_seconds is not None:
            self.debounce_seconds = max(0.0, float(debounce_seconds))
        if pending_objective is not None:
            self.pending_objective = float(pending_objective)
        if cost_objective is not None:
            self.cost_objective = float(cost_objective)
        if error_budget is not None:
            self.error_budget = max(1e-9, float(error_budget))
        if burn_threshold is not None:
            self.burn_threshold = float(burn_threshold)
        if fast_window is not None:
            self.fast_window = max(1, int(fast_window))
        if slow_window is not None:
            self.slow_window = max(self.fast_window, int(slow_window))
        if min_samples is not None:
            self.min_samples = max(1, int(min_samples))
        if spool_max_bytes is not None:
            self._spool_max_bytes = int(spool_max_bytes)
        if spool:
            self._open_spool(spool)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop captured capsules, queued triggers, dedupe/debounce state,
        and this layer's resettable families (per-run harness reset; keeps
        the enabled flag and the spool directory)."""
        with self._lock:
            if self._ring is not None:
                self._ring.clear()
                self._queue.clear()
                self._fingerprints.clear()
                self._last_capture.clear()
                self._cost_samples.clear()
            self._seq = 0
        for family in (CAPTURES, SUPPRESSED, BURN_RATE):
            family.clear()

    def _open_spool(self, path: str) -> None:
        """Adopt `path` as the capsule spool directory, seeding the byte
        accounting (and the sequence counter) from capsules already on disk
        so a restarted process keeps honoring the budget. A dead disk
        disables spooling without killing capture — the ring keeps serving."""
        max_seq = 0
        try:
            os.makedirs(path, exist_ok=True)
            existing: List[Tuple[str, int]] = []
            for name in sorted(os.listdir(path)):
                if name.startswith("CAPSULE_") and name.endswith(".json"):
                    existing.append((name, os.path.getsize(os.path.join(path, name))))
                    stem = name[: -len(".json")]
                    try:
                        max_seq = max(max_seq, int(stem.rsplit("_", 1)[-1]))
                    except ValueError:
                        log.warning("capsule spool: unparseable sequence in %s; ignoring for numbering", name)
        except OSError as exc:
            log.warning("capsule spool unavailable (%s); capturing to memory only", exc)
            with self._lock:
                self._spool_dead = True
            self._spool_dir = None
            return
        self._spool_dir = path
        with self._lock:
            self._spool_dead = False
            self._spool_files = OrderedDict(existing)
            self._spool_bytes = sum(size for _, size in existing)
            self._seq = max(self._seq, max_seq)
            SPOOL_BYTES.set(float(self._spool_bytes))

    # -- the trigger bus -----------------------------------------------------

    def trigger(self, kind: str, **detail) -> None:
        """Enqueue one typed trigger. Cheap by design: emit sites call this
        while holding their own witnessed locks (the breaker emits from its
        transition), so this only appends under the capsule lock — capture
        happens later, in poll(), with no capsule lock held."""
        if not self.enabled:
            return
        if kind not in TRIGGERS:
            SUPPRESSED.inc(reason="invalid")
            log.warning("capsule trigger of unknown kind %r dropped", kind)
            return
        with self._lock:
            if self._queue is None:
                return
            if len(self._queue) == self._queue.maxlen:
                SUPPRESSED.inc(reason="queue-full")
                return
            self._queue.append((kind, dict(detail)))

    # -- the burn-rate monitor -----------------------------------------------

    @staticmethod
    def _window_burn(samples: List[float], objective: float, window: int, min_samples: int, budget: float) -> float:
        tail = samples[-window:]
        if len(tail) < min_samples:
            return 0.0
        violating = sum(1 for s in tail if s > objective)
        return (violating / len(tail)) / budget

    def burn_rates(self) -> Dict[str, Dict[str, float]]:
        """{slo: {window: burn}} over the current sample windows. Pending
        latency reads the SLO summary's per-provisioner observation rings
        (worst series wins); cost drift reads the series poll() samples."""
        from . import slo as _slo

        rates: Dict[str, Dict[str, float]] = {}
        pending = {"fast": 0.0, "slow": 0.0}
        for labels in _slo.PENDING_LATENCY.series():
            obs = _slo.PENDING_LATENCY.observations(**labels)
            for window_name, width in (("fast", self.fast_window), ("slow", self.slow_window)):
                burn = self._window_burn(obs, self.pending_objective, width, self.min_samples, self.error_budget)
                pending[window_name] = max(pending[window_name], burn)
        rates[SLO_PENDING] = pending
        with self._lock:
            drift = list(self._cost_samples) if self._cost_samples is not None else []
        rates[SLO_COST_DRIFT] = {
            window_name: self._window_burn(drift, self.cost_objective, width, self.min_samples, self.error_budget)
            for window_name, width in (("fast", self.fast_window), ("slow", self.slow_window))
        }
        return rates

    def _sample_burn(self) -> List[Tuple[str, dict]]:
        """One burn-monitor round: sample cost drift, export the gauges,
        and return slo-burn triggers for every SLO burning in BOTH windows."""
        from . import slo as _slo

        with self._lock:
            if self._cost_samples is not None:
                self._cost_samples.append(float(_slo.COST_DRIFT.value()))
        fired: List[Tuple[str, dict]] = []
        for slo_name, windows in self.burn_rates().items():
            for window_name in BURN_WINDOWS:
                BURN_RATE.set(round(windows[window_name], 6), slo=slo_name, window=window_name)
            if windows["fast"] >= self.burn_threshold and windows["slow"] >= self.burn_threshold:
                fired.append((TRIGGER_SLO_BURN, {"slo": slo_name}))
        return fired

    # -- polled trigger sources ----------------------------------------------

    def _poll_sources(self) -> List[Tuple[str, dict]]:
        """Evaluate every polled trigger source. Runs with NO capsule lock
        held (each source takes its own subsystem's lock)."""
        from . import invariants as _invariants
        from . import journal as _journal

        found = self._sample_burn()
        if _journal.JOURNAL.enabled:
            for err in _journal.JOURNAL.conservation_errors():
                # "pod <name>: segments sum ..." — the pod is the stable key
                pod = err.split(":", 1)[0].split(" ", 1)[-1]
                found.append((TRIGGER_CONSERVATION, {"pod": pod}))
        for cycle in WITNESS.cycles():
            found.append((TRIGGER_LOCK_CYCLE, {"cycle": "->".join(cycle)}))
        if _invariants.MONITOR.armed():
            for violation in _invariants.MONITOR.violations():
                found.append(
                    (TRIGGER_INVARIANT, {"invariant": violation["invariant"], "entity": violation["entity"]})
                )
        return found

    # -- capture -------------------------------------------------------------

    def poll(self) -> int:
        """Drain the trigger bus into capsules: evaluate polled sources,
        debounce/dedupe under the lock, build each accepted capsule's
        document OUTSIDE the lock, store under the lock. Returns the number
        of capsules captured this round."""
        if not self.enabled:
            return 0
        polled = self._poll_sources()
        now = self.clock.now()
        accepted: List[Tuple[str, dict, str, int]] = []  # (kind, detail, fp, seq)
        suppressed: List[str] = []
        with self._lock:
            if self._queue is None:
                return 0
            candidates = list(self._queue) + polled
            self._queue.clear()
            for kind, detail in candidates:
                fp = fingerprint(kind, detail)
                if fp in self._fingerprints.get(kind, []):
                    suppressed.append("duplicate")
                    continue
                last = self._last_capture.get(kind)
                if last is not None and (now - last) < self.debounce_seconds:
                    suppressed.append("debounce")
                    continue
                self._seq += 1
                self._fingerprints.setdefault(kind, []).append(fp)
                self._last_capture[kind] = now
                accepted.append((kind, detail, fp, self._seq))
        for reason in suppressed:
            SUPPRESSED.inc(reason=reason)
        captured = 0
        for kind, detail, fp, seq in accepted:
            doc = self._build(kind, detail, fp, seq, now)
            errs = capsule_errors(doc)
            if errs:
                # a malformed capture is a bug in THIS module; surface it
                # loudly but never let evidence capture break the caller
                SUPPRESSED.inc(reason="invalid")
                log.error("capsule %s failed self-validation: %s", doc["capsule"]["id"], "; ".join(errs))
                continue
            self._store(doc)
            CAPTURES.inc(trigger=kind)
            captured += 1
            log.warning("incident capsule %s captured (trigger=%s fingerprint=%s)", doc["capsule"]["id"], kind, fp)
        return captured

    def _build(self, kind: str, detail: dict, fp: str, seq: int, now: float) -> dict:
        """Assemble one capsule document. Runs with NO capsule lock held:
        every block acquires its own subsystem's lock (tracer, journal,
        flight, breaker), and the cross-links ride the ids those layers
        already stamp on their records."""
        from . import flight as _flight
        from . import invariants as _invariants
        from . import journal as _journal
        from . import slo as _slo
        from . import tracing as _tracing
        from .solver import faults as _faults

        trace_index = _tracing.TRACER.traces()[:CAPTURE_TRACES]
        trees = {}
        for entry in trace_index[:CAPTURE_TREES]:
            tree = _tracing.TRACER.span_tree(entry["trace_id"])
            if tree is not None:
                trees[entry["trace_id"]] = tree
        # the journal slice is stored ASCENDING so `capsule inspect --replay`
        # can feed it straight into ReplayTrace.from_events
        journal_events = list(reversed(_journal.JOURNAL.events(limit=CAPTURE_JOURNAL_EVENTS)))
        flight_records = [r.to_dict() for r in _flight.FLIGHT.records()[:CAPTURE_FLIGHT_RECORDS]]
        return {
            "capsule": {
                "id": f"{kind}-{seq:04d}",
                "seq": seq,
                "trigger": kind,
                "fingerprint": fp,
                "detail": detail,
                "t": round(now, 6),
            },
            "traces": {"index": trace_index, "trees": trees},
            "decisions": _tracing.DECISIONS.recent(limit=CAPTURE_DECISIONS),
            "journal": {
                "stats": _journal.JOURNAL.stats(),
                "events": journal_events,
                "conservation_errors": _journal.JOURNAL.conservation_errors(),
                "waterfall": _journal.JOURNAL.segment_quantiles(),
            },
            "flight": {
                "records": flight_records,
                "last_record_id": _flight.FLIGHT.last_record_id(),
            },
            "fault_domain": {
                "breaker": _faults.BREAKER.snapshot(),
                "faults_total": _faults.faults_total(),
                "degraded_total": _faults.degraded_total(),
            },
            "locks": WITNESS.snapshot(),
            "slo": _slo.SLO.snapshot(),
            "burn_rate": self.burn_rates(),
            "invariants": {
                "armed": _invariants.MONITOR.armed(),
                "violations": _invariants.MONITOR.violations(),
            },
            "metrics": REGISTRY.export_text(),
        }

    def _store(self, doc: dict) -> None:
        with self._lock:
            if self._ring is None:
                return
            self._ring[doc["capsule"]["id"]] = doc
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
            self._spool_write_locked(doc)

    def _spool_write_locked(self, doc: dict) -> None:
        """One capsule file, then evict oldest files until the directory is
        back inside the byte budget (the journal's rotation-budget
        discipline: never more than the budget on disk). A dead disk stops
        spooling — capture itself survives on the in-memory ring."""
        if self._spool_dir is None or self._spool_dead:
            return
        meta = doc["capsule"]
        name = f"CAPSULE_{meta['trigger']}_{meta['seq']:04d}.json"
        try:
            data = (json.dumps(doc, sort_keys=True) + "\n").encode("utf-8")
            with open(os.path.join(self._spool_dir, name), "wb") as f:
                f.write(data)
            self._spool_files[name] = len(data)
            self._spool_bytes += len(data)
            # oldest-first eviction until the directory is back inside the
            # budget; a single capsule larger than the whole budget evicts
            # itself (the ring still serves it) — the invariant monitor's
            # budget row must NEVER observe spool_bytes > spool_max_bytes
            while self._spool_bytes > self._spool_max_bytes and self._spool_files:
                oldest, size = next(iter(self._spool_files.items()))
                os.remove(os.path.join(self._spool_dir, oldest))
                del self._spool_files[oldest]
                self._spool_bytes -= size
                SPOOL_EVICTIONS.inc()
            SPOOL_BYTES.set(float(self._spool_bytes))
        except (OSError, ValueError) as exc:
            log.warning("capsule spool write failed (%s); spooling disabled, ring capture continues", exc)
            self._spool_dead = True

    # -- read surface --------------------------------------------------------

    def index(self) -> List[dict]:
        """Newest-first capsule index rows (the /debug/capsules listing)."""
        with self._lock:
            docs = list(self._ring.values()) if self._ring is not None else []
        return [dict(doc["capsule"]) for doc in reversed(docs)]

    def capsule_by_id(self, capsule_id: str) -> Optional[dict]:
        with self._lock:
            if self._ring is None:
                return None
            return self._ring.get(capsule_id)

    def captures_total(self) -> int:
        return int(sum(CAPTURES.values().values()))

    def fingerprints(self) -> Dict[str, List[str]]:
        """{trigger: sorted fingerprints} for every capture this run — the
        cross-transport determinism surface SCENARIO artifacts score."""
        with self._lock:
            if self._fingerprints is None:
                return {}
            return {kind: sorted(fps) for kind, fps in self._fingerprints.items() if fps}

    def stats(self) -> dict:
        with self._lock:
            stored = len(self._ring) if self._ring is not None else 0
            queued = len(self._queue) if self._queue is not None else 0
            spool_dir = self._spool_dir if not self._spool_dead else None
            spool_bytes = self._spool_bytes if spool_dir is not None else None
        return {
            "enabled": self.enabled,
            "capsules_stored": stored,
            "capacity": self.capacity,
            "triggers_queued": queued,
            "captures_total": self.captures_total(),
            "suppressed": {reason[0]: int(count) for reason, count in sorted(SUPPRESSED.values().items())},
            "debounce_seconds": self.debounce_seconds,
            # declared-budget surface for the invariant monitor, the same
            # shape the journal spool exposes (None when not spooling)
            "spool": spool_dir,
            "spool_bytes": spool_bytes,
            "spool_max_bytes": self._spool_max_bytes,
        }


CAPSULE = CapsuleEngine()


def enabled() -> bool:
    return CAPSULE.enabled


# -- HTTP routes (ObservabilityServer extra routes) ---------------------------


def _json(status, payload) -> tuple:
    return status, "application/json; charset=utf-8", json.dumps(payload) + "\n"


def _capsules_route(query: dict) -> tuple:
    capsule_id = (query.get("id") or [None])[0]
    if capsule_id is not None:
        doc = CAPSULE.capsule_by_id(capsule_id)
        if doc is None:
            return _json(404, {"error": f"no capsule with id {capsule_id!r}", "status": 404})
        return _json(200, doc)
    payload = CAPSULE.stats()
    payload["capsules"] = CAPSULE.index()
    payload["burn_rate"] = CAPSULE.burn_rates() if CAPSULE.enabled else {}
    return _json(200, payload)


def routes() -> dict:
    """The capsule read surface, served from the metrics listener alongside
    tracing/SLO/flight/journal (cmd/controller.py wires it behind
    --enable-capsules)."""
    return {"/debug/capsules": _capsules_route}


def route_descriptions() -> dict:
    """/debug-index descriptions, keyed like routes() (see tracing.py)."""
    return {
        "/debug/capsules": "incident capsules: triggered cross-subsystem evidence bundles + burn rates; ?id= detail",
    }
