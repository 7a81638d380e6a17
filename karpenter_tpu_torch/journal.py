"""Lifecycle journal: the recorded pod/node transition stream + the
end-to-end pending-latency waterfall.

`karpenter_slo_pod_pending_duration_seconds` scores creation->bind as one
opaque number; nobody can say whether a slow p99 was batch wait, solve time,
launch latency, or node initialization. This module records the lifecycle
stream that decomposes it:

- **pod transitions** — created -> queued -> batch-admitted -> solved ->
  nominated -> bound (or failed / deleted), each event cross-linked to the
  trace ID of the controller pass that caused it, the decision record
  (via pod name + trace), and the flight-recorder solve id that placed it.
- **node transitions** — launch-requested -> launched -> registered ->
  ready -> initialized -> terminated.
- **the waterfall** — per pod, the creation->bind interval decomposed into
  consecutive segments (queue_wait / batch_wait / solve / launch /
  node_ready / bind) whose sum equals the observed pending duration BY
  CONSTRUCTION (the conservation invariant every scenario run asserts);
  solve carries encode/fill/device/commit sub-splits joined from the flight
  record. Aggregated per provisioner into p50/p95/p99 per segment, exported
  as `karpenter_waterfall_segment_seconds{segment,provisioner}` and served
  at `/debug/waterfall` (index + `?pod=` detail, 404-shaped JSON).
- **the on-disk trace format** — an optional append-only JSONL spool with a
  size-bounded rotation (never more than the configured budget on disk),
  self-validated by journal_schema.py and replayable through
  scenarios/replay.py `ReplayTrace` — the recorded-arrival-trace seam
  ROADMAP item 3 builds on.

Design constraints match tracing.py exactly:

- **disabled == free**: OFF by default; the ring/milestone maps allocate on
  `enable()`, never before, and every event site is one attribute read when
  disabled (the overhead-guard bar in tests/test_journal.py). The watch
  hooks exist only after `attach()`.
- **zero deps, bounded memory**: bounded event ring (default 8192, eviction
  counted), bounded per-entity milestone map, bounded completed-waterfall
  ring; the spool is size-bounded by rotation.
- **clocked**: every timestamp flows through the `utils/clock.py` seam (the
  kube clock after `attach()`), so a campaign's compressed clock compresses
  the journal identically — which is what makes replay exact.
- **one read surface**: `/debug/journal` + `/debug/waterfall` on the
  metrics listener (wired behind `--enable-journal` in cmd/controller.py).
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .analysis.guards import guarded_by
from .analysis.witness import WITNESS
from .logsetup import get_logger
from .metrics import REGISTRY
from .utils.clock import Clock

log = get_logger("journal")

DEFAULT_RING = 8192
MAX_ENTITIES = 16384  # per-entity milestone maps retained (oldest evicted)
MAX_COMPLETED = 4096  # completed waterfalls retained for /debug/waterfall
DEFAULT_SPOOL_MAX_BYTES = 16 * 2**20  # total on-disk budget (live + rotated)

KIND_POD = "pod"
KIND_NODE = "node"
KIND_SOLVER = "solver"
KIND_KUBE = "kube"
KIND_CHAOS = "chaos"

# the transition vocabularies; journal_schema.py validates files against them
POD_EVENTS = ("created", "queued", "batch-admitted", "solved", "nominated", "bound", "failed", "deleted")
NODE_EVENTS = ("launch-requested", "launched", "registered", "ready", "initialized", "terminated")
# solver fault-domain events (solver/faults.py + solver/dense.py): unlike
# pod/node milestones these are a STREAM — a solve may hit the same fault
# kind twice, the breaker re-opens — so they bypass the first-occurrence
# dedupe and never participate in the waterfall
SOLVER_EVENTS = ("fault", "degraded", "breaker-opened", "breaker-half-open", "breaker-closed")
# control-plane fault-domain events (kube/chaos.py + kube/leaderelection.py):
# conflict storms, watch gaps, informer relists, and lease transitions —
# also a stream (the same storm fires repeatedly), so replay traces capture
# control-plane weather alongside pod/node/solver events
KUBE_EVENTS = ("conflict-storm", "watch-gap", "relist", "lease-lost", "lease-acquired")
# chaos-orchestrator events (scenarios/chaos_orchestrator.py + invariants.py):
# the schedule arming, every delivered cross-domain event, and every
# confirmed invariant violation — a stream like solver/kube, never deduped,
# so a replayed journal carries the chaos weather next to the load it hit
CHAOS_EVENTS = ("schedule-armed", "injected", "invariant-violation")

# waterfall segments, in chain order: consecutive sub-intervals of
# created->bound, so their sum IS the pending duration (conservation)
SEGMENTS = ("queue_wait", "batch_wait", "solve", "launch", "node_ready", "bind")

# the pod milestones that bound the first four segments, in chain order
_POD_CHAIN = ("created", "queued", "batch-admitted", "solved", "nominated")

QUANTILES = (0.5, 0.95, 0.99)

# registered at import so gen_docs sees the families without a live journal
EVENTS_TOTAL = REGISTRY.counter(
    "karpenter_journal_events_total",
    "Lifecycle transitions recorded by the journal, by entity kind.",
    ("kind",),
)
EVENTS_STORED = REGISTRY.gauge(
    "karpenter_journal_events_stored", "Lifecycle events currently held in the bounded journal ring."
)
EVENTS_DROPPED = REGISTRY.counter(
    "karpenter_journal_events_dropped", "Lifecycle events evicted from the bounded journal ring."
)
SPOOL_ROTATIONS = REGISTRY.counter(
    "karpenter_journal_spool_rotations_total",
    "Journal spool rotations (the JSONL file hit half the on-disk budget and rolled to .1).",
)
WATERFALL_SEGMENT = REGISTRY.summary(
    "karpenter_waterfall_segment_seconds",
    "Per-pod pending-latency decomposition: seconds spent in each waterfall"
    " segment (queue_wait, batch_wait, solve, launch, node_ready, bind), per provisioner.",
    ("segment", "provisioner"),
    objectives=QUANTILES,
)


@dataclass
class JournalEvent:
    """One recorded lifecycle transition."""

    seq: int
    t: float  # clock-seam seconds (the kube clock after attach)
    kind: str  # pod | node
    entity: str  # pod or node name
    event: str  # one of POD_EVENTS / NODE_EVENTS
    attrs: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> dict:
        out = {"seq": self.seq, "t": round(self.t, 6), "kind": self.kind, "entity": self.entity, "event": self.event}
        if self.attrs:
            out["attrs"] = self.attrs
        return out


def _clamp(value: float, lo: float, hi: float) -> float:
    return max(lo, min(value, hi))


def _quantile_row(values: List[float], with_sum: bool = False) -> dict:
    """Sorted-index quantile row for one segment's observations (sorts in
    place; callers own the list)."""
    values.sort()
    row = {"count": len(values)}
    if with_sum:
        row["sum_seconds"] = round(sum(values), 6)
    for q in QUANTILES:
        row[f"p{int(q * 100)}"] = round(values[min(len(values) - 1, int(q * len(values)))], 6)
    return row


@guarded_by(
    "_lock",
    "_ring",
    "_seq",
    "_last_t",
    "_milestones",
    "_completed",
    "_spool",
    "_spool_bytes",
    "_spool_path",
    "_spool_max_bytes",
)
class Journal:
    """Bounded lifecycle-event ring + milestone tracking + the waterfall."""

    def __init__(self, capacity: int = DEFAULT_RING):
        self._lock = WITNESS.lock("journal.events")
        self.capacity = capacity
        self.enabled = False
        self.clock: Clock = Clock()
        # allocated on enable(), never before — "disabled is a true no-op"
        self._ring: Optional[deque] = None
        self._seq = 0
        self._last_t = 0.0
        # (kind, entity) -> {milestone -> t}: first-occurrence dedupe + the
        # waterfall's raw material; bounded, oldest entity evicted
        self._milestones: Optional[OrderedDict] = None
        # pod -> completed waterfall entry (set at the bound event); bounded
        self._completed: Optional[OrderedDict] = None
        self._spool = None  # open file object when spooling
        self._spool_bytes = 0
        self._spool_path: Optional[str] = None
        self._spool_max_bytes = DEFAULT_SPOOL_MAX_BYTES

    # -- lifecycle -----------------------------------------------------------

    def enable(self, capacity: Optional[int] = None, clock: Optional[Clock] = None) -> None:
        with self._lock:
            if capacity is not None:
                self.capacity = capacity
            first = self._ring is None
            if first:
                self._ring = deque(maxlen=self.capacity)
                self._milestones = OrderedDict()
                self._completed = OrderedDict()
            elif self._ring.maxlen != self.capacity:
                # re-enabled with a new bound: keep the newest events
                self._ring = deque(self._ring, maxlen=self.capacity)
        if first and WITNESS.enabled:
            # first enable happens at Runtime construction, before any event
            # site holds the lock: adopt a witnessed lock so the journal
            # joins the lock-order graph the chaos suites assert acyclic
            self._lock = WITNESS.lock("journal.events")
        if clock is not None:
            self.clock = clock
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop events, milestones, completed waterfalls, and this layer's
        resettable families (per-run harness reset; keeps the enabled flag
        and the spool)."""
        with self._lock:
            if self._ring is not None:
                self._ring.clear()
                self._milestones.clear()
                self._completed.clear()
            self._last_t = 0.0  # the next run may use a different clock epoch
        for family in (EVENTS_TOTAL, EVENTS_DROPPED, WATERFALL_SEGMENT):
            family.clear()
        EVENTS_STORED.set(0)

    def attach(self, kube) -> None:
        """Wire the pod/node watch hooks onto a cluster backend and adopt
        its clock (the one timestamp seam). Idempotent per backend; replay
        is skipped so attaching mid-flight only journals entities created
        from here on (same marker discipline as slo.SLOAccountant.attach)."""
        self.clock = kube.clock
        with self._lock:
            if getattr(kube, "_journal_attached", False):
                return
            kube._journal_attached = True
        kube.watch("Pod", lambda event: self._on_pod_event(kube, event), replay=False)
        kube.watch("Node", lambda event: self._on_node_event(kube, event), replay=False)

    # -- the JSONL spool -------------------------------------------------------

    def set_spool(self, path: Optional[str], max_bytes: int = DEFAULT_SPOOL_MAX_BYTES) -> None:
        """(Re)target the append-only JSONL spool; None closes it. The spool
        is size-bounded: before a write would push the live file past half
        of `max_bytes` it rotates to `<path>.1` (replacing the previous
        rotation), so live + rotated never exceed the budget."""
        with self._lock:
            if self._spool is not None:
                try:
                    self._spool.close()
                except OSError as err:
                    log.warning("journal spool close failed: %s", err)
            self._spool = None
            self._spool_path = path
            self._spool_max_bytes = max_bytes
            self._spool_bytes = 0
            if path is not None:
                try:
                    self._spool = open(path, "w", encoding="utf-8")
                except OSError as err:
                    log.warning("journal spool unavailable at %s: %s", path, err)
                    self._spool_path = None

    def _spool_write_locked(self, line: str) -> None:
        if self._spool is None:
            return
        try:
            # rotate BEFORE a write would push the live file past half the
            # budget: live and rotated each stay <= budget/2, so their sum
            # never exceeds the budget at any observable instant (a single
            # line larger than half the budget still lands whole)
            if self._spool_bytes and self._spool_bytes + len(line) > self._spool_max_bytes // 2:
                self._spool.close()
                os.replace(self._spool_path, self._spool_path + ".1")
                self._spool = open(self._spool_path, "w", encoding="utf-8")
                self._spool_bytes = 0
                SPOOL_ROTATIONS.inc()
            self._spool.write(line)
            self._spool_bytes += len(line)
        except (OSError, ValueError) as err:
            # a dead disk (OSError) or a file closed under us (ValueError)
            # must not take the control plane with it: stop spooling, keep
            # journaling in memory
            log.warning("journal spool write failed (spooling disabled): %s", err)
            self._spool = None

    def flush_spool(self) -> None:
        with self._lock:
            if self._spool is not None:
                try:
                    self._spool.flush()
                except OSError as err:
                    log.warning("journal spool flush failed: %s", err)

    # -- recording -------------------------------------------------------------

    def record(
        self, kind: str, entity: str, event: str, t: Optional[float] = None, attrs: Optional[dict] = None, **kwattrs
    ) -> Optional[JournalEvent]:
        """Append one transition. First-occurrence semantics per (entity,
        event): a transition already journaled for this entity is a no-op,
        so watch redeliveries and retry rounds cannot skew the waterfall
        (the FIRST batch admission / solve is the one that decomposes the
        pending time). Returns the event, or None when disabled/deduped.
        Attributes arrive as keywords or — for names that would collide
        with this signature, e.g. the solver events' `kind` — via `attrs`."""
        if not self.enabled:
            return None
        attrs = {**(attrs or {}), **kwattrs}
        if kind == KIND_POD:
            vocab = POD_EVENTS
        elif kind == KIND_NODE:
            vocab = NODE_EVENTS
        elif kind == KIND_SOLVER:
            vocab = SOLVER_EVENTS
        elif kind == KIND_KUBE:
            vocab = KUBE_EVENTS
        elif kind == KIND_CHAOS:
            vocab = CHAOS_EVENTS
        else:
            raise ValueError(f"unknown journal kind {kind!r}")
        if event not in vocab:
            raise ValueError(f"unknown {kind} transition {event!r}; one of {vocab}")
        if t is None:
            t = self.clock.now()
        with self._lock:
            if self._ring is None:
                return None
            # the stream is monotonic BY CONTRACT (journal_schema.py, and
            # replay's inter-arrival reconstruction): two threads can stamp
            # then dispatch out of order by microseconds, so clamp forward.
            # Milestones keep the RAW stamp: the waterfall conserves against
            # authoritative instants (creation_timestamp, the bind verb's
            # startTime), and a cross-entity clamp must not skew a pod's
            # decomposition — the per-pod chain does its own ordering clamp.
            raw_t = t
            t = max(t, self._last_t)
            self._last_t = t
            if kind in (KIND_POD, KIND_NODE):
                # solver/kube fault-domain events are a stream (the same
                # fault kind can legitimately repeat), so only pod/node
                # milestones carry the first-occurrence dedupe + waterfall
                # bookkeeping
                milestones = self._milestones.get((kind, entity))
                if milestones is None:
                    milestones = {}
                    self._milestones[(kind, entity)] = milestones
                    while len(self._milestones) > MAX_ENTITIES:
                        self._milestones.popitem(last=False)
                elif event in milestones:
                    return None  # first occurrence wins
                milestones[event] = raw_t
                if kind == KIND_POD and event == "solved":
                    # the cross-link payload (trace id, flight-record solve
                    # id) survives ring eviction with the milestone map
                    milestones["_solved_attrs"] = dict(attrs)
            record = JournalEvent(seq=self._seq, t=t, kind=kind, entity=entity, event=event, attrs=dict(attrs))
            self._seq += 1
            evicting = len(self._ring) == self._ring.maxlen
            self._ring.append(record)  # deque(maxlen=) evicts the oldest O(1)
            if evicting:
                EVENTS_DROPPED.inc()
            EVENTS_STORED.set(float(len(self._ring)))
            self._spool_write_locked(json.dumps(record.to_dict()) + "\n")
            completed = None
            if kind == KIND_POD and event == "bound":
                completed = self._complete_waterfall_locked(entity, milestones, dict(attrs))
            elif kind == KIND_POD and event == "deleted":
                # a deleted pod's name may be reused (StatefulSet-style): drop
                # its milestones so the next incarnation journals fresh instead
                # of hitting the first-occurrence dedupe — the SLO cross-feed
                # (keyed by name) would otherwise overwrite the dead pod's
                # waterfall with the new pod's observation and fabricate a
                # conservation violation. Completed waterfalls stay: they are
                # history, and a rebind under the reused name replaces them.
                self._milestones.pop((kind, entity), None)
        EVENTS_TOTAL.inc(kind=kind)
        if completed is not None:
            provisioner = completed["provisioner"]
            for segment, seconds in completed["segments"].items():
                WATERFALL_SEGMENT.observe(seconds, segment=segment, provisioner=provisioner)
        return record

    def pod_event(self, name: str, event: str, t: Optional[float] = None, **attrs) -> Optional[JournalEvent]:
        return self.record(KIND_POD, name, event, t=t, **attrs)

    def node_event(self, name: str, event: str, t: Optional[float] = None, **attrs) -> Optional[JournalEvent]:
        return self.record(KIND_NODE, name, event, t=t, **attrs)

    def solver_event(self, entity: str, event: str, t: Optional[float] = None, **attrs) -> Optional[JournalEvent]:
        """One solver fault-domain transition (solver/faults.py): a
        classified fault, a degradation-ladder rung, or a circuit-breaker
        state change. `entity` names the emitting component ('dense',
        'breaker'); unlike pod/node milestones these are never deduped."""
        return self.record(KIND_SOLVER, entity, event, t=t, attrs=attrs)

    def kube_event(self, entity: str, event: str, t: Optional[float] = None, **attrs) -> Optional[JournalEvent]:
        """One control-plane fault-domain transition (kube/chaos.py +
        kube/leaderelection.py): an injected conflict storm, a watch gap,
        an informer relist, or a lease transition. `entity` names the
        emitting component (a verb boundary, a watch loop, an elector
        identity); like solver events these are a stream, never deduped."""
        return self.record(KIND_KUBE, entity, event, t=t, attrs=attrs)

    def chaos_event(self, entity: str, event: str, t: Optional[float] = None, **attrs) -> Optional[JournalEvent]:
        """One chaos-orchestrator transition (scenarios/chaos_orchestrator.py
        + invariants.py): the schedule arming, a delivered cross-domain
        event, or a confirmed invariant violation. `entity` names the action
        or the violated invariant; a stream, never deduped."""
        return self.record(KIND_CHAOS, entity, event, t=t, attrs=attrs)

    def note_observed_pending(self, pod: str, seconds: float) -> None:
        """Cross-feed from the SLO accountant: the independently-measured
        pending duration this pod observed into
        karpenter_slo_pod_pending_duration_seconds. The conservation check
        prefers it over the journal's own bound-created interval — two
        observers, one invariant."""
        if not self.enabled:
            return
        with self._lock:
            if self._completed is None:
                return
            entry = self._completed.get(pod)
            if entry is not None:
                entry["observed_pending_seconds"] = round(seconds, 6)

    # -- watch hooks -----------------------------------------------------------

    def _on_pod_event(self, kube, event) -> None:
        if not self.enabled:
            return
        pod = event.obj
        name = pod.metadata.name
        if event.type == "DELETED":
            self.pod_event(name, "deleted", phase=pod.status.phase)
            return
        if not pod.spec.node_name:
            # creation_timestamp is stamped by the same clock before the
            # watch dispatches, so "created" matches the SLO accountant's
            # pending-start exactly
            self.pod_event(name, "created", t=pod.metadata.creation_timestamp or None)
            return
        node = kube.get_node(pod.spec.node_name)
        provisioner = ""
        if node is not None:
            from .api import labels as lbl

            provisioner = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL, "")
        # `bound` at the bind verb's authoritative stamp (PodStatus.startTime,
        # the same instant the SLO accountant measures against) — the node
        # lookup above is a network round trip on the HTTP transport and must
        # not leak into the waterfall's conserved interval
        self.pod_event(
            name, "bound", t=pod.status.start_time or None,
            node=pod.spec.node_name, provisioner=provisioner,
        )

    def _on_node_event(self, kube, event) -> None:
        if not self.enabled:
            return
        node = event.obj
        if event.type == "DELETED":
            # fallback for deletions that bypass the termination controller
            # (first occurrence wins, so the controller's richer record sticks)
            self.node_event(node.name, "terminated")
            return
        if event.type == "ADDED":
            self.node_event(node.name, "registered", t=node.metadata.creation_timestamp or None)
        if node.ready():
            self.node_event(node.name, "ready")

    # -- the waterfall ---------------------------------------------------------

    def _complete_waterfall_locked(self, pod: str, milestones: Dict[str, float], attrs: dict) -> Optional[dict]:
        """Decompose created->bound into consecutive segments. Milestones a
        pod skipped (bound straight onto existing capacity with no solve)
        carry the previous boundary forward, so their segment scores zero
        and the chain stays gapless — which is what makes conservation exact
        by construction."""
        created = milestones.get("created")
        bound = milestones.get("bound")
        if created is None or bound is None:
            return None  # attach-mid-flight: no honest decomposition exists
        bound = max(bound, created)
        boundaries = [created]
        for milestone in _POD_CHAIN[1:]:
            t = milestones.get(milestone)
            boundaries.append(_clamp(t, boundaries[-1], bound) if t is not None else boundaries[-1])
        # the node_ready/bind split: the bound node's ready (or initialized)
        # instant, clamped into [nominated, bound]. A node that was ready
        # long before this pod existed clamps to `nominated` — node_ready 0,
        # the whole tail is bind — the existing-capacity case.
        node_name = str(attrs.get("node") or "")
        node_ms = self._milestones.get((KIND_NODE, node_name), {}) if node_name else {}
        split = node_ms.get("ready", node_ms.get("initialized"))
        boundaries.append(_clamp(split, boundaries[-1], bound) if split is not None else boundaries[-1])
        boundaries.append(bound)
        segments = {
            segment: round(boundaries[i + 1] - boundaries[i], 6) for i, segment in enumerate(SEGMENTS)
        }
        solved_attrs = milestones.get("_solved_attrs", {})
        entry = {
            "pod": pod,
            "provisioner": str(attrs.get("provisioner") or solved_attrs.get("provisioner") or ""),
            "node": node_name,
            "created_t": round(created, 6),
            "bound_t": round(bound, 6),
            "pending_seconds": round(bound - created, 6),
            "observed_pending_seconds": None,  # filled by the SLO cross-feed
            "segments": segments,
            "trace_id": str(solved_attrs.get("trace_id") or ""),
            "flight_record": solved_attrs.get("flight_record"),
        }
        self._completed[pod] = entry
        while len(self._completed) > MAX_COMPLETED:
            self._completed.popitem(last=False)
        return entry

    def completed(self) -> List[dict]:
        with self._lock:
            if self._completed is None:
                return []
            return [dict(entry, segments=dict(entry["segments"])) for entry in self._completed.values()]

    def waterfall_for(self, pod: str) -> Optional[dict]:
        with self._lock:
            if self._completed is None:
                return None
            entry = self._completed.get(pod)
            return dict(entry, segments=dict(entry["segments"])) if entry is not None else None

    def segment_quantiles(self) -> Dict[str, dict]:
        """{segment: {p50, p95, p99, count}} across every completed pod —
        the SCENARIO_*.json `waterfall` score block."""
        by_segment: Dict[str, List[float]] = {segment: [] for segment in SEGMENTS}
        for entry in self.completed():
            for segment, seconds in entry["segments"].items():
                by_segment[segment].append(seconds)
        return {segment: _quantile_row(values, with_sum=True) for segment, values in by_segment.items() if values}

    def conservation_errors(self, tolerance: float = 0.05, completed: Optional[List[dict]] = None) -> List[str]:
        """The invariant: per pod, segments sum to the observed pending
        duration within `tolerance` seconds. `observed` is the SLO
        accountant's independent measurement when it arrived (two observers
        of one interval), else the journal's own bound-created interval.
        `completed` reuses a caller-held snapshot instead of re-copying."""
        errors = []
        for entry in completed if completed is not None else self.completed():
            total = sum(entry["segments"].values())
            observed = entry["observed_pending_seconds"]
            if observed is None:
                observed = entry["pending_seconds"]
            if abs(total - observed) > tolerance:
                errors.append(
                    f"pod {entry['pod']}: segments sum {total:.6f}s != observed pending "
                    f"{observed:.6f}s (delta {abs(total - observed):.6f}s > {tolerance}s)"
                )
        return errors

    # -- read surface ----------------------------------------------------------

    def events(self, limit: int = 200, entity: Optional[str] = None) -> List[dict]:
        """Newest-first events, bounded; `entity` filters before bounding."""
        with self._lock:
            records = list(self._ring) if self._ring is not None else []
        out = []
        for record in reversed(records):
            if entity is not None and record.entity != entity:
                continue
            out.append(record.to_dict())
            if len(out) >= limit:
                break
        return out

    def stats(self) -> dict:
        with self._lock:
            stored = len(self._ring) if self._ring is not None else 0
            entities = len(self._milestones) if self._milestones is not None else 0
            completed = len(self._completed) if self._completed is not None else 0
            seq = self._seq
            spooling = self._spool_path if self._spool is not None else None
            spool_bytes = self._spool_bytes if self._spool is not None else None
            spool_max = self._spool_max_bytes
        return {
            "enabled": self.enabled,
            "events_stored": stored,
            "events_total": seq,
            # evidence-loss surface (mirrors /debug/traces): events already
            # evicted from the ring, and the bound eviction happens at
            "events_dropped": int(EVENTS_DROPPED.value()),
            "capacity": self.capacity,
            "entities_tracked": entities,
            "waterfalls_completed": completed,
            "spool": spooling,
            # declared-budget surface for the invariant monitor: occupancy
            # vs bound for the ring, the milestone map, the completed ring,
            # and the on-disk spool (spool_bytes None when not spooling)
            "spool_bytes": spool_bytes,
            "spool_max_bytes": spool_max,
        }

    def waterfall_index(self) -> dict:
        """The /debug/waterfall index: per-provisioner per-segment quantiles
        plus the conservation verdict over every completed pod."""
        completed = self.completed()
        per_provisioner: Dict[str, Dict[str, List[float]]] = {}
        for entry in completed:
            segments = per_provisioner.setdefault(entry["provisioner"] or "N/A", {s: [] for s in SEGMENTS})
            for segment, seconds in entry["segments"].items():
                segments[segment].append(seconds)
        aggregated = {
            provisioner: {segment: _quantile_row(values) for segment, values in segments.items() if values}
            for provisioner, segments in per_provisioner.items()
        }
        errors = self.conservation_errors(completed=completed)
        return {
            "enabled": self.enabled,
            "segments": list(SEGMENTS),
            "pods_completed": len(completed),
            "per_provisioner": aggregated,
            "conservation": {"violations": len(errors), "errors": errors[:20]},
        }

    def waterfall_detail(self, pod: str) -> Optional[dict]:
        """The ?pod= view: the segment decomposition, the pod's full event
        stream, the solve sub-splits joined from the flight record, and the
        latest decision-log outcome — one page answering 'where did this
        pod's pending time go'."""
        entry = self.waterfall_for(pod)
        if entry is None:
            return None
        detail = dict(entry)
        detail["events"] = list(reversed(self.events(limit=len(POD_EVENTS), entity=pod)))
        solve_phases = None
        if entry["flight_record"] is not None:
            from .flight import FLIGHT

            record = FLIGHT.record_by_id(entry["flight_record"])
            if record is not None:
                solve_phases = {k: round(v, 6) for k, v in record.phases.items()}
        detail["solve_phases"] = solve_phases  # null when the record evicted / host-path solve
        from .tracing import DECISIONS

        detail["decision"] = DECISIONS.latest_outcome_for(pod)
        return detail


# the process-wide instance (the TRACER/SLO/FLIGHT analog): controllers feed
# it, the Runtime enables and attaches it behind --enable-journal, the
# campaign runner enables it per scenario run
JOURNAL = Journal()


def enabled() -> bool:
    return JOURNAL.enabled


# -- HTTP routes (ObservabilityServer extra routes) ---------------------------


def _json(status, payload) -> tuple:
    return status, "application/json; charset=utf-8", json.dumps(payload) + "\n"


_EVENTS_DEFAULT_LIMIT = 200
_EVENTS_MAX_LIMIT = 2000


def _journal_route(query: dict) -> tuple:
    entity = (query.get("entity") or [None])[0]
    raw_limit = (query.get("limit") or [None])[0]
    limit = _EVENTS_DEFAULT_LIMIT
    if raw_limit is not None:
        try:
            limit = int(raw_limit)
        except ValueError:
            return _json(404, {"error": f"limit {raw_limit!r} is not an integer", "status": 404})
        limit = max(1, min(limit, _EVENTS_MAX_LIMIT))
    payload = JOURNAL.stats()
    payload["events"] = JOURNAL.events(limit=limit, entity=entity)
    payload["limit"] = limit
    if entity is not None:
        if not payload["events"]:
            return _json(404, {"error": f"no journal events for entity {entity!r}", "status": 404})
        payload["entity"] = entity
    return _json(200, payload)


def _waterfall_route(query: dict) -> tuple:
    pod = (query.get("pod") or [None])[0]
    if pod is None:
        return _json(200, JOURNAL.waterfall_index())
    detail = JOURNAL.waterfall_detail(pod)
    if detail is None:
        return _json(404, {"error": f"no completed waterfall for pod {pod!r}", "status": 404})
    return _json(200, detail)


def routes() -> dict:
    """The journal read surface, served from the metrics listener alongside
    tracing/SLO/flight (cmd/controller.py wires it behind --enable-journal)."""
    return {"/debug/journal": _journal_route, "/debug/waterfall": _waterfall_route}


def route_descriptions() -> dict:
    """/debug-index descriptions, keyed like routes() (see tracing.py)."""
    return {
        "/debug/journal": "lifecycle journal: pod/node transition stream; ?entity=, ?limit=",
        "/debug/waterfall": "pending-latency waterfall: per-segment quantiles + conservation; ?pod= detail",
    }
