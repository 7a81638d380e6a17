"""Decision tracing: spans + per-pod audit records across the pipeline.

The Dapper-lineage answer to "why did this node launch / why is this solve
slow": every controller pass opens a span, spans within one trigger share a
trace ID, and the dense solver's phase timings (encode/fill/device/commit)
attach as child spans — so a provisioning round is one span tree from
pending-pod batch through the device solve to node launch and pod bind,
inspectable live over the metrics port and exportable as a Chrome
trace-event / Perfetto timeline.

Design constraints, in order:

- **disabled == free**: tracing defaults OFF and a disabled tracer is a true
  no-op — no ring allocation, no span objects, no per-pod record objects.
  The guard is one attribute read per span() call.
- **zero deps, bounded memory**: completed traces live in a thread-safe ring
  (default 256 traces); overflow evicts oldest and counts into
  `karpenter_tracing_traces_dropped`. In-flight buffers are bounded too, so
  a span leak cannot grow without bound.
- **ambient seam**: `span()` reads the per-thread current span, so
  controllers never thread trace IDs manually. Work fanned out to worker
  threads (the launch pool) passes an explicit `parent=` context captured
  with `current_context()`.
- **synthetic child spans**: the dense solver measures its phases with
  perf_counter boundaries, not nested blocks; `record_span()` turns those
  measured intervals into completed child spans after the fact. All span
  starts derive from perf_counter plus one process-constant epoch offset, so
  exported timestamps are monotonic (Chrome/Perfetto require it).

Alongside spans, `DecisionLog` keeps per-pod **decision records** from the
scheduler's admission path: outcome (placed-existing | placed-new | failed),
the chosen node and instance type, and per-constraint rejection counts — the
audit trail behind `/debug/decisions?pod=...`.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from .analysis.guards import guarded_by
from .metrics import REGISTRY

# perf_counter -> epoch seconds, fixed once per process: every span start is
# perf_counter + this, so ordering across spans is exactly perf_counter
# ordering (time.time can step backwards under NTP; trace viewers cannot)
_EPOCH_OFFSET = time.time() - time.perf_counter()

# registered at import so gen_docs sees the families without a live tracer
TRACES_DROPPED = REGISTRY.counter(
    "karpenter_tracing_traces_dropped",
    "Completed or in-flight traces evicted from the bounded trace ring",
)
TRACES_STORED = REGISTRY.gauge(
    "karpenter_tracing_traces_stored", "Completed traces currently held in the trace ring"
)
DECISIONS_DROPPED = REGISTRY.counter(
    "karpenter_tracing_decisions_dropped",
    "Per-pod decision records evicted from the bounded decision ring",
)

DEFAULT_RING = 256
DEFAULT_DECISION_RING = 4096
MAX_SPANS_PER_TRACE = 4096
MAX_INFLIGHT_TRACES = 64

OUTCOME_PLACED_EXISTING = "placed-existing"
OUTCOME_PLACED_NEW = "placed-new"
OUTCOME_FAILED = "failed"


def _now() -> float:
    return time.perf_counter() + _EPOCH_OFFSET


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start: float  # epoch seconds (perf_counter-derived, monotonic-consistent)
    duration: float = 0.0  # seconds; 0 while open
    attributes: Dict[str, object] = field(default_factory=dict)
    thread: str = ""

    def set(self, **attrs) -> None:
        self.attributes.update(attrs)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "duration_ms": round(self.duration * 1000, 3),
            "attributes": self.attributes,
            "thread": self.thread,
        }


class _NullSpan:
    """The disabled-path span: set() swallows attributes, nothing allocates."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


@guarded_by("_lock", "_ring", "_inflight", "_last_trace_id")
class Tracer:
    def __init__(self, capacity: int = DEFAULT_RING):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.capacity = capacity
        self.enabled = False
        # allocated on enable(), never before — "disabled is a true no-op"
        self._ring: Optional[OrderedDict] = None  # trace_id -> List[Span] (completed)
        self._inflight: Optional[OrderedDict] = None  # trace_id -> List[Span] (open roots)
        self._last_trace_id: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None:
                self.capacity = capacity
            if self._ring is None:
                self._ring = OrderedDict()
                self._inflight = OrderedDict()
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop every stored trace (tests); keeps the enabled flag."""
        with self._lock:
            if self._ring is not None:
                self._ring.clear()
                self._inflight.clear()
            self._last_trace_id = None
            TRACES_STORED.set(0)

    # -- ambient current-span seam ---------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_context(self) -> Optional[Tuple[str, str]]:
        """(trace_id, span_id) of the ambient span, for handing to worker
        threads that should parent under it; None outside any span."""
        stack = getattr(self._local, "stack", None)
        if not stack:
            return None
        top = stack[-1]
        return (top.trace_id, top.span_id)

    def current_trace_id(self) -> Optional[str]:
        ctx = self.current_context()
        return ctx[0] if ctx else None

    def last_trace_id(self) -> Optional[str]:
        """Trace ID of the most recently COMPLETED trace."""
        with self._lock:
            return self._last_trace_id

    # -- span creation ---------------------------------------------------------

    @contextmanager
    def span(
        self, name: str, parent: Optional[Tuple[str, str]] = None, drop_childless: bool = False, **attrs
    ) -> Iterator[object]:
        """Open a span; nests under the ambient span of this thread (or the
        explicit `parent` context). A span that exits with no parent is a
        trace root: its completion moves the whole trace into the ring.

        `drop_childless` (roots only): discard the completed trace when it
        holds nothing but the root span — the idle-reconcile case, where
        storing every empty pass would churn provision/interruption traces
        out of the bounded ring."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        stack = self._stack()
        if parent is None and stack:
            parent = (stack[-1].trace_id, stack[-1].span_id)
        trace_id = parent[0] if parent else _new_id()
        sp = Span(
            trace_id=trace_id,
            span_id=_new_id(),
            parent_id=parent[1] if parent else None,
            name=name,
            start=_now(),
            attributes=dict(attrs) if attrs else {},
            thread=threading.current_thread().name,
        )
        start_mono = time.perf_counter()
        is_root = parent is None
        if is_root:
            self._open_trace(trace_id)
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.duration = time.perf_counter() - start_mono
            if stack and stack[-1] is sp:
                stack.pop()
            self._store(sp, complete_trace=is_root, drop_childless=is_root and drop_childless)

    def open_span(self, name: str, parent: Optional[Tuple[str, str]] = None, **attrs) -> Optional[Span]:
        """Open a span WITHOUT entering the ambient stack — for operations
        whose lifetime crosses reconcile passes (a disruption command:
        validate this pass, drain-handoff several passes later). The trace
        stays in-flight until close_span() on the root; children attach by
        passing ctx_of(span) as an explicit parent. Unlike span(), the
        AMBIENT span is deliberately NOT inherited — a cross-pass operation
        must outlive whatever reconcile pass happened to start it, so with
        no explicit parent it roots its own trace. Returns None (and every
        related call no-ops) when tracing is disabled."""
        if not self.enabled:
            return None
        sp = Span(
            trace_id=parent[0] if parent else _new_id(),
            span_id=_new_id(),
            parent_id=parent[1] if parent else None,
            name=name,
            start=_now(),
            attributes=dict(attrs) if attrs else {},
            thread=threading.current_thread().name,
        )
        sp._start_mono = time.perf_counter()  # type: ignore[attr-defined]
        if sp.parent_id is None:
            self._open_trace(sp.trace_id)
        return sp

    def close_span(self, sp: Optional[Span], **attrs) -> None:
        """Complete a span from open_span(); a root completion moves the
        whole trace into the ring."""
        if sp is None or not self.enabled:
            return
        if attrs:
            sp.attributes.update(attrs)
        sp.duration = time.perf_counter() - getattr(sp, "_start_mono", time.perf_counter())
        self._store(sp, complete_trace=sp.parent_id is None)

    @staticmethod
    def ctx_of(sp: Optional[Span]) -> Optional[Tuple[str, str]]:
        return (sp.trace_id, sp.span_id) if sp is not None else None

    def record_span(
        self,
        name: str,
        start: float,
        duration: float,
        attrs: Optional[dict] = None,
        parent: Optional[Tuple[str, str]] = None,
    ) -> Optional[Tuple[str, str]]:
        """Add an already-measured interval as a completed child span. `start`
        is a perf_counter value (the instrumentation sites all measure with
        perf_counter); it is mapped onto the same epoch offset every live
        span uses. Returns the new span's (trace_id, span_id) context so
        callers can hang further synthetic children under it."""
        if not self.enabled:
            return None
        if parent is None:
            parent = self.current_context()
        if parent is None:
            return None
        sp = Span(
            trace_id=parent[0],
            span_id=_new_id(),
            parent_id=parent[1],
            name=name,
            start=start + _EPOCH_OFFSET,
            duration=duration,
            attributes=dict(attrs) if attrs else {},
            thread=threading.current_thread().name,
        )
        self._store(sp, complete_trace=False)
        return (sp.trace_id, sp.span_id)

    # -- storage ---------------------------------------------------------------

    def _open_trace(self, trace_id: str) -> None:
        with self._lock:
            if self._inflight is None:
                return
            while len(self._inflight) >= MAX_INFLIGHT_TRACES:
                self._inflight.popitem(last=False)
                TRACES_DROPPED.inc()
            self._inflight[trace_id] = []

    def _store(self, sp: Span, complete_trace: bool, drop_childless: bool = False) -> None:
        with self._lock:
            if self._inflight is None:
                return
            buf = self._inflight.get(sp.trace_id)
            if buf is None:
                # late span of an evicted/completed trace, or a record_span
                # against a parent that never opened here: drop silently
                if not complete_trace:
                    return
                buf = []
            if len(buf) < MAX_SPANS_PER_TRACE:
                buf.append(sp)
            if complete_trace:
                self._inflight.pop(sp.trace_id, None)
                if drop_childless and len(buf) <= 1:
                    return  # an empty pass is not evidence; don't churn the ring
                while len(self._ring) >= self.capacity:
                    self._ring.popitem(last=False)
                    TRACES_DROPPED.inc()
                self._ring[sp.trace_id] = buf
                self._last_trace_id = sp.trace_id
                TRACES_STORED.set(float(len(self._ring)))

    # -- read surface ----------------------------------------------------------

    def traces(self) -> List[dict]:
        """Recent completed traces, newest first: the /debug/traces index."""
        with self._lock:
            items = list(self._ring.items()) if self._ring else []
        out = []
        for trace_id, spans in reversed(items):
            root = next((s for s in spans if s.parent_id is None), None)
            out.append(
                {
                    "trace_id": trace_id,
                    "root": root.name if root else (spans[0].name if spans else ""),
                    "start": root.start if root else (spans[0].start if spans else 0.0),
                    "duration_ms": round((root.duration if root else 0.0) * 1000, 3),
                    "spans": len(spans),
                }
            )
        return out

    def spans_of(self, trace_id: str) -> Optional[List[Span]]:
        with self._lock:
            if self._ring is None:
                return None
            spans = self._ring.get(trace_id)
            return list(spans) if spans is not None else None

    def span_tree(self, trace_id: str) -> Optional[dict]:
        """The trace as a nested tree keyed off the root span."""
        spans = self.spans_of(trace_id)
        if not spans:
            return None
        nodes = {s.span_id: {**s.to_dict(), "children": []} for s in spans}
        roots = []
        for s in sorted(spans, key=lambda s: s.start):
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            if parent is not None:
                parent["children"].append(node)
            else:
                roots.append(node)
        if not roots:
            return None
        return roots[0] if len(roots) == 1 else {"name": "trace", "trace_id": trace_id, "children": roots}

    def export_chrome(self, trace_id: str) -> Optional[dict]:
        """Chrome trace-event format (catapult/Perfetto loadable): complete
        ('X') events with microsecond ts/dur, one tid per source thread."""
        spans = self.spans_of(trace_id)
        if spans is None:
            return None
        tids: Dict[str, int] = {}
        events = []
        for s in sorted(spans, key=lambda s: s.start):
            tid = tids.setdefault(s.thread or "main", len(tids) + 1)
            events.append(
                {
                    "name": s.name,
                    "cat": "karpenter",
                    "ph": "X",
                    "ts": int(s.start * 1e6),
                    "dur": max(1, int(s.duration * 1e6)),
                    "pid": 1,
                    "tid": tid,
                    "args": {k: repr(v) if not isinstance(v, (str, int, float, bool)) else v for k, v in s.attributes.items()},
                }
            )
        meta = [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid, "args": {"name": thread}}
            for thread, tid in tids.items()
        ]
        return {"displayTimeUnit": "ms", "traceEvents": meta + events}


# -- per-pod decision records -------------------------------------------------

# IncompatibleError messages -> constraint buckets. Keyword matching is the
# honest option here: the admission path raises strings, not typed reasons,
# and the buckets only need to be stable enough to aggregate.
_REJECTION_CLASSES = (
    ("tolerate", "taints"),
    ("taint", "taints"),
    ("host port", "host-ports"),
    ("hostport", "host-ports"),
    ("volume", "volume-limits"),
    ("exceeds node resources", "resources"),
    ("satisfied resources", "resources"),
    ("topology", "topology"),
    ("requirement", "requirements"),
    ("incompatible", "requirements"),
)


def classify_rejection(message: str) -> str:
    lowered = message.lower()
    for needle, bucket in _REJECTION_CLASSES:
        if needle in lowered:
            return bucket
    return "other"


@dataclass
class DecisionRecord:
    pod: str
    outcome: str  # placed-existing | placed-new | failed
    node: str = ""
    instance_type: str = ""
    provisioner: str = ""
    trace_id: str = ""
    error: str = ""
    rejections: Dict[str, int] = field(default_factory=dict)
    timestamp: float = field(default_factory=_now)

    def to_dict(self) -> dict:
        return {
            "pod": self.pod,
            "outcome": self.outcome,
            "node": self.node,
            "instance_type": self.instance_type,
            "provisioner": self.provisioner,
            "trace_id": self.trace_id,
            "error": self.error,
            "rejections": self.rejections,
            "timestamp": self.timestamp,
        }


@guarded_by("_lock", "_ring")
class DecisionLog:
    """Bounded ring of per-pod scheduling decisions, indexed by pod name.

    Only populated while the tracer is enabled (the scheduler checks before
    allocating any per-pod state), so the disabled path allocates nothing."""

    def __init__(self, capacity: int = DEFAULT_DECISION_RING):
        self._lock = threading.Lock()
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)

    def record(self, record: DecisionRecord) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                DECISIONS_DROPPED.inc()
            self._ring.append(record)

    def update_node(self, pod_names, node: str, instance_type: str, placeholder: str = "") -> None:
        """Back-fill the real node name once the launch lands: the scheduler
        records placed-new against the placeholder virtual node; the launch
        path knows the cloud instance. `placeholder` pins the rewrite to the
        record created for THIS virtual node — a launch fed by a
        simulation-mode solve (the interruption proactive re-solve records
        no decisions) must not rewrite a pod's earlier, already-backfilled
        record."""
        names = set(pod_names)
        with self._lock:
            for record in reversed(self._ring):
                if record.pod in names and record.outcome == OUTCOME_PLACED_NEW and record.node == placeholder:
                    record.node = node
                    if instance_type:
                        record.instance_type = instance_type
                    names.discard(record.pod)
                    if not names:
                        return

    def for_pod(self, pod: str) -> List[dict]:
        with self._lock:
            return [r.to_dict() for r in self._ring if r.pod == pod]

    def latest_outcome_for(self, pod: str) -> Optional[dict]:
        """The newest decision record for one pod (the journal's waterfall
        detail joins it so /debug/waterfall?pod= answers outcome + rejection
        tallies in the same page); None when the ring holds nothing."""
        with self._lock:
            for record in reversed(self._ring):
                if record.pod == pod:
                    return record.to_dict()
        return None

    def recent(self, limit: int = 100, outcome: Optional[str] = None) -> List[dict]:
        """Newest-first records, bounded by `limit`; `outcome` filters to one
        outcome class BEFORE bounding (so ?outcome=failed&limit=50 is the
        last 50 failures, not the failures among the last 50 records)."""
        with self._lock:
            records = list(self._ring)
        out = []
        for record in reversed(records):
            if outcome is not None and record.outcome != outcome:
                continue
            out.append(record.to_dict())
            if len(out) >= limit:
                break
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


# the process-wide instances (the REGISTRY analog): controllers import these,
# the Runtime enables them behind --enable-tracing, bench enables directly
TRACER = Tracer()
DECISIONS = DecisionLog()


def enabled() -> bool:
    return TRACER.enabled


# -- HTTP routes (ObservabilityServer extra routes) ---------------------------


def _json(status, payload) -> tuple:
    return status, "application/json; charset=utf-8", json.dumps(payload) + "\n"


def _traces_route(query: dict) -> tuple:
    trace_id = (query.get("id") or [None])[0]
    if trace_id is None:
        traces = TRACER.traces()
        # evidence-loss surface: how much of the ring is full and how many
        # traces have already been overwritten — a reader of a triggered
        # incident needs to know whether the window still covers it
        return _json(
            200,
            {
                "enabled": TRACER.enabled,
                "traces": traces,
                "traces_dropped": int(TRACES_DROPPED.value()),
                "occupancy": len(traces),
                "capacity": TRACER.capacity,
            },
        )
    fmt = (query.get("format") or ["tree"])[0]
    if fmt == "chrome":
        payload = TRACER.export_chrome(trace_id)
        if payload is None:
            return _json(404, {"error": f"trace {trace_id!r} not found", "status": 404})
        return _json(200, payload)
    tree = TRACER.span_tree(trace_id)
    if tree is None:
        return _json(404, {"error": f"trace {trace_id!r} not found", "status": 404})
    return _json(200, {"trace_id": trace_id, "root": tree})


_VALID_OUTCOMES = (OUTCOME_PLACED_EXISTING, OUTCOME_PLACED_NEW, OUTCOME_FAILED)

# the index listing is bounded: an unbounded ?limit= would serialize the
# whole 4096-record ring into one response on a busy cluster
_DECISIONS_DEFAULT_LIMIT = 100
_DECISIONS_MAX_LIMIT = 1000


def _decisions_route(query: dict) -> tuple:
    pod = (query.get("pod") or [None])[0]
    outcome = (query.get("outcome") or [None])[0]
    if outcome is not None and outcome not in _VALID_OUTCOMES:
        return _json(
            404,
            {"error": f"unknown outcome {outcome!r}; one of {list(_VALID_OUTCOMES)}", "status": 404},
        )
    raw_limit = (query.get("limit") or [None])[0]
    limit = _DECISIONS_DEFAULT_LIMIT
    if raw_limit is not None:
        try:
            limit = int(raw_limit)
        except ValueError:
            return _json(404, {"error": f"limit {raw_limit!r} is not an integer", "status": 404})
        limit = max(1, min(limit, _DECISIONS_MAX_LIMIT))
    if pod is None:
        records = DECISIONS.recent(limit=limit, outcome=outcome)
        payload = {"enabled": TRACER.enabled, "records": records, "limit": limit}
        if outcome is not None:
            payload["outcome"] = outcome
        return _json(200, payload)
    records = DECISIONS.for_pod(pod)
    if outcome is not None:
        records = [r for r in records if r["outcome"] == outcome]
    if not records:
        suffix = f" with outcome {outcome!r}" if outcome is not None else ""
        return _json(404, {"error": f"no decision records for pod {pod!r}{suffix}", "status": 404})
    # same bound and ordering as the index: newest first, one hot pod can
    # accumulate hundreds of ring entries
    records.reverse()
    return _json(200, {"pod": pod, "records": records[:limit]})


def routes() -> dict:
    """The tracing routes, served from the metrics listener alongside the
    live-profiling endpoints (cmd/controller.py wires them behind
    --enable-tracing)."""
    return {"/debug/traces": _traces_route, "/debug/decisions": _decisions_route}


def route_descriptions() -> dict:
    """One-line /debug-index descriptions, keyed like routes() — owned here
    so the index (observability.debug_index_route) can never drift from the
    paths this module actually serves."""
    return {
        "/debug/traces": "recent trace index; ?id= span tree, &format=chrome Perfetto export",
        "/debug/decisions": "per-pod scheduling decision records; ?pod=, ?outcome=, ?limit=",
    }
