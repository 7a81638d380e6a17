"""Runtime lock-order witness: the dynamic half of the concurrency tooling.

Go-Karpenter leans on the race detector to catch what `go vet` cannot; this
is the Python analog for LOCK ORDERING. Shared-state classes create their
locks through `WITNESS.lock/rlock/condition(name)`; while the witness is
enabled, every acquisition records the per-thread held-set so the witness
maintains the global acquisition-order graph (edge A->B = "some thread
acquired B while holding A"). A cycle in that graph is a potential deadlock
— two threads interleaving the two orders WILL deadlock eventually, even if
no run has hung yet. The storm/crash/campaign chaos suites run with the
witness on and assert zero cycles, so every chaos scenario doubles as a
deadlock hunt.

Also recorded, per lock: acquisition and contention counts, hold times
(with a long-hold counter above LONG_HOLD_SECONDS — a lock held across a
network call is a latency bug even when ordering is clean), all exported as
`karpenter_lockwitness_*` metrics and served as JSON from `/debug/locks`.

Disabled is the default and is a TRUE no-op: `WITNESS.lock()` returns a
plain `threading.Lock` — not a wrapper with a dead branch — so production
hot paths pay nothing, the same bar tracing and SLO accounting meet.
Wrappers created while enabled keep working after `disable()` (they
short-circuit on the enabled flag), so a teardown cannot strand a lock.

Reentrant acquisition of the same RLock adds no edge and no duplicate held
entry; ordering is judged on first acquisition only. The witness's own
bookkeeping runs under one internal leaf lock that is never held while
acquiring a witnessed lock, so the witness cannot deadlock the program it
watches.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..metrics import REGISTRY

LONG_HOLD_SECONDS = 0.1

ACQUISITIONS = REGISTRY.counter(
    "karpenter_lockwitness_acquisitions_total",
    "Acquisitions of witnessed locks while the lock-order witness is enabled",
    ("lock",),
)
CONTENDED = REGISTRY.counter(
    "karpenter_lockwitness_contended_total",
    "Witnessed acquisitions that had to wait for another holder",
    ("lock",),
)
LONG_HOLDS = REGISTRY.counter(
    "karpenter_lockwitness_long_holds_total",
    f"Witnessed lock holds longer than {LONG_HOLD_SECONDS}s",
    ("lock",),
)
EDGES = REGISTRY.gauge(
    "karpenter_lockwitness_edges",
    "Distinct ordered pairs (A held while acquiring B) in the acquisition-order graph",
)
CYCLES = REGISTRY.gauge(
    "karpenter_lockwitness_cycles",
    "Cycles (potential deadlocks) detected in the lock acquisition-order graph",
)
LOCKS_REGISTERED = REGISTRY.gauge(
    "karpenter_lockwitness_locks", "Witnessed locks created since the witness was enabled"
)


class _WitnessedLock:
    """Lock/RLock wrapper that reports to the owning witness. Supports the
    full acquire(blocking, timeout) protocol plus the context manager, so a
    threading.Condition built over it works unmodified."""

    __slots__ = ("_witness", "_inner", "name")

    def __init__(self, witness: "LockWitness", inner, name: str):
        self._witness = witness
        self._inner = inner
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        witness = self._witness
        if not witness.enabled:
            return self._inner.acquire(blocking, timeout)
        contended = False
        acquired = self._inner.acquire(False)
        if not acquired:
            if not blocking:
                # a failed non-blocking acquire is a PROBE, not a wait —
                # Condition._is_owned() probes exactly this way on every
                # wait()/notify(), so counting it would drown the metric
                return False
            contended = True
            acquired = self._inner.acquire(True, timeout)
            if not acquired:
                CONTENDED.inc(lock=self.name)  # waited the full timeout
                return False
        witness._on_acquired(self.name, contended)
        return True

    def release(self) -> None:
        # ALWAYS run the held-stack bookkeeping: a disable() landing between
        # acquire and release must not strand a phantom entry that poisons
        # the edge graph after the next enable (metrics are gated inside)
        self._witness._on_released(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked() if hasattr(self._inner, "locked") else False


class LockWitness:
    def __init__(self):
        self.enabled = False
        self._meta = threading.Lock()  # leaf lock: guards everything below
        self._local = threading.local()
        self._names: Dict[str, str] = {}  # name -> kind
        self._edges: Dict[Tuple[str, str], int] = {}
        self._cycles: List[List[str]] = []
        self._cycle_keys: set = set()
        self._max_hold: Dict[str, float] = {}

    # -- lifecycle -------------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop the recorded graph and stats (test teardown). Call with no
        witnessed locks held; per-thread held stacks are rebuilt naturally."""
        with self._meta:
            self._names.clear()
            self._edges.clear()
            self._cycles.clear()
            self._cycle_keys.clear()
            self._max_hold.clear()
        EDGES.set(0)
        CYCLES.set(0)
        LOCKS_REGISTERED.set(0)

    # -- factories -------------------------------------------------------------

    def lock(self, name: str):
        """A mutex for `name`. Plain threading.Lock when disabled."""
        if not self.enabled:
            return threading.Lock()
        self._register(name, "lock")
        return _WitnessedLock(self, threading.Lock(), name)

    def rlock(self, name: str):
        if not self.enabled:
            return threading.RLock()
        self._register(name, "rlock")
        return _WitnessedLock(self, threading.RLock(), name)

    def condition(self, name: str):
        """A Condition whose underlying mutex is witnessed. The Condition's
        wait() releases and reacquires through the wrapper, so held-set
        bookkeeping stays correct across waits."""
        if not self.enabled:
            return threading.Condition()
        self._register(name, "condition")
        return threading.Condition(_WitnessedLock(self, threading.Lock(), name))

    def _register(self, name: str, kind: str) -> None:
        with self._meta:
            self._names[name] = kind
            LOCKS_REGISTERED.set(float(len(self._names)))

    # -- acquisition bookkeeping -----------------------------------------------

    def _held(self) -> list:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = []  # [name, depth, acquired_at]
        return held

    def _on_acquired(self, name: str, contended: bool) -> None:
        ACQUISITIONS.inc(lock=name)
        if contended:
            CONTENDED.inc(lock=name)
        held = self._held()
        for entry in held:
            if entry[0] == name:  # reentrant: deeper, no new edge
                entry[1] += 1
                return
        new_edges = []
        for entry in held:
            new_edges.append((entry[0], name))
        held.append([name, 1, time.perf_counter()])
        if new_edges:
            self._record_edges(new_edges)

    def _on_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                held[i][1] -= 1
                if held[i][1] == 0:
                    duration = time.perf_counter() - held[i][2]
                    del held[i]
                    if not self.enabled:
                        return  # bookkeeping only: no stats while disabled
                    if duration > LONG_HOLD_SECONDS:
                        LONG_HOLDS.inc(lock=name)
                    with self._meta:
                        if duration > self._max_hold.get(name, 0.0):
                            self._max_hold[name] = duration
                return

    def _record_edges(self, edges: List[Tuple[str, str]]) -> None:
        with self._meta:
            fresh = []
            for edge in edges:
                if edge[0] == edge[1]:
                    continue
                if edge in self._edges:
                    self._edges[edge] += 1
                else:
                    self._edges[edge] = 1
                    fresh.append(edge)
            for a, b in fresh:
                cycle = self._find_path(b, a)
                if cycle is not None:
                    key = frozenset(cycle)
                    if key not in self._cycle_keys:
                        self._cycle_keys.add(key)
                        self._cycles.append(cycle)
            EDGES.set(float(len(self._edges)))
            CYCLES.set(float(len(self._cycles)))

    def _find_path(self, start: str, target: str) -> Optional[List[str]]:
        """DFS for a path start -> ... -> target over the edge graph; with
        the new edge target->start already inserted, such a path closes a
        cycle. Returns the cycle's node list (target first) or None.
        Caller holds self._meta."""
        adjacency: Dict[str, List[str]] = {}
        for a, b in self._edges:
            adjacency.setdefault(a, []).append(b)
        stack = [(start, [target, start])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            if node == target:
                return path[:-1]
            for nxt in adjacency.get(node, ()):
                if nxt == target:
                    return path
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- read surface ----------------------------------------------------------

    def cycles(self) -> List[List[str]]:
        with self._meta:
            return [list(c) for c in self._cycles]

    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._meta:
            return dict(self._edges)

    def locks(self) -> Dict[str, str]:
        with self._meta:
            return dict(self._names)

    def snapshot(self) -> dict:
        """The /debug/locks payload."""
        with self._meta:
            return {
                "enabled": self.enabled,
                "locks": dict(self._names),
                "edges": [
                    {"from": a, "to": b, "count": count} for (a, b), count in sorted(self._edges.items())
                ],
                "cycles": [list(c) for c in self._cycles],
                "max_hold_seconds": {k: round(v, 6) for k, v in sorted(self._max_hold.items())},
                "long_hold_threshold_seconds": LONG_HOLD_SECONDS,
            }


# the process-wide witness (the TRACER/REGISTRY analog): shared classes
# create their locks through it; chaos suites enable it around a run
WITNESS = LockWitness()


def _locks_route(query: dict) -> tuple:
    return 200, "application/json; charset=utf-8", json.dumps(WITNESS.snapshot(), indent=1) + "\n"


def routes() -> dict:
    """`/debug/locks` for the metrics listener (cmd/controller.py wires it
    behind --enable-lock-witness)."""
    return {"/debug/locks": _locks_route}


def route_descriptions() -> dict:
    """/debug-index descriptions, keyed like routes() (see tracing.py)."""
    return {
        "/debug/locks": "lock-order witness: acquisition graph, cycles (potential deadlocks), contention/hold times",
    }
