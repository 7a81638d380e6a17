"""Invariant monitor: the slow-leak witnesses the chaos suites sample over hours.

Every witness built so far answers "did this run break something *now*" —
lock cycles, informer divergence, double launches, budget violations. None
of them catches what leaks *slowly*: a loop thread that outlives its
Runtime by one crash/restart cycle, a watch subscription a dead control
plane left attached, a bounded ring quietly exceeding its declared budget,
heap growth with a positive slope over compressed hours. This module is the
standing census + monitor the soak tier samples every few compressed
minutes:

- **thread census** (`CENSUS`) — every Runtime-spawned thread (control
  loops, the provisioner batcher thread, the lease elector, the
  leader-recovery task) registers under its owning Runtime's identity;
  `stop()`/`crash()` join-with-timeout and then `release()` the owner —
  any thread still alive at release is a *straggler*, logged and counted
  until it dies. A leak is a straggler that never does.
- **watch accounting** — the monitor baselines the cluster backend's
  watch-subscription count when armed; growth above the baseline is a
  leaked subscription (crash/restart cycles are net-zero by contract:
  every successor attaches exactly what its predecessor detached).
- **bounded-budget checks** — the journal's event ring / milestone map /
  completed-waterfall ring / spool bytes and the flight recorder's solve
  ring are each compared against their *declared* budgets — defense in
  depth over the `deque(maxlen=)` guarantees, because a budget that
  silently stopped being enforced is exactly the bug class this catches.
- **memory slope** — with `trace_memory=True` (the soak tier), tracemalloc
  samples traced-heap bytes each round; `rss_growth_slope` is the
  least-squares slope in bytes/second over the run. A flat or negative
  slope over compressed hours is the no-leak witness.
- **folded witnesses** — lock-order cycles (`analysis/witness.py`),
  confirmed informer divergences (`kube/coherence.py`), and client-token
  double launches fold into the same `InvariantReport`, so one document —
  served at `/debug/invariants` and schema-gated into `SCENARIO_*.json` —
  answers "is anything, anywhere, leaking or lying".

Disabled-is-free: nothing samples until `arm()`; the census is a dict
insert per thread spawn (the journal/SLO bar). Violations are recorded
once per (invariant, entity) — a leak that persists across 400 samples is
one violation, not 400 — counted in
`karpenter_invariant_violations_total{invariant}` and journaled as
`kind="chaos"` `invariant-violation` events.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

from .analysis.guards import guarded_by
from .analysis.witness import WITNESS
from .logsetup import get_logger
from .metrics import REGISTRY
from .utils.clock import Clock

log = get_logger("invariants")

VIOLATIONS = REGISTRY.counter(
    "karpenter_invariant_violations_total",
    "Distinct invariant violations the monitor confirmed, by invariant"
    " (threads.leak, watches.leak, journal.ring/entities/completed/spool,"
    " flight.ring, capsule.ring/spool, locks.cycle, informer.divergence,"
    " cloud.double-launch) — each (invariant, entity) pair counts once,"
    " however long it persists.",
    ("invariant",),
)
SAMPLES = REGISTRY.counter(
    "karpenter_invariant_samples_total",
    "Invariant-monitor sample rounds taken while armed (the soak tier samples"
    " every few compressed minutes).",
)
LEAKED_THREADS = REGISTRY.gauge(
    "karpenter_invariant_leaked_threads",
    "Threads still alive after their owning Runtime released them from the"
    " census (join-with-timeout expired and the thread never exited).",
)
LEAKED_WATCHES = REGISTRY.gauge(
    "karpenter_invariant_leaked_watches",
    "Watch subscriptions on the cluster backend above the armed baseline —"
    " a dead owner's informer still attached, or an undrained chaos watch.",
)


@guarded_by("_lock", "_owners", "_stragglers")
class ThreadCensus:
    """Process-wide registry of Runtime-owned threads (the COHERENCE
    pattern). `register()` at spawn, `release(owner)` after the owner's
    shutdown joins — anything still alive at release is a straggler,
    retained (and counted by the monitor) until it actually dies."""

    def __init__(self):
        self._lock = WITNESS.lock("invariants.census")
        self._owners: Dict[str, List[threading.Thread]] = {}
        self._stragglers: List[Tuple[str, threading.Thread]] = []

    def register(self, owner: str, thread: threading.Thread) -> None:
        with self._lock:
            threads = self._owners.setdefault(owner, [])
            # prune the owner's dead threads here, not only at release: a
            # flapping leader registers a fresh leader-recovery thread per
            # regain, and keeping every dead Thread object until shutdown
            # would make the census itself the slow leak it exists to catch
            threads[:] = [t for t in threads if t.is_alive()]
            threads.append(thread)

    def release(self, owner: str) -> List[str]:
        """The owner has joined its threads: drop them from the census and
        return the names of any STILL-ALIVE stragglers (kept under watch
        until they die — a straggler that never does is the leak)."""
        with self._lock:
            threads = self._owners.pop(owner, [])
            stragglers = [t for t in threads if t.is_alive()]
            self._stragglers.extend((owner, t) for t in stragglers)
            self._prune_locked()
        names = [t.name for t in stragglers]
        if names:
            log.warning("thread census: %s released with straggler(s) still alive: %s", owner, names)
        return names

    def _prune_locked(self) -> None:
        self._stragglers = [(o, t) for o, t in self._stragglers if t.is_alive()]

    def leaked(self) -> List[dict]:
        """Stragglers still alive right now (dead ones age out)."""
        with self._lock:
            self._prune_locked()
            return [{"owner": owner, "thread": t.name} for owner, t in self._stragglers]

    def snapshot(self) -> dict:
        with self._lock:
            self._prune_locked()
            owners = {
                owner: [t.name for t in threads if t.is_alive()] for owner, threads in self._owners.items()
            }
            stragglers = [{"owner": owner, "thread": t.name} for owner, t in self._stragglers]
        return {"owners": owners, "stragglers": stragglers}

    def reset(self) -> None:
        """Test-harness reset; never called by the runtime."""
        with self._lock:
            self._owners.clear()
            self._stragglers.clear()


CENSUS = ThreadCensus()


def _journal_budget_rows() -> List[Tuple[str, str, int, int]]:
    """(invariant, entity, occupancy, budget) rows for the journal's
    declared bounds; empty when the journal never enabled."""
    from . import journal

    stats = journal.JOURNAL.stats()
    if stats["events_stored"] == 0 and stats["entities_tracked"] == 0 and not stats["enabled"]:
        return []
    rows = [
        ("journal.ring", "events", stats["events_stored"], journal.JOURNAL.capacity),
        ("journal.entities", "milestones", stats["entities_tracked"], journal.MAX_ENTITIES),
        ("journal.completed", "waterfalls", stats["waterfalls_completed"], journal.MAX_COMPLETED),
    ]
    if stats.get("spool_bytes") is not None:
        rows.append(("journal.spool", "bytes", stats["spool_bytes"], stats["spool_max_bytes"]))
    return rows


def _flight_budget_rows() -> List[Tuple[str, str, int, int]]:
    from .flight import FLIGHT

    if not FLIGHT.enabled:
        return []
    return [("flight.ring", "records", len(FLIGHT.records()), FLIGHT.capacity)]


def _capsule_budget_rows() -> List[Tuple[str, str, int, int]]:
    """The capsule engine's declared bounds: the in-memory ring and — when
    spooling — the on-disk byte budget (the journal's rotation-budget
    invariant, shared by the capsule spool)."""
    from .capsule import CAPSULE

    if not CAPSULE.enabled:
        return []
    stats = CAPSULE.stats()
    rows = [("capsule.ring", "capsules", stats["capsules_stored"], stats["capacity"])]
    if stats.get("spool_bytes") is not None:
        rows.append(("capsule.spool", "bytes", stats["spool_bytes"], stats["spool_max_bytes"]))
    return rows


@guarded_by(
    "_lock",
    "_armed",
    "_generation",
    "_kube",
    "_backend",
    "_clock",
    "_baseline_watchers",
    "_coherence_baseline",
    "_sample_count",
    "_violations",
    "_memory_series",
    "_trace_memory",
    "_own_tracemalloc",
    "_last",
)
class InvariantMonitor:
    """The process-wide leak monitor (the COHERENCE/FLIGHT singleton
    pattern): `arm()` against a cluster backend captures the baselines,
    `sample()` runs one witness round (the campaign runner calls it on its
    sample cadence — ~one compressed minute at soak compression),
    `report()` is the InvariantReport served at /debug/invariants and
    scored into SCENARIO_*.json."""

    # bound on the memory series the slope regresses over: the whole series
    # lives for the armed window (the PROCESS lifetime in a controller with
    # --invariants-interval), and an unbounded buffer inside the leak
    # monitor would be the joke writing itself. Oldest points age out; a
    # slope over the trailing window is still the trend that matters.
    MEMORY_SERIES_BOUND = 4096

    def __init__(self):
        from collections import deque

        self._lock = WITNESS.lock("invariants.monitor")
        self._armed = False
        self._generation = 0
        self._kube = None
        self._backend = None
        self._clock: Clock = Clock()
        self._baseline_watchers = 0
        self._coherence_baseline = 0
        self._sample_count = 0
        self._violations: Dict[Tuple[str, str], dict] = {}
        self._memory_series = deque(maxlen=self.MEMORY_SERIES_BOUND)
        self._trace_memory = False
        self._own_tracemalloc = False
        self._last: Optional[dict] = None

    # -- lifecycle -----------------------------------------------------------

    def arm(self, kube, backend=None, clock: Optional[Clock] = None, trace_memory: bool = False) -> int:
        """Start a monitoring window: baseline the watch-subscription count
        and the coherence counter NOW (the armed state is the healthy
        state), optionally start tracemalloc for the memory slope. Arming
        replaces any previous window; the returned generation is the arm's
        ownership token — pass it back to disarm() so a stale owner (a
        stopped Runtime whose window was already replaced) cannot tear down
        a successor's live window."""
        from collections import deque

        from .kube.coherence import divergences_total

        own_trace = False
        if trace_memory:
            import tracemalloc

            if not tracemalloc.is_tracing():
                tracemalloc.start()
                own_trace = True
        watcher_count_fn = getattr(kube, "watcher_count", None)
        baseline = int(watcher_count_fn()) if watcher_count_fn is not None else 0
        with self._lock:
            self._armed = True
            self._generation += 1
            generation = self._generation
            self._kube = kube
            self._backend = backend
            self._clock = clock or getattr(kube, "clock", None) or Clock()
            self._baseline_watchers = baseline
            self._coherence_baseline = divergences_total()
            self._sample_count = 0
            self._violations = {}
            self._memory_series = deque(maxlen=self.MEMORY_SERIES_BOUND)
            self._trace_memory = trace_memory
            self._own_tracemalloc = own_trace
            self._last = None
        LEAKED_THREADS.set(0)
        LEAKED_WATCHES.set(0)
        return generation

    def disarm(self, generation: Optional[int] = None) -> None:
        """End the window; the last report stays readable until re-armed.
        With `generation`, only the window that arm() returned it for is
        torn down — a no-op for a stale owner. None disarms whatever is
        live (the campaign runner's per-run teardown, which owns the
        monitor for the whole process)."""
        with self._lock:
            if not self._armed:
                return
            if generation is not None and generation != self._generation:
                return
            self._armed = False
            self._kube = None
            self._backend = None
            own_trace = self._own_tracemalloc
            self._own_tracemalloc = False
        if own_trace:
            import tracemalloc

            tracemalloc.stop()

    def armed(self) -> bool:
        with self._lock:
            return self._armed

    # -- one witness round -----------------------------------------------------

    def _record_locked(self, invariant: str, entity: str, detail: str, t: float) -> None:
        key = (invariant, entity)
        if key in self._violations:
            return
        self._violations[key] = {"invariant": invariant, "entity": entity, "detail": detail, "t": round(t, 3)}
        VIOLATIONS.inc(invariant=invariant)
        log.error("invariant violation [%s] %s: %s", invariant, entity, detail)
        from .journal import JOURNAL

        if JOURNAL.enabled:
            JOURNAL.chaos_event(f"{invariant}/{entity}", "invariant-violation", detail=detail)

    def sample(self) -> Optional[dict]:
        """One witness round across every invariant; returns the sample row
        (None when disarmed). Cheap by design — thread enumeration, a few
        counter reads — so the campaign runner rides its sample cadence."""
        from .analysis.witness import WITNESS as LOCK_WITNESS
        from .kube.coherence import divergences_total

        with self._lock:
            if not self._armed:
                return None
            kube = self._kube
            backend = self._backend
            clock = self._clock
            baseline_watchers = self._baseline_watchers
            coherence_baseline = self._coherence_baseline
            trace_memory = self._trace_memory
        t = clock.now()
        leaked_threads = CENSUS.leaked()
        watcher_count_fn = getattr(kube, "watcher_count", None)
        watchers = int(watcher_count_fn()) if watcher_count_fn is not None else baseline_watchers
        leaked_watches = max(0, watchers - baseline_watchers)
        budget_rows = _journal_budget_rows() + _flight_budget_rows() + _capsule_budget_rows()
        cycles = LOCK_WITNESS.cycles()
        divergence_delta = divergences_total() - coherence_baseline
        double_launches = int(backend.double_launches()) if backend is not None else 0
        traced_bytes = None
        if trace_memory:
            # only when THIS window asked for tracing: something else in the
            # process (the live profiler's heap endpoint) may have started
            # tracemalloc, and a slope nobody requested must not leak into
            # non-soak scores
            import tracemalloc

            if tracemalloc.is_tracing():
                traced_bytes = tracemalloc.get_traced_memory()[0]
        with self._lock:
            if not self._armed:
                return None
            for leak in leaked_threads:
                self._record_locked("threads.leak", leak["thread"], f"owner {leak['owner']} released it alive", t)
            if leaked_watches > 0:
                self._record_locked(
                    "watches.leak", "kube",
                    f"{watchers} watch subscription(s), baseline {baseline_watchers}", t,
                )
            for invariant, entity, occupancy, budget in budget_rows:
                if occupancy > budget:
                    self._record_locked(invariant, entity, f"occupancy {occupancy} > declared budget {budget}", t)
            for cycle in cycles:
                self._record_locked("locks.cycle", "->".join(cycle), "lock acquisition-order cycle", t)
            if divergence_delta > 0:
                self._record_locked(
                    "informer.divergence", "coherence", f"{divergence_delta} confirmed divergence(s) this window", t
                )
            if double_launches > 0:
                self._record_locked("cloud.double-launch", "token-ledger", f"{double_launches} double launch(es)", t)
            if traced_bytes is not None:
                self._memory_series.append((t, traced_bytes))
            row = {
                "t": round(t, 3),
                "threads_leaked": len(leaked_threads),
                "watchers": watchers,
                "watches_leaked": leaked_watches,
                "traced_bytes": traced_bytes,
                "violations": len(self._violations),
            }
            self._sample_count += 1
            self._last = row
        SAMPLES.inc()
        LEAKED_THREADS.set(float(len(leaked_threads)))
        LEAKED_WATCHES.set(float(leaked_watches))
        return row

    # -- the report ------------------------------------------------------------

    def _slope_locked(self) -> Optional[float]:
        """Least-squares slope of traced-heap bytes over the window
        (bytes/second); None below 3 samples — a slope from 2 points is
        noise dressed as a trend."""
        series = list(self._memory_series)
        if len(series) < 3:
            return None
        n = len(series)
        t0 = series[0][0]
        xs = [t - t0 for t, _ in series]
        ys = [float(b) for _, b in series]
        mean_x = sum(xs) / n
        mean_y = sum(ys) / n
        denom = sum((x - mean_x) ** 2 for x in xs)
        if denom <= 0:
            return None
        return round(sum((x - mean_x) * (y - mean_y) for x, y in zip(xs, ys)) / denom, 3)

    def violations(self) -> List[dict]:
        with self._lock:
            return [dict(v) for v in self._violations.values()]

    def report(self) -> dict:
        """The InvariantReport: /debug/invariants payload and the
        SCENARIO_*.json score source."""
        with self._lock:
            armed = self._armed
            samples = self._sample_count
            last = dict(self._last) if self._last is not None else None
            violations = [dict(v) for v in self._violations.values()]
            slope = self._slope_locked()
            baseline_watchers = self._baseline_watchers
        return {
            "armed": armed,
            "samples": samples,
            "leaked_threads": last["threads_leaked"] if last else 0,
            "leaked_watches": last["watches_leaked"] if last else 0,
            "watchers": {"baseline": baseline_watchers, "current": last["watchers"] if last else None},
            "rss_growth_slope": slope,
            "violations": violations,
            "census": CENSUS.snapshot(),
        }


MONITOR = InvariantMonitor()


# -- HTTP routes (ObservabilityServer extra routes) ---------------------------


def _invariants_route(query: dict) -> tuple:
    if MONITOR.armed():
        MONITOR.sample()  # serve a fresh round, not the last loop tick's
    return 200, "application/json; charset=utf-8", json.dumps(MONITOR.report(), indent=1) + "\n"


def routes() -> dict:
    """`/debug/invariants` for the metrics listener (cmd/controller.py wires
    it behind --invariants-interval)."""
    return {"/debug/invariants": _invariants_route}


def route_descriptions() -> dict:
    """/debug-index descriptions, keyed like routes() (see tracing.py)."""
    return {
        "/debug/invariants": "invariant monitor: thread census, watch/ring/heap leak witnesses, confirmed violations",
    }
