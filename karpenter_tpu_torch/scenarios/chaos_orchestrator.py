"""Cross-domain chaos orchestrator: one seed, three fault domains, one history.

PRs 9/13/14 built three deterministic fault seams — cloud capacity
(`PoolCapacity`/ICE + reclaim waves + crash/restart), solver
(`solver/faults.FAULTS`), and kube control plane (`kube/chaos.KUBE_CHAOS` +
the imperative gap/steal/compact verbs) — but every chaos scenario so far
storms exactly ONE domain. The races worth finding live in the
interactions (a watch gap across a pool exhaustion, a crash inside a
conflict storm mid-reclaim), and the Jepsen lesson is that randomized
*composition* of independent nemeses finds them where hand-composed
single-domain storms cannot. This module is that composer:

- **`ChaosSchedule`** — a seeded schedule of interleaved fault events
  across all three seams, drawn from ONE seed (fanned out splitmix-style,
  `utils/seeds.py`, so the imperative draw, the solver `FaultSpec` export,
  and the kube `KubeFaultSpec` export are independent streams of one
  number). The imperative timeline events (pool exhaustions with paired
  restores, spot-reclaim waves, API latency, watch gaps ± forced
  compaction, lease steals, kill -9 crash/restarts) execute as one scenario
  primitive; the seeded per-dispatch / per-verb triggers export as plain
  spec dicts (`solver_specs()` / `kube_specs()`) that the campaign arms on
  the existing injectors — spec export/import is what makes the three
  seams composable from one seed. `history()` is the determinism witness:
  a pure function of the construction inputs, byte-identical for the same
  seed, pinned cross-transport exactly like the solver and kube plans.
- **the soak tier** (`Soak` + `diurnal_trace`) — a scenario kind that
  drives HOURS of compressed load (a synthetic diurnal arrival trace
  replayed through `ReplayTrace`, inter-arrival structure
  preserved, clock-compressed `compress`×) under a low-rate background
  `ChaosSchedule`, while the campaign runner samples the invariant monitor
  (`invariants.py`) every ~compressed-minute. The scored run lands the
  leak witnesses — `leaked_threads`, `leaked_watches`, `rss_growth_slope`,
  `invariant_violations` — in `SCENARIO_*.json` next to lost/leaked/budget.
- **the shrinker** (`ddmin`) — when a soak breaks an invariant, the
  recorded schedule replays SUBSETS deterministically (delta debugging,
  Zeller's ddmin) until the failure is minimal, and the minimal failing
  schedule is emitted as a committed `SHRINK_<scenario>.json` reproducer:
  a flaky multi-hour failure becomes a tier-1-sized seeded test.

The port's copy of karpenter_tpu/scenarios/chaos_orchestrator.py. The
seeded solver specs name the port's dispatch seams, "plain", "sharded" and
"cuda" (K1's launch), where the reference names "plain", "sharded" and
"pallas".
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from ..analysis.guards import guarded_by
from ..analysis.witness import WITNESS
from ..journal import JOURNAL
from ..logsetup import get_logger
from ..metrics import REGISTRY
from ..provenance import provenance_block
from ..utils.seeds import split_seed
from .primitives import Primitive, Scenario, ScenarioContext

log = get_logger("chaos")

CHAOS_INJECTED = REGISTRY.counter(
    "karpenter_chaos_injected_total",
    "Cross-domain chaos events the orchestrator's schedule delivered, by fault"
    " domain (cloud, kube, solver): the imperative timeline actions — pool"
    " exhaustions, reclaim waves, API latency, watch gaps, lease steals,"
    " crashes. The seeded per-dispatch/per-verb triggers count through their"
    " own families (karpenter_solver_faults_total, karpenter_kube_faults_injected_total).",
    ("domain",),
)

DOMAIN_CLOUD = "cloud"
DOMAIN_KUBE = "kube"
DOMAIN_SOLVER = "solver"
DOMAINS = (DOMAIN_CLOUD, DOMAIN_KUBE, DOMAIN_SOLVER)

# imperative actions the seeded draw may pick, with weights: crashes are the
# heaviest hammer so they stay rare; capacity weather dominates, the way it
# does in production
ACTION_POOL_EXHAUST = "pool-exhaust"
ACTION_POOL_RESTORE = "pool-restore"
ACTION_SPOT_RECLAIM = "spot-reclaim"
ACTION_API_LATENCY = "api-latency"
ACTION_WATCH_GAP = "watch-gap"
ACTION_LEASE_STEAL = "lease-steal"
ACTION_CRASH = "crash"
# never drawn — import-only, the seeded negative control: attaches a watch
# subscription it deliberately never drains, the leak the invariant monitor
# must catch and the shrinker must isolate
ACTION_WATCH_LEAK = "watch-leak"

_ACTION_DOMAIN = {
    ACTION_POOL_EXHAUST: DOMAIN_CLOUD,
    ACTION_POOL_RESTORE: DOMAIN_CLOUD,
    ACTION_SPOT_RECLAIM: DOMAIN_CLOUD,
    ACTION_API_LATENCY: DOMAIN_CLOUD,
    ACTION_CRASH: DOMAIN_CLOUD,
    ACTION_WATCH_GAP: DOMAIN_KUBE,
    ACTION_LEASE_STEAL: DOMAIN_KUBE,
    ACTION_WATCH_LEAK: DOMAIN_KUBE,
}

DEFAULT_ACTIONS: Tuple[Tuple[str, float], ...] = (
    (ACTION_POOL_EXHAUST, 3.0),
    (ACTION_SPOT_RECLAIM, 2.0),
    (ACTION_API_LATENCY, 2.0),
    (ACTION_WATCH_GAP, 3.0),
    (ACTION_CRASH, 0.5),
)

_SOLVER_FAULT_KINDS = ("hbm", "device-lost", "compile")
# the port's dispatch seams: "plain" before every unsplit bucket choice,
# "sharded" before one over a solver mesh, "cuda" at K1's launch (the card
# only)
_SOLVER_ENTRIES = ("plain", "sharded", "cuda")
# (fault, verb, obj_kind) combos the kube draw picks from — each legal at
# its verb per kube/chaos._FAULTS_BY_VERB (the storms must stress, never
# wedge). A Node create conflict meets the provisioner's idempotent create;
# a Node update conflict the controllers' retry_on_conflict, which re-reads
# and re-applies its edit, and past its attempts leaves the node to the next
# pass; a Pod update conflict the binder's next attempt (the stand-in's next
# tick), with nothing of the bind stored; a stale read the conditional write
# it makes lose, which reads again
_KUBE_FAULT_COMBOS = (
    ("conflict", "create", "Node"),
    ("conflict", "update", "Node"),
    ("conflict", "update", "Pod"),
    ("stale-read", "get", "Node"),
    ("stale-read", "get", "Pod"),
)


@dataclass
class ChaosEvent:
    """One imperative chaos action on the schedule timeline."""

    index: int
    offset: float  # seconds after the schedule's own start
    domain: str
    action: str
    params: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "index": self.index,
            "offset": self.offset,
            "domain": self.domain,
            "action": self.action,
            "params": dict(self.params),
        }

    @classmethod
    def from_dict(cls, obj: dict) -> "ChaosEvent":
        return cls(
            index=int(obj["index"]),
            offset=float(obj["offset"]),
            domain=str(obj["domain"]),
            action=str(obj["action"]),
            params=dict(obj.get("params", {})),
        )


@guarded_by("_lock", "_executed", "_failed")
@dataclass
class ChaosSchedule(Primitive):
    """A seeded cross-domain chaos schedule, drawn at construction: same
    inputs -> byte-identical `history()`, on every transport, every run.

    The imperative events run on the scenario timeline as one primitive
    (each pool exhaustion gets a paired restore so the schedule can never
    wedge convergence behind a forgotten wall); the seeded solver/kube
    trigger specs export via `solver_specs()` / `kube_specs()` for the
    campaign to arm on the existing injectors. `imported` replaces the
    draw with explicit event dicts — the shrinker's replay path and the
    negative-control composition seam."""

    seed: int = 0
    events_count: int = 12
    horizon: float = 8.0  # seconds of scenario timeline the events spread over
    instance_type: str = "general-4x8"
    zones: Tuple[str, ...] = ("zone-a", "zone-b", "zone-c")
    solver_faults: int = 2  # seeded FaultSpec draws (each emitted per dispatch flavor)
    kube_faults: int = 2  # seeded KubeFaultSpec draws
    actions: Tuple[Tuple[str, float], ...] = DEFAULT_ACTIONS
    imported: Optional[List[dict]] = None

    def __post_init__(self):
        self._lock = WITNESS.lock("chaos.schedule")
        # __post_init__ is not the checker-exempt __init__, so the guarded
        # state initializes under its lock like any other access
        with self._lock:
            self._executed: List[dict] = []
            self._failed: List[dict] = []
        self._solver_specs = self._draw_solver_specs()
        self._kube_specs = self._draw_kube_specs()
        if self.imported is not None:
            self.events = [ChaosEvent.from_dict(e) for e in self.imported]
        else:
            self.events = self._draw_events()

    # -- the seeded draw -------------------------------------------------------

    def _draw_solver_specs(self) -> List[dict]:
        if self.solver_faults <= 0:
            return []
        rng = random.Random(split_seed(self.seed, "chaos.solver-specs"))
        specs: List[dict] = []
        for _ in range(self.solver_faults):
            kind = rng.choice(_SOLVER_FAULT_KINDS)
            nth = rng.randint(2, 8)
            # one spec per dispatch seam: a plain-only spec would leave
            # K1's own seam on the card untested
            for entry in _SOLVER_ENTRIES:
                specs.append({"kind": kind, "entry": entry, "nth": nth, "count": 1})
        return specs

    def _draw_kube_specs(self) -> List[dict]:
        if self.kube_faults <= 0:
            return []
        rng = random.Random(split_seed(self.seed, "chaos.kube-specs"))
        specs: List[dict] = []
        for _ in range(self.kube_faults):
            fault, verb, obj_kind = rng.choice(_KUBE_FAULT_COMBOS)
            specs.append(
                {"fault": fault, "verb": verb, "obj_kind": obj_kind, "nth": rng.randint(2, 12), "count": rng.randint(1, 2)}
            )
        return specs

    def _draw_events(self) -> List[ChaosEvent]:
        rng = random.Random(split_seed(self.seed, "chaos.events"))
        names = [a for a, _ in self.actions]
        weights = [w for _, w in self.actions]
        raw: List[Tuple[float, str, dict]] = []
        for _ in range(self.events_count):
            offset = round(rng.uniform(0.2, self.horizon), 3)
            action = rng.choices(names, weights=weights)[0]
            params = self._draw_params(rng, action)
            raw.append((offset, action, params))
            if action == ACTION_POOL_EXHAUST:
                # the paired restore: an exhausted pool ALWAYS comes back,
                # so a drawn wall can never outlive the schedule and wedge
                # the convergence phase behind it
                restore_at = round(offset + rng.uniform(0.8, 2.0), 3)
                raw.append(
                    (restore_at, ACTION_POOL_RESTORE, {"instance_type": self.instance_type, "zone": params["zone"], "capacity_type": params["capacity_type"]})
                )
        raw.sort(key=lambda e: (e[0], e[1], json.dumps(e[2], sort_keys=True)))
        return [
            ChaosEvent(index=i, offset=offset, domain=_ACTION_DOMAIN[action], action=action, params=params)
            for i, (offset, action, params) in enumerate(raw)
        ]

    def _draw_params(self, rng: random.Random, action: str) -> dict:
        if action == ACTION_POOL_EXHAUST:
            return {
                "instance_type": self.instance_type,
                "zone": rng.choice(list(self.zones)),
                "capacity_type": rng.choice(("spot", "on-demand")),
                "capacity": rng.choice((0, 1)),
            }
        if action == ACTION_SPOT_RECLAIM:
            return {
                "fraction": round(rng.uniform(0.2, 0.5), 2),
                "warning_seconds": 1.0,
                "max_victims": rng.randint(1, 3),
            }
        if action == ACTION_API_LATENCY:
            return {
                "seconds": round(rng.uniform(0.04, 0.1), 3),
                "duration": round(rng.uniform(0.5, 1.2), 2),
                "delayed_requests": 20,
                "throttled_requests": rng.randint(0, 4),
            }
        if action == ACTION_WATCH_GAP:
            return {"duration": round(rng.uniform(0.3, 0.8), 2), "compact": rng.random() < 0.4}
        return {}

    # -- the composition exports ----------------------------------------------

    def solver_specs(self) -> List[dict]:
        """FaultSpec dicts for `solver_faults.FaultPlan.from_specs` — the
        solver seam's share of this schedule's seed."""
        return [dict(s) for s in self._solver_specs]

    def kube_specs(self) -> List[dict]:
        """KubeFaultSpec dicts for `kube_chaos.KubeFaultPlan.from_specs`."""
        return [dict(s) for s in self._kube_specs]

    # -- the determinism witness -----------------------------------------------

    def history(self) -> dict:
        """The full planned chaos sequence — imperative events AND exported
        trigger specs — as a pure function of the construction inputs.
        Byte-identical (json.dumps of this, sorted keys) for the same seed,
        on every transport: the cross-domain determinism witness."""
        return {
            "seed": self.seed,
            "solver_specs": self.solver_specs(),
            "kube_specs": self.kube_specs(),
            "events": [e.to_dict() for e in self.events],
        }

    def history_digest(self) -> str:
        return hashlib.sha256(json.dumps(self.history(), sort_keys=True).encode()).hexdigest()[:16]

    def executed(self) -> List[dict]:
        """Events actually delivered this run, in delivery order."""
        with self._lock:
            return [dict(e) for e in self._executed]

    def failed(self) -> List[dict]:
        """Events whose delivery RAISED this run: never counted as
        injected — a soak whose weather could not be delivered must fail
        its 'schedule fully delivered' convergence bar, not launder the
        miss into chaos_injected_total."""
        with self._lock:
            return [dict(e) for e in self._failed]

    def injected_total(self) -> int:
        with self._lock:
            return len(self._executed)

    # -- execution -------------------------------------------------------------

    def run(self, ctx: ScenarioContext) -> None:
        with self._lock:
            # a fresh run replays the identical schedule
            self._executed = []
            self._failed = []
        if JOURNAL.enabled:
            JOURNAL.chaos_event("schedule", "schedule-armed", seed=self.seed, events=len(self.events))
        log.info("chaos schedule: %d event(s) over %.1fs (seed %d)", len(self.events), self.horizon, self.seed)
        elapsed = 0.0
        for event in self.events:
            wait = event.offset - elapsed
            if wait > 0:
                if ctx.sleep(wait):
                    return
                elapsed = event.offset
            try:
                blocking = self._execute(ctx, event)
            except Exception:  # noqa: BLE001 - one event must not kill the schedule
                # NOT delivered: the event lands in failed(), never in the
                # executed/injected accounting — soak_settled's fully-
                # delivered bar must see the miss, not a laundered count
                log.exception("chaos event %d (%s) failed", event.index, event.action)
                with self._lock:
                    self._failed.append(event.to_dict())
                continue
            elapsed += blocking
            with self._lock:
                self._executed.append(event.to_dict())
            CHAOS_INJECTED.inc(domain=event.domain)
            if JOURNAL.enabled:
                JOURNAL.chaos_event(event.action, "injected", domain=event.domain, index=event.index)

    def _execute(self, ctx: ScenarioContext, event: ChaosEvent) -> float:
        """Deliver one event; returns the seconds it blocked the timeline
        (gap/latency events sleep inline, so later offsets shift — the
        DELIVERY order is the deterministic contract, not wall instants)."""
        p = event.params
        if event.action == ACTION_POOL_EXHAUST:
            ctx.backend.set_pool_capacity(p["instance_type"], p["zone"], p["capacity_type"], int(p["capacity"]))
            return 0.0
        if event.action == ACTION_POOL_RESTORE:
            ctx.backend.set_pool_capacity(p["instance_type"], p["zone"], p["capacity_type"], None)
            return 0.0
        if event.action == ACTION_SPOT_RECLAIM:
            from .primitives import SpotReclaimWave

            SpotReclaimWave(
                fraction=p["fraction"], warning_seconds=p["warning_seconds"], max_victims=p["max_victims"]
            ).run(ctx)
            return 0.0
        if event.action == ACTION_API_LATENCY:
            ctx.backend.inject_api_latency(p["seconds"])
            if ctx.service is not None:
                ctx.service.delay_next(p["delayed_requests"], p["seconds"])
                if p["throttled_requests"]:
                    ctx.service.throttle_next(p["throttled_requests"])
            ctx.sleep(p["duration"])
            ctx.backend.inject_api_latency(0.0)
            return p["duration"]
        if event.action == ACTION_WATCH_GAP:
            from .primitives import WatchGap

            WatchGap(duration=p["duration"], compact=bool(p.get("compact"))).run(ctx)
            return p["duration"]
        if event.action == ACTION_LEASE_STEAL:
            from ..kube.leaderelection import steal_lease

            steal_lease(ctx.kube, identity=p.get("thief", "chaos-thief"))
            return 0.0
        if event.action == ACTION_CRASH:
            ctx.crash_runtime()
            return 0.0
        if event.action == ACTION_WATCH_LEAK:
            # the deliberate bug: a subscription nobody will ever drain —
            # the invariant monitor's watches.leak witness must catch it
            ctx.kube.watch("Pod", lambda _event: None, replay=False)
            return 0.0
        raise ValueError(f"unknown chaos action {event.action!r}")

    def config(self) -> dict:
        """Provenance payload: the drawn schedule is summarized by digest —
        two artifacts compare equal iff they ran the identical chaos."""
        return {
            "kind": type(self).__name__,
            "offset": self.offset,
            "seed": self.seed,
            "events_count": len(self.events),
            "horizon": self.horizon,
            "instance_type": self.instance_type,
            "solver_faults": self.solver_faults,
            "kube_faults": self.kube_faults,
            "history_digest": self.history_digest(),
        }


# -- the soak tier --------------------------------------------------------------


@dataclass
class Soak(Scenario):
    """A scenario kind that represents HOURS of wall time compressed into a
    seconds-scale run: a recorded (or synthesized) arrival trace replayed
    `compress`x faster through ReplayTrace, a low-rate background
    ChaosSchedule, and the invariant monitor sampled on the campaign's
    cadence (~one compressed minute per sample at soak compression). The
    leak witnesses — threads, watches, ring budgets, heap slope — are the
    scored acceptance surface a short storm can never exercise."""

    compress: float = 60.0  # one real second = this many compressed seconds
    compressed_span: float = 0.0  # recorded wall-time the load trace spans

    def config(self) -> dict:
        out = super().config()
        out["kind"] = "soak"
        out["compress"] = self.compress
        out["compressed_span"] = self.compressed_span
        return out


def diurnal_trace(seed: int, span_seconds: float, arrivals: int, compress: float, offset: float = 0.0):
    """Synthesize a diurnal arrival trace and wrap it in a ReplayTrace:
    `arrivals` pod creations over `span_seconds` of recorded wall time,
    inter-arrival density following the half-cosine day (quiet night, busy
    midday), replayed `compress`x faster. Deterministic per seed — the
    inverse-CDF draw uses its own fanned-out stream."""
    from .replay import ReplayTrace

    rng = random.Random(split_seed(seed, "soak.trace"))

    def inverse_cdf(u: float) -> float:
        # density f(x) = 1 - cos(2*pi*x) on [0, 1); CDF F(x) = x - sin(2*pi*x)/(2*pi).
        # F is monotone (f >= 0), so bisection converges deterministically.
        lo, hi = 0.0, 1.0
        for _ in range(48):
            mid = (lo + hi) / 2
            if mid - math.sin(2 * math.pi * mid) / (2 * math.pi) < u:
                lo = mid
            else:
                hi = mid
        return (lo + hi) / 2

    times = sorted(inverse_cdf(rng.random()) * span_seconds for _ in range(arrivals))
    events = [
        {"seq": i, "t": round(t, 6), "kind": "pod", "entity": f"replay-{i:05d}", "event": "created"}
        for i, t in enumerate(times)
    ]
    return ReplayTrace.from_events(
        events, compress=compress, offset=offset, source=f"synthetic-diurnal/seed={seed}/span={span_seconds:g}s"
    )


# -- the shrinker ----------------------------------------------------------------


def ddmin(
    events: Sequence[dict], failing: Callable[[List[dict]], bool], max_tests: int = 128
) -> Tuple[List[dict], int]:
    """Delta debugging (Zeller's ddmin) over a recorded chaos schedule:
    deterministically replay subsets of `events` through `failing` until no
    smaller subset still fails. Returns (minimal failing schedule, replays
    run). `failing` must be deterministic — which is exactly what the
    seeded schedule + per-run-fresh cluster guarantee."""
    current = list(events)
    tests = 1
    if not failing(list(current)):
        raise ValueError("ddmin requires a failing input schedule")
    n = 2
    while len(current) >= 2 and tests < max_tests:
        chunk = math.ceil(len(current) / n)
        subsets = [current[i : i + chunk] for i in range(0, len(current), chunk)]
        reduced = False
        for subset in subsets:
            tests += 1
            if failing(list(subset)):
                current, n, reduced = subset, 2, True
                break
        if not reduced and n > 2:
            for i in range(len(subsets)):
                complement = [e for j, s in enumerate(subsets) for e in s if j != i]
                tests += 1
                if failing(list(complement)):
                    current, n, reduced = complement, max(2, n - 1), True
                    break
        if not reduced:
            if n >= len(current):
                break
            n = min(len(current), 2 * n)
    return current, tests


def replay_failing_schedule(events: Sequence[dict], invariant: str = "watches.leak") -> bool:
    """The shrinker's deterministic replay predicate: deliver a recorded
    schedule subset (offsets collapsed — DELIVERY ORDER is the recorded
    contract, wall spacing is not) against a fresh in-memory cluster +
    cloud with the invariant monitor armed, and report whether `invariant`
    fires. Fresh state per replay is what makes ddmin sound: no subset can
    inherit a leak from the previous probe. Re-arms the process-wide
    monitor, so never call it inside a live campaign run."""
    from ..cloudprovider.simulated.backend import CloudBackend
    from ..invariants import MONITOR
    from ..kube.cluster import KubeCluster

    kube = KubeCluster()
    backend = CloudBackend(clock=kube.clock)
    ctx = ScenarioContext(kube, backend, runtime=None)
    schedule = ChaosSchedule(imported=[dict(e, offset=0.0) for e in events])
    MONITOR.arm(kube, backend=backend, clock=kube.clock)
    try:
        schedule.run(ctx)
        MONITOR.sample()
        return any(v["invariant"] == invariant for v in MONITOR.violations())
    finally:
        MONITOR.disarm()
        ctx.stop.set()


def shrink_failing_schedule(scenario: str, seed: int, events: Sequence[dict], invariant: str = "watches.leak") -> dict:
    """ddmin a recorded failing schedule down to its minimal reproducer and
    return the committed SHRINK document: the workflow a broken soak run
    feeds its recorded history through."""
    minimal, replays = ddmin(list(events), lambda subset: replay_failing_schedule(subset, invariant))
    return shrink_doc(scenario, invariant, seed=seed, original=list(events), minimal=minimal, replays=replays)


SHRINK_KEYS = ("scenario", "invariant", "provenance", "seed", "original_events", "minimal_events", "replays")


def shrink_doc(scenario: str, invariant: str, seed: int, original: List[dict], minimal: List[dict], replays: int) -> dict:
    """The committed SHRINK_<scenario>.json shape: provenance + the full
    failing schedule + its ddmin-minimal reproducer."""
    return {
        "scenario": scenario,
        "invariant": invariant,
        "seed": seed,
        "provenance": provenance_block({"scenario": scenario, "invariant": invariant, "seed": seed, "events": minimal}),
        "original_events": list(original),
        "minimal_events": list(minimal),
        "replays": replays,
    }


def shrink_doc_errors(doc) -> List[str]:
    """Structural problems with one SHRINK_*.json document; empty = valid."""
    from ..provenance import provenance_errors

    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["document must be a JSON object"]
    for key in SHRINK_KEYS:
        if key not in doc:
            errs.append(f"missing top-level key {key!r}")
    errs.extend(provenance_errors(doc.get("provenance", {})))
    for key in ("original_events", "minimal_events"):
        events = doc.get(key)
        if not isinstance(events, list) or not events:
            errs.append(f"{key} must be a non-empty list")
            continue
        for i, event in enumerate(events):
            if not isinstance(event, dict):
                errs.append(f"{key}[{i}] must be an object")
                continue
            for required in ("index", "offset", "domain", "action"):
                if required not in event:
                    errs.append(f"{key}[{i}] missing {required!r}")
            action = event.get("action")
            if action is not None:
                if action not in _ACTION_DOMAIN:
                    # a typo'd action replays as a swallowed ValueError — a
                    # reproducer that silently stopped reproducing
                    errs.append(f"{key}[{i}].action {action!r} is not a chaos action (one of {sorted(_ACTION_DOMAIN)})")
                elif event.get("domain") != _ACTION_DOMAIN[action]:
                    errs.append(
                        f"{key}[{i}].domain {event.get('domain')!r} does not match action {action!r}"
                        f" (expected {_ACTION_DOMAIN[action]!r})"
                    )
    minimal = doc.get("minimal_events")
    original = doc.get("original_events")
    if isinstance(minimal, list) and isinstance(original, list) and len(minimal) > len(original):
        errs.append("minimal_events cannot exceed original_events")
    replays = doc.get("replays")
    if replays is not None and (not isinstance(replays, int) or isinstance(replays, bool) or replays < 1):
        errs.append("replays must be a positive integer")
    return errs


def write_shrink(path: str, doc: dict) -> None:
    """Validate then land the reproducer (emit-time crash over silent gap,
    the SCENARIO emit contract)."""
    errors = shrink_doc_errors(doc)
    if errors:
        raise AssertionError(f"shrink document is invalid: {errors}")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    log.info("wrote %s (%d -> %d event(s), %d replay(s))", path, len(doc["original_events"]), len(doc["minimal_events"]), doc["replays"])
