"""Kube control-plane fault domain: deterministic API chaos + conflict accounting.

The port's copy of karpenter_tpu/kube/chaos.py. Over HTTP the port's client
keeps one shared informer per kind (kube/client.py), so two things differ
from the reference's transport: a "watch" fault is consulted once per
informer stream, not once per watch() call, and the topology's and the pod
scraper's reads come from the informer's store and send no request, so no
fault plan reaches them there. In memory they still read the store through
`list_pods` and `get_node`, where a "get" fault is consulted as before.

The cloud provider has a typed fault domain and the solver has its own
(`solver/faults.py`); this module is the third leg — the Kubernetes API
itself. `kube/apiserver.py` implements real optimistic concurrency (409 on a
stale resourceVersion), 410-Gone relists, and lease-based election; this
module lets a scenario inject a conflict storm, drop a watch stream, compact
the journal, or steal the lease mid-disruption. Mirrors the solver seam's
discipline exactly:

- **injection seam** — `KubeFaultSpec` + `KubeFaultPlan` + the process-wide
  `KUBE_CHAOS` injector: seeded, per-verb, nth-call triggers consulted at
  every kube verb boundary on BOTH transports (the in-memory `KubeCluster`
  and the HTTP `APIServerState` behind `HttpKubeClient`). Fault kinds:
  `conflict` (an injected 409 the caller's RetryOnConflict / idempotent
  create / election round must absorb), `stale-read` (a GET serves the
  previous version, so the next conditional write loses), `watch-drop` (a
  watch subscribe refused — the informer reconnects from its last RV
  through the full-jitter backoff), `compact` (a forced journal compaction,
  so a reconnect from an old RV gets 410 Gone and relists), and
  `lease-lost` (one election round fails its CAS, the holder steps down).
  Unset, the seam is one attribute read per verb (the tracing/SLO/FLIGHT
  disabled-is-free bar); installed, the same seed + plan + verb sequence
  produce the identical fault history on every run — `history()` is the
  determinism witness the chaos tests pin byte for byte.
- **imperative chaos verbs** — watch gaps and lease steals are timeline
  actions, not verb intercepts: `KubeCluster.chaos_watch_gap_begin/_end`
  buffer (or, with `chaos_compact()`, drop-and-relist) watch dispatch the
  way a dead-then-reconnected stream does; `APIServerState` kills live
  chunked streams and blackouts subscribes; `steal_lease()`
  (kube/leaderelection.py) overwrites the holder mid-renew. Every action is
  recorded into the installed plan's history alongside the seeded triggers.
- **conflict accounting** — `karpenter_kube_conflicts_total{kind,verb}`
  counts every 409 a client OBSERVES (injected or organic), and retry
  exhaustion surfaces as the typed `ConflictExhausted` instead of a bare
  Conflict — a controller that used to swallow or re-raise blindly now
  dispatches on WHAT happened and the campaign scores the storm.
- **journal vocabulary** — `kind="kube"` stream events (conflict-storm,
  watch-gap, relist, lease-lost, lease-acquired) land in the lifecycle
  journal so replay traces capture control-plane weather alongside
  pod/node/solver events.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..analysis.guards import guarded_by
from ..analysis.witness import WITNESS
from ..logsetup import get_logger
from ..metrics import REGISTRY

log = get_logger("kube.chaos")

# -- the fault vocabulary --------------------------------------------------------

FAULT_CONFLICT = "conflict"
FAULT_STALE_READ = "stale-read"
FAULT_WATCH_DROP = "watch-drop"
FAULT_COMPACT = "compact"
FAULT_LEASE_LOST = "lease-lost"

FAULT_KINDS = (FAULT_CONFLICT, FAULT_STALE_READ, FAULT_WATCH_DROP, FAULT_COMPACT, FAULT_LEASE_LOST)

# verb boundaries the injector is consulted at; "watch" is the subscribe
# verb (where watch-drop / compact fire on the HTTP transport), and
# "lease-renew" is the election round's CAS (kube/leaderelection.py)
VERBS = ("create", "update", "update_no_retry", "delete", "get", "watch", "lease-renew")

# which faults make sense at which verbs — a plan wiring `compact` onto
# `update` would silently never manifest; refuse it at construction
_FAULTS_BY_VERB = {
    "create": (FAULT_CONFLICT,),
    "update": (FAULT_CONFLICT,),
    "update_no_retry": (FAULT_CONFLICT,),
    "delete": (FAULT_CONFLICT,),
    "get": (FAULT_STALE_READ,),
    "watch": (FAULT_WATCH_DROP, FAULT_COMPACT),
    "lease-renew": (FAULT_LEASE_LOST, FAULT_CONFLICT),
    "*": FAULT_KINDS,
}

# -- metrics (registered at import so gen_docs sees the families) ----------------

KUBE_CONFLICTS = REGISTRY.counter(
    "karpenter_kube_conflicts_total",
    "Optimistic-concurrency conflicts (409 / stale resourceVersion) observed by"
    " kube clients, by object kind and verb — injected storms and organic races"
    " alike; exhaustion of the bounded RetryOnConflict budget raises the typed"
    " ConflictExhausted instead of a bare Conflict.",
    ("kind", "verb"),
)
KUBE_FAULTS_INJECTED = REGISTRY.counter(
    "karpenter_kube_faults_injected_total",
    "Control-plane faults the installed KubeFaultPlan injected, by fault kind"
    " (conflict, stale-read, watch-drop, compact, lease-lost) — chaos-run"
    " bookkeeping, zero in production.",
    ("fault",),
)


def conflicts_total() -> int:
    """Sum of observed kube conflicts across (kind, verb) — score surface."""
    return int(sum(KUBE_CONFLICTS.values().values()))


# -- the seeded plan -------------------------------------------------------------


@dataclass
class KubeFaultSpec:
    """One planned trigger. `fault` is the kind injected; `verb` scopes it to
    one verb boundary ('*' = any verb the fault is legal at); `obj_kind`
    scopes it to one object kind ('*' = any). `nth` fires on the nth
    matching call (1-based) for `count` consecutive matching calls; with
    `nth` None, `probability` draws a seeded coin per matching call — still
    fully deterministic for a given (plan, seed, call sequence)."""

    fault: str
    verb: str = "*"
    obj_kind: str = "*"
    nth: Optional[int] = None
    count: int = 1
    probability: float = 0.0

    def __post_init__(self):
        if self.fault not in FAULT_KINDS:
            raise ValueError(f"unknown kube fault {self.fault!r}; one of {sorted(FAULT_KINDS)}")
        if self.verb != "*" and self.verb not in VERBS:
            raise ValueError(f"unknown kube verb {self.verb!r}; one of {sorted(VERBS)}")
        if self.fault not in _FAULTS_BY_VERB[self.verb]:
            raise ValueError(f"fault {self.fault!r} cannot fire at verb {self.verb!r}")
        if self.nth is not None and self.nth < 1:
            raise ValueError("nth is 1-based")
        if not (0.0 <= self.probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")


@guarded_by("_lock", "_calls", "_spec_calls", "_history")
class KubeFaultPlan:
    """A seeded, deterministic schedule of control-plane faults. Same plan +
    same seed + same verb sequence -> identical fault history, byte for
    byte — the determinism witness the chaos suites pin on BOTH kube
    transports (solver/faults.py FaultPlan, transliterated)."""

    def __init__(self, specs: Sequence[KubeFaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = WITNESS.lock("kube.chaos-plan")
        self._calls = 0
        self._spec_calls = [0] * len(self.specs)
        self._history: List[dict] = []

    @classmethod
    def from_specs(cls, specs: Sequence[dict], seed: int = 0) -> "KubeFaultPlan":
        return cls([KubeFaultSpec(**spec) for spec in specs], seed=seed)

    def check(self, verb: str, obj_kind: str) -> Optional[str]:
        """Consult the plan at one verb-boundary call; returns the fault
        kind to inject when a trigger fires (first matching spec wins), else
        None. The CALLER manifests the fault in its transport's vocabulary
        (Conflict vs ApiError 409, a buffered gap vs a killed stream)."""
        fire: Optional[KubeFaultSpec] = None
        with self._lock:
            self._calls += 1
            call = self._calls
            for i, spec in enumerate(self.specs):
                if spec.verb != "*" and spec.verb != verb:
                    continue
                if spec.obj_kind != "*" and spec.obj_kind != obj_kind:
                    continue
                if spec.verb == "*" and spec.fault not in _FAULTS_BY_VERB.get(verb, ()):
                    continue  # a wildcard spec only fires where its fault is legal
                self._spec_calls[i] += 1
                matched = self._spec_calls[i]
                if spec.nth is not None:
                    hit = spec.nth <= matched < spec.nth + spec.count
                else:
                    # one seeded draw per matching call per spec, consumed
                    # whether or not it fires — the sequence is a pure
                    # function of (seed, verb order)
                    hit = self._rng.random() < spec.probability
                if hit and fire is None:
                    fire = spec
            if fire is not None:
                self._history.append({"call": call, "verb": verb, "kind": obj_kind, "fault": fire.fault})
        return fire.fault if fire is not None else None

    def record_action(self, action: str, **attrs) -> None:
        """Append an imperative chaos action (watch-gap begin/end, forced
        compaction, lease steal) into the same history stream the seeded
        triggers land in, so the determinism witness covers the WHOLE run's
        control-plane weather, not just the planned part."""
        with self._lock:
            self._calls += 1
            self._history.append({"call": self._calls, "action": action, **attrs})

    def history(self) -> List[dict]:
        """The fired triggers and recorded actions, in call order (the
        determinism witness)."""
        with self._lock:
            return [dict(h) for h in self._history]

    def fired(self) -> int:
        with self._lock:
            return sum(1 for h in self._history if "fault" in h)


class KubeChaosInjector:
    """Process-wide seam the kube verb boundaries consult (the solver
    FAULTS analog). No plan installed (production) = one attribute read per
    verb; `install()` arms a KubeFaultPlan, `clear()` disarms."""

    def __init__(self):
        self._plan: Optional[KubeFaultPlan] = None

    @property
    def plan(self) -> Optional[KubeFaultPlan]:
        return self._plan

    def install(self, plan: KubeFaultPlan) -> None:
        self._plan = plan
        log.info("kube fault plan installed: %d spec(s), seed %d", len(plan.specs), plan.seed)

    def clear(self) -> None:
        self._plan = None

    def fired(self) -> int:
        plan = self._plan
        return plan.fired() if plan is not None else 0

    def check(self, verb: str, obj_kind: str) -> Optional[str]:
        plan = self._plan
        if plan is None:
            return None
        fault = plan.check(verb, obj_kind)
        if fault is not None:
            KUBE_FAULTS_INJECTED.inc(fault=fault)
            from ..journal import JOURNAL

            if JOURNAL.enabled and fault == FAULT_CONFLICT:
                JOURNAL.kube_event(f"{verb}/{obj_kind or '*'}", "conflict-storm", verb=verb)
            log.debug("kube chaos: injected %s at %s %s", fault, verb, obj_kind)
        return fault

    def record_action(self, action: str, **attrs) -> None:
        plan = self._plan
        if plan is not None:
            plan.record_action(action, **attrs)


KUBE_CHAOS = KubeChaosInjector()
