"""Informer-coherence witness: proof the caches mirror the API, continuously.

Every solve reads the `controllers/state/cluster.py` mirror, not the API;
"Priority Matters" assumes a CONSISTENT cluster view as input to the
constraint matrix, and the incremental-solve direction (ROADMAP item 1)
makes a provably coherent informer cache a hard prerequisite — a stale
delta applied to device-resident matrices is silent corruption. This module
is the runtime proof, the coherence analog of the lock-order witness
(analysis/witness.py):

- registered caches (`COHERENCE.register`) are periodically DEEP-COMPARED
  against an authoritative store snapshot: node names + resourceVersions,
  and the pod->node binding map for non-terminal bound pods — the exact
  state the scheduler packs against;
- a raw mismatch is only COUNTED when it is attributable: the store version
  is read before and after the compare (a moved store means the mismatch
  may be in-flight watch delivery, the round is skipped), and the mismatch
  must persist across a confirm re-read — a static store whose cache still
  disagrees after the settle window is a real coherence bug, not latency;
- confirmed divergences land in `karpenter_informer_divergences_total{kind}`
  and the last check is served at `/debug/coherence`;
- every chaos suite asserts ZERO divergences at teardown (the lock-witness
  pattern): `final_check()` polls until the cache catches up or the timeout
  expires, so convergence itself proves the informer contract survived the
  conflict storms, watch gaps, compactions, and lease flaps injected by
  kube/chaos.py.

Disabled-is-free: nothing here hooks the watch path — the witness reads
snapshots on its own cadence, and an unregistered process pays nothing.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..analysis.guards import guarded_by
from ..analysis.witness import WITNESS
from ..logsetup import get_logger
from ..metrics import REGISTRY

log = get_logger("kube.coherence")

DIVERGENCES = REGISTRY.counter(
    "karpenter_informer_divergences_total",
    "Confirmed informer-cache divergences from the authoritative store, by"
    " object kind: the cache disagreed with a STATIC store even after the"
    " confirm re-read — a real coherence bug, never in-flight watch latency.",
    ("kind",),
)
CHECKS = REGISTRY.counter(
    "karpenter_coherence_checks_total",
    "Coherence-witness compare rounds, by result: 'clean' (cache == store),"
    " 'divergent' (confirmed mismatch), 'skipped' (the store moved during the"
    " compare, so a mismatch would be unattributable).",
    ("result",),
)

RESULT_CLEAN = "clean"
RESULT_DIVERGENT = "divergent"
RESULT_SKIPPED = "skipped"


def divergences_total() -> int:
    """Sum of confirmed divergences across kinds (score surface)."""
    return int(sum(DIVERGENCES.values().values()))


def _store_view(kube) -> Dict[str, Dict[str, object]]:
    """The authoritative snapshot in the witness's comparison shape."""
    from ..utils import pod as podutils

    nodes = {n.name: int(n.metadata.resource_version or 0) for n in kube.list_nodes()}
    bindings = {}
    for p in kube.list_pods():
        if p.spec.node_name and not podutils.is_terminal(p):
            bindings[f"{p.metadata.namespace}/{p.metadata.name}"] = p.spec.node_name
    return {"nodes": nodes, "bindings": bindings}


def _store_version(kube) -> int:
    """The store's global resourceVersion (both transports expose it)."""
    version = getattr(kube, "version", None)
    return int(version()) if version is not None else -1


def _gap_open(kube) -> bool:
    """True while an injected watch gap is suppressing this store's
    dispatch: the cache lagging a gapped store is the INTENDED chaos, not a
    coherence bug — the witness skips those rounds and judges the repair at
    gap close instead."""
    accessor = getattr(kube, "chaos_gap_open", None)
    return bool(accessor()) if accessor is not None else False


def _divergence_key(d: dict) -> tuple:
    return (d["cache"], d["kind"], d["what"], d["entity"])


def compare(name: str, cluster) -> List[dict]:
    """One raw deep-compare of a cache against its store. Returns mismatch
    records; raw results may include in-flight watch deliveries — only
    `check()`/`final_check()` decide what counts."""
    store = _store_view(cluster.kube)
    cache = cluster.coherence_view()
    out: List[dict] = []
    for node, rv in cache["nodes"].items():
        store_rv = store["nodes"].get(node)
        if store_rv is None:
            out.append({"cache": name, "kind": "Node", "what": "ghost", "entity": node,
                        "detail": f"cache holds node {node!r} the store deleted"})
        elif store_rv != rv:
            out.append({"cache": name, "kind": "Node", "what": "stale", "entity": node,
                        "detail": f"cache at resourceVersion {rv}, store at {store_rv}"})
    for node in store["nodes"]:
        if node not in cache["nodes"]:
            out.append({"cache": name, "kind": "Node", "what": "missing", "entity": node,
                        "detail": f"store node {node!r} never reached the cache"})
    for key, node in cache["bindings"].items():
        store_node = store["bindings"].get(key)
        if store_node is None:
            out.append({"cache": name, "kind": "Pod", "what": "ghost", "entity": key,
                        "detail": f"cache binds {key!r} to {node!r}; the store has no such binding"})
        elif store_node != node:
            out.append({"cache": name, "kind": "Pod", "what": "stale", "entity": key,
                        "detail": f"cache binds {key!r} to {node!r}, store to {store_node!r}"})
    for key in store["bindings"]:
        if key not in cache["bindings"]:
            out.append({"cache": name, "kind": "Pod", "what": "missing", "entity": key,
                        "detail": f"store binding {key!r} never reached the cache"})
    return out


@guarded_by("_lock", "_registered", "_last")
class CoherenceWitness:
    """The process-wide registry of informer caches under witness (the
    WITNESS/FLIGHT singleton pattern). `register()` is idempotent per name;
    a stopped/crashed Runtime deregisters what it registered — a dead
    control plane's cache must not keep being compared (or keep the cache
    object alive)."""

    def __init__(self):
        self._lock = WITNESS.lock("coherence.witness")
        self._registered: Dict[str, object] = {}  # name -> Cluster
        self._last: Optional[dict] = None  # last check result (read surface)

    def register(self, name: str, cluster) -> None:
        with self._lock:
            self._registered[name] = cluster

    def deregister(self, name: str) -> None:
        with self._lock:
            self._registered.pop(name, None)

    def registered(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._registered)

    def compare_registered(self) -> List[dict]:
        """One raw compare of every registered cache — the cheap predicate
        convergence loops poll (no confirm pass, nothing recorded)."""
        out: List[dict] = []
        for name, cluster in self.registered().items():
            out.extend(compare(name, cluster))
        return out

    def check(self, confirm_delay: float = 0.25) -> List[dict]:
        """One witnessed round per registered cache: raw compare, then — on
        a mismatch — the store-version guard and the confirm re-read. Only
        divergences that persist against a static store are counted and
        returned. Listing/sleeping happens OUTSIDE the registry lock (on
        the HTTP transport these are network round trips)."""
        confirmed: List[dict] = []
        registered = self.registered()
        for name, cluster in registered.items():
            if _gap_open(cluster.kube):
                CHECKS.inc(result=RESULT_SKIPPED)
                continue
            v1 = _store_version(cluster.kube)
            raw = compare(name, cluster)
            if not raw:
                CHECKS.inc(result=RESULT_CLEAN)
                continue
            cluster.clock.sleep(confirm_delay)
            if _gap_open(cluster.kube) or _store_version(cluster.kube) != v1:
                # the store moved mid-compare: the mismatch may be watch
                # delivery still in flight — unattributable, skip the round
                CHECKS.inc(result=RESULT_SKIPPED)
                continue
            keys = {_divergence_key(d) for d in raw}
            persisting = [d for d in compare(name, cluster) if _divergence_key(d) in keys]
            if not persisting:
                CHECKS.inc(result=RESULT_CLEAN)
                continue
            CHECKS.inc(result=RESULT_DIVERGENT)
            for d in persisting:
                DIVERGENCES.inc(kind=d["kind"])
                log.error("informer divergence: %s", d["detail"])
            confirmed.extend(persisting)
        with self._lock:
            self._last = {"divergences": confirmed, "caches": sorted(registered)}
        return confirmed

    def final_check(self, timeout: float = 3.0, poll: float = 0.05) -> List[dict]:
        """The teardown assertion: poll until every registered cache matches
        its store, or record + return the divergences still standing at the
        timeout. A quiesced run (every chaos suite's convergence point) must
        come back empty — the zero-cycles analog for informer coherence."""
        clusters = self.registered()
        if not clusters:
            return []
        clock = next(iter(clusters.values())).clock
        deadline = clock.now() + timeout
        raw: List[dict] = []
        while True:
            raw = self.compare_registered()
            if not raw:
                CHECKS.inc(result=RESULT_CLEAN)
                return []
            if clock.now() >= deadline:
                break
            clock.sleep(poll)
        CHECKS.inc(result=RESULT_DIVERGENT)
        for d in raw:
            DIVERGENCES.inc(kind=d["kind"])
            log.error("informer divergence at teardown: %s", d["detail"])
        with self._lock:
            self._last = {"divergences": raw, "caches": sorted(clusters)}
        return raw

    def snapshot(self) -> dict:
        """The /debug/coherence payload."""
        with self._lock:
            last = self._last
        by_kind = {}
        for key, value in DIVERGENCES.values().items():
            by_kind[key[0] or "N/A"] = int(value)
        return {
            "caches": sorted(self.registered()),
            "divergences_total": divergences_total(),
            "divergences_by_kind": by_kind,
            "checks": {key[0]: int(value) for key, value in CHECKS.values().items()},
            "last_check": last,
        }


COHERENCE = CoherenceWitness()


# -- HTTP routes (ObservabilityServer extra routes) ---------------------------


def _coherence_route(query: dict) -> tuple:
    return 200, "application/json; charset=utf-8", json.dumps(COHERENCE.snapshot(), indent=1) + "\n"


def routes() -> dict:
    """`/debug/coherence` for the metrics listener (cmd/controller.py wires
    it next to /debug/locks)."""
    return {"/debug/coherence": _coherence_route}


def route_descriptions() -> dict:
    """/debug-index descriptions, keyed like routes() (see tracing.py)."""
    return {
        "/debug/coherence": "informer-coherence witness: registered caches, confirmed divergences vs the store, last check",
    }
