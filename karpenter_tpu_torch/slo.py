"""SLO accounting: end-to-end behavioral metrics for the running Runtime.

The solver headline (BENCH_*.json) scores how fast one solve is; this layer
scores what users of the cluster actually experience while the Runtime runs:

- **pod pending latency** — creation to bind, per provisioner. The watch
  stream is the source of truth: a pod enters the pending set when it is
  seen unbound, and observes exactly once when its binding lands. A pod
  deleted while still Pending observes nothing and leaves nothing behind
  (the pendingPods semantics of controllers/metrics/pod.py).
- **time-to-node-ready** — node object creation to the kubelet's Ready flip,
  per provisioner: the launch-pipeline half of pending latency.
- **cluster cost** — live $/hr of provisioned capacity, plus a drift ratio
  against an *ideal fresh repack* (what the same bound workload would cost if
  re-solved onto empty state), maintained by the SLOScraper controller
  (controllers/metrics/slo.py). Drift creeping up across a disruption wave
  is the behavioral regression the bespoke storm tests could not score.
- **disruption churn** — nodes torn down by reason, and pods displaced from
  terminating/cordoned capacity.

Design constraints match tracing.py exactly:

- **disabled == free**: OFF by default; the watch hooks exist only after
  `attach()`, and every hook's disabled path is one attribute read — no
  per-pod state, no allocations (the overhead-guard bar in tests/test_slo.py).
- **zero deps, bounded memory**: the pending sets shrink as pods bind or
  die; `reset()` drops everything between campaign scenarios so each run
  scores only its own observations.
- **one read surface**: `/debug/slo` on the metrics listener serves
  `snapshot()` as JSON (wired behind `--enable-slo` in cmd/controller.py);
  the same families export through `/metrics` for scrapers.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, Optional

from .api import labels as lbl
from .journal import JOURNAL
from .metrics import REGISTRY

NOT_APPLICABLE = "N/A"

QUANTILES = (0.5, 0.95, 0.99)

# registered at import so gen_docs sees the families without a live tracker
PENDING_LATENCY = REGISTRY.summary(
    "karpenter_slo_pod_pending_duration_seconds",
    "Seconds from pod creation until the pod is bound to a node, per provisioner.",
    ("provisioner",),
    objectives=QUANTILES,
)
NODE_READY = REGISTRY.summary(
    "karpenter_slo_node_ready_duration_seconds",
    "Seconds from node creation until the node reports Ready, per provisioner.",
    ("provisioner",),
    objectives=QUANTILES,
)
PENDING_PODS = REGISTRY.gauge(
    "karpenter_slo_pending_pods",
    "Pods currently waiting for a binding (the live pending set).",
)
CLUSTER_COST = REGISTRY.gauge(
    "karpenter_slo_cluster_cost_per_hour",
    "Hourly price of all provisioned capacity at current offering prices.",
)
IDEAL_COST = REGISTRY.gauge(
    "karpenter_slo_ideal_cost_per_hour",
    "Hourly price of an ideal fresh repack of the currently bound workload onto empty state.",
)
COST_DRIFT = REGISTRY.gauge(
    "karpenter_slo_cost_drift_ratio",
    "Actual cluster cost over the ideal fresh-repack cost (1.0 = no drift).",
)
NODES_CHURNED = REGISTRY.counter(
    "karpenter_slo_nodes_churned_total",
    "Nodes removed from the cluster, by disruption reason (interruption, drift, emptiness, other).",
    ("reason",),
)
PODS_DISPLACED = REGISTRY.counter(
    "karpenter_slo_pods_displaced_total",
    "Pods deleted off terminating, cordoned, or vanished nodes (disruption fallout, not scale-down).",
)


def classify_churn(node) -> str:
    """Why did this node go away? Read off the state the disruption pipeline
    stamps: the interruption taint, the drift flag, the emptiness stamp."""
    if any(t.key == lbl.TAINT_INTERRUPTION for t in node.spec.taints):
        return "interruption"
    if node.metadata.annotations.get(lbl.DRIFTED_ANNOTATION):
        return "drift"
    if lbl.EMPTINESS_TIMESTAMP_ANNOTATION in node.metadata.annotations:
        return "emptiness"
    return "other"


class SLOAccountant:
    """Watch-driven latency bookkeeping + the /debug/slo snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        # allocated on enable(), never before — "disabled is a true no-op"
        self._pending: Optional[Dict[str, float]] = None  # pod uid -> creation ts
        self._nodes_becoming_ready: Optional[Dict[str, float]] = None  # node name -> creation ts

    # -- lifecycle -----------------------------------------------------------

    def enable(self) -> None:
        with self._lock:
            if self._pending is None:
                self._pending = {}
                self._nodes_becoming_ready = {}
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop live state AND this layer's metric families (campaign
        scenarios score per-run; keeps the enabled flag)."""
        with self._lock:
            if self._pending is not None:
                self._pending.clear()
                self._nodes_becoming_ready.clear()
        for family in (PENDING_LATENCY, NODE_READY, NODES_CHURNED, PODS_DISPLACED):
            family.clear()
        for gauge in (PENDING_PODS, CLUSTER_COST, IDEAL_COST, COST_DRIFT):
            gauge.clear()

    def attach(self, kube) -> None:
        """Wire the pod/node watch hooks onto a cluster backend. Idempotent
        per backend; replay is skipped so attaching mid-flight only accounts
        pods created from here on (a restart must not observe stale ages).
        The marker lives ON the backend object (not in an id() set here):
        CPython recycles object ids, and a stale id entry would silently
        skip attaching to a fresh cluster."""
        with self._lock:
            if getattr(kube, "_slo_attached", False):
                return
            kube._slo_attached = True
        kube.watch("Pod", lambda event: self._on_pod_event(kube, event), replay=False)
        kube.watch("Node", lambda event: self._on_node_event(kube, event), replay=False)

    # -- watch hooks ---------------------------------------------------------

    def _on_pod_event(self, kube, event) -> None:
        if not self.enabled:
            return
        pod = event.obj
        uid = pod.uid
        terminal = event.type == "DELETED" or pod.status.phase in ("Succeeded", "Failed")
        if terminal:
            with self._lock:
                was_pending = self._pending.pop(uid, None) is not None
                PENDING_PODS.set(float(len(self._pending)))
            # a pod deleted while still Pending records NO observation — and
            # a bound pod torn off dying capacity counts as displaced
            if not was_pending and pod.spec.node_name and event.type == "DELETED":
                node = kube.get_node(pod.spec.node_name)
                if node is None or node.metadata.deletion_timestamp is not None or node.spec.unschedulable:
                    PODS_DISPLACED.inc()
            return
        if not pod.spec.node_name:
            with self._lock:
                if uid not in self._pending:
                    self._pending[uid] = pod.metadata.creation_timestamp or kube.clock.now()
                    PENDING_PODS.set(float(len(self._pending)))
            return
        with self._lock:
            start = self._pending.pop(uid, None)
            PENDING_PODS.set(float(len(self._pending)))
        if start is None:
            return  # bound before we ever saw it pending (attach mid-flight)
        # the interval ends at the bind verb's authoritative stamp, NOT at
        # this handler's dispatch time: on the HTTP transport the node lookup
        # below is a network round trip that must not inflate the latency
        # (and the journal's waterfall conserves against this same stamp)
        end = pod.status.start_time if pod.status.start_time is not None else kube.clock.now()
        node = kube.get_node(pod.spec.node_name)
        if node is not None:
            provisioner = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL, NOT_APPLICABLE)
        else:
            provisioner = pod.spec.node_selector.get(lbl.PROVISIONER_NAME_LABEL, NOT_APPLICABLE)
        observed = max(0.0, end - start)
        PENDING_LATENCY.observe(observed, provisioner=provisioner)
        if JOURNAL.enabled:
            # cross-feed the journal's waterfall: the conservation invariant
            # checks the per-segment decomposition against THIS independent
            # measurement of the same creation->bind interval
            JOURNAL.note_observed_pending(pod.metadata.name, observed)

    def _on_node_event(self, kube, event) -> None:
        if not self.enabled:
            return
        node = event.obj
        provisioner = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL, NOT_APPLICABLE)
        if event.type == "DELETED":
            with self._lock:
                self._nodes_becoming_ready.pop(node.name, None)
            NODES_CHURNED.inc(reason=classify_churn(node))
            return
        ready = node.ready()
        if event.type == "ADDED":
            start = node.metadata.creation_timestamp or kube.clock.now()
            if ready:
                # born Ready (the fake provider's nodes): time-to-ready is
                # whatever already elapsed, usually ~0
                NODE_READY.observe(max(0.0, kube.clock.now() - start), provisioner=provisioner)
                return
            with self._lock:
                self._nodes_becoming_ready.setdefault(node.name, start)
            return
        if not ready:
            return
        with self._lock:
            start = self._nodes_becoming_ready.pop(node.name, None)
        if start is not None:
            NODE_READY.observe(max(0.0, kube.clock.now() - start), provisioner=provisioner)

    # -- read surface ----------------------------------------------------------

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending) if self._pending is not None else 0

    @staticmethod
    def _quantile_block(summary) -> dict:
        out = {}
        for labels in summary.series():
            provisioner = labels.get("provisioner") or NOT_APPLICABLE
            entry = {"count": summary.count(**labels), "sum_seconds": round(summary.sum(**labels), 6)}
            for q in QUANTILES:
                value = summary.quantile(q, **labels)
                entry[f"p{int(q * 100)}"] = None if math.isnan(value) else round(value, 6)
            out[provisioner] = entry
        return out

    def snapshot(self) -> dict:
        """The /debug/slo payload: live pending set, per-provisioner latency
        quantiles, cost gauges, churn counters."""
        return {
            "enabled": self.enabled,
            "pending_pods": self.pending_count(),
            "pod_pending_latency_seconds": self._quantile_block(PENDING_LATENCY),
            "node_ready_seconds": self._quantile_block(NODE_READY),
            "cost": {
                "cluster_cost_per_hour": round(CLUSTER_COST.value(), 6),
                "ideal_cost_per_hour": round(IDEAL_COST.value(), 6),
                "cost_drift_ratio": round(COST_DRIFT.value(), 6),
            },
            "churn": {
                "nodes_churned": {labels[0] or "other": value for labels, value in NODES_CHURNED.values().items()},
                "pods_displaced": PODS_DISPLACED.value(),
            },
        }


# the process-wide instance (the TRACER analog): the Runtime enables and
# attaches it behind --enable-slo; campaigns reset it between scenarios
SLO = SLOAccountant()


def enabled() -> bool:
    return SLO.enabled


# -- HTTP route (ObservabilityServer extra routes) ----------------------------


def _slo_route(query: dict) -> tuple:
    return 200, "application/json; charset=utf-8", json.dumps(SLO.snapshot()) + "\n"


def routes() -> dict:
    """The SLO read surface, served from the metrics listener alongside the
    tracing/profiling endpoints (cmd/controller.py wires it behind
    --enable-slo)."""
    return {"/debug/slo": _slo_route}


def route_descriptions() -> dict:
    """/debug-index descriptions, keyed like routes() (see tracing.py)."""
    return {
        "/debug/slo": "SLO snapshot: pending-latency/time-to-ready quantiles, cluster $/hr, cost drift, churn",
    }
