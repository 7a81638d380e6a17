"""Consolidation controller: delete or replace underutilized nodes.

Mirrors pkg/controllers/consolidation/controller.go — a polling loop gated on
cluster-epoch change and a stabilization window; candidates are initialized,
consolidation-enabled, non-nominated, non-annotated nodes; empty nodes are
deleted in one action; otherwise candidates are tried in ascending disruption
cost with a **simulated scheduling run** that excludes the node
(SchedulerOptions(simulation_mode=True, exclude_nodes=[node])):

  - all pods fit on other (existing/in-flight) nodes      -> DELETE
  - pods need exactly one new, cheaper node               -> REPLACE
    (price-filtered; spot->spot replacement is blocked since the spot
     market already chose this node)

This is the second consumer of the same scheduler core — and of the same TPU
dense path — proving the packer-plugin seam the reference establishes
(consolidation/controller.go:430-498). On the card, a what-if of at least
the solver's min_batch pods runs through K2 (the fill onto the other nodes)
and, when it needs a new node, K1.

The port's copy of karpenter_tpu/controllers/consolidation/controller.py.
Left out with the telemetry (ROADMAP A8): the trace spans around a pass,
the what-if and the action, and the metrics registry's families of
ConsolidationMetrics, which keeps its plain tallies. One change of cost, not
of outcome: a pass reads every candidate's pods from one scan of the store
(`_pods_by_node`), where the reference scans the whole store per candidate,
twice (kube.pods_on_node in _is_empty and _disruption_cost): on 2,000 nodes
of 72 pods that is 4,000 scans of 144,000 pods a pass.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ...api import labels as lbl
from ...api.objects import Node, Pod
from ...cloudprovider.types import CloudProvider, NodeRequest
from ...events import Recorder
from ...kube.cluster import KubeCluster
from ...scheduler import SchedulerOptions
from ...utils import pod as podutils
from ..state.cluster import Cluster, StateNode
from ...logsetup import get_logger
from ..disruption.eligibility import PDBLimits
from .helpers import disruption_cost, lifetime_remaining

log = get_logger("consolidation")


class ActionType(enum.Enum):
    DELETE = "delete"
    DELETE_EMPTY = "delete-empty"
    REPLACE = "replace"
    NO_ACTION = "no-action"


@dataclass
class ConsolidationAction:
    type: ActionType
    nodes: List[Node] = field(default_factory=list)
    replacement_name: Optional[str] = None
    reason: str = ""
    replacement: object = None  # the VirtualNode to launch for REPLACE


@dataclass
class ConsolidationMetrics:
    """Per-controller tallies (the reference's consolidation/metrics.go:35-72
    families, kept as plain numbers until the metrics registry is ported;
    tests/test_torch_consolidation.py's cluster_record holds them to the JAX
    package's)."""

    evaluations: int = 0
    nodes_terminated: int = 0
    nodes_created: int = 0
    actions: List[str] = field(default_factory=list)

    def record_created(self, n: int = 1) -> None:
        self.nodes_created += n

    def record_terminated(self, n: int = 1) -> None:
        self.nodes_terminated += n

    def record_action(self, action: str) -> None:
        self.actions.append(action)


class ConsolidationController:
    STABILIZATION_WINDOW = 300.0  # unsettled-cluster settle wait (controller.go:573-580)
    POLL_INTERVAL = 10.0
    # retry.Attempts(30) × Delay(2s)..MaxDelay(10s) ≈ 4.5 minutes total
    # (controller.go:341-345): a replacement that never initializes is abandoned
    REPLACE_READY_TIMEOUT = 270.0

    def __init__(
        self,
        kube: KubeCluster,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        provisioner_controller,
        recorder: Optional[Recorder] = None,
        clock=None,
    ):
        from ...utils.clock import Clock

        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.provisioner_controller = provisioner_controller
        self.recorder = recorder or Recorder()
        self.clock = clock or kube.clock or Clock()
        self.metrics = ConsolidationMetrics()
        self._last_epoch = -1
        self._pending_replace: Optional[ConsolidationAction] = None
        self._pending_deadline = 0.0

    # -- gating ---------------------------------------------------------------

    def stabilization_window(self) -> float:
        """0 when the cluster is settled, 5 minutes when it is converging
        (controller.go:573-580). The reference's settled test is "no pending
        pods and every ReplicaSet/RC/StatefulSet reports ready"; the object
        model here has no workload controllers, so the capacity-side analog is
        "no pending pods and every node is Ready and initialized" — both
        detect in-flight convergence that consolidation should not race."""
        if self.kube.pending_pods():
            return self.STABILIZATION_WINDOW
        for node in self.kube.list_nodes():
            if node.metadata.deletion_timestamp is not None:
                continue
            if not node.ready() or node.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) != "true":
                return self.STABILIZATION_WINDOW
        return 0.0

    def should_run(self) -> bool:
        epoch = self.cluster.consolidation_epoch()
        if epoch == self._last_epoch and self._pending_replace is None:
            return False
        if self._pending_replace is not None:
            # a parked replacement is the tail of an in-flight action, not a
            # new disruption — the reference completes it inside the same
            # ProcessCluster call, unconditioned on stabilization
            return True
        # stabilization: a settled cluster consolidates again immediately; a
        # churning one waits out the full window since the last node
        # creation/deletion (controller.go:96-103,573-580)
        now = self.clock.now()
        last_churn = max(self.cluster.last_node_creation_time(), self.cluster.last_node_deletion_time())
        settle = self.stabilization_window()
        if settle > 0 and last_churn > 0 and now - last_churn < settle:
            return False
        self._last_epoch = epoch
        return True

    # -- the pass --------------------------------------------------------------

    def process_cluster(self) -> ConsolidationAction:
        self.metrics.evaluations += 1
        return self._process_cluster()

    def _process_cluster(self) -> ConsolidationAction:
        # finish a replacement that was waiting on readiness; the wait is
        # bounded at ~4.5 minutes (controller.go:341-352) — a replacement that
        # never initializes is abandoned and the old node uncordoned so a
        # stuck launch cannot wedge all future consolidation
        pending = self._pending_replace
        if pending is not None:
            replacement = self.kube.get_node(pending.replacement_name) if pending.replacement_name else None
            if replacement is None:
                self._pending_replace = None  # replacement vanished; re-evaluate
                self._uncordon(pending.nodes)
            elif replacement.ready():
                self._pending_replace = None
                self._terminate(pending)
                return pending
            elif self.clock.now() >= self._pending_deadline:
                self._pending_replace = None
                self._uncordon(pending.nodes)
                # reap the never-ready launch: with no liveness reaper in the
                # node controller it would otherwise leak as phantom in-flight
                # capacity (and real money) forever
                self.kube.delete(replacement)
                log.warning(
                    "consolidation replace: timed out waiting for %s readiness; abandoning and reaping it",
                    pending.replacement_name,
                )
                return ConsolidationAction(ActionType.NO_ACTION, reason="replacement readiness timed out")
            else:
                self.recorder.waiting_on_readiness(replacement)
                return ConsolidationAction(ActionType.NO_ACTION, reason="waiting on replacement readiness")
        # any framework-owned node still initializing blocks the WHOLE pass
        # (controller.go:196-203,231): its in-flight capacity isn't in the
        # simulation, so every replace/delete decision would double-count
        if self._uninitialized_node_exists():
            return ConsolidationAction(ActionType.NO_ACTION, reason="uninitialized nodes exist")
        candidates = self.candidate_nodes()
        if not candidates:
            return ConsolidationAction(ActionType.NO_ACTION, reason="no candidates")

        # fast path: delete all empty candidates at once (controller.go:135-142)
        pods_by_node = self._pods_by_node()
        empty = [c for c in candidates if self._is_empty(c, pods_by_node)]
        if empty:
            action = ConsolidationAction(ActionType.DELETE_EMPTY, nodes=[c.node for c in empty], reason="empty nodes")
            self.perform(action)
            return action

        candidate, action = self._first_beneficial_action(candidates, PDBLimits(self.kube), pods_by_node)
        if action.type != ActionType.NO_ACTION:
            self.perform(action)
        return action

    def _first_beneficial_action(self, candidates, pdb: PDBLimits, pods_by_node: Dict[str, List[Pod]]):
        """The ascending-disruption-cost scan shared by standalone mode and
        the orchestrator's propose(): the first candidate whose simulated
        removal is beneficial wins (one non-empty action per pass). Returns
        (candidate, action); candidate is None on NO_ACTION."""
        for candidate in sorted(candidates, key=lambda c: self._disruption_cost(c, pods_by_node.get(c.name, []))):
            pods = pods_by_node.get(candidate.name, [])
            if self._can_terminate(candidate, pods, pdb) is not None:
                continue
            action = self._replace_or_delete(candidate, pods)
            if action.type != ActionType.NO_ACTION:
                return candidate, action
        return None, ConsolidationAction(ActionType.NO_ACTION, reason="no beneficial action")

    def _uninitialized_node_exists(self) -> bool:
        """An owned node still warming up blocks the pass (controller.go:196-203).
        Past REPLACE_READY_TIMEOUT the call is made on cloud-provider instance
        liveness, not wall clock alone: an instance that still exists but never
        registered (a large TPU slice can legitimately boot longer than the
        replace window) keeps blocking, while a launch whose instance is gone
        must not wedge consolidation forever. Providers that cannot answer
        (instance_exists → None) fall back to the age-based escape."""
        blocked = False

        def visit(state: StateNode) -> bool:
            nonlocal blocked
            node = state.node
            if not state.owned() or state.initialized() or node.metadata.deletion_timestamp is not None:
                return True
            if self.clock.now() - node.metadata.creation_timestamp >= self.REPLACE_READY_TIMEOUT:
                if not self.cloud_provider.instance_exists(node):
                    return True  # instance gone (or unknowable): stuck, not warming
            blocked = True
            return False

        self.cluster.for_each_node(visit)
        return blocked

    def candidate_nodes(self) -> List[StateNode]:
        out: List[StateNode] = []

        def visit(state: StateNode) -> bool:
            node = state.node
            name = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
            if name is None:
                return True
            provisioner = self.kube.get("Provisioner", name, namespace="")
            if provisioner is None or provisioner.spec.consolidation is None or not provisioner.spec.consolidation.enabled:
                return True
            if node.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) != "true":
                return True
            if node.metadata.annotations.get(lbl.DO_NOT_CONSOLIDATE_ANNOTATION) == "true":
                return True
            if self.cluster.is_node_nominated(node.name):
                return True
            if node.metadata.deletion_timestamp is not None:
                return True
            out.append(state)
            return True

        self.cluster.for_each_node(visit)
        return out

    def _pods_by_node(self) -> Dict[str, List[Pod]]:
        """Each node's pods, as kube.pods_on_node gives them (the store's
        order), from one scan of the store."""
        out: Dict[str, List[Pod]] = {}
        for pod in self.kube.list_pods():
            if pod.spec.node_name:
                out.setdefault(pod.spec.node_name, []).append(pod)
        return out

    def _is_empty(self, state: StateNode, pods_by_node: Dict[str, List[Pod]]) -> bool:
        return podutils.is_node_empty(pods_by_node.get(state.name, []))

    def _disruption_cost(self, state: StateNode, pods: Optional[List[Pod]] = None) -> float:
        name = state.node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
        provisioner = self.kube.get("Provisioner", name, namespace="") if name else None
        ttl = provisioner.spec.ttl_seconds_until_expired if provisioner else None
        if pods is None:
            pods = self.kube.pods_on_node(state.name)
        return disruption_cost(pods, lifetime_remaining(self.clock, state.node, ttl))

    def _can_terminate(self, state: StateNode, pods, pdb: PDBLimits) -> Optional[str]:
        # the gate shared with every other disruption method (eligibility.py):
        # PDBs at their limit, do-not-disrupt/do-not-evict pods, ownerless pods
        from ..disruption.eligibility import pod_ineligible_reason

        return pod_ineligible_reason(pods, pdb)

    # -- candidate-source mode (the disruption orchestrator) ---------------------

    def propose(self, pdb: Optional[PDBLimits] = None, exclude: frozenset = frozenset()) -> list:
        """Pure candidate-source mode: the same decision pipeline as
        process_cluster — empty fast path, then the shared
        _first_beneficial_action scan — but nothing is cordoned, launched,
        or terminated here. The disruption orchestrator owns budgets, the
        validated command queue, and execution; this method only PROPOSES.
        `pdb` is the orchestrator's per-pass shared PDB snapshot (built here
        only when called standalone); `exclude` is its busy set, filtered
        BEFORE any simulation so queued candidates are not re-solved."""
        from ..disruption.methods import METHOD_CONSOLIDATION, DisruptionCommand

        self.metrics.evaluations += 1
        if self._uninitialized_node_exists():
            return []
        candidates = [c for c in self.candidate_nodes() if c.name not in exclude]
        if not candidates:
            return []
        commands = []
        pods_by_node = self._pods_by_node()
        empty = [c for c in candidates if self._is_empty(c, pods_by_node)]
        if empty:
            # ONE command per node, not one grouped command: a command
            # larger than the provisioner's budget could never clear the
            # in_flight + len(nodes) <= limit gate and would livelock in
            # the queue; per-node commands let the budget pace them
            for c in empty:
                commands.append(
                    DisruptionCommand(
                        method=METHOD_CONSOLIDATION,
                        nodes=[c.node],
                        provisioner_name=c.node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL, ""),
                        reason="empty nodes",
                        created_at=self.clock.now(),
                        # the decision is ONLY sound while the node holds
                        # no reschedulable pods; execution must re-check
                        require_empty=True,
                    )
                )
            return commands
        candidate, action = self._first_beneficial_action(candidates, pdb or PDBLimits(self.kube), pods_by_node)
        if action.type != ActionType.NO_ACTION:
            commands.append(
                DisruptionCommand(
                    method=METHOD_CONSOLIDATION,
                    nodes=action.nodes,
                    provisioner_name=candidate.node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL, ""),
                    reason=action.reason,
                    replacements=[action.replacement] if action.replacement is not None else [],
                    candidate_price=self._node_price(candidate) if action.replacement is not None else None,
                    created_at=self.clock.now(),
                )
            )
        return commands

    # -- the simulated scheduling decision --------------------------------------

    def _replace_or_delete(self, candidate: StateNode, pods) -> ConsolidationAction:
        """Simulate scheduling the node's pods with the node gone
        (controller.go:430-498)."""
        reschedulable = [p for p in pods if not podutils.is_owned_by_daemonset(p) and not podutils.is_terminal(p)]
        state_nodes = self.cluster.nodes_snapshot()
        results = self.provisioner_controller.schedule(
            reschedulable,
            state_nodes,
            opts=SchedulerOptions(simulation_mode=True, exclude_nodes=[candidate.name]),
        )
        if results.unschedulable:
            return ConsolidationAction(ActionType.NO_ACTION, reason="pods would not reschedule")
        if not results.new_nodes or all(not n.pods for n in results.new_nodes):
            return ConsolidationAction(ActionType.DELETE, nodes=[candidate.node], reason="pods fit on other nodes")
        populated = [n for n in results.new_nodes if n.pods]
        if len(populated) > 1:
            return ConsolidationAction(ActionType.NO_ACTION, reason="would need multiple replacement nodes")

        replacement = populated[0]
        current_price = self._node_price(candidate)
        if current_price is None:
            return ConsolidationAction(ActionType.NO_ACTION, reason="unknown node price")
        # only consider strictly cheaper types (price filter, :475)
        cheaper = [it for it in replacement.instance_type_options if it.price() < current_price]
        if not cheaper:
            return ConsolidationAction(ActionType.NO_ACTION, reason="no cheaper replacement")
        # spot -> spot replacement is blocked: the spot market already picked
        # this allocation and churn risks capacity (:483-487)
        if candidate.node.metadata.labels.get(lbl.LABEL_CAPACITY_TYPE) == lbl.CAPACITY_TYPE_SPOT:
            ct = replacement.requirements.get(lbl.LABEL_CAPACITY_TYPE)
            if ct.has(lbl.CAPACITY_TYPE_SPOT):
                return ConsolidationAction(ActionType.NO_ACTION, reason="spot-to-spot replacement blocked")
        replacement.instance_type_options = cheaper
        return ConsolidationAction(
            ActionType.REPLACE,
            nodes=[candidate.node],
            reason=f"replace with cheaper node ({cheaper[0].name()})",
            replacement=replacement,
        )

    def _node_price(self, state: StateNode) -> Optional[float]:
        from ...cloudprovider.types import lookup_instance_type

        it = lookup_instance_type(self.cloud_provider, state.node, self.kube.list_provisioners())
        return it.price() if it is not None else None

    # -- execution ----------------------------------------------------------------

    def perform(self, action: ConsolidationAction) -> None:
        if action.type == ActionType.NO_ACTION:
            return
        if action.type == ActionType.REPLACE:
            # cordon the outgoing node before launching so new pods cannot
            # land on it while the replacement converges (controller.go:310-312)
            self._cordon(action.nodes)
            replacement = action.replacement
            try:
                node = self.cloud_provider.create(
                    NodeRequest(template=replacement.template, instance_type_options=replacement.instance_type_options)
                )
                self.kube.create(node)
            except Exception:
                # launch failed: restore schedulability before surfacing the
                # error (controller.go:321-325 uncordons on launch failure)
                self._uncordon(action.nodes)
                raise
            action.replacement_name = node.name
            log.info("consolidation replace: launching %s to replace %s (%s)", node.name, ", ".join(n.name for n in action.nodes), action.reason)
            self.metrics.record_created()
            # nominate so emptiness/other consolidation passes don't reap the
            # replacement before the old node's pods migrate to it
            self.cluster.nominate_node_for_pod(node.name)
            # wait for the replacement to go Ready before disrupting the old
            # node (controller.go:304-352); fake/capacity-backed nodes are
            # Ready on creation, real providers converge via node events —
            # the action parks as pending and process_cluster finishes it
            if not node.ready():
                self.recorder.waiting_on_readiness(node)
                self._pending_replace = action
                self._pending_deadline = self.clock.now() + self.REPLACE_READY_TIMEOUT
                return
        self._terminate(action)

    def _cordon(self, nodes: Sequence[Node]) -> None:
        for node in nodes:
            if not node.spec.unschedulable:
                node.spec.unschedulable = True
                self.kube.update(node)

    def _uncordon(self, nodes: Sequence[Node]) -> None:
        for stale in nodes:
            # re-fetch: the cached copy may be gone or superseded by the time
            # a parked action unwinds
            node = self.kube.get_node(stale.name)
            if node is None:
                continue
            # a node already being deleted stays cordoned (controller.go:584-586)
            if node.spec.unschedulable and node.metadata.deletion_timestamp is None:
                node.spec.unschedulable = False
                self.kube.update(node)

    def _terminate(self, action: ConsolidationAction) -> None:
        for node in action.nodes:
            log.info("consolidation %s: terminating %s (%s)", action.type.value, node.name, action.reason)
            self.recorder.terminating_node(node, f"consolidation: {action.reason}")
            self.kube.delete(node)
            self.metrics.record_terminated()
        self.metrics.record_action(action.type.value)
