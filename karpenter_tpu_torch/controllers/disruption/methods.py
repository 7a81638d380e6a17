"""Disruption methods: the candidate sources the orchestrator consults.

Each method proposes `DisruptionCommand`s — candidates plus a replacement
plan from a dense-solver re-simulation (the same simulated scheduling run
consolidation and the interruption controller's proactive re-solve use) —
and can re-assert its predicate just before execution (`still_valid`). No
method cordons, launches, or drains anything itself: the orchestrator owns
the serialized command queue, the budget ledger, and execution.

Methods:
  emptiness  — nodes past their provisioner's ttlSecondsAfterEmpty
               (the emptiness timestamp is stamped by the node lifecycle
               controller; this method only consumes it);
  expiration — nodes older than ttlSecondsUntilExpired, replaced via
               re-simulation when they still hold reschedulable pods;
  drift      — nodes whose launch-time spec-hash (the
               karpenter.sh/provisioner-hash annotation stamped by the
               provider) no longer matches their Provisioner's current
               template; flagged karpenter.sh/drifted and replaced.

Consolidation participates as a fourth source through
`ConsolidationController.propose()` (controllers/consolidation).

The port's copy of karpenter_tpu/controllers/disruption/methods.py. The
re-simulation is the provisioner's schedule() in simulation mode, so on the
card a batch of at least the solver's min_batch pods runs through K2 and,
for new nodes, K1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, List, Optional

from ...api import labels as lbl
from ...api.objects import Node
from ...api.provisioner import Provisioner
from ...logsetup import get_logger
from ...scheduler import SchedulerOptions
from ...utils import pod as podutils
from ..state.cluster import StateNode

log = get_logger("disruption")

METHOD_EMPTINESS = "emptiness"
METHOD_EXPIRATION = "expiration"
METHOD_DRIFT = "drift"
METHOD_CONSOLIDATION = "consolidation"


@dataclass
class DisruptionCommand:
    """One voluntary-disruption decision: candidates + replacement plan."""

    method: str
    nodes: List[Node]
    provisioner_name: str
    reason: str
    replacements: List[object] = field(default_factory=list)  # VirtualNodes to launch
    launched: List[str] = field(default_factory=list)  # launched replacement node names
    created_at: float = 0.0
    outcome: str = ""
    # the decision assumed the candidates were empty (emptiness method,
    # consolidation's empty fast path): re-validation must re-check it
    require_empty: bool = False
    # budget-blocked backoff: the command sleeps in the queue until this
    # time instead of re-attempting (and re-tracing) every pass
    blocked_until: float = 0.0
    # price of the candidate at decision time; consolidation-replace commands
    # re-check non-increasing pricing against this just before execution
    candidate_price: Optional[float] = None
    # the reference's open "disrupt" trace span; unused until the tracer is
    # ported (ROADMAP A8)
    trace_span: object = None
    trace_ctx: object = None

    def node_names(self) -> List[str]:
        return [n.name for n in self.nodes]


class MethodBase:
    """Shared candidate plumbing: walk owned/initialized/undeleted/
    un-nominated nodes of provisioners that opted into this method."""

    name = "base"

    def __init__(self, kube, cluster, provisioner_controller, clock):
        self.kube = kube
        self.cluster = cluster
        self.provisioner_controller = provisioner_controller
        self.clock = clock

    def _candidates(self, exclude: FrozenSet[str] = frozenset(), require_initialized: bool = True) -> List[StateNode]:
        """`exclude` is the orchestrator's busy set (already queued / charged
        / pending nodes): filtering here, before any re-simulation, is what
        keeps a parked replacement wait from re-solving the same candidates
        every pass just to discard the result at dedupe time.
        `require_initialized=False` (expiration only) also admits nodes that
        never finished initializing — the expiry clock runs from creation,
        and a never-initialized node would otherwise leak forever."""
        out: List[StateNode] = []

        def visit(state: StateNode) -> bool:
            node = state.node
            if node.name in exclude:
                return True
            if not state.owned() or (require_initialized and not state.initialized()):
                return True
            if node.metadata.deletion_timestamp is not None:
                return True
            if self.cluster.is_node_nominated(node.name):
                return True
            out.append(state)
            return True

        self.cluster.for_each_node(visit)
        return out

    def _provisioner_of(self, node: Node) -> Optional[Provisioner]:
        name = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
        if name is None:
            return None
        return self.kube.get("Provisioner", name, namespace="")

    def resimulate(self, node: Node) -> Optional[List[object]]:
        """Replacement plan: schedule the node's reschedulable pods with the
        node excluded (simulation mode — nothing launches here). Returns the
        populated VirtualNodes to open, [] when everything fits on existing
        capacity, or None when the pods would NOT reschedule (the node must
        not be disrupted)."""
        pods = [p for p in self.kube.pods_on_node(node.name) if podutils.is_reschedulable(p)]
        if not pods:
            return []
        results = self.provisioner_controller.schedule(
            pods,
            self.cluster.nodes_snapshot(),
            opts=SchedulerOptions(simulation_mode=True, exclude_nodes=[node.name]),
        )
        if results.unschedulable:
            return None
        return [vn for vn in results.new_nodes if vn.pods]

    def propose(self, exclude: FrozenSet[str] = frozenset()) -> List[DisruptionCommand]:  # pragma: no cover - interface
        raise NotImplementedError

    def still_valid(self, command: DisruptionCommand) -> Optional[str]:
        """Re-assert the method predicate just before execution; returns the
        invalidation reason, or None when the command may proceed."""
        return None


class EmptinessMethod(MethodBase):
    """ttlSecondsAfterEmpty deletion, consuming the emptiness timestamp the
    node lifecycle controller stamps (controllers/node). No replacement —
    an empty node frees capacity outright."""

    name = METHOD_EMPTINESS

    def _empty_past_ttl(self, node: Node, provisioner: Provisioner) -> bool:
        ttl = provisioner.spec.ttl_seconds_after_empty
        if ttl is None:
            return False
        stamp = node.metadata.annotations.get(lbl.EMPTINESS_TIMESTAMP_ANNOTATION)
        if stamp is None:
            return False
        return self.clock.now() - float(stamp) >= ttl

    def propose(self, exclude: FrozenSet[str] = frozenset()) -> List[DisruptionCommand]:
        out: List[DisruptionCommand] = []
        for state in self._candidates(exclude):
            provisioner = self._provisioner_of(state.node)
            if provisioner is None or not self._empty_past_ttl(state.node, provisioner):
                continue
            if not podutils.is_node_empty(self.kube.pods_on_node(state.name)):
                continue  # the stamp is stale; the lifecycle controller will clear it
            out.append(
                DisruptionCommand(
                    method=self.name,
                    nodes=[state.node],
                    provisioner_name=provisioner.name,
                    reason=f"empty past ttlSecondsAfterEmpty={provisioner.spec.ttl_seconds_after_empty:.0f}s",
                    created_at=self.clock.now(),
                    require_empty=True,
                )
            )
        return out

    def still_valid(self, command: DisruptionCommand) -> Optional[str]:
        for node in command.nodes:
            if not podutils.is_node_empty(self.kube.pods_on_node(node.name)):
                return f"node {node.name} is no longer empty"
        return None


class ExpirationMethod(MethodBase):
    """ttlSecondsUntilExpired replacement: expired nodes are rotated, with
    replacement capacity planned by re-simulation and launched (by the
    orchestrator) before the drain. Uninitialized nodes ARE candidates here
    (unlike every other method): the legacy node-controller path expired
    them regardless of initialization, and with no liveness reaper a
    never-initialized node would otherwise leak past its TTL forever."""

    name = METHOD_EXPIRATION

    def _expired(self, node: Node, provisioner: Provisioner) -> bool:
        ttl = provisioner.spec.ttl_seconds_until_expired
        if ttl is None:
            return False
        return self.clock.now() - node.metadata.creation_timestamp >= ttl

    def propose(self, exclude: FrozenSet[str] = frozenset()) -> List[DisruptionCommand]:
        out: List[DisruptionCommand] = []
        for state in self._candidates(exclude, require_initialized=False):
            provisioner = self._provisioner_of(state.node)
            if provisioner is None or not self._expired(state.node, provisioner):
                continue
            replacements = self.resimulate(state.node)
            if replacements is None:
                log.debug("expiration: %s expired but its pods would not reschedule; skipping", state.name)
                continue
            out.append(
                DisruptionCommand(
                    method=self.name,
                    nodes=[state.node],
                    provisioner_name=provisioner.name,
                    reason=f"expired past ttlSecondsUntilExpired={provisioner.spec.ttl_seconds_until_expired:.0f}s",
                    replacements=replacements,
                    created_at=self.clock.now(),
                )
            )
        return out

    def still_valid(self, command: DisruptionCommand) -> Optional[str]:
        return None  # expiry is monotonic; existence/eligibility are checked centrally


class DriftMethod(MethodBase):
    """Spec-hash drift: a node whose recorded launch hash
    (karpenter.sh/provisioner-hash) no longer matches its Provisioner's
    current template is flagged karpenter.sh/drifted and replaced. Nodes
    launched before the hash seam existed (no annotation) are unknowable
    and never flagged."""

    name = METHOD_DRIFT

    def _current_hash(self, provisioner: Provisioner, cache: Optional[dict] = None) -> str:
        """Current template digest; per-pass `cache` (provisioner name ->
        hash) keeps one template build + sha256 per PROVISIONER per pass
        instead of per node — the hash is identical across a provisioner's
        nodes and the orchestrator ticks every second."""
        if cache is not None and provisioner.name in cache:
            return cache[provisioner.name]
        from ...scheduling.nodetemplate import NodeTemplate

        digest = NodeTemplate.from_provisioner(provisioner).spec_hash()
        if cache is not None:
            cache[provisioner.name] = digest
        return digest

    def is_drifted(self, node: Node, cache: Optional[dict] = None) -> Optional[bool]:
        """True/False, or None when undetectable (no recorded hash or no
        provisioner to compare against)."""
        recorded = node.metadata.annotations.get(lbl.PROVISIONER_HASH_ANNOTATION)
        if recorded is None:
            return None
        provisioner = self._provisioner_of(node)
        if provisioner is None:
            return None
        return self._current_hash(provisioner, cache) != recorded

    def propose(self, exclude: FrozenSet[str] = frozenset()) -> List[DisruptionCommand]:
        out: List[DisruptionCommand] = []
        hash_cache: dict = {}
        # flag maintenance walks EVERY candidate (cheap: one hash per
        # provisioner via the cache) — a queued/busy node whose provisioner
        # reverted must still heal its karpenter.sh/drifted flag; only the
        # expensive re-simulation + command creation respect the busy set
        for state in self._candidates():
            drifted = self.is_drifted(state.node, hash_cache)
            flagged = state.node.metadata.annotations.get(lbl.DRIFTED_ANNOTATION) == "true"
            if drifted is None:
                continue
            if not drifted:
                if flagged:  # healed (provisioner reverted): clear the flag
                    del state.node.metadata.annotations[lbl.DRIFTED_ANNOTATION]
                    self.kube.update(state.node)
                continue
            if state.name in exclude:
                continue  # already queued/charged: no re-simulation
            if not flagged:
                state.node.metadata.annotations[lbl.DRIFTED_ANNOTATION] = "true"
                self.kube.update(state.node)
                log.info("node %s drifted from its provisioner spec; flagged for replacement", state.name)
            replacements = self.resimulate(state.node)
            if replacements is None:
                log.debug("drift: %s drifted but its pods would not reschedule; skipping", state.name)
                continue
            provisioner = self._provisioner_of(state.node)
            if provisioner is None:
                continue
            out.append(
                DisruptionCommand(
                    method=self.name,
                    nodes=[state.node],
                    provisioner_name=provisioner.name,
                    reason="spec hash drifted from provisioner template",
                    replacements=replacements,
                    created_at=self.clock.now(),
                )
            )
        return out

    def still_valid(self, command: DisruptionCommand) -> Optional[str]:
        for node in command.nodes:
            fresh = self.kube.get_node(node.name)
            if fresh is not None and self.is_drifted(fresh) is not True:
                return f"node {node.name} is no longer drifted"
        return None
