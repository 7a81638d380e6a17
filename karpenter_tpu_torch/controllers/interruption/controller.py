"""Interruption controller: queue-fed proactive drain with pre-provisioned
replacement capacity.

The analog of the reference's SQS-fed interruption controller (its single
biggest post-v0.15 robustness feature): poll the cloud's notification queue,
parse the message taxonomy (messages.py), map the instance id to a node
through cluster state, and act —

  spot_interruption / scheduled_maintenance (capacity WILL vanish):
    1. cordon + taint the victim so nothing new lands on it;
    2. PROACTIVELY SOLVE: run a provisioning round for the victim's
       reschedulable pods with the victim excluded, and launch the result —
       replacement capacity is booting while the 2-minute warning window
       ticks (the fast dense re-solve is what makes this feasible at all);
    3. hand the node to the termination controller (kube delete + the
       drain/finalize protocol it already owns).
  rebalance_recommendation (elevated risk, no deadline): cordon only.
  instance_stopped / instance_terminated (capacity ALREADY gone):
    garbage-collect the node immediately.

Delivery-contract obligations (the queue is at-least-once):
  - a malformed payload is counted, left UNDELETED, and dead-letters after
    the redrive threshold — it must never wedge the loop;
  - a duplicate delivery (same message id, or a second notice for a node
    already being handled) is idempotent: the action short-circuits and the
    message is deleted;
  - a notice for an unknown / already-deleted instance deletes cleanly.

Every handled message is deleted by receipt handle; the new counters
(messages_received{kind}, messages_deleted, message_parse_errors,
actions_performed{action}, dead_letter_depth) make the loop observable.

The port's copy of karpenter_tpu/controllers/interruption/controller.py. One
deliberate difference: the reference logs and swallows any exception of a
message's handling. Here, where the proactive re-solve
(`provisioner.schedule`, which runs the solve on the card) raises, the
victim's one-solve claim is cleared and the message is left undeleted for
redelivery; a solver fault (solver/faults.py: a `SolverFault`, an open
breaker's included) is logged, as the reference does, and the redelivered
notice solves again on the card, while any other exception, a device-lost
the card raised included (faults.ends_the_loop), leaves poll_once(), so it
never hides behind a log line. Every other failure of a
message's handling is still logged and left for redelivery; the cordon
writes through the backend's retry_on_conflict, so a conflict no retry
absorbed is one such failure.

A second deliberate difference: the pods a re-solve places are neither
bound nor counted in cluster state until their successors bind, so in the
reference each notice of a wave re-solves on a snapshot that shows the room
earlier notices booked as free again, books it twice and books their
replacements as empty nodes; and a notice handled between a provisioning
round's nominations and their binds books the round's room again. Here
every launch enters its (node name, pods) pairs in cluster state's record
of nominations (`Cluster.nominate_pods`, from `launch_nodes`), and every
re-solve counts the record's live pairs on its snapshot
(`ProvisionerController.nominated_snapshot`) and in its topology domains
(`schedule(nominated=)`), each pod once, at the node it was last nominated
on. An entry leaves once its pod is bound there, once its node is gone from
cluster state or once the cluster's nomination window
(`Cluster.nomination_ttl`) has passed since the nomination; a successor
bound inside that window is counted twice, which can only cost a later
re-solve an extra launch, never an over-booked node.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ...analysis import WITNESS, guarded_by
from ...api import labels as lbl
from ...api.objects import Node
from ...events import Recorder
from ...kube.cluster import KubeCluster
from ...logsetup import get_logger
from ...metrics import REGISTRY
from ...scheduler import SchedulerOptions
from ...solver.faults import SolverFault, ends_the_loop
from ...tracing import TRACER
from ...utils import pod as podutils
from ..edits import cordon
from ..state.cluster import Cluster
from .messages import (
    ACTION_CORDON,
    ACTION_CORDON_AND_DRAIN,
    ACTION_GARBAGE_COLLECT,
    ACTION_NO_OP,
    InterruptionMessage,
    MessageParseError,
    parse,
)

log = get_logger("interruption")

# the cordon + taint, idempotent: a cordoned node that lacks the taint gets it
_CORDON = cordon(lbl.TAINT_INTERRUPTION, retaint=True)

# how long a handled message id is remembered for duplicate suppression;
# comfortably above the queue's visibility timeout so every redelivery of a
# deleted-but-raced message short-circuits
HANDLED_TTL = 600.0


class _ReSolveFault(Exception):
    """Carries an exception of the proactive re-solve (its __cause__) past
    poll_once()'s per-message handler."""


@guarded_by("_lock", "_handled", "_replaced")
class InterruptionController:
    MAX_MESSAGES = 10

    def __init__(
        self,
        kube: KubeCluster,
        cluster: Cluster,
        provisioner,
        queue,
        termination=None,
        recorder: Optional[Recorder] = None,
        clock=None,
        cloud_provider=None,
    ):
        from ...utils.clock import Clock

        self.kube = kube
        self.cluster = cluster
        self.provisioner = provisioner  # ProvisionerController: the proactive solve
        self.queue = queue  # NotificationQueue or CloudAPIClient (duck-typed)
        self.termination = termination  # TerminationController: the drain handoff
        # offering-health feed: providers exposing mark_offering_unavailable
        # get the victim's pool quarantined BEFORE the proactive re-solve
        self.cloud_provider = cloud_provider
        self.recorder = recorder or Recorder()
        self.clock = clock or (kube.clock if kube is not None else None) or Clock()
        self._lock = WITNESS.lock("interruption.controller")
        self._handled: dict = {}  # message_id -> expiry (duplicate suppression)
        self._replaced: dict = {}  # node name -> expiry (one proactive solve per victim)
        self.messages_received = REGISTRY.counter(
            "karpenter_interruption_messages_received",
            "Interruption queue messages received, by parsed kind ('malformed' for parse failures)",
            ("kind",),
        )
        self.messages_deleted = REGISTRY.counter(
            "karpenter_interruption_messages_deleted", "Interruption queue messages deleted after handling"
        )
        self.message_parse_errors = REGISTRY.counter(
            "karpenter_interruption_message_parse_errors",
            "Interruption queue payloads that failed to parse (left to dead-letter)",
        )
        self.actions_performed = REGISTRY.counter(
            "karpenter_interruption_actions_performed",
            "Actions taken on interruption notices",
            ("action",),
        )
        self.dead_letter_depth = REGISTRY.gauge(
            "karpenter_interruption_dead_letter_depth", "Depth of the interruption queue's dead-letter list"
        )

    # -- the poll loop body --------------------------------------------------

    def poll_once(self, wait_seconds: float = 0.0) -> int:
        """One receive/handle/delete round; returns messages received, or
        -1 when the receive itself failed (so callers can back off instead
        of hammering a dead transport). Transport failures are survivable —
        the queue is at-least-once, so anything missed redelivers. An
        exception of a proactive re-solve other than a held solver fault
        (faults.ends_the_loop) is raised here, after the rest of the message's handling was skipped
        (it stays on the queue, as a solver fault's does)."""
        try:
            messages = self.queue.receive_messages(max_messages=self.MAX_MESSAGES, wait_seconds=wait_seconds)
        except Exception as err:  # noqa: BLE001 - the loop must outlive the transport
            log.warning("interruption queue receive failed (will retry): %s", err)
            return -1
        for message in messages:
            fault = None
            try:
                self._handle(message)
            except _ReSolveFault as wrapped:
                fault = wrapped.__cause__
            except Exception:  # noqa: BLE001 - one bad message must not stall the rest
                log.exception("handling interruption message %s failed; left for redelivery", message.message_id)
            if isinstance(fault, SolverFault) and not ends_the_loop(fault):
                log.warning(
                    "interruption message %s held by a %s fault; left for redelivery: %s", message.message_id, fault.kind, fault
                )
            elif fault is not None:
                raise fault
        try:
            self.dead_letter_depth.set(float(self.queue.dead_letter_depth()))
        except Exception as err:  # noqa: BLE001 - observability only
            log.debug("dead-letter depth scrape failed (gauge unchanged): %s", err)
        return len(messages)

    # -- message handling ----------------------------------------------------

    def _handle(self, received) -> None:
        try:
            msg = parse(received.body)
        except MessageParseError as err:
            # counted and left on the queue: redelivery runs the redrive
            # policy and the payload lands in the dead-letter list, where an
            # operator can inspect it (deleting here would erase the evidence)
            self.message_parse_errors.inc()
            self.messages_received.inc(kind="malformed")
            log.warning("unparseable interruption message %s: %s", received.message_id, err)
            return
        self.messages_received.inc(kind=msg.kind)
        if self._already_handled(received.message_id):
            # at-least-once redelivery of something we acted on: the world
            # is already in the target state, just re-delete
            self._delete(received)
            return
        node = self._node_of(msg.instance_id)
        action = msg.action()
        if node is None:
            # unknown or already-deleted instance: the notice is moot
            log.info("interruption notice %s for unknown instance %s: no-op", msg.kind, msg.instance_id)
            self.actions_performed.inc(action=ACTION_NO_OP)
            self._mark_handled(received.message_id)
            self._delete(received)
            return
        # one trace per acted-on notice: cordon -> re-solve -> replacement
        # launch -> drain handoff all share the trace ID, and the deadline
        # attrs make the 2-minute warning budget auditable span by span
        with TRACER.span(
            "interruption-notice", controller="interruption", kind=msg.kind, instance=msg.instance_id,
            node=node.name, action=action,
            deadline_remaining_s=round(msg.deadline - self.clock.now(), 3) if msg.deadline else None,
        ):
            if msg.kind == "spot_interruption":
                # the pool the cloud is reclaiming FROM is the worst
                # candidate for the replacement: quarantine it in the
                # unavailable-offerings cache before the proactive re-solve
                # prices the replacement universe
                self._mark_reclaimed_offering(node)
            self.recorder.node_interrupted(node, msg.kind, self._describe(msg))
            if action == ACTION_GARBAGE_COLLECT:
                self._garbage_collect(node)
            elif action == ACTION_CORDON:
                with TRACER.span("cordon", node=node.name):
                    self._cordon(node)
            elif action == ACTION_CORDON_AND_DRAIN:
                self._cordon_and_drain(node, msg)
        self.actions_performed.inc(action=action)
        self._mark_handled(received.message_id)
        self._delete(received)

    def _mark_reclaimed_offering(self, node: Node) -> None:
        """Quarantine the victim's (instance-type, zone, capacity-type)
        pool: a spot pool the cloud is actively draining will reclaim a
        fresh launch just as fast, so the replacement must route around it
        until the unavailable-offering TTL expires. Providers without the
        hook (the fake provider) no-op."""
        mark = getattr(self.cloud_provider, "mark_offering_unavailable", None)
        if mark is None:
            return
        labels = node.metadata.labels
        type_name = labels.get(lbl.LABEL_INSTANCE_TYPE)
        zone = labels.get(lbl.LABEL_TOPOLOGY_ZONE)
        capacity_type = labels.get(lbl.LABEL_CAPACITY_TYPE)
        if not (type_name and zone and capacity_type):
            return  # an unlabeled fixture node carries no pool to quarantine
        mark(type_name, zone, capacity_type)
        log.info(
            "quarantined reclaimed offering %s/%s/%s ahead of the replacement solve",
            type_name, zone, capacity_type,
        )

    @staticmethod
    def _describe(msg: InterruptionMessage) -> str:
        if msg.kind == "spot_interruption":
            return f"Spot interruption warning: instance {msg.instance_id} reclaimed at {msg.deadline:.0f}"
        if msg.kind == "rebalance_recommendation":
            return f"Rebalance recommendation for instance {msg.instance_id}"
        if msg.kind == "scheduled_maintenance":
            return f"Scheduled maintenance for instance {msg.instance_id}"
        return f"Instance {msg.instance_id} state change: {msg.kind}"

    def _delete(self, received) -> None:
        try:
            if self.queue.delete_message(received.receipt_handle):
                self.messages_deleted.inc()
        except Exception as err:  # noqa: BLE001 - redelivery will offer it again
            log.warning("delete of interruption message %s failed: %s", received.message_id, err)

    def _already_handled(self, message_id: str) -> bool:
        now = self.clock.now()
        with self._lock:
            expiry = self._handled.get(message_id)
            return expiry is not None and expiry > now

    @staticmethod
    def _ttl_insert(ttl_map: dict, key: str, expiry: float, cap: int = 4096) -> None:
        """Insert into a TTL map bounded by dropping OLDEST entries (all
        entries share one TTL, so insertion order == expiry order — an
        ordered-dict LRU, O(1) amortized even mid-storm; a rebuild that
        only removed expired entries would be O(n) per insert and remove
        nothing while a storm keeps every entry fresh)."""
        while len(ttl_map) >= cap:
            del ttl_map[next(iter(ttl_map))]
        ttl_map[key] = expiry

    def _mark_handled(self, message_id: str) -> None:
        now = self.clock.now()
        with self._lock:
            self._ttl_insert(self._handled, message_id, now + HANDLED_TTL)

    # -- instance -> node ----------------------------------------------------

    def _node_of(self, instance_id: str) -> Optional[Node]:
        """Resolve through cluster state (the incremental mirror), matching
        the provider-id tail — 'sim:///i-012345' ends in the instance id."""
        found: List[Node] = []

        def visit(state) -> bool:
            provider_id = state.node.spec.provider_id
            if provider_id and provider_id.rsplit("/", 1)[-1] == instance_id:
                found.append(state.node)
                return False
            return True

        self.cluster.for_each_node(visit)
        return found[0] if found else None

    # -- actions -------------------------------------------------------------

    def _cordon(self, node: Node) -> bool:
        """Cordon + taint, idempotently. Returns True when this call made a
        change (False = a duplicate notice; skip downstream work)."""
        return self.kube.retry_on_conflict("Node", node.name, node.metadata.namespace, _CORDON, held=node) is not None

    def _cordon_and_drain(self, node: Node, msg: InterruptionMessage) -> None:
        with TRACER.span("cordon", node=node.name):
            self._cordon(node)
        if node.metadata.deletion_timestamp is None and not self._replacement_in_flight(node.name):
            # the proactive solve, BEFORE the drain starts: replacement
            # capacity launches while the warning window ticks. A transient
            # failure must not burn the one-solve-per-victim claim — clear
            # it and re-raise so the redelivered notice retries the solve
            # before any drain starts
            try:
                self._provision_replacement(node)
            except Exception:
                with self._lock:
                    self._replaced.pop(node.name, None)
                raise
        self._hand_off_to_termination(node)

    def _garbage_collect(self, node: Node) -> None:
        """The instance is already gone: delete the node and drive the
        termination protocol now — its drain evicts the (unreachable) pods
        so their controllers reschedule them onto live capacity."""
        self._hand_off_to_termination(node)

    def _hand_off_to_termination(self, node: Node) -> None:
        """Termination-controller handoff: the delete starts the cordon/
        drain/finalize protocol it owns; reconcile now rather than waiting
        for the lifecycle loop's next tick."""
        with TRACER.span("drain-handoff", node=node.name):
            self.kube.delete(node)
            if self.termination is not None:
                refreshed = self.kube.get_node(node.name)
                if refreshed is not None:
                    self.termination.reconcile(refreshed)

    def _replacement_in_flight(self, node_name: str) -> bool:
        now = self.clock.now()
        with self._lock:
            expiry = self._replaced.get(node_name)
            if expiry is not None and expiry > now:
                return True
            self._replaced.pop(node_name, None)  # expired: re-insert at the tail
            self._ttl_insert(self._replaced, node_name, now + HANDLED_TTL)
            return False

    def _provision_replacement(self, node: Node) -> int:
        """Schedule the victim's reschedulable pods with the victim excluded
        and LAUNCH the result (consolidation runs the same schedule() in
        simulation mode; here the launch is real). Returns nodes launched."""
        pods = [
            p
            for p in self.kube.pods_on_node(node.name)
            if not podutils.is_terminal(p)
            and not podutils.is_owned_by_daemonset(p)
            and not podutils.is_owned_by_node(p)
        ]
        if not pods:
            return 0
        # what earlier re-solves and rounds nominated is not bound yet: count
        # it on the snapshot and in the topology domains, or this re-solve
        # hands the same room out again and takes their replacements for
        # empty nodes
        booked = self._live_bookings(pods)
        state_nodes = self.provisioner.nominated_snapshot(booked)
        with TRACER.span("re-solve", node=node.name, pods=len(pods)):
            try:
                results = self.provisioner.schedule(
                    pods, state_nodes, opts=SchedulerOptions(simulation_mode=True, exclude_nodes=[node.name]),
                    nominated=booked,
                )
            except Exception as err:
                # the re-solve runs on the card: its fault leaves poll_once()
                raise _ReSolveFault() from err
        placed: List[tuple] = []
        with TRACER.span("launch-replacement", node=node.name) as sp:
            # the launch enters its pairs in cluster state's record
            launched = self.provisioner.launch_nodes(results, placed=placed)
            sp.set(launched=len(launched))
        self.recorder.interruption_replacement_launched(node, len(pods))
        log.info(
            "proactive re-solve for %s: %d pod(s) -> %d replacement node(s) launched, %d onto existing capacity",
            node.name, len(pods), len(launched), sum(len(v.pods) for v in results.existing_nodes),
        )
        return len(launched)

    def _book(self, placed: List[tuple]) -> None:
        """Enter (node name, pods) pairs in cluster state's record of
        nominations, as a launch does."""
        self.cluster.nominate_pods(placed)

    def _live_bookings(self, solving: Sequence = ()) -> List[tuple]:
        """The record's live (node name, pods) pairs, less the pods of
        `solving`, the re-solve's own."""
        return self.cluster.nominations(solving=solving)
