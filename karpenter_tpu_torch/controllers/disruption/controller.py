"""Disruption orchestrator: the single owner of voluntary node disruption.

Before this subsystem, three uncoordinated actors — consolidation, the node
controller's emptiness/expiration reconcilers, and interruption — each ran
their own eviction path with no global rate limit, so a config change or TTL
expiry could legally drain a large fraction of the cluster at once. The
orchestrator unifies them the way the reference's disruption controller did:

  methods (methods.py + consolidation.propose()) PROPOSE DisruptionCommands;
  a shared eligibility gate (eligibility.py: PDBs + karpenter.sh/do-not-
  disrupt) filters candidates;
  per-provisioner budgets (budgets.py, spec.disruption.budgets) are enforced
  ATOMICALLY across all methods by one in-flight ledger;
  a single serialized command queue RE-VALIDATES each command just before
  execution (candidates still exist / still empty / still drifted, budget
  still available, replacement still priced non-increasing), launches
  replacement capacity and waits for initialization BEFORE cordon+drain
  (the interruption controller's proactive-replacement discipline), and
  marks commands failed-with-reason otherwise.

Termination remains the sole drain executor — execution here ends at
kube.delete (the drain handoff). Involuntary disruption (the interruption
controller) never passes through this queue and is never budget-blocked.

Each executed command is one trace: disrupt -> validate ->
launch-replacement -> drain-handoff (the root stays open across passes while
a replacement initializes; tracing.py open_span/close_span).

The port's copy of karpenter_tpu/controllers/disruption/controller.py. One
deliberate difference: the reference logs and swallows any exception raised
by a method's or consolidation's propose(). Here a solver fault
(solver/faults.py: a `SolverFault`, an open breaker's included) ends that
source's pass with no action, and the next tick retries it on the card; any
other exception, a device-lost the card raised included
(faults.ends_the_loop), leaves reconcile(), so it cannot hide behind a log
line. Every Node write goes through the backend's retry_on_conflict; a
conflict no retry absorbed leaves that node to the next pass (a candidate
whose disrupting mark cannot be written voids its command, which its method
proposes again).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Set

from ...api import labels as lbl
from ...cloudprovider.types import NodeRequest
from ...events import Recorder
from ...kube.cluster import Conflict
from ...logsetup import get_logger
from ...metrics import REGISTRY
from ...solver.faults import SolverFault, ends_the_loop
from ...tracing import TRACER
from ..edits import cordon, requeue, set_annotation
from .budgets import BudgetTracker, allowed_disruptions
from .eligibility import PDBLimits, pod_ineligible_reason
from .methods import (
    METHOD_CONSOLIDATION,
    DisruptionCommand,
    DriftMethod,
    EmptinessMethod,
    ExpirationMethod,
)

log = get_logger("disruption")

OUTCOME_DISRUPTED = "disrupted"
OUTCOME_INVALIDATED = "invalidated"
OUTCOME_LAUNCH_FAILED = "launch-failed"
OUTCOME_REPLACEMENT_TIMED_OUT = "replacement-timed-out"
OUTCOME_REPLACEMENT_VANISHED = "replacement-vanished"


class DisruptionController:
    # fast tick: the pass is cheap when idle, and a parked command advances
    # one state per pass — a slower cadence would stretch every replacement
    # wait by that much (runtime.py _disruption_loop waits on this)
    POLL_INTERVAL = 1.0
    # how long a budget-blocked command sleeps before re-attempting; blocked
    # attempts are counted/traced only on the TRANSITION into blocked, so a
    # long drain holding the budget is one signal, not one per pass
    BUDGET_RETRY_PERIOD = 10.0
    # bounded wait for a launched replacement to initialize, the same budget
    # consolidation's standalone replace wait uses (retry.Attempts math)
    REPLACE_READY_TIMEOUT = 270.0

    def __init__(
        self,
        kube,
        cluster,
        cloud_provider,
        provisioner_controller,
        consolidation=None,
        termination=None,
        recorder: Optional[Recorder] = None,
        clock=None,
    ):
        from ...utils.clock import Clock

        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.provisioner_controller = provisioner_controller
        self.consolidation = consolidation  # ConsolidationController, source mode
        self.termination = termination
        self.recorder = recorder or Recorder()
        self.clock = clock or (kube.clock if kube is not None else None) or Clock()
        self.tracker = BudgetTracker()
        self.methods = [
            EmptinessMethod(kube, cluster, provisioner_controller, self.clock),
            ExpirationMethod(kube, cluster, provisioner_controller, self.clock),
            DriftMethod(kube, cluster, provisioner_controller, self.clock),
        ]
        self._method_by_name = {m.name: m for m in self.methods}
        self._queue: Deque[DisruptionCommand] = deque()
        self._pending: Optional[DisruptionCommand] = None
        self._pending_deadline = 0.0
        self._gauged_provisioners: Set[str] = set()
        self.commands = REGISTRY.counter(
            "karpenter_disruption_commands",
            "Disruption commands finished, by method and outcome",
            ("method", "outcome"),
        )
        self.budget_blocked = REGISTRY.counter(
            "karpenter_disruption_budget_blocked_total",
            "Disruption commands deferred because the provisioner's budget was exhausted",
            ("provisioner",),
        )
        self.eligible_nodes = REGISTRY.gauge(
            "karpenter_disruption_eligible_nodes",
            "Nodes currently eligible for voluntary disruption",
            ("provisioner",),
        )
        self.ineligible_nodes = REGISTRY.gauge(
            "karpenter_disruption_ineligible_nodes",
            "Owned nodes currently ineligible for voluntary disruption (do-not-disrupt, PDBs, uninitialized)",
            ("provisioner",),
        )
        self.queue_depth = REGISTRY.gauge(
            "karpenter_disruption_queue_depth", "Commands waiting in the disruption queue"
        )
        self.nodes_disrupting = REGISTRY.gauge(
            "karpenter_disruption_nodes_disrupting",
            "Nodes currently charged against their provisioner's disruption budget",
            ("provisioner",),
        )
        self.recoveries = REGISTRY.counter(
            "karpenter_disruption_recoveries_total",
            "Crash-restart reconstruction actions, by what the recovered marker required",
            ("action",),
        )

    # -- restart reconstruction ------------------------------------------------

    def recover(self) -> dict:
        """Rebuild crash-lost in-memory state from the durable node markers
        (labels.py DISRUPTING/REPLACEMENT_FOR): the budget ledger is
        re-charged for nodes mid-voluntary-drain, candidates stranded
        cordoned-but-undeleted are released, and orphaned replacement
        launches are reaped or adopted. Run ONCE at startup, before any
        reconcile pass — so a restart mid-disruption neither exceeds budgets
        nor strands capacity. Returns an action->nodes summary."""
        summary = {"recharged": [], "released": [], "reaped": [], "adopted": []}
        for node in list(self.kube.list_nodes()):
            method = node.metadata.annotations.get(lbl.DISRUPTING_ANNOTATION)
            provisioner_name = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL, "")
            if method:
                if node.metadata.deletion_timestamp is not None:
                    # mid-drain: the charge must survive the restart or a
                    # fresh pass could exceed the budget while this drain is
                    # still in flight (release happens, as always, when the
                    # node object is gone)
                    self.tracker.try_charge(provisioner_name, node.name, None)
                    self.recoveries.inc(action="recharged")
                    summary["recharged"].append(node.name)
                else:
                    # crashed between charge and delete: the command died
                    # with the process. Release the node — clear the marker
                    # and the cordon — and let the method re-propose it.
                    try:
                        self.kube.retry_on_conflict("Node", node.name, node.metadata.namespace, _release, held=node)
                    except Conflict as err:
                        requeue("DisruptionController", node, err)
                        continue
                    self.recoveries.inc(action="released")
                    summary["released"].append(node.name)
                continue
            targets = node.metadata.annotations.get(lbl.REPLACEMENT_FOR_ANNOTATION)
            if targets is None:
                continue
            candidates_alive = any(
                (fresh := self.kube.get_node(name)) is not None and fresh.metadata.deletion_timestamp is None
                for name in targets.split(",")
                if name
            )
            initialized = node.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) == "true"
            if candidates_alive and not initialized:
                # its command is gone and its candidates are still whole: the
                # re-proposed command will launch its own replacement — this
                # one would leak as empty nominated capacity
                self.kube.delete(node)
                self.recoveries.inc(action="reaped")
                summary["reaped"].append(node.name)
            else:
                # the drain finished (or the node is already real capacity):
                # adopt it — clear the marker, keep it protected briefly
                try:
                    self.kube.retry_on_conflict("Node", node.name, node.metadata.namespace, _ADOPT, held=node)
                except Conflict as err:
                    requeue("DisruptionController", node, err)
                    continue
                self.cluster.nominate_node_for_pod(node.name)
                self.recoveries.inc(action="adopted")
                summary["adopted"].append(node.name)
        if any(summary.values()):
            log.info(
                "disruption restart recovery: recharged=%s released=%s reaped=%s adopted=%s",
                summary["recharged"], summary["released"], summary["reaped"], summary["adopted"],
            )
        return summary

    # -- the pass -------------------------------------------------------------

    def reconcile(self) -> None:
        """One orchestrator pass: settle finished drains, advance the parked
        command, gather fresh proposals, then drain the queue serially."""
        self._release_completed()
        if self._pending is not None:
            self._continue_pending()
        pdb = PDBLimits(self.kube)
        self._propose(pdb)
        if self._pending is None:
            self._drain_queue(pdb)
        self.queue_depth.set(float(len(self._queue)))

    # -- budget bookkeeping ----------------------------------------------------

    def _release_completed(self) -> None:
        """A charge is held from execution start until the node object is
        GONE — 'simultaneously disrupted' includes the whole drain."""
        for provisioner_name in self.tracker.provisioners():
            for node_name in self.tracker.charged_nodes(provisioner_name):
                if self.kube.get_node(node_name) is None:
                    self.tracker.release(provisioner_name, node_name)
            self.nodes_disrupting.set(float(self.tracker.in_flight(provisioner_name)), provisioner=provisioner_name)

    def _owned_node_count(self, provisioner_name: str) -> int:
        count = 0

        def visit(state) -> bool:
            nonlocal count
            if state.node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) == provisioner_name:
                count += 1
            return True

        self.cluster.for_each_node(visit)
        return count

    def _budget_limit(self, provisioner_name: str) -> Optional[int]:
        provisioner = self.kube.get("Provisioner", provisioner_name, namespace="")
        if provisioner is None:
            return 0  # provisioner gone: nothing voluntary may proceed
        return allowed_disruptions(provisioner, self._owned_node_count(provisioner_name), self.clock.now())

    # -- proposal --------------------------------------------------------------

    def _busy_nodes(self) -> Set[str]:
        busy: Set[str] = set()
        for cmd in self._queue:
            busy.update(cmd.node_names())
        if self._pending is not None:
            busy.update(self._pending.node_names())
        for provisioner_name in self.tracker.provisioners():
            busy.update(self.tracker.charged_nodes(provisioner_name))
        return busy

    def _propose(self, pdb: PDBLimits) -> None:
        # busy nodes are excluded INSIDE the sources, before any
        # re-simulation — a queued/parked candidate must not be re-solved
        # every pass only to be discarded at dedupe time. A solver fault in a
        # source's what-if ends that source's pass with no action; any other
        # exception leaves the pass.
        busy = frozenset(self._busy_nodes())
        commands: List[DisruptionCommand] = []
        for method in self.methods:
            try:
                commands.extend(method.propose(busy))
            except SolverFault as fault:
                if ends_the_loop(fault):
                    raise
                log.warning("disruption method %s held by a %s fault; the next pass retries: %s", method.name, fault.kind, fault)
        if self.consolidation is not None and self.consolidation.should_run():
            try:
                commands.extend(self.consolidation.propose(pdb, exclude=busy))
            except SolverFault as fault:
                if ends_the_loop(fault):
                    raise
                self.consolidation.retry_next_pass()
                log.warning("consolidation held by a %s fault; the next pass retries: %s", fault.kind, fault)
        busy = set(busy)
        eligible: Dict[str, int] = {}
        ineligible: Dict[str, int] = {}
        # zero out provisioners reported last pass but absent this one, so a
        # settled cluster's gauges drop back instead of pinning stale counts
        for name in self._gauged_provisioners:
            eligible.setdefault(name, 0)
            ineligible.setdefault(name, 0)
        for cmd in commands:
            if any(name in busy for name in cmd.node_names()):
                continue
            reason = None
            for node in cmd.nodes:
                reason = pod_ineligible_reason(self.kube.pods_on_node(node.name), pdb)
                if reason is not None:
                    break
            if reason is not None:
                ineligible[cmd.provisioner_name] = ineligible.get(cmd.provisioner_name, 0) + len(cmd.nodes)
                log.debug("disruption %s: %s ineligible: %s", cmd.method, cmd.node_names(), reason)
                continue
            eligible[cmd.provisioner_name] = eligible.get(cmd.provisioner_name, 0) + len(cmd.nodes)
            busy.update(cmd.node_names())
            self._queue.append(cmd)
        for name, count in eligible.items():
            self.eligible_nodes.set(float(count), provisioner=name)
        for name, count in ineligible.items():
            self.ineligible_nodes.set(float(count), provisioner=name)
        # remember every provisioner with a NONZERO gauge in either family —
        # a dict-merge would let one family's zero mask the other's count
        self._gauged_provisioners = {
            name for name in set(eligible) | set(ineligible)
            if eligible.get(name, 0) + ineligible.get(name, 0) > 0
        }

    # -- the serialized queue ---------------------------------------------------

    def _drain_queue(self, pdb: PDBLimits) -> None:
        for _ in range(len(self._queue)):
            if self._pending is not None:
                return  # a replacement is initializing: the queue halts behind it
            cmd = self._queue.popleft()
            if cmd.blocked_until > self.clock.now():
                self._queue.append(cmd)  # still in budget backoff: no attempt, no trace
                continue
            self._execute(cmd, pdb)

    def _block_on_budget(self, cmd: DisruptionCommand) -> None:
        """Defer, don't fail: the command sleeps BUDGET_RETRY_PERIOD and
        retries once budget frees up. The counter ticks only on the
        transition into blocked — a drain holding the budget for minutes is
        one signal, and (tracing on) one trace, not one per pass."""
        if cmd.blocked_until == 0.0:
            self.budget_blocked.inc(provisioner=cmd.provisioner_name)
        cmd.blocked_until = self.clock.now() + self.BUDGET_RETRY_PERIOD
        self._queue.append(cmd)

    def _execute(self, cmd: DisruptionCommand, pdb: PDBLimits) -> None:
        # budget prescreen BEFORE the trace root opens: repeat blocked
        # attempts must not churn the bounded trace ring. A GONE provisioner
        # deliberately skips the prescreen — validation below invalidates
        # the command (blocking on its zero budget would cycle forever)
        limit = None
        if self.kube.get("Provisioner", cmd.provisioner_name, namespace="") is not None:
            limit = self._budget_limit(cmd.provisioner_name)
            if limit is not None and self.tracker.in_flight(cmd.provisioner_name) + len(cmd.nodes) > limit:
                # drop commands that went invalid while waiting — a long
                # budget freeze must not pin a healed/vanished candidate in
                # the queue (and in every pass's busy set) indefinitely
                invalid = self._validate(cmd, pdb)
                if invalid is not None:
                    cmd.trace_span = TRACER.open_span(
                        "disrupt", controller="disruption", method=cmd.method,
                        nodes=",".join(cmd.node_names()), provisioner=cmd.provisioner_name, reason=cmd.reason,
                    )
                    cmd.trace_ctx = TRACER.ctx_of(cmd.trace_span)
                    self._finish(cmd, OUTCOME_INVALIDATED, invalid)
                    return
                self._block_on_budget(cmd)
                return
        cmd.blocked_until = 0.0
        cmd.trace_span = TRACER.open_span(
            "disrupt", controller="disruption", method=cmd.method,
            nodes=",".join(cmd.node_names()), provisioner=cmd.provisioner_name, reason=cmd.reason,
        )
        cmd.trace_ctx = TRACER.ctx_of(cmd.trace_span)
        with TRACER.span("validate", parent=cmd.trace_ctx, method=cmd.method) as sp:
            invalid = self._validate(cmd, pdb)
            blocked = False
            if invalid is None:
                charged: List[str] = []
                for name in cmd.node_names():
                    if self.tracker.try_charge(cmd.provisioner_name, name, limit):
                        charged.append(name)
                    else:
                        for done in charged:
                            self.tracker.release(cmd.provisioner_name, done)
                        blocked = True
                        break
            sp.set(invalid=invalid or "", budget_blocked=blocked)
        if invalid is not None:
            self._finish(cmd, OUTCOME_INVALIDATED, invalid)
            return
        if blocked:
            TRACER.close_span(cmd.trace_span, outcome="budget-blocked")
            cmd.trace_span = cmd.trace_ctx = None
            self._block_on_budget(cmd)
            return
        # the charge is durable from here: stamp the candidates so a restart
        # can reconstruct the ledger (mid-drain) or release them (pre-drain)
        if not self._stamp_disrupting(cmd):
            self._fail_replacement(cmd, OUTCOME_INVALIDATED, "a candidate's disrupting mark lost to a write conflict")
            return
        if cmd.replacements and not cmd.launched:
            if not self._launch_replacements(cmd):
                return
            self._pending = cmd
            self._pending_deadline = self.clock.now() + self.REPLACE_READY_TIMEOUT
            return
        self._disrupt(cmd)

    def _stamp_disrupting(self, cmd: DisruptionCommand) -> bool:
        """Mark every candidate; False when a mark lost to a conflict."""
        stamp = set_annotation(lbl.DISRUPTING_ANNOTATION, cmd.method)
        for stale in cmd.nodes:
            node = self.kube.get_node(stale.name)
            if node is not None:
                try:
                    self.kube.retry_on_conflict("Node", node.name, node.metadata.namespace, stamp, held=node)
                except Conflict as err:
                    requeue("DisruptionController", node, err)
                    return False
        return True

    def _clear_disrupting(self, cmd: DisruptionCommand) -> None:
        """Unwind the durable marker when a command fails AFTER its charges
        landed — the candidates survive, so the marker must not outlive the
        charge (a restart would misread it as a stranded disruption)."""
        for stale in cmd.nodes:
            node = self.kube.get_node(stale.name)
            if node is not None:
                try:
                    self.kube.retry_on_conflict("Node", node.name, node.metadata.namespace, _UNMARK, held=node)
                except Conflict as err:
                    requeue("DisruptionController", node, err)

    def _validate(self, cmd: DisruptionCommand, pdb: PDBLimits) -> Optional[str]:
        """The just-before-execution re-validation: candidates still exist
        and are still eligible, the method predicate still holds, and a
        consolidation replacement is still priced non-increasing."""
        if self.kube.get("Provisioner", cmd.provisioner_name, namespace="") is None:
            # a deleted provisioner's zero budget would otherwise cycle the
            # command through the blocked path forever
            return f"provisioner {cmd.provisioner_name} no longer exists"
        for node in cmd.nodes:
            fresh = self.kube.get_node(node.name)
            if fresh is None or fresh.metadata.deletion_timestamp is not None:
                return f"candidate {node.name} no longer exists"
            reason = pod_ineligible_reason(self.kube.pods_on_node(node.name), pdb)
            if reason is not None:
                return reason
        if cmd.require_empty:
            # the emptiness method AND consolidation's empty fast path: a
            # decision made on an empty node is void once pods landed on it
            from ...utils import pod as podutils

            for node in cmd.nodes:
                if not podutils.is_node_empty(self.kube.pods_on_node(node.name)):
                    return f"node {node.name} is no longer empty"
        method = self._method_by_name.get(cmd.method)
        if method is not None:
            reason = method.still_valid(cmd)
            if reason is not None:
                return reason
        if cmd.method == METHOD_CONSOLIDATION and cmd.replacements and cmd.candidate_price is not None:
            cheapest = min(
                (it.price() for vn in cmd.replacements for it in vn.instance_type_options),
                default=None,
            )
            if cheapest is None or cheapest > cmd.candidate_price:
                return (
                    f"replacement price {cheapest} now exceeds candidate price {cmd.candidate_price}"
                    if cheapest is not None
                    else "replacement has no priced instance type left"
                )
        return None

    # -- execution ---------------------------------------------------------------

    def _launch_replacements(self, cmd: DisruptionCommand) -> bool:
        """Launch the replacement plan BEFORE any cordon: the candidates stay
        schedulable until the new capacity is initialized. Returns False when
        the launch failed (command finished, charges released). The handler
        wraps only the provider's create and the store's create, never the
        card."""
        with TRACER.span("launch-replacement", parent=cmd.trace_ctx, replacements=len(cmd.replacements)) as sp:
            launched: List[str] = []
            try:
                for vn in cmd.replacements:
                    node = self.cloud_provider.create(
                        NodeRequest(template=vn.template, instance_type_options=vn.instance_type_options)
                    )
                    # durable link to the candidates: a restarted controller
                    # reaps this launch if they still exist (its command died
                    # with the process) or adopts it if they are gone
                    node.metadata.annotations[lbl.REPLACEMENT_FOR_ANNOTATION] = ",".join(cmd.node_names())
                    self.kube.create(node)
                    # protect the replacement from other methods while it warms
                    self.cluster.nominate_node_for_pod(node.name)
                    launched.append(node.name)
            except Exception as err:  # noqa: BLE001 - capacity errors self-heal next pass
                log.warning(
                    "disruption %s: replacement launch failed for %s (unwinding %d partial launch(es)): %s",
                    cmd.method, ", ".join(cmd.node_names()), len(launched), err,
                )
                sp.set(error=str(err))
                for name in launched:
                    ghost = self.kube.get_node(name)
                    if ghost is not None:
                        self.kube.delete(ghost)
                for name in cmd.node_names():
                    self.tracker.release(cmd.provisioner_name, name)
                self._clear_disrupting(cmd)
                self._finish(cmd, OUTCOME_LAUNCH_FAILED, f"replacement launch failed: {err}")
                return False
            cmd.launched = launched
            sp.set(launched=",".join(launched))
        log.info(
            "disruption %s: launched replacement(s) %s for %s (%s); waiting for initialization before drain",
            cmd.method, ", ".join(launched), ", ".join(cmd.node_names()), cmd.reason,
        )
        return True

    def _continue_pending(self) -> None:
        cmd = self._pending
        replacements = [self.kube.get_node(name) for name in cmd.launched]
        if any(node is None for node in replacements):
            self._pending = None
            # reap the SURVIVING launches too: a half-vanished plan must not
            # leak the rest as empty nominated capacity
            for node in replacements:
                if node is not None:
                    self.kube.delete(node)
            self._fail_replacement(cmd, OUTCOME_REPLACEMENT_VANISHED, "replacement node vanished before initialization")
            return
        if all(node.metadata.labels.get(lbl.LABEL_NODE_INITIALIZED) == "true" for node in replacements):
            self._pending = None
            # the wait can last minutes: re-validate before the cordon — a
            # do-not-disrupt pod or PDB that landed on a still-schedulable
            # candidate voids the command (the drain would wedge forever,
            # holding its budget charge with it)
            invalid = self._validate(cmd, PDBLimits(self.kube))
            if invalid is not None:
                for node in replacements:
                    self.kube.delete(node)  # reap the now-unneeded launches
                self._fail_replacement(cmd, OUTCOME_INVALIDATED, invalid)
                return
            self._disrupt(cmd)
            return
        if self.clock.now() >= self._pending_deadline:
            self._pending = None
            # reap the never-ready launches so they don't leak as phantom capacity
            for node in replacements:
                if node is not None:
                    self.kube.delete(node)
            self._fail_replacement(cmd, OUTCOME_REPLACEMENT_TIMED_OUT, "replacement never initialized")
            return
        for node in replacements:
            self.recorder.waiting_on_readiness(node)
            self.cluster.nominate_node_for_pod(node.name)  # keep the nomination fresh

    def _fail_replacement(self, cmd: DisruptionCommand, outcome: str, reason: str) -> None:
        # candidates were never cordoned (launch-before-cordon), so failure
        # needs no unwind beyond releasing the budget charges + their
        # durable markers
        for name in cmd.node_names():
            self.tracker.release(cmd.provisioner_name, name)
        self._clear_disrupting(cmd)
        log.warning("disruption %s of %s abandoned: %s", cmd.method, ", ".join(cmd.node_names()), reason)
        self._finish(cmd, outcome, reason)

    def _disrupt(self, cmd: DisruptionCommand) -> None:
        """Cordon + delete the candidates: the termination controller owns
        the drain from here (it is the sole drain executor)."""
        # the replacements are real capacity now: drop their durable link so
        # a later restart adopts them as ordinary nodes
        for name in cmd.launched:
            replacement = self.kube.get_node(name)
            if replacement is not None:
                try:
                    self.kube.retry_on_conflict("Node", name, replacement.metadata.namespace, _ADOPT, held=replacement)
                except Conflict as err:
                    requeue("DisruptionController", replacement, err)  # a restart's recovery adopts it
        with TRACER.span("drain-handoff", parent=cmd.trace_ctx, nodes=",".join(cmd.node_names())):
            for stale in cmd.nodes:
                node = self.kube.get_node(stale.name)
                if node is None:
                    continue
                try:
                    self.kube.retry_on_conflict("Node", node.name, node.metadata.namespace, _CORDON, held=node)
                except Conflict as err:
                    requeue("DisruptionController", node, err)  # the termination controller cordons it as it drains
                self.recorder.terminating_node(node, f"disruption {cmd.method}: {cmd.reason}")
                self.kube.delete(node)
                if self.termination is not None:
                    refreshed = self.kube.get_node(node.name)
                    if refreshed is not None:
                        try:
                            self.termination.reconcile(refreshed)
                        except Conflict as err:
                            requeue("TerminationController", refreshed, err)
        log.info("disruption %s: disrupting %s (%s)", cmd.method, ", ".join(cmd.node_names()), cmd.reason)
        self._finish(cmd, OUTCOME_DISRUPTED, cmd.reason)

    def _finish(self, cmd: DisruptionCommand, outcome: str, reason: str) -> None:
        cmd.outcome = outcome
        self.commands.inc(method=cmd.method, outcome=outcome)
        TRACER.close_span(cmd.trace_span, outcome=outcome, detail=reason)
        cmd.trace_span = cmd.trace_ctx = None


# -- the Node edits, each idempotent on a fresh object ---------------------------


def _release(node) -> bool:
    """Clear a stranded disrupting mark and the cordon it came with."""
    if lbl.DISRUPTING_ANNOTATION not in node.metadata.annotations:
        return False
    del node.metadata.annotations[lbl.DISRUPTING_ANNOTATION]
    if node.spec.unschedulable and not any(
        t.key in (lbl.TAINT_INTERRUPTION, lbl.TAINT_NODE_UNSCHEDULABLE) for t in node.spec.taints
    ):
        node.spec.unschedulable = False
    return True


_UNMARK = set_annotation(lbl.DISRUPTING_ANNOTATION, None)
_ADOPT = set_annotation(lbl.REPLACEMENT_FOR_ANNOTATION, None)
_CORDON = cordon()
