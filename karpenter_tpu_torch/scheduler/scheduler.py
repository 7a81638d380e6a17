"""Scheduler: the provisioning solve.

Mirrors pkg/controllers/provisioning/scheduling/scheduler.go — the queue loop
with preference relaxation, placement against existing nodes then planned
virtual nodes then a fresh node from the weight-ordered templates, and
per-provisioner remaining-resource limit tracking (with the pessimistic
subtract-max invariant that prevents over-provisioning).

Device integration: when a `dense_solver` is attached (solver/dense.py), the
scheduler first runs the whole batch through the dense solve on the device;
pods the dense path placed feasibly are committed wholesale through the exact
host-side add() protocol in the solver-chosen order (cheap — one pass, no
search), and only the remainder falls into the sequential relaxation loop.
An exception from the dense solve propagates: the batch is never silently
rescheduled on the host. The boundary counts it into the solver fault
taxonomy first (solver/faults.py): its kind where a seam has not counted it
already, 'unclassified' where classify has no name for it.

The port's copy of karpenter_tpu/scheduler/scheduler.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..api import labels as lbl
from ..api.objects import PREFER_NO_SCHEDULE, Pod
from ..api.provisioner import Provisioner
from ..cloudprovider.types import InstanceType
from ..flight import FLIGHT
from ..scheduling.nodetemplate import NodeTemplate
from ..tracing import (
    DECISIONS,
    OUTCOME_FAILED,
    OUTCOME_PLACED_EXISTING,
    OUTCOME_PLACED_NEW,
    TRACER,
    DecisionRecord,
    classify_rejection,
)
from ..utils import resources as res
from .existingnode import ExistingNodeView
from .node import IncompatibleError, VirtualNode, catalog_filter_cache
from .preferences import Preferences
from .queue import Queue
from .topology import Topology


@dataclass
class SchedulerOptions:
    """simulation_mode suppresses event recording; exclude_nodes removes
    nodes from consideration (the consolidation hook, scheduler.go:38-43)."""

    simulation_mode: bool = False
    exclude_nodes: List[str] = field(default_factory=list)


@dataclass
class SchedulingResults:
    new_nodes: List[VirtualNode]
    existing_nodes: List[ExistingNodeView]
    unschedulable: Dict[Pod, str]

    def pod_errors(self) -> Dict[str, str]:
        return {pod.name: err for pod, err in self.unschedulable.items()}


class Scheduler:
    def __init__(
        self,
        node_templates: Sequence[NodeTemplate],
        provisioners: Sequence[Provisioner],
        topology: Topology,
        instance_types: Dict[str, List[InstanceType]],
        daemon_overhead: Optional[Dict[str, Dict[str, float]]] = None,
        state_nodes: Sequence[object] = (),
        opts: Optional[SchedulerOptions] = None,
        recorder=None,
        cluster=None,
        dense_solver=None,
    ):
        opts = opts if opts is not None else SchedulerOptions()
        # a PreferNoSchedule taint on any provisioner enables the blanket
        # toleration relaxation (scheduler.go:50-59)
        tolerate_prefer_no_schedule = any(
            taint.effect == PREFER_NO_SCHEDULE for p in provisioners for taint in p.spec.taints
        )
        self.node_templates = list(node_templates)
        self.topology = topology
        self.recorder = recorder
        self.cluster = cluster
        self.opts = opts
        self.preferences = Preferences(tolerate_prefer_no_schedule)
        self.dense_solver = dense_solver
        # instance types pre-sorted by price: the first surviving option of a
        # node is always its cheapest launchable type (scheduler.go:61-65)
        self.instance_types = {
            name: sorted(types, key=lambda it: (it.price(), it.name())) for name, types in instance_types.items()
        }
        # vectorized survivor-filter state per provisioner catalog, shared by
        # every VirtualNode this solve opens (host loop and dense commits);
        # keyed on the provider-owned lists so repeated solves reuse entries
        self.filter_caches = {name: catalog_filter_cache(types) for name, types in instance_types.items()}
        self.daemon_overhead = daemon_overhead or {}
        self.remaining_resources: Dict[str, Dict[str, float]] = {
            p.name: dict(p.spec.limits.resources) for p in provisioners if p.spec.limits is not None
        }
        self.nodes: List[VirtualNode] = []
        self.existing_nodes: List[ExistingNodeView] = []
        # per-pod rejection tallies for the decision audit (tracing.py):
        # allocated only when the tracer is on and this is a REAL solve —
        # simulated runs (consolidation / interruption what-ifs) place
        # nothing, so records from them would be noise, and the disabled
        # path must not allocate per-pod state (the overhead guarantee)
        self._rejections: Optional[Dict[str, Dict[str, int]]] = (
            {} if TRACER.enabled and not opts.simulation_mode else None
        )
        # the delta journal's epoch of the instant state_nodes were taken
        # (Cluster.nodes_snapshot's NodesSnapshot), the incremental engine's
        # checkpoint for this solve; None where the nodes are not the
        # cluster's snapshot, and then the solve leaves the engine's resident
        # state alone (solver/dense.py:_fill_existing)
        self.snapshot_epoch: Optional[int] = getattr(state_nodes, "epoch", None)
        self._calculate_existing_nodes(state_nodes)

    def _calculate_existing_nodes(self, state_nodes) -> None:
        named_templates = {t.provisioner_name: t for t in self.node_templates}
        excluded = set(self.opts.exclude_nodes)
        for state_node in state_nodes:
            node = state_node.node
            if node.name in excluded:
                continue
            # a node being deleted is not schedulable capacity
            # (suite_test.go:3589: launch a second node if an in-flight node
            # is terminating)
            if node.metadata.deletion_timestamp is not None or getattr(state_node, "marked_for_deletion", False):
                continue
            name = node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
            if name is None or name not in named_templates:
                continue  # not launched by a provisioner we recognize
            template = named_templates[name]
            self.existing_nodes.append(
                ExistingNodeView(state_node, self.topology, template.startup_taints, self.daemon_overhead.get(name, {}))
            )
            # recompute remaining limits against real capacity for a
            # consistent view (scheduler.go:256-260)
            if name in self.remaining_resources:
                self.remaining_resources[name] = res.subtract(self.remaining_resources[name], node.status.capacity)

    # -- solve ---------------------------------------------------------------

    def solve(self, pods: Sequence[Pod]) -> SchedulingResults:
        with TRACER.span("solve", pods=len(pods), simulation=self.opts.simulation_mode) as sp:
            # solver-latency SLO feed (flight.py): real solves only —
            # simulation re-solves (consolidation / interruption / cost
            # what-ifs) would pollute the quantiles campaigns score. One
            # attribute read when telemetry is off.
            observe = FLIGHT.enabled and not self.opts.simulation_mode
            if observe:
                t0 = time.perf_counter()
            results = self._solve(pods)
            if observe:
                FLIGHT.observe_solve_latency(time.perf_counter() - t0)
            sp.set(
                new_nodes=len([n for n in results.new_nodes if n.pods]),
                on_existing=sum(len(v.pods) for v in results.existing_nodes),
                unschedulable=len(results.unschedulable),
            )
            return results

    def _solve(self, pods: Sequence[Pod]) -> SchedulingResults:
        errors: Dict[Pod, str] = {}
        queue_pods = list(pods)

        # dense fast path: one batch solve proposes placements and commits
        # them through the exact host protocol; the host loop below takes
        # the pods it returns
        if self.dense_solver is not None:
            try:
                queue_pods = self.dense_solver.presolve(self, queue_pods)
            except Exception as exc:
                # counted, then raised: a new failure mode cannot hide
                from ..solver.faults import KIND_UNCLASSIFIED, SOLVER_FAULTS, classify, count_fault

                fault = classify(exc)
                if fault is None:
                    SOLVER_FAULTS.inc(kind=KIND_UNCLASSIFIED)
                else:
                    count_fault(fault)
                raise

        q = Queue(queue_pods)
        while True:
            pod = q.pop()
            if pod is None:
                break
            err = self._add(pod)
            if err is None:
                errors.pop(pod, None)
                q.note_progress()
                continue
            errors[pod] = err
            # relax returns a *copy* with one constraint dropped (or None);
            # caller-owned pod specs are never mutated — critical for
            # simulation mode, where pods come from live cluster state.
            relaxed_pod = self.preferences.relax(pod)
            if relaxed_pod is not None:
                q.push(relaxed_pod, True)
                self.topology.update(relaxed_pod)
            else:
                q.push(pod, False)

        for node in self.nodes:
            node.finalize_scheduling()
        unschedulable = {pod: errors.get(pod, "did not schedule") for pod in q.remaining()}
        if not self.opts.simulation_mode:
            self._record_results(unschedulable)
        if self._rejections is not None:
            self._record_decisions(unschedulable)
        return SchedulingResults(new_nodes=self.nodes, existing_nodes=self.existing_nodes, unschedulable=unschedulable)

    def _record_decisions(self, unschedulable: Dict[Pod, str]) -> None:
        """Per-pod audit records (tracing.py DecisionLog): what each pod got
        and what rejected it along the way. placed-new records carry the
        placeholder hostname; the launch path back-fills the real node."""
        trace_id = TRACER.current_trace_id() or ""
        for view in self.existing_nodes:
            labels = view.node.metadata.labels
            for pod in view.pods:
                DECISIONS.record(
                    DecisionRecord(
                        pod=pod.name,
                        outcome=OUTCOME_PLACED_EXISTING,
                        node=view.node.name,
                        instance_type=labels.get(lbl.LABEL_INSTANCE_TYPE, ""),
                        provisioner=labels.get(lbl.PROVISIONER_NAME_LABEL, ""),
                        trace_id=trace_id,
                        rejections=self._rejections.pop(pod.uid, {}),
                    )
                )
        for node in self.nodes:
            chosen = node.instance_type_options[0].name() if node.instance_type_options else ""
            for pod in node.pods:
                DECISIONS.record(
                    DecisionRecord(
                        pod=pod.name,
                        outcome=OUTCOME_PLACED_NEW,
                        node=getattr(node, "_hostname", ""),
                        instance_type=chosen,
                        provisioner=node.provisioner_name,
                        trace_id=trace_id,
                        rejections=self._rejections.pop(pod.uid, {}),
                    )
                )
        for pod, err in unschedulable.items():
            DECISIONS.record(
                DecisionRecord(
                    pod=pod.name,
                    outcome=OUTCOME_FAILED,
                    trace_id=trace_id,
                    error=err,
                    rejections=self._rejections.pop(pod.uid, {}),
                )
            )

    def _note_rejection(self, pod: Pod, err) -> None:
        buckets = self._rejections.setdefault(pod.uid, {})
        key = classify_rejection(str(err))
        buckets[key] = buckets.get(key, 0) + 1

    def _record_results(self, unschedulable: Dict[Pod, str]) -> None:
        if self.recorder is None:
            return
        for pod, err in unschedulable.items():
            self.recorder.pod_failed_to_schedule(pod, err)
        for node_view in self.existing_nodes:
            if node_view.pods and self.cluster is not None:
                self.cluster.nominate_node_for_pod(node_view.node.name)
            for pod in node_view.pods:
                self.recorder.nominate_pod(pod, node_view.node)

    def _add(self, pod: Pod) -> Optional[str]:
        # 1. in-flight real nodes first (scheduler.go:191-195)
        track = self._rejections is not None
        for node_view in self.existing_nodes:
            try:
                node_view.add(pod)
                return None
            except IncompatibleError as e:
                if track:
                    self._note_rejection(pod, e)
                continue

        # 2. planned virtual nodes, emptiest first (scheduler.go:198-205).
        # The O(R) capacity prescreen skips nodes no surviving type could
        # fit — on dense batches the scan crosses hundreds of committed
        # bins per host-path pod and the exact protocol per node is ~50us
        # of requirement algebra + exception machinery.
        self.nodes.sort(key=lambda n: len(n.pods))
        pod_requests = res.pod_requests(pod)
        for node in self.nodes:
            if not node.could_fit(pod_requests):
                continue
            try:
                node.add(pod)
                return None
            except IncompatibleError as e:
                if track:
                    self._note_rejection(pod, e)
                continue

        # 3. open a new node from the first workable template (weight order)
        errs: List[str] = []
        for template in self.node_templates:
            instance_types = self.instance_types.get(template.provisioner_name, [])
            remaining = self.remaining_resources.get(template.provisioner_name)
            if remaining is not None:
                instance_types = filter_by_remaining_resources(instance_types, remaining)
                if not instance_types:
                    errs.append(f"all available instance types exceed limits for provisioner {template.provisioner_name!r}")
                    continue
            node = VirtualNode(
                template,
                self.topology,
                self.daemon_overhead.get(template.provisioner_name, {}),
                instance_types,
                filter_cache=self.filter_caches.get(template.provisioner_name),
            )
            try:
                node.add(pod)
            except IncompatibleError as e:
                node.release()  # drop the probe node's phantom hostname domain
                if track:
                    self._note_rejection(pod, e)
                errs.append(f"incompatible with provisioner {template.provisioner_name!r}, {e}")
                continue
            self.nodes.append(node)
            if remaining is not None:
                # pessimistic: assume the largest surviving type launches
                # (subtractMax invariant, scheduler.go:263-284)
                self.remaining_resources[template.provisioner_name] = subtract_max(remaining, node.instance_type_options)
            return None
        return "; ".join(errs) if errs else "no node templates available"


def subtract_max(remaining: Dict[str, float], instance_types: Sequence[InstanceType]) -> Dict[str, float]:
    if not instance_types:
        return remaining
    it_max = res.max_resources(*[it.resources() for it in instance_types])
    return {k: v - it_max.get(k, 0.0) for k, v in remaining.items()}


def filter_by_remaining_resources(instance_types: Sequence[InstanceType], remaining: Dict[str, float]) -> List[InstanceType]:
    """Drop types whose capacity alone would breach the provisioner limit."""
    return [it for it in instance_types if not res.any_exceeds(it.resources(), remaining)]
