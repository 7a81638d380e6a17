"""ProvisionerController: the provisioning orchestrator.

Mirrors pkg/controllers/provisioning/provisioner.go — wait for a batch
window, wait for cluster-state sync, snapshot state nodes, collect pending
provisionable pods (validating PVCs and injecting volume topology), run the
scheduler (the dense path on the card + host oracle), and launch the
resulting nodes through the cloud provider, nominating pods onto them.

Like the reference, this controller does NOT bind pods — the cluster's
scheduler does that once the node joins; nomination events plus the
cluster-state nomination TTL prevent double-provisioning in the meantime.

The port's copy of karpenter_tpu/controllers/provisioning/provisioner.py.
Three deliberate differences from the reference:

- its batch loop logs a failed round and goes on; the port's holds the
  batch on a solver fault (solver/faults.py: a `SolverFault`, an open
  breaker's included): the pods stay Pending and the loop re-arms itself
  for max(now, the breaker's reopen time), since no pod event will wake it,
  and retries on the card. It holds the batch the same way when the cluster
  state has not caught up with the API by the round's sync deadline
  (`ClusterNotSynced`, the reference's TimeoutError): the round launched
  nothing, and the loop re-triggers its batcher, as provisioner.go requeues
  an unsynced reconcile. Any other exception, a device-lost the card
  raised included (faults.ends_the_loop), ends the loop at that round,
  stays in `error`, and `stop()` re-raises it;
- its capacity-failure re-solve takes the cluster state as it stands,
  where the pods the round nominated are not yet bound, so it hands their
  capacity out again; the port's re-solve counts them on their nodes, in
  the nodes' free resources and in the topology domains (over the solver
  sidecar too: the request ships them as bound to their nodes). It counts
  every other live nomination too: `launch_nodes` enters every pair it
  collects in cluster state's record of nominations
  (`Cluster.nominate_pods`), and `nominated_view` is what every re-solve
  reads, the interruption controller's and the disruption what-ifs'
  included;
- where the solver sidecar fails, its `schedule` falls back to the local
  scheduler; the port's lets the RemoteSchedulingError out of `schedule()`
  (and so out of the round), as a failure on the card would.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from ...api import labels as lbl
from ...api.objects import Pod
from ...logsetup import get_logger
from ...cloudprovider.types import CloudProvider, NodeRequest
from ...config import Config
from ...events import Recorder
from ...flight import FLIGHT
from ...journal import JOURNAL
from ...kube.cluster import Conflict, KubeCluster
from ...metrics import REGISTRY
from ...cloudprovider.errors import InsufficientCapacityError
from ...scheduler import SchedulerOptions, build_scheduler
from ...scheduler.scheduler import SchedulingResults
from ...solver.faults import BREAKER, SolverFault, ends_the_loop
from ...tracing import DECISIONS, OUTCOME_FAILED, TRACER, DecisionRecord
from ...utils import pod as podutils
from ...utils import resources as res
from ..state.cluster import Cluster
from .batcher import Batcher
from .volumetopology import VolumeTopology

log = get_logger("provisioning")


class ClusterNotSynced(TimeoutError):
    """The cluster state had not caught up with the API by the round's sync
    deadline, or the loop was stopped while the round waited for it. The
    round launched nothing: its batch stays pending for the next round."""


class ProvisionerController:
    def __init__(
        self,
        kube: KubeCluster,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        config: Optional[Config] = None,
        recorder: Optional[Recorder] = None,
        dense_solver=None,
        remote_solver=None,
        wait_for_cluster_sync: bool = True,
        clock=None,
        ice_backoff_seconds: Optional[float] = None,
        leader_check=None,
    ):
        from ...utils.clock import Clock

        self.kube = kube
        # leadership gate (runtime.py _may_act): when set, the batch loop
        # holds a completed batch until the gate opens instead of launching
        # as a deposed leader. None = always act (embedded and test callers
        # with no election)
        self._leader_check = leader_check
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.config = config or Config()
        self.recorder = recorder or Recorder()
        self.dense_solver = dense_solver
        # the solver sidecar (service/client.py): batches at or above the
        # crossover solve there; a failed remote solve raises
        self.remote_solver = remote_solver
        self.wait_for_cluster_sync = wait_for_cluster_sync
        self.clock = clock or kube.clock or Clock()
        self.batcher = Batcher(self.config, self.clock)
        self.volume_topology = VolumeTopology(kube)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_results: Optional[SchedulingResults] = None
        # same family the Runtime loops feed for every other controller
        self.reconcile_duration = REGISTRY.histogram(
            "karpenter_reconcile_duration_seconds",
            "Duration of controller reconcile passes",
            ("controller",),
        )
        self.launch_failures = REGISTRY.counter(
            "karpenter_provisioning_launch_failures_total",
            "Node launches that failed, by failure class",
            ("reason",),
        )
        self.last_trace_id: Optional[str] = None  # trace of the latest round (tracing on)
        # the exception that ended the batch loop (None while it runs, and
        # after a clean stop); stop() re-raises it
        self.error: Optional[Exception] = None
        # capacity-failure escalation: a pod parks here once every rung of
        # the escalation ladder (next-cheapest offering -> next type ->
        # re-solve) is exhausted; get_pods skips it until the instant passes
        # so a total crunch cannot hot-loop the solver against the wall
        self.ice_backoff_seconds = ice_backoff_seconds if ice_backoff_seconds is not None else self.ICE_BACKOFF_SECONDS
        self._ice_backoff: Dict[tuple, float] = {}  # (namespace, name) -> retry-after instant
        # liveness for unschedulable leftovers: a round that could not place
        # every pod re-enters on this deadline even with no fresh pod event
        # (the controller-runtime requeue-with-backoff analog) — without it,
        # pods waiting out an offering quarantine would stall until an
        # unrelated pod event happened to pull the batcher trigger
        self._unschedulable_retry_at: Optional[float] = None
        # when a round held by a solver fault retries (its batch stays
        # Pending); None while no round is held
        self._fault_retry_at: Optional[float] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="provisioner", daemon=True)
        self._thread.start()

    @property
    def thread(self) -> Optional[threading.Thread]:
        """The batch loop's thread (None before start)."""
        return self._thread

    def stop(self) -> None:
        """Stop the batch loop; re-raise the exception that ended it, if any."""
        self._stop.set()
        self.batcher.trigger_immediate()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.error is not None:
            raise self.error

    def _run(self) -> None:
        while not self._stop.is_set():
            # parked pods (capacity-failure backoff) bound the idle wait:
            # their retry needs no fresh pod event to re-enter the round
            self.batcher.wait(deadline=self._earliest_ice_retry())
            if self._stop.is_set():
                return
            # leader-flap gate: a deposed leader HOLDS the batch (the pods
            # stay pending, a successor will pick them up or we will on
            # re-election) rather than launching capacity it no longer owns
            while self._leader_check is not None and not self._leader_check():
                if self._stop.is_set():
                    return
                self.clock.sleep(0.05)
            self._fault_retry_at = None
            try:
                self.provision()
            except ClusterNotSynced as exc:
                if self._stop.is_set():
                    return
                # a watch lagging the API (a scale-up's node events over
                # HTTP) is transient: the batch re-enters through the
                # batcher's window
                log.warning("provisioning round held: %s; the batch stays pending and retries", exc)
                self.batcher.trigger()
                continue
            except Exception as exc:
                if isinstance(exc, SolverFault) and not ends_the_loop(exc):
                    self._fault_retry_at = max(self.clock.now(), BREAKER.retry_at())
                    log.warning(
                        "provisioning round held by a %s fault; the batch stays pending and retries on the device at %.3f: %s",
                        exc.kind, self._fault_retry_at, exc,
                    )
                    continue
                # any other failed round (among others, a device-lost the
                # card raised: its context stays broken) ends the loop
                # instead of hiding behind a log line
                log.exception("provisioning round failed; the batch loop stops")
                self.error = exc
                return

    def _earliest_ice_retry(self) -> Optional[float]:
        deadlines = list(self._ice_backoff.values())
        if self._unschedulable_retry_at is not None:
            deadlines.append(self._unschedulable_retry_at)
        if self._fault_retry_at is not None:
            deadlines.append(self._fault_retry_at)
        return min(deadlines) if deadlines else None

    def trigger(self) -> None:
        self.batcher.trigger()

    def trigger_and_wait(self) -> SchedulingResults:
        """Deterministic test path: run one full provisioning round now."""
        return self.provision()

    # -- the provisioning round ------------------------------------------------

    def provision(self) -> SchedulingResults:
        with TRACER.span("provision", controller="provisioning") as root:
            with self.reconcile_duration.time(controller="provisioning"):
                results = self._provision_round(root)
            self.last_trace_id = getattr(root, "trace_id", None)
        self.last_results = results
        return results

    # bounded capacity-failure escalation: after the initial launch, how
    # many IMMEDIATE re-solves (with the failed pools excluded via the
    # provider's unavailable-offerings cache) a round runs before parking
    # the still-failing pods behind the backoff
    ICE_RESOLVE_ATTEMPTS = 2
    # how long a pod that exhausted the ladder sits out of get_pods: long
    # enough not to hot-loop the solver into the wall, short enough to
    # re-probe well within the unavailable-offering TTL
    ICE_BACKOFF_SECONDS = 10.0

    def _provision_round(self, root) -> SchedulingResults:
        if self.wait_for_cluster_sync:
            deadline = self.clock.now() + 10.0
            while not self.cluster.synchronized():
                if self.clock.now() > deadline or self._stop.is_set():
                    raise ClusterNotSynced("cluster state failed to synchronize")
                self.clock.sleep(0.05)

        # the primary solve reads no nominations: its batch holds the pods a
        # round nominated that are still pending, and counting them again
        # would book them twice
        state_nodes = self.cluster.nodes_snapshot()
        # batch: collect + constrain the pending pods (PVC validation and
        # volume-topology injection live inside get_pods)
        with TRACER.span("batch") as sp:
            pods = self.get_pods()
            sp.set(pods=len(pods), state_nodes=len(state_nodes))
        if JOURNAL.enabled:
            trace_id = TRACER.current_trace_id() or ""
            for pod in pods:
                JOURNAL.pod_event(pod.metadata.name, "batch-admitted", trace_id=trace_id)
        start = self.clock.now()
        results = self._schedule_journaled(pods, state_nodes)
        ice_failed: List[object] = []
        launched = self.launch_nodes(results, ice_failures=ice_failed)
        # fallback re-solve: a typed insufficient-capacity launch failure
        # already fed the provider's negative offering cache, so an
        # IMMEDIATE re-solve sees a universe with the exhausted pools
        # masked and routes the affected pods to the next-cheapest offering
        # or the next type — instead of leaving them pending a full batch
        # cycle to retry into the same wall
        any_unschedulable = bool(results.unschedulable)
        for attempt in range(self.ICE_RESOLVE_ATTEMPTS):
            if not ice_failed:
                break
            retry_pods = [p for vn in ice_failed for p in vn.pods]
            # the round's placements are nominated, not bound: the re-solve
            # counts them and every other live nomination (cluster state's
            # record, which launch_nodes entered them in), or it would hand
            # their capacity out again
            with TRACER.span("ice-resolve", attempt=attempt + 1, pods=len(retry_pods)):
                state_nodes, nominated = self.nominated_view(retry_pods)
                retry_results = self._schedule_journaled(retry_pods, state_nodes, nominated=nominated)
                any_unschedulable |= bool(retry_results.unschedulable)
                ice_failed = []
                launched += self.launch_nodes(retry_results, ice_failures=ice_failed)
        if ice_failed:
            self._park_ice_failures(ice_failed)
        # requeue-with-backoff liveness: ANY pod left unschedulable this
        # round — in the primary solve or a capacity re-solve whose universe
        # was fully quarantined — re-enters on the deadline, with no fresh
        # pod event needed
        self._unschedulable_retry_at = (
            self.clock.now() + self.ice_backoff_seconds if any_unschedulable else None
        )
        root.set(
            pods=len(pods),
            launched=len(launched),
            on_existing=sum(len(v.pods) for v in results.existing_nodes),
            unschedulable=len(results.unschedulable),
        )
        if pods:
            log.info(
                "provisioned batch: %d pods -> %d new nodes (%d launched), %d on existing, %d unschedulable in %.0f ms",
                len(pods),
                len([n for n in results.new_nodes if n.pods]),
                len(launched),
                sum(len(v.pods) for v in results.existing_nodes),
                len(results.unschedulable),
                (self.clock.now() - start) * 1000,
            )
        return results

    def _schedule_journaled(
        self, pods: Sequence[Pod], state_nodes: Sequence[object], nominated: Sequence[tuple] = ()
    ) -> SchedulingResults:
        """schedule() plus per-pod lifecycle events — ONLY for the real
        provisioning round (simulation re-solves through schedule() directly
        and must journal nothing, like the decision log)."""
        if not JOURNAL.enabled:
            return self.schedule(pods, state_nodes, nominated=nominated)
        rid_before = FLIGHT.last_record_id()
        results = self.schedule(pods, state_nodes, nominated=nominated)
        rid = FLIGHT.last_record_id()
        self._journal_solve_results(results, rid if rid != rid_before else None)
        return results

    def _journal_solve_results(self, results: SchedulingResults, flight_record) -> None:
        """Per-pod `solved`/`failed` journal events cross-linked to the
        round's trace and (when the dense path dispatched) the flight-record
        solve id. First occurrence wins in the journal, so an ICE re-solve
        never rewrites a pod's original solve instant."""
        trace_id = TRACER.current_trace_id() or ""
        for vn in results.new_nodes:
            if not vn.pods:
                continue
            instance_type = vn.instance_type_options[0].name() if vn.instance_type_options else ""
            for pod in vn.pods:
                JOURNAL.pod_event(
                    pod.metadata.name, "solved", placement="new", provisioner=vn.provisioner_name,
                    instance_type=instance_type, trace_id=trace_id, flight_record=flight_record,
                )
        for view in results.existing_nodes:
            provisioner = view.node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL, "")
            for pod in view.pods:
                JOURNAL.pod_event(
                    pod.metadata.name, "solved", placement="existing", provisioner=provisioner,
                    node=view.node.name, trace_id=trace_id, flight_record=flight_record,
                )
        for pod, err in results.unschedulable.items():
            JOURNAL.pod_event(pod.metadata.name, "failed", error=str(err)[:200], trace_id=trace_id)

    def nominated_view(self, pods: Sequence[Pod]) -> tuple:
        """What a re-solve of `pods` solves on: the state nodes with the
        live nominations of cluster state's record counted on them, and
        those (node name, pods) pairs for the topology
        (`schedule(nominated=)`); `pods` themselves are left out."""
        nominated = self.cluster.nominations(solving=pods)
        return self.nominated_snapshot(nominated), nominated

    def nominated_snapshot(self, placed: Sequence[tuple]) -> List[object]:
        """The cluster's state nodes with the (node name, pods) placements
        of `placed` counted on them (a pair whose node is not in cluster
        state counts nowhere). Where a pair falls on them, it is a plain
        list with no snapshot epoch: its views are not the cluster's
        snapshot, so a solve on them bypasses the incremental engine (its
        resident state is neither read nor written, and no audit runs), as a
        simulation does. The nominations are in no journal, so the engine's
        rows could not show them. Where none does, it is the snapshot
        itself, and the engine serves it."""
        snapshot = self.cluster.nodes_snapshot()
        by_name = {state.name: state for state in snapshot}
        if not any(name in by_name for name, _ in placed):
            return snapshot
        for name, pods in placed:
            state = by_name.get(name)
            if state is not None:
                for pod in pods:
                    state.add_pod(pod)
        return list(snapshot)

    def _park_ice_failures(self, failed_nodes) -> None:
        """Terminal rung of the escalation ladder: every re-solve attempt
        still hit insufficient capacity. Mark each pod unschedulable — an
        event, a per-pod decision-log record naming the failure, and a
        backoff that keeps the pod out of the next batches until the
        unavailable-offering TTL has a chance to restore a pool."""
        retry_at = self.clock.now() + self.ice_backoff_seconds
        for vn in failed_nodes:
            for pod in vn.pods:
                self.recorder.pod_failed_to_schedule(
                    pod, "insufficient capacity: every offering exhausted; backing off"
                )
                if TRACER.enabled:
                    DECISIONS.record(
                        DecisionRecord(
                            pod=pod.metadata.name,
                            outcome=OUTCOME_FAILED,
                            provisioner=vn.provisioner_name,
                            trace_id=TRACER.current_trace_id() or "",
                            error="insufficient capacity: escalation exhausted (next-offering, next-type, re-solve)",
                        )
                    )
                if JOURNAL.enabled:
                    JOURNAL.pod_event(
                        pod.metadata.name, "failed", error="insufficient capacity: escalation exhausted"
                    )
                while len(self._ice_backoff) >= 4096:
                    del self._ice_backoff[next(iter(self._ice_backoff))]
                self._ice_backoff[(pod.namespace, pod.metadata.name)] = retry_at
        log.warning(
            "capacity-failure escalation exhausted for %d pod(s); backing off %.1fs",
            sum(len(vn.pods) for vn in failed_nodes),
            self.ice_backoff_seconds,
        )

    def get_pods(self) -> List[Pod]:
        """Pending provisionable pods, PVC-validated, topology-injected.

        Volume-topology injection operates on a copy: the stored pod object
        is user state and must not accumulate injected requirements across
        rounds (the pod stays pending if a round fails)."""
        import copy

        now = self.clock.now()
        pods = []
        seen_parkable = set()
        for pod in self.kube.list_pods():
            if not podutils.is_provisionable(pod):
                continue
            key = (pod.namespace, pod.metadata.name)
            seen_parkable.add(key)
            backoff = self._ice_backoff.get(key)
            if backoff is not None:
                if backoff > now:
                    continue  # parked by the capacity-failure escalation
                del self._ice_backoff[key]
            err = self.volume_topology.validate_persistent_volume_claims(pod)
            if err is not None:
                self.recorder.pod_failed_to_schedule(pod, err)
                continue
            if self.volume_topology.needs_injection(pod):
                # Pod.__deepcopy__ drops the per-pod memo caches, so the
                # injected affinity is re-derived by every consumer
                pod = copy.deepcopy(pod)
                self.volume_topology.inject(pod)
            pods.append(pod)
        # sweep backoff entries whose pod is gone (deleted) or no longer
        # provisionable (bound): a stale entry's past deadline would pin
        # Batcher.wait's deadline in the past forever — a busy loop of
        # empty provision rounds until process restart
        for key in [k for k in self._ice_backoff if k not in seen_parkable]:
            del self._ice_backoff[key]
        return pods

    def schedule(
        self,
        pods: Sequence[Pod],
        state_nodes: Sequence[object],
        opts: Optional[SchedulerOptions] = None,
        nominated: Sequence[tuple] = (),
    ) -> SchedulingResults:
        # a provisioner being deleted must not place new capacity
        # (provisioning suite: "should ignore provisioners that are deleting")
        provisioners = [p for p in self.kube.list_provisioners() if p.metadata.deletion_timestamp is None]
        if self.remote_solver is not None and len(pods) >= self._remote_min_batch():
            from ...scheduler.builder import apply_kubelet_max_pods

            # the same kubelet maxPods cap the local build applies — the
            # client materializes launch options from THIS universe, so an
            # uncapped list would launch nodes at native pod density
            instance_types = {
                p.name: apply_kubelet_max_pods(p, self.cloud_provider.get_instance_types(p)) for p in provisioners
            }
            with TRACER.span("solve-remote", pods=len(pods)):
                results = self.remote_solver.solve(
                    provisioners,
                    instance_types,
                    pods,
                    daemonset_pods=self.daemonset_pods(),
                    state_nodes=state_nodes,
                    kube=self.kube,
                    simulation_mode=bool(opts and opts.simulation_mode),
                    exclude_nodes=list(opts.exclude_nodes) if opts else [],
                    nominated=nominated,
                )
            if not (opts and opts.simulation_mode):
                for pod, err in results.unschedulable.items():
                    self.recorder.pod_failed_to_schedule(pod, err)
            return results
        scheduler = build_scheduler(
            provisioners,
            self.cloud_provider,
            pods,
            kube=self.kube,
            cluster=self.cluster,
            state_nodes=state_nodes,
            daemonset_pods=self.daemonset_pods(),
            opts=opts,
            recorder=self.recorder,
            dense_solver=self.dense_solver,
            nominated=nominated,
        )
        return scheduler.solve(pods)

    def _remote_min_batch(self) -> int:
        """Below the host/device crossover the wire trip plus the sidecar's
        device solve loses to the local exact loop on both latency and node
        cost — route small batches locally even when a sidecar is
        configured."""
        from ...utils.options import DENSE_MIN_BATCH_DEFAULT

        return self.dense_solver.min_batch if self.dense_solver is not None else DENSE_MIN_BATCH_DEFAULT

    def daemonset_pods(self) -> List[Pod]:
        """Pod templates of every DaemonSet, for per-template overhead."""
        return [ds.pod_template() for ds in self.kube.list("DaemonSet")]

    # -- launching ---------------------------------------------------------------

    # upper bound on concurrent cloud Create calls; the reference fans out
    # one goroutine per node (provisioner.go:176 ParallelizeUntil with
    # workers == len(nodes)) — a cap keeps thread count sane at 10k scale
    LAUNCH_WORKERS = 50

    def launch_nodes(
        self,
        results: SchedulingResults,
        ice_failures: Optional[List[object]] = None,
        placed: Optional[List[tuple]] = None,
    ) -> List[str]:
        """Launch the round's new nodes. `ice_failures` (caller-owned, so
        concurrent callers — the interruption controller's replacement
        launch — never share state) collects the virtual nodes whose launch
        hit a typed InsufficientCapacityError: the fallback re-solve input.
        `placed` (caller-owned too) collects a (node name, pods) pair for
        each launched node and each existing node nominated pods; every such
        pair enters cluster state's record of nominations, whoever called."""
        with TRACER.span("launch") as sp:
            launched = self._launch_nodes(results, ice_failures, placed)
            sp.set(nodes=len(launched))
        return launched

    def _launch_nodes(
        self,
        results: SchedulingResults,
        ice_failures: Optional[List[object]] = None,
        placed: Optional[List[tuple]] = None,
    ) -> List[str]:
        provisioners = {p.name: p for p in self.kube.list_provisioners()}
        to_launch = [vn for vn in results.new_nodes if vn.pods]

        # limits prescreen stays serial with projected usage so a concurrent
        # batch cannot blow through a provisioner limit mid-flight (the
        # sequential loop got this accounting for free via cluster state)
        approved = []
        projected: Dict[str, Dict[str, float]] = {}
        usage_snapshot: Dict[str, Dict[str, float]] = {}  # state is frozen until creates start
        for vn in to_launch:
            provisioner = provisioners.get(vn.provisioner_name)
            if provisioner is not None and provisioner.spec.limits is not None:
                if vn.provisioner_name not in usage_snapshot:
                    usage_snapshot[vn.provisioner_name] = self._provisioner_usage(vn.provisioner_name)
                usage = res.merge(usage_snapshot[vn.provisioner_name], projected.get(vn.provisioner_name, {}))
                reason = provisioner.spec.limits.exceeded_by(usage)
                if reason is not None:
                    log.warning("not launching node for provisioner %s: limits exceeded: %s", vn.provisioner_name, reason)
                    for pod in vn.pods:
                        self.recorder.pod_failed_to_schedule(pod, f"limits exceeded: {reason}")
                    continue
                # the provider may land on ANY surviving option, so project the
                # per-resource max across options — the same conservative
                # subtractMax stance the scheduler's limit filtering takes
                estimate: Dict[str, float] = {}
                for it in vn.instance_type_options:
                    for k, v in it.resources().items():
                        if v > estimate.get(k, 0.0):
                            estimate[k] = v
                projected[vn.provisioner_name] = res.merge(projected.get(vn.provisioner_name, {}), estimate)
            approved.append(vn)

        # fan out the cloud Create calls — one slow or failing launch neither
        # serializes nor aborts its siblings (provisioner.go:172-190). The
        # ambient span is thread-local, so the pool workers parent their
        # launch-node spans under an explicitly captured context.
        parent_ctx = TRACER.current_context()
        if len(approved) <= 1:
            names = [self._launch(vn, parent_ctx, ice_failures) for vn in approved]
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(len(approved), self.LAUNCH_WORKERS)) as pool:
                names = list(pool.map(lambda vn: self._launch(vn, parent_ctx, ice_failures), approved))
        launched = [n for n in names if n is not None]
        pairs = [(name, vn.pods) for name, vn in zip(names, approved) if name is not None]
        # nominate pods onto existing nodes they were scheduled against
        with TRACER.span("bind") as sp:
            nominated = 0
            journal_on = JOURNAL.enabled
            for view in results.existing_nodes:
                if view.pods:
                    self.cluster.nominate_node_for_pod(view.node.name)
                    for pod in view.pods:
                        self.recorder.nominate_pod(pod, view.node)
                        nominated += 1
                        if journal_on:
                            JOURNAL.pod_event(pod.metadata.name, "nominated", node=view.node.name)
                    pairs.append((view.node.name, view.pods))
            sp.set(nominated=nominated)
        # every re-solve reads what this launch nominated until the pods bind
        self.cluster.nominate_pods(pairs)
        if placed is not None:
            placed += pairs
        return launched

    def _launch(self, virtual_node, parent_ctx=None, ice_failures: Optional[List[object]] = None) -> Optional[str]:
        with TRACER.span(
            "launch-node", parent=parent_ctx, provisioner=virtual_node.provisioner_name, pods=len(virtual_node.pods)
        ) as sp:
            return self._launch_one(virtual_node, sp, ice_failures)

    def _launch_one(self, virtual_node, sp, ice_failures: Optional[List[object]] = None) -> Optional[str]:
        requested_as = getattr(virtual_node, "_hostname", "")
        if JOURNAL.enabled and requested_as:
            JOURNAL.node_event(
                requested_as, "launch-requested", provisioner=virtual_node.provisioner_name,
                pods=len(virtual_node.pods), trace_id=TRACER.current_trace_id() or "",
            )
        try:
            node = self.cloud_provider.create(
                NodeRequest(template=virtual_node.template, instance_type_options=virtual_node.instance_type_options)
            )
        except InsufficientCapacityError as e:
            # typed capacity failure: the provider already quarantined the
            # exhausted pools; hand the virtual node to the caller's
            # fallback re-solve (list.append is atomic — pool workers share
            # the caller's list safely)
            log.warning("insufficient capacity for provisioner %s: %s", virtual_node.provisioner_name, e)
            sp.set(error=str(e), insufficient_capacity=True)
            self.launch_failures.inc(reason="insufficient_capacity")
            if ice_failures is not None:
                ice_failures.append(virtual_node)
            for pod in virtual_node.pods:
                self.recorder.pod_failed_to_schedule(pod, f"launch failed: {e}")
            return None
        except Exception as e:  # noqa: BLE001 - capacity errors self-heal next batch
            log.warning("node launch failed for provisioner %s: %s", virtual_node.provisioner_name, e)
            sp.set(error=str(e))
            self.launch_failures.inc(reason="other")
            for pod in virtual_node.pods:
                self.recorder.pod_failed_to_schedule(pod, f"launch failed: {e}")
            return None
        if JOURNAL.enabled:
            # `launched` (cloud instance exists) precedes `registered` (the
            # node object lands in the API on the create below)
            JOURNAL.node_event(
                node.name, "launched", requested_as=requested_as,
                instance_type=node.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE, ""),
                provisioner=virtual_node.provisioner_name, trace_id=TRACER.current_trace_id() or "",
            )
        try:
            self.kube.create(node)
        except Conflict:
            # idempotent create (provisioner.go:317-328) — absorbed, never
            # silent: the log names the node so a leader-flap double-register
            # is attributable instead of vanishing into a bare `pass`
            log.info("node %s already registered (create conflict absorbed)", node.name)
        sp.set(node=node.name, instance_type=node.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE, ""))
        if TRACER.enabled:
            # the scheduler recorded placed-new against the placeholder
            # hostname; the audit record should name the real instance.
            # Matching on the placeholder means launches fed by simulated
            # solves (which recorded nothing) back-fill nothing.
            DECISIONS.update_node(
                [p.name for p in virtual_node.pods],
                node.name,
                node.metadata.labels.get(lbl.LABEL_INSTANCE_TYPE, ""),
                placeholder=getattr(virtual_node, "_hostname", ""),
            )
        self.recorder.launching_node(node, f"for {len(virtual_node.pods)} pod(s)")
        self.cluster.nominate_node_for_pod(node.name)
        journal_on = JOURNAL.enabled
        for pod in virtual_node.pods:
            self.recorder.nominate_pod(pod, node)
            if journal_on:
                JOURNAL.pod_event(pod.metadata.name, "nominated", node=node.name)
        return node.name

    def _provisioner_usage(self, provisioner_name: str) -> Dict[str, float]:
        """Current provisioned capacity for the provisioner, from cluster
        state so in-flight nodes count immediately (counter semantics)."""
        usage: Dict[str, float] = {}

        def visit(state) -> bool:
            nonlocal usage
            if state.node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) == provisioner_name:
                usage = res.merge(usage, state.capacity)
            return True

        self.cluster.for_each_node(visit)
        return usage
