"""Garbage-collection controller: the cloud/node two-way reconciliation sweep.

The reference survives controller crashes because the apiserver + cloud are
the source of truth and a node-GC controller continuously reconciles one
against the other (pkg/controllers/node + the cloud provider's instance GC).
Before this sweep, the only GC here was message-driven — the interruption
controller reacting to instance_stopped/instance_terminated notices — which
a crash can lose entirely (the queue delivers at-least-once, but a consumer
that never existed when the notice dead-lettered never acts on it).

The sweep runs at startup and on an interval, in BOTH directions:

  orphans — cloud instances with no matching node object: a crash between
            CreateFleet and kube.create leaks a paid instance with nothing
            pointing at it. Instances older than the registration grace
            period (fresh launches are still in their legitimate
            launch->register window) are terminated at the cloud.
  ghosts  — node objects whose backing instance is GONE (reclaimed, stopped,
            terminated out-of-band while we were down): the node is deleted
            and handed to the termination controller, whose drain evicts the
            (unreachable) pods so their controllers reschedule them onto
            live capacity.

Counters per direction (karpenter_gc_collected_total{direction}) plus a
sweep counter make crash-recovery convergence observable and testable.

The port's copy of karpenter_tpu/controllers/gc/controller.py; its two
registry counters are plain tallies (the disruption controller's `Tally`,
same names and labels) until the port has a metrics registry (ROADMAP A8).
"""

from __future__ import annotations

from typing import List

from ...api import labels as lbl
from ...logsetup import get_logger
from ..disruption.controller import Tally

log = get_logger("gc")

DIRECTION_ORPHANED_INSTANCE = "orphaned-instance"
DIRECTION_GHOST_NODE = "ghost-node"

# how long a freshly launched instance may exist without a node object
# before the sweep treats it as leaked; must comfortably exceed the
# create->register window (fleet batcher window + kube.create)
DEFAULT_REGISTRATION_GRACE = 30.0


class GarbageCollectionController:
    def __init__(
        self,
        kube,
        cluster,
        cloud_provider,
        termination=None,
        clock=None,
        registration_grace: float = DEFAULT_REGISTRATION_GRACE,
    ):
        from ...utils.clock import Clock

        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.termination = termination
        self.clock = clock or (kube.clock if kube is not None else None) or Clock()
        self.registration_grace = registration_grace
        # objects reconciled away by the sweep, by direction (orphaned-
        # instance: cloud instance with no node; ghost-node: node whose
        # instance is gone), and sweeps completed
        self.collected = Tally()
        self.sweeps = Tally()

    # -- the sweep -----------------------------------------------------------

    def reconcile(self) -> dict:
        """One full two-way sweep; returns {'orphans': [...], 'ghosts': [...]}
        (the ids/names collected) so callers and tests can assert on it.

        Both directions reconcile against ONE instance-inventory snapshot
        (list_instances), so a provider without an inventory — the fake
        provider's fixture nodes, real clouds we only half-know — is never
        swept at all: deleting a node on anything less than the cloud's own
        word would turn a probe failure into capacity loss. Ordering
        matters: nodes are snapshotted BEFORE instances, so a node whose
        instance misses from the later listing is definitively a ghost
        (registration follows launch, never precedes it)."""
        nodes = list(self.kube.list_nodes())
        list_fn = getattr(self.cloud_provider, "list_instances", None)
        if list_fn is None:
            return {"orphans": [], "ghosts": []}  # no inventory: nothing to reconcile against
        try:
            instances = list_fn()
        except Exception as err:  # noqa: BLE001 - a degraded cloud must not kill the loop
            log.warning("gc sweep: list_instances failed (will retry next sweep): %s", err)
            return {"orphans": [], "ghosts": []}
        orphans = self._collect_orphans(nodes, instances)
        ghosts = self._collect_ghosts(nodes, {i.instance_id for i in instances})
        self.sweeps.inc()
        if orphans or ghosts:
            log.info("gc sweep: terminated %d orphaned instance(s) %s, finalized %d ghost node(s) %s",
                     len(orphans), orphans, len(ghosts), ghosts)
        return {"orphans": orphans, "ghosts": ghosts}

    # -- direction 1: cloud instances with no node ---------------------------

    def _collect_orphans(self, nodes, instances) -> List[str]:
        registered = set()
        for node in nodes:
            provider_id = node.spec.provider_id
            if provider_id:
                registered.add(provider_id.rsplit("/", 1)[-1])
        now = self.clock.now()
        collected: List[str] = []
        for instance in instances:
            if instance.instance_id in registered:
                continue
            if now - instance.launched_at < self.registration_grace:
                continue  # still inside its legitimate launch->register window
            try:
                self.cloud_provider.terminate_instance(instance.instance_id)
            except Exception as err:  # noqa: BLE001 - next sweep retries
                log.warning("gc: terminating orphaned instance %s failed: %s", instance.instance_id, err)
                continue
            self.collected.inc(direction=DIRECTION_ORPHANED_INSTANCE)
            collected.append(instance.instance_id)
        return collected

    # -- direction 2: nodes whose instance is gone ---------------------------

    def _collect_ghosts(self, nodes, live_ids: set) -> List[str]:
        collected: List[str] = []
        for node in nodes:
            if lbl.PROVISIONER_NAME_LABEL not in node.metadata.labels:
                continue  # not ours
            if node.metadata.deletion_timestamp is not None:
                continue  # already terminating: that controller owns it
            provider_id = node.spec.provider_id
            if not provider_id:
                continue  # never registered a cloud identity: unknowable
            if provider_id.rsplit("/", 1)[-1] in live_ids:
                continue
            self.collected.inc(direction=DIRECTION_GHOST_NODE)
            collected.append(node.name)
            self.kube.delete(node)
            if self.termination is not None:
                refreshed = self.kube.get_node(node.name)
                if refreshed is not None:
                    # drive the drain/finalize protocol now: the pods on a
                    # dead instance must reschedule, not wait for a tick
                    self.termination.reconcile(refreshed)
        return collected
