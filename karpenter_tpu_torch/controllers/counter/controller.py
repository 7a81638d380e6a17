"""Counter controller: per-provisioner provisioned-resource rollup.

Mirrors pkg/controllers/counter/controller.go — sums cluster-state capacity
(so in-flight nodes count immediately) into Provisioner.status.resources,
which the limits check consumes.

The port's copy of karpenter_tpu/controllers/counter/controller.py. The
status write goes through the backend's retry_on_conflict to the
Provisioner's status subresource, so it lands the status only and runs no
admission: a Provisioner another client wrote with no admission keeps the
spec it was written with (the reference's full update defaults it). A
conflict no retry absorbed leaves the provisioner to the next pass.
"""

from __future__ import annotations

from typing import Dict

from ...api import labels as lbl
from ...api.provisioner import Provisioner
from ...kube.cluster import Conflict, KubeCluster
from ...utils import resources as res
from ..edits import requeue
from ..state.cluster import Cluster


class CounterController:
    def __init__(self, kube: KubeCluster, cluster: Cluster):
        self.kube = kube
        self.cluster = cluster

    def reconcile_all(self) -> None:
        totals: Dict[str, Dict[str, float]] = {}

        def visit(state) -> bool:
            name = state.node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
            if name is not None:
                totals[name] = res.merge(totals.get(name, {}), state.capacity)
            return True

        self.cluster.for_each_node(visit)
        for provisioner in self.kube.list_provisioners():
            new_totals = totals.get(provisioner.name, {})

            def mutate(fresh: Provisioner, new_totals=new_totals) -> bool:
                if fresh.status.resources == new_totals:  # avoid no-op update churn
                    return False
                fresh.status.resources = new_totals
                return True

            try:
                self.kube.retry_on_conflict(
                    "Provisioner", provisioner.name, provisioner.metadata.namespace, mutate, held=provisioner, status_only=True
                )
            except Conflict as err:
                requeue("CounterController", provisioner, err)
