"""Counter controller: per-provisioner provisioned-resource rollup.

Mirrors pkg/controllers/counter/controller.go — sums cluster-state capacity
(so in-flight nodes count immediately) into Provisioner.status.resources,
which the limits check consumes.

The port's copy of karpenter_tpu/controllers/counter/controller.py.
"""

from __future__ import annotations

from typing import Dict

from ...api import labels as lbl
from ...kube.cluster import KubeCluster
from ...utils import resources as res
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
            if provisioner.status.resources != new_totals:  # avoid no-op update churn
                provisioner.status.resources = new_totals
                self.kube.update(provisioner)
