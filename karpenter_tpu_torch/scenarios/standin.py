"""Workload stand-in: kubelet + kube-scheduler + ReplicaSet, minimally.

The generalized form of the cluster stand-in the interruption- and
disruption-storm tests each hand-rolled: a thread that

- flips freshly launched nodes Ready (the kubelet),
- binds pending pods first-fit onto schedulable live capacity (the
  kube-scheduler) — live meaning the backing instance still exists,
- reconciles the replica count to the scenario's mutable `desired`
  (the ReplicaSet controller), scaling down pending-first so shrink waves
  exercise the deleted-while-Pending SLO path.

Everything else — provisioning new capacity, draining interrupted nodes,
replacing drifted ones — is the Runtime's job; the stand-in only plays the
cluster around it.

The port's copy of karpenter_tpu/scenarios/standin.py.
"""

from __future__ import annotations

import itertools
import random
import threading
from typing import Optional

from ..api.objects import Container, NodeCondition, ObjectMeta, OwnerReference, Pod, PodCondition, PodSpec, PodStatus, ResourceRequirements
from ..logsetup import get_logger
from .primitives import ScenarioContext

log = get_logger("standin")

_counter = itertools.count(1)


def workload_pod(cpu: float, app: str = "scenario") -> Pod:
    """A pending, unschedulable, ReplicaSet-owned pod (the provisionable
    shape, without importing test fixtures into the package)."""
    name = f"load-{next(_counter):06d}"
    return Pod(
        metadata=ObjectMeta(
            name=name,
            namespace="default",
            labels={"app": app},
            owner_references=[OwnerReference(kind="ReplicaSet", name=f"{app}-rs")],
        ),
        spec=PodSpec(
            containers=[Container(resources=ResourceRequirements(requests={"cpu": cpu, "memory": 256 * 2**20}))]
        ),
        status=PodStatus(
            phase="Pending",
            conditions=[PodCondition(type="PodScheduled", status="False", reason="Unschedulable")],
        ),
    )


def pod_cpu_request(pod) -> float:
    return sum(c.resources.requests.get("cpu", 0.0) for c in pod.spec.containers)


def live_pods(kube):
    return [p for p in kube.list_pods() if p.status.phase not in ("Succeeded", "Failed")]


class WorkloadStandIn(threading.Thread):
    def __init__(self, ctx: ScenarioContext, tick_interval: float = 0.1, app: str = "scenario", jitter_seed: Optional[int] = None):
        super().__init__(daemon=True, name="workload-standin")
        self.ctx = ctx
        self.tick_interval = tick_interval
        self.app = app
        # seeded tick jitter (the kubelet/scheduler never tick on a metronome):
        # +-30% per tick from the scenario's fanned-out master seed, so the
        # stand-in's interleaving is part of the one-number reproducibility
        # story instead of an unseeded source of run-to-run drift
        self._jitter = random.Random(jitter_seed) if jitter_seed is not None else None

    def _tick_timeout(self) -> float:
        if self._jitter is None:
            return self.tick_interval
        return self.tick_interval * self._jitter.uniform(0.7, 1.3)

    def run(self) -> None:
        while not self.ctx.stop.wait(timeout=self._tick_timeout()):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the stand-in must survive races with the runtime
                log.debug("stand-in tick lost a race with the runtime; retrying next tick", exc_info=True)

    def tick(self) -> None:
        ctx = self.ctx
        nodes = ctx.kube.list_nodes()
        # kubelet: flip Ready
        for node in nodes:
            if not node.ready():
                node.status.conditions = [NodeCondition(type="Ready", status="True")]
                try:
                    ctx.kube.update(node)
                except Exception as err:  # noqa: BLE001 - lost update race with a controller
                    log.debug("kubelet stand-in ready-flip lost an update race on %s: %s", node.name, err)
        # kube-scheduler: first-fit cpu onto schedulable live capacity
        usable = []
        for node in nodes:
            if node.spec.unschedulable or node.metadata.deletion_timestamp is not None:
                continue
            instance_id = node.spec.provider_id.split("///", 1)[-1]
            if not ctx.backend.instance_exists(instance_id):
                continue
            used = sum(pod_cpu_request(p) for p in ctx.kube.pods_on_node(node.name))
            usable.append([node, node.status.allocatable.get("cpu", 0.0) - used])
        pods = live_pods(ctx.kube)
        for pod in pods:
            if pod.spec.node_name:
                continue
            need = pod_cpu_request(pod)
            for slot in usable:
                if slot[1] >= need:
                    try:
                        ctx.kube.bind_pod(pod, slot[0].name)
                    except Exception as err:  # noqa: BLE001 - pod deleted under us
                        log.debug("scheduler stand-in bind of %s raced a delete: %s", pod.metadata.name, err)
                        break
                    slot[1] -= need
                    break
        # ReplicaSet: reconcile to desired, both directions
        desired = ctx.desired
        pods = live_pods(ctx.kube)
        deficit = desired - len(pods)
        for _ in range(max(0, deficit)):
            ctx.kube.create(workload_pod(ctx.pod_cpu, app=self.app))
        if deficit < 0:
            # shrink pending-first (a ramp-down cancels queued work before
            # killing running replicas — and exercises the SLO rule that a
            # pod deleted while Pending observes nothing)
            doomed = sorted(pods, key=lambda p: (bool(p.spec.node_name), p.metadata.creation_timestamp))
            for pod in doomed[: -deficit]:
                ctx.kube.delete(pod, grace=False)
