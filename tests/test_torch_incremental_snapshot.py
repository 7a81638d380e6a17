"""The incremental engine serves the rows of the snapshot it was handed, held
beside the JAX package's engine on the CPU.

Two interleavings hand the JAX package's warm fill a stale resident row:

- A mutation recorded through the real feed (kube store -> watch -> Cluster
  -> delta journal) after `nodes_snapshot()` and before a full pass's
  solve. The reference checkpoints at the journal's epoch read inside
  `advance`, after the mutation, and a full pass keeps no window, so its
  next pass serves the row as it was: the mirror differs from a fresh
  encode of that pass's views, its auditor (every audit a full shadow at 8
  nodes) calls it a missed delta, and where the stale row shows more room
  than the node has, the fill books the node beyond it. The port
  checkpoints at the snapshot's epoch, read under the cluster lock with the
  nodes: its next pass re-encodes the row, and every one of those counts
  is 0.
- The capacity-failure re-solve, which solves on the round's nominated
  views. Handed to the engine as the cluster's snapshot (what the port did
  before its nominated views carried no epoch), the delta pass serves the
  standing nodes' rows without the round's nominations, and the re-solve
  books that room a second time. The port's re-solve bypasses the engine:
  its placements equal a round with no engine, the engine counts the pass
  as a bypass and the auditor does not count it. The reference's re-solve
  counts no nominations at all and books the room again, engine or none.

And the auditor's window: a record that lands after the snapshot and before
the audit's end is in the next audit's window, so a damaged mirror row of
that node is row-drift on the port, where the reference, whose window
starts at the audit's end, calls it a missed delta.

Tolerance: exact throughout (encoded rows byte for byte, placements,
divergence kinds and rows).
"""

from __future__ import annotations

import pytest

from karpenter_tpu.api import labels as ref_lbl
from karpenter_tpu.cloudprovider.fake import FakeCloudProvider as RefProvider
from karpenter_tpu.cloudprovider.fake import instance_types as ref_instance_types
from karpenter_tpu.controllers.state.cluster import Cluster as RefCluster
from karpenter_tpu.ir.encode import encode_warm_views as ref_encode_warm_views
from karpenter_tpu.kube.cluster import KubeCluster as RefKubeCluster
from karpenter_tpu.scheduler import build_scheduler as ref_build_scheduler
from karpenter_tpu.solver import DenseSolver as RefDenseSolver
from karpenter_tpu.solver.audit import AUDITOR
from karpenter_tpu.solver.incremental import IncrementalEngine as RefEngine
from karpenter_tpu.utils import resources as ref_res
from karpenter_tpu_torch import testing
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.controllers.state.cluster import Cluster, NodesSnapshot
from karpenter_tpu_torch.ir.encode import encode_warm_views
from karpenter_tpu_torch.kube.cluster import KubeCluster
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.solver import DenseSolver
from karpenter_tpu_torch.solver.audit import KIND_MISSED_DELTA, KIND_ROW_DRIFT, ResidencyAuditor
from karpenter_tpu_torch.solver.incremental import PASS_BYPASS, PASS_DELTA, PASS_FULL, IncrementalEngine
from karpenter_tpu_torch.utils import resources as res
from tests import helpers as ref_helpers
from tests.test_torch_provisioner_ice import _batch, _nominations, _refused_types, _strict
from tests.test_torch_provisioning import Kit, outcome, reference_singletons  # noqa: F401

NODES = 8  # at most the auditors' sample: every audit is a full shadow
TYPES = 20
BATCH = 20  # churn_batch pods of 0.5 CPU / 512Mi: 10 CPU, all onto one empty node
FILLED, EMPTIED = "churn-n0000", "churn-n0001"
FIELDS = ("usable", "avail_tol", "requests0", "head0")

REF_KNOBS = ("enabled", "interval", "sample_rows", "shadow_every", "shadow_budget_bytes", "seed")


@pytest.fixture(autouse=True)
def _reference_auditor():
    """The JAX package's process-wide auditor, restored after the test."""
    saved = {k: getattr(AUDITOR, k) for k in REF_KNOBS}
    AUDITOR.reset()
    yield
    vars(AUDITOR).pop("maybe_audit", None)  # a test's recording wrapper
    AUDITOR.reset()
    for k, v in saved.items():
        setattr(AUDITOR, k, v)


def _stale_rows(views, enc, encode) -> list:
    """The names of the rows of `enc` that differ from a fresh encode of
    `views` in any encoded field."""
    fresh = encode(views)
    return [
        v.node.name
        for i, v in enumerate(views)
        if any(getattr(fresh, f)[i].tobytes() != getattr(enc, f)[i].tobytes() for f in FIELDS)
        or (fresh.zone[i], fresh.ct[i], fresh.hostname[i], tuple(fresh.taint_sig[i]))
        != (enc.zone[i], enc.ct[i], enc.hostname[i], tuple(enc.taint_sig[i]))
    ]


class _Side:
    """One package's standing cluster (testing.standing_cluster's NODES
    fake-it-15 nodes, created through the kube store) with a persistent
    incremental DenseSolver, its auditor on or off. Every engine pass
    records its kind and the rows it served that differ from a fresh encode
    of its own views; every audit records its findings."""

    def __init__(self, side: str, audit: bool):
        self.side = side
        if side == "ref":
            self.kube = RefKubeCluster()
            for i in range(NODES):
                self.kube.create(ref_helpers.make_node(**_standing_node(i)))
            self.cluster = RefCluster(self.kube, None)
            self.engine = RefEngine(self.cluster.delta_journal)
            self.solver = RefDenseSolver(min_batch=1, use_mesh=False, incremental=self.engine)
            self.provider, self.provisioners = RefProvider(ref_instance_types(TYPES)), [ref_helpers.make_provisioner()]
            self.build, self.encode, self.make_pod, self.res = ref_build_scheduler, ref_encode_warm_views, ref_helpers.make_pod, ref_res
            if audit:
                AUDITOR.enable(interval=1, shadow_every=1, seed=3)
            else:
                AUDITOR.disable()
            self.auditor = AUDITOR
            self.last_divergence = lambda: AUDITOR._last_divergence
        else:
            self.kube = KubeCluster()
            testing.standing_cluster(self.kube, NODES)
            self.cluster = Cluster(self.kube, None)
            self.engine = IncrementalEngine(self.cluster.delta_journal, device="cpu")
            self.auditor = ResidencyAuditor(seed=3, interval=1) if audit else None
            self.solver = DenseSolver(min_batch=1, device="cpu", incremental=self.engine, auditor=self.auditor)
            self.provider, self.provisioners = FakeCloudProvider(instance_types(TYPES)), [testing.make_provisioner()]
            self.build, self.encode, self.make_pod, self.res = build_scheduler, encode_warm_views, testing.make_pod, res
            self.last_divergence = lambda: self.auditor.last_divergence
        self.passes, self.stale, self.findings = [], [], []
        self._pods = 0
        advance = self.engine.advance

        def recording(views, *args):
            adv = advance(views, *args)
            self.passes.append((adv.kind, adv.reason))
            self.stale.append(_stale_rows(views, adv.enc, self.encode) if adv.enc is not None else [])
            return adv

        self.engine.advance = recording
        if audit:
            maybe_audit = self.auditor.maybe_audit

            def audited(*args, **kwargs):
                report = maybe_audit(*args, **kwargs)
                found = self.last_divergence()["findings"] if report is not None else []
                self.findings[-1] += [(f["row"], f["kind"]) for f in found]
                return report

            self.auditor.maybe_audit = audited

    def bound_pod(self, node: str, cpu, memory: str):
        self._pods += 1
        return self.make_pod(
            name=f"bound-{self._pods:03d}", requests={"cpu": cpu, "memory": memory},
            node_name=node, phase="Running", unschedulable=False,
        )

    def fill(self, node: str) -> None:
        """Bind a pod that takes the node's whole room."""
        self.kube.create(self.bound_pod(node, 16, "32Gi"))

    def empty(self, node: str) -> None:
        """Delete every pod bound to the node."""
        for pod in self.kube.list_pods():
            if pod.spec.node_name == node:
                self.kube.delete(pod, grace=False)

    def solve(self, step: int, mutate=None) -> dict:
        """One pass: the snapshot, then `mutate()` through the kube store,
        then the solve of churn_batch(step) on the snapshot. Returns the
        nodes booked beyond their room (the snapshot's bound pods and the
        pass's placements) and whether the placements equal a fresh
        solver's on the same snapshot and batch."""
        snapshot = self.cluster.nodes_snapshot()
        if mutate is not None:
            mutate()
        self.findings.append([])
        pods = testing.churn_batch(step, BATCH) if self.side == "port" else _ref_batch(step)
        results = self.build(self.provisioners, self.provider, pods, cluster=self.cluster, state_nodes=snapshot, dense_solver=self.solver).solve(pods)
        fresh_solver = RefDenseSolver(min_batch=1, use_mesh=False) if self.side == "ref" else DenseSolver(min_batch=1, device="cpu")
        fresh = self.build(self.provisioners, self.provider, pods, cluster=self.cluster, state_nodes=snapshot, dense_solver=fresh_solver).solve(pods)
        return {"overbooked": _overbooked(snapshot, results, self.res), "same_as_fresh": _placements(results) == _placements(fresh)}


def _standing_node(i: int) -> dict:
    """testing.standing_cluster's node i, as the reference's make_node
    arguments."""
    return dict(
        name=f"churn-n{i:04d}",
        labels={
            ref_lbl.PROVISIONER_NAME_LABEL: "default",
            ref_lbl.LABEL_INSTANCE_TYPE: "fake-it-15",
            ref_lbl.LABEL_TOPOLOGY_ZONE: testing.ZONES[i % 3],
            ref_lbl.LABEL_CAPACITY_TYPE: "on-demand",
        },
        allocatable={"cpu": 16, "memory": "32Gi", "pods": 110},
    )


def _ref_batch(step: int) -> list:
    return [
        ref_helpers.make_pod(name=f"churn-p{step:03d}-{i:03d}", labels={"app": "delta"}, requests={"cpu": 0.5, "memory": "512Mi"})
        for i in range(BATCH)
    ]


def _overbooked(snapshot, results, resources) -> list:
    """The nodes whose bound pods (as the snapshot has them) and this pass's
    placements together request more than the node has, in any resource."""
    by_name = {s.name: s for s in snapshot}
    over = []
    for view in results.existing_nodes:
        free = dict(by_name[view.node.name].available)
        for pod in view.pods:
            free = resources.subtract(free, resources.pod_requests(pod))
        if any(v < -1e-6 for v in free.values()):
            over.append(view.node.name)
    return sorted(over)


def _placements(results):
    return (
        sorted((v.node.name, tuple(sorted(p.name for p in v.pods))) for v in results.existing_nodes if v.pods),
        sorted(tuple(sorted(p.name for p in n.pods)) for n in results.new_nodes if n.pods),
    )


def _run(side: str, mutation: str, full: str, audit: bool) -> tuple:
    """The pass with the planted mutation (the cold pass, or a full pass
    forced with reason 'audit' after a clean cold and delta pass), then the
    next pass on a fresh snapshot with no mutation. Returns the side and
    the two passes' records."""
    s = _Side(side, audit)
    if mutation == "remove":
        for _ in range(3):
            s.kube.create(s.bound_pod(EMPTIED, 4, "8Gi"))
    step = 0
    if full == "audit":
        for _ in range(2):
            s.solve(step)
            step += 1
        s.engine.invalidate("audit")
    plant = (lambda: s.fill(FILLED)) if mutation == "bind" else (lambda: s.empty(EMPTIED))
    planted = s.solve(step, plant)
    after = s.solve(step + 1)
    return s, planted, after


@pytest.mark.parametrize("full", ["cold", "audit"])
@pytest.mark.parametrize("mutation", ["bind", "remove"])
def test_a_mutation_after_the_snapshot_on_a_full_pass(mutation, full):
    node = FILLED if mutation == "bind" else EMPTIED
    # with the auditors on: the reference's next audit calls the row a missed
    # delta; the port's finds nothing
    ref, _, _ = _run("ref", mutation, full, audit=True)
    port, planted, after = _run("port", mutation, full, audit=True)
    assert ref.passes[-2][0] == port.passes[-2][0] == PASS_FULL and port.passes[-2][1] == full
    assert ref.stale[-1] == [node], f"the reference's next pass served {ref.stale[-1]}"
    assert ref.findings[-1] == [(node, KIND_MISSED_DELTA)], ref.findings
    assert port.passes[-1] == (PASS_DELTA, "")
    assert port.stale == [[]] * len(port.passes) and port.findings == [[]] * len(port.findings)
    assert port.auditor.divergences == {}
    for rec in (planted, after):
        assert rec == {"overbooked": [], "same_as_fresh": True}

    # with the auditors off: the reference's row stays stale; where it shows
    # more room than the node has, the reference books the node beyond it
    ref, _, ref_after = _run("ref", mutation, full, audit=False)
    port, planted, after = _run("port", mutation, full, audit=False)
    assert ref.stale[-1] == [node] and ref.passes[-1][0] == PASS_DELTA
    assert port.stale == [[]] * len(port.passes) and port.passes[-1] == (PASS_DELTA, "")
    for rec in (planted, after):
        assert rec == {"overbooked": [], "same_as_fresh": True}
    if mutation == "bind":
        assert ref_after["overbooked"] == [FILLED] and not ref_after["same_as_fresh"]


def test_the_auditor_window_starts_at_the_snapshot():
    """A pod bound after the snapshot, while the pass runs (right after the
    engine advanced, before the audit ends), is in the next audit's window:
    the port's auditor checkpoints at the snapshot's epoch. A damaged mirror
    row of that node on the next pass is then row-drift, the journal having
    named the node; the reference's window starts at its audit's end and
    calls the same damage a missed delta."""
    kinds = {}
    for side in ("ref", "port"):
        s = _Side(side, audit=True)
        s.solve(0)
        advance, armed = s.engine.advance, ["bind", "damage"]

        def interleaved(views, *args):
            adv = advance(views, *args)
            if armed and armed[0] == "bind":
                armed.pop(0)
                s.kube.create(s.bound_pod(FILLED, 2, "4Gi"))
            elif armed:
                armed.pop(0)
                row = s.engine._resident.row_of[FILLED]
                s.engine._resident.enc.avail_tol[row] += 1.0
            return adv

        s.engine.advance = interleaved
        epoch = s.cluster.delta_journal.current_epoch()
        s.solve(1)
        if side == "port":
            assert s.auditor._last_epoch == epoch
            assert FILLED in s.cluster.delta_journal.dirty_since(s.auditor._last_epoch)
            assert s.findings[-1] == []
        s.solve(2)
        kinds[side] = s.findings[-1]
    assert kinds["port"] == [(FILLED, KIND_ROW_DRIFT)]
    assert kinds["ref"] == [(FILLED, KIND_MISSED_DELTA)]


# -- the capacity-failure re-solve under the engine ---------------------------


STANDING = 3


def _ice_round(k, engine: bool, audit: bool = False, as_snapshot: bool = False) -> dict:
    """tests/test_torch_provisioner_ice.py's strict round (every pool of the
    type the first round launched most is refused) on STANDING standing
    nodes, the dense solver carrying an engine (and an auditor) or not.
    `as_snapshot` hands the re-solve's nominated views to the engine as the
    cluster's snapshot, with the cluster's epoch."""

    def env_with_batch():
        k.reset_names()
        env = k.env(instance_types=k.fake.instance_types(TYPES))
        if k.side == "port":
            testing.standing_cluster(env.kube, STANDING)
        else:
            for i in range(STANDING):
                env.kube.create(ref_helpers.make_node(**_standing_node(i)))
        for pod in _batch(k):
            env.kube.create(pod)
        return env

    first = env_with_batch()
    first.provision()
    env = env_with_batch()
    _strict(env, k, _refused_types(first, k, "most_launched_type"))
    controller = env.provisioner_controller
    auditor = None
    if engine:
        if k.side == "port":
            auditor = ResidencyAuditor(seed=3, interval=1) if audit else None
            controller.dense_solver = DenseSolver(
                min_batch=1, device="cpu", incremental=IncrementalEngine(env.cluster.delta_journal, device="cpu"), auditor=auditor,
            )
        else:
            controller.dense_solver = RefDenseSolver(min_batch=1, use_mesh=False, incremental=RefEngine(env.cluster.delta_journal))
    if as_snapshot:
        nominated = controller.nominated_snapshot

        def with_epoch(placed):
            return NodesSnapshot(nominated(placed), env.cluster.delta_journal.current_epoch())

        controller.nominated_snapshot = with_epoch
    schedules = []
    schedule = controller.schedule

    def watched(pods, state_nodes, opts=None, **kwargs):
        before = dict(controller.dense_solver.incremental.passes) if engine else {}
        results = schedule(pods, state_nodes, opts, **kwargs)
        after = dict(controller.dense_solver.incremental.passes) if engine else {}
        kinds = [kind for kind in after if after[kind] != before.get(kind, 0)]
        schedules.append({"pods": len(pods), "pass": kinds, "on_existing": sum(len(v.pods) for v in results.existing_nodes)})
        return results

    controller.schedule = watched
    env.provision()
    standing = {f"churn-n{i:04d}" for i in range(STANDING)}
    return {
        "schedules": schedules,
        "overbooked": _over_room(env, k),
        "nominated_onto_standing": sum(len(p) for name, p in _nominations(env).items() if name in standing),
        "outcome": outcome(env, k),
        "auditor": None if auditor is None else {"passes": auditor.passes, "audits": auditor.audits, "divergences": dict(auditor.divergences)},
    }


def _over_room(env, k) -> list:
    """tests/test_torch_provisioner_ice.py's _overbooked by node name: the
    nodes whose bound and nominated pods request more than they have."""
    over = []
    nominated = _nominations(env)
    for node in env.kube.list_nodes():
        free = dict(env.cluster.get_state_node(node.name).available)
        for pod in nominated.get(node.name, {}).values():
            free = k.res.subtract(free, k.res.pod_requests(pod))
        if any(v < -1e-6 for v in free.values()):
            over.append(node.name)
    return sorted(over)


def test_a_capacity_failure_resolve_leaves_the_resident_state_alone():
    port = Kit("port", "dense")
    plain = _ice_round(port, engine=False)
    engine = _ice_round(port, engine=True, audit=True)
    resolves = engine["schedules"][1:]
    assert resolves, "the ladder did not re-solve"
    assert plain["nominated_onto_standing"] > 0, "the round nominated nothing onto the standing nodes"
    # the re-solves bypass the engine, and the auditor counts only the
    # primary solve; the round equals the round with no engine
    assert engine["schedules"][0]["pass"] == [PASS_FULL]
    assert all(s["pass"] == [PASS_BYPASS] for s in resolves), engine["schedules"]
    assert engine["auditor"] == {"passes": 1, "audits": 1, "divergences": {}}
    assert plain["overbooked"] == engine["overbooked"] == []
    assert engine["outcome"] == plain["outcome"]
    assert engine["schedules"] == [dict(s, **{"pass": e["pass"]}) for s, e in zip(plain["schedules"], engine["schedules"])]

    # the same views handed to the engine as the cluster's snapshot: the
    # delta pass serves the standing rows without the round's nominations,
    # and the re-solve books that room again; the auditor calls it a missed
    # delta
    stale = _ice_round(port, engine=True, as_snapshot=True)
    assert all(s["pass"] == [PASS_DELTA] for s in stale["schedules"][1:]), stale["schedules"]
    assert set(stale["overbooked"]) & {f"churn-n{i:04d}" for i in range(STANDING)}, stale["overbooked"]
    audited = _ice_round(port, engine=True, audit=True, as_snapshot=True)
    assert audited["auditor"]["divergences"].get(KIND_MISSED_DELTA, 0) >= 1, audited["auditor"]

    # the reference's re-solve counts no nominations: it books the room
    # again, with its engine or with none
    ref = Kit("ref", "dense")
    for ref_round in (_ice_round(ref, engine=False), _ice_round(ref, engine=True)):
        assert ref_round["overbooked"], "the reference's round booked no node over its room"
