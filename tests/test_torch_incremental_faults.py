"""The incremental engine and the solver fault domain, on both packages.

tests/test_incremental_faults.py's cases under the port's semantics, each on
tests/test_torch_audit.py's `_Pair` rig (one seeded churn driving both
packages' clusters, a persistent incremental solver each, every audit a full
shadow): the same fault, injected on both sides, voids residency with the
same reason, and the recovery pass is a clean full re-encode that places
pods as the reference's does and as a fresh solver does.

- `fault-breaker`: an open breaker holds the batch (the port raises
  SolverBreakerOpenError; the reference's host loop places it) and voids
  residency on both;
- `fault-chunked`: the reference's reactive chunked rung after an injected
  HBM fault, the port's pre-solve budget split;
- `fault-device`: a classified fault at the rebase, counted once; the port
  raises it typed, the reference places the pass from its host mirror.

The reference's `fault-flavor` case (a kernel fault retiring the Pallas or
mesh flavor mid-solve) has no counterpart: the port has no flavor
retirement (ROADMAP C).

Then the corruption kinds, injected by the same FaultPlan on both packages
at the engine's state seams (the reference's tests/test_residency_audit.py
cases): corrupt-row, suppress-delta and corrupt-device are each found once
by both auditors, of their kind, healed by a full re-encode, with the same
plan history and no pod lost.
"""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_tpu.ir import delta as ref_delta
from karpenter_tpu.scheduler import build_scheduler as ref_build_scheduler
from karpenter_tpu.solver import faults as ref_faults
from karpenter_tpu.solver.incremental import INCREMENTAL_INVALIDATIONS as REF_INVALIDATIONS
from karpenter_tpu.utils.clock import FakeClock as RefFakeClock
from karpenter_tpu_torch import flight, testing
from karpenter_tpu_torch.ir import delta
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.solver import faults
from karpenter_tpu_torch.solver.audit import KIND_DEVICE_CORRUPT, KIND_MISSED_DELTA, KIND_ROW_DRIFT
from karpenter_tpu_torch.solver.faults import (
    KIND_CORRUPT_DEVICE,
    KIND_CORRUPT_ROW,
    KIND_DEVICE_LOST,
    KIND_SUPPRESS_DELTA,
    RUNG_CHUNKED,
    SolverBreakerOpenError,
    SolverDeviceLostError,
)
from karpenter_tpu_torch.solver.incremental import INCREMENTAL_INVALIDATIONS, PASS_DELTA, PASS_FULL
from karpenter_tpu_torch.utils.clock import FakeClock
from tests.helpers import make_pod as ref_make_pod
from tests.test_differential_campaign import _provisioners as ref_provisioners
from tests.test_differential_campaign import _rename as ref_rename
from tests.test_torch_audit import _every_audit_a_shadow, _fingerprint, _Pair  # noqa: F401
from tests.test_torch_provisioning import reference_singletons  # noqa: F401

PACKAGES = (ref_faults, faults)


@pytest.fixture(autouse=True)
def _fault_domain_hygiene():
    for package in PACKAGES:
        package.FAULTS.clear()
        package.BREAKER.reset()
        package.BREAKER.configure(threshold=3, backoff=30.0)
    yield
    for package in PACKAGES:
        package.FAULTS.clear()
        package.BREAKER.reset()
        package.BREAKER.configure(threshold=3, backoff=30.0)


def _sizes(step, count):
    prng = np.random.default_rng(7700 + step)
    return [float(prng.choice([0.25, 0.5])) for _ in range(count)]


def _port_batch(pair, step, sizes, memory):
    """The port's side of one pass (pair._solve with a memory request):
    (fingerprint, None), or (None, the exception that held the batch)."""
    pods = testing.rename(
        [testing.make_pod(labels={"app": "faulted"}, requests={"cpu": c, "memory": memory}) for c in sizes], f"{pair.tag}{step}"
    )
    pair.solver.stats = pair.solver.stats.__class__()
    scheduler = build_scheduler(
        testing.campaign_provisioners(), pair.provider, pods, cluster=pair.cluster,
        state_nodes=pair.cluster.nodes_snapshot(), dense_solver=pair.solver,
    )
    try:
        results = scheduler.solve(pods)
    except faults.SolverFault as fault:
        return None, fault
    placed = sum(len(n.pods) for n in results.new_nodes) + sum(len(v.pods) for v in results.existing_nodes)
    assert placed == len(pods), f"{pair.tag} step {step}: a fault must never lose pods"
    return _fingerprint(results, scheduler, pair.solver.stats), None


def _ref_batch(pair, step, sizes, memory):
    """The reference's side of the same pass; it always places the batch."""
    pods = ref_rename([ref_make_pod(labels={"app": "faulted"}, requests={"cpu": c, "memory": memory}) for c in sizes], f"{pair.tag}{step}")
    pair.ref_solver.stats = pair.ref_solver.stats.__class__()
    scheduler = ref_build_scheduler(
        ref_provisioners(), pair.ref_provider, pods, cluster=pair.ref_cluster,
        state_nodes=pair.ref_cluster.nodes_snapshot(), dense_solver=pair.ref_solver,
    )
    results = scheduler.solve(pods)
    placed = sum(len(n.pods) for n in results.new_nodes) + sum(len(v.pods) for v in results.existing_nodes)
    assert placed == len(pods)
    return _fingerprint(results, scheduler, pair.ref_solver.stats)


def _faulted_pass(pair, step, fault_type, count=8, memory="256Mi"):
    """One pass whose fault the port raises (typed, batch held) and the
    reference absorbs (its rung places the batch)."""
    sizes = _sizes(step, count)
    got, fault = _port_batch(pair, step, sizes, memory)
    assert got is None and isinstance(fault, fault_type), fault
    _ref_batch(pair, step, sizes, memory)
    return fault


def _recovery(pair, step, reason):
    """The pass after the fault: on both sides a full re-encode attributed
    to `reason`, placing pods alike and as a fresh solver does; the pass
    after it is delta again."""
    assert pair.engine._resident is None and pair.ref_engine._resident is None
    full_before = pair.engine.passes[PASS_FULL]
    bases = INCREMENTAL_INVALIDATIONS.value(reason=reason), REF_INVALIDATIONS.value(reason=reason)
    pair.step()
    got = pair.solve(step)
    assert pair.passes[-1] == pair.ref_passes[-1] == (PASS_FULL, reason)
    assert pair.engine.passes[PASS_FULL] == full_before + 1
    assert (INCREMENTAL_INVALIDATIONS.value(reason=reason), REF_INVALIDATIONS.value(reason=reason)) == (bases[0] + 1, bases[1] + 1)
    want = pair._fresh(step)
    assert got["views"] == want["views"] and got["new_nodes"] == want["new_nodes"]
    delta_before = pair.engine.passes[PASS_DELTA]
    pair.step()
    pair.solve(step + 1)
    assert pair.engine.passes[PASS_DELTA] == delta_before + 1


def test_open_breaker_voids_resident_state_with_zero_lost_pods():
    pair = _Pair(8800, "brk")
    pair.warm_to_delta()
    full_before = pair.engine.passes[PASS_FULL]
    for package in PACKAGES:
        for _ in range(3):
            package.BREAKER.record_fault(KIND_DEVICE_LOST)
        assert package.BREAKER.state == faults.STATE_OPEN
    pair.step()
    fault = _faulted_pass(pair, 2, SolverBreakerOpenError)
    assert fault.kind == KIND_DEVICE_LOST
    assert pair.engine.passes[PASS_FULL] == full_before, "the held pass never reaches the engine"
    assert pair.passes == pair.ref_passes
    for package in PACKAGES:
        package.BREAKER.reset()
    _recovery(pair, 3, "fault-breaker")


def test_half_open_probe_that_fits_standing_nodes_closes_the_breaker():
    """The recovery probe's pods all fit the standing nodes: the warm fill
    (K2) places the batch and no bucket reaches the bucket choice. The port
    closes its breaker at the end of any admitted solve that raised nothing;
    the reference records success only after the bucket choice, so its
    breaker stays half-open (and its what-ifs go to the host loop meanwhile,
    where the port's would be held: ROADMAP C)."""
    pair = _Pair(9200, "probe")
    pair.warm_to_delta()
    clocks = []
    for package, clock in ((ref_faults, RefFakeClock()), (faults, FakeClock())):
        package.BREAKER.configure(threshold=1, backoff=5.0, clock=clock)
        package.BREAKER.record_fault(KIND_DEVICE_LOST)
        assert package.BREAKER.state == faults.STATE_OPEN
        clock.step(6.0)
        clocks.append(clock)
    pair.step()
    sizes = [0.25, 0.25]
    got, fault = _port_batch(pair, 2, sizes, "256Mi")
    want = _ref_batch(pair, 2, sizes, "256Mi")
    assert fault is None and got == want
    assert got["new_nodes"] == [], "the warm fill placed the whole batch"
    assert faults.BREAKER.state == faults.STATE_CLOSED
    assert ref_faults.BREAKER.state == ref_faults.STATE_HALF_OPEN
    # while the port's breaker is closed its what-ifs are admitted again
    assert faults.BREAKER.admit(simulation=True)


def test_rebase_device_fault_voids_residency_with_zero_lost_pods():
    pair = _Pair(9000, "rbs")
    pair.warm_to_delta()
    bases = faults.SOLVER_FAULTS.value(kind=KIND_DEVICE_LOST), ref_faults.SOLVER_FAULTS.value(kind=KIND_DEVICE_LOST)
    for package in PACKAGES:
        package.FAULTS.install(package.FaultPlan([package.FaultSpec(kind=KIND_DEVICE_LOST, entry="rebase", nth=1)]))
    pair.step()
    fault = _faulted_pass(pair, 2, SolverDeviceLostError)
    assert "rebase" in str(fault)
    # the reference's pass went on from its host mirror and logged a delta
    # pass; the port's raised inside it
    assert pair.ref_passes.pop() == (PASS_DELTA, "") and pair.passes == pair.ref_passes
    assert ref_faults.FAULTS.plan.history() == faults.FAULTS.plan.history() == [{"call": 1, "entry": "rebase", "kind": KIND_DEVICE_LOST}]
    for package in PACKAGES:
        package.FAULTS.clear()
    assert (faults.SOLVER_FAULTS.value(kind=KIND_DEVICE_LOST), ref_faults.SOLVER_FAULTS.value(kind=KIND_DEVICE_LOST)) == (bases[0] + 1, bases[1] + 1), (
        "the rebase fault counts once, on its way through the rebase, the dense solve and the scheduler"
    )
    assert faults.BREAKER.consecutive == 1, "the dense solve recorded it into the breaker"
    _recovery(pair, 3, "fault-device")


def test_chunked_rung_voids_resident_state(monkeypatch):
    """The reference chunks after an injected HBM fault; the port splits
    before any launch, over its budget. Either rung voids residency."""
    pair = _Pair(9100, "chk")
    pair.warm_to_delta()
    monkeypatch.setattr(flight.FlightRecorder, "hbm_snapshot", staticmethod(lambda device=None: (1 << 20, 0)))
    was_enabled = flight.FLIGHT.enabled
    flight.FLIGHT.enable()
    try:
        pair.solver.hbm_budget_bytes = 1 << 19
        ref_faults.FAULTS.install(ref_faults.FaultPlan([ref_faults.FaultSpec(kind="hbm", entry="plain", nth=1)]))
        base = faults.DEGRADED_SOLVES.value(rung=RUNG_CHUNKED)
        pair.step()
        # a memory-bound batch that overflows the warm cluster: the spill
        # forces the new-node bucket choice, where the rung is taken
        sizes = _sizes(2, 60)
        got, fault = _port_batch(pair, 2, sizes, "16Gi")
        want = _ref_batch(pair, 2, sizes, "16Gi")
        assert fault is None and got == want
        assert pair.solver._solve_rungs == [RUNG_CHUNKED] and pair.ref_solver._solve_rungs == [ref_faults.RUNG_CHUNKED]
        assert faults.DEGRADED_SOLVES.value(rung=RUNG_CHUNKED) == base + 1
        ref_faults.FAULTS.clear()
        pair.solver.hbm_budget_bytes = 0
        _recovery(pair, 3, "fault-chunked")
    finally:
        if not was_enabled:
            flight.FLIGHT.disable()
        flight.FLIGHT.reset()


# -- the corruption kinds, injected by plans -----------------------------------------------------


def _install_both(kind, entry):
    plans = []
    for package in PACKAGES:
        plan = package.FaultPlan([package.FaultSpec(kind=kind, entry=entry, nth=1)])
        package.FAULTS.install(plan)
        plans.append(plan)
    return plans


def _found_once(pair, plans, kind, fields=None):
    for package in PACKAGES:
        package.FAULTS.clear()
    assert [plan.corruptions_fired() for plan in plans] == [1, 1]
    assert plans[0].history() == plans[1].history()
    assert pair.auditor.divergences == {kind: 1} and pair.auditor.heals == 1
    last = pair.auditor.last_divergence
    assert last["kinds"] == [kind]
    if fields is not None:
        assert last["findings"][-1]["fields"] == fields
    pair.assert_same_audits()


def test_corrupt_row_plan_is_row_drift_and_heals():
    pair = _Pair(9300, "drift")
    pair.warm_to_delta()
    plans = _install_both(KIND_CORRUPT_ROW, "resident-row")
    pair.step()
    pair.solve(2)
    _found_once(pair, plans, KIND_ROW_DRIFT, ["avail_tol"])
    pair.assert_healed_then_fresh(3)


def test_suppress_delta_plan_is_a_missed_delta_and_heals():
    pair = _Pair(9400, "miss")
    pair.warm_to_delta()
    victim = next(n for n in pair.engine._resident.names if n not in pair.engine._resident.prev_dirty)
    plans = _install_both(KIND_SUPPRESS_DELTA, "journal-record")
    assert delta._corrupt_consult is not None and ref_delta._corrupt_consult is not None, "install arms the journal seam"
    for kube, make_pod in ((pair.kube, testing.make_pod), (pair.ref_kube, ref_make_pod)):
        kube.create(
            make_pod(
                name="miss-suppressed-pod", labels={"app": "standing"}, requests={"cpu": 0.5, "memory": "512Mi"},
                node_name=victim, phase="Running", unschedulable=False,
            )
        )
    pair.solve(2)
    _found_once(pair, plans, KIND_MISSED_DELTA)
    assert delta._corrupt_consult is None and ref_delta._corrupt_consult is None, "clear disarms the journal seam"
    assert pair.auditor.last_divergence["rows"] == [victim]
    pair.assert_healed_then_fresh(3)


def test_corrupt_device_plan_is_device_corrupt_and_heals():
    pair = _Pair(9500, "dev")
    pair.warm_to_delta()
    plans = _install_both(KIND_CORRUPT_DEVICE, "rebase")
    pair.step()
    pair.solve(2)
    _found_once(pair, plans, KIND_DEVICE_CORRUPT, ["head_dev"])
    pair.assert_healed_then_fresh(3)
