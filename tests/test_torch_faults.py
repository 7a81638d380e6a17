"""The solver fault domain (solver/faults.py) on the port, held against the JAX package.

- tests/test_solver_faults.py's TestClassify, TestFaultPlan and
  TestCircuitBreaker, as written on the port (a port copy of the module
  through `port_copy`);
- the classifier on the CUDA and torch surfaces: the error names and texts
  the kernel wrappers raise, torch's CUDA messages, `torch.cuda.OutOfMemoryError`
  and a failed nvcc build;
- port counterparts of TestLadderRungs, TestBreakerEndToEnd,
  TestFaultObservability and the determinism case (both flavors: the
  single-device dispatch and an 8-block CPU mesh), under the port's
  semantics: a fault is
  classified, counted, journaled, recorded into the breaker and raised
  typed, and the batch is held; there is no flavor retirement, no host rung
  and no chunking from an `except`. Each runs the same seeded batch and
  plan through both packages and compares what the semantics keep equal:
  the fault plan's history, the classification, the breaker's states, the
  counters and the `fault` journal events; whenever the breaker admits the
  device both place every pod alike;
- the budget split: K1 (its plain version here) on each half of the bucket
  axis, bit-equal to one launch, and the same placements as an unsplit
  solve;
- the three controllers: a SolverFault holds the work and a later attempt
  completes it on the device; an exception classify() has no name for ends
  the loop.

Both packages' injectors and breakers start each test cleared and closed,
and `reference_singletons` restores them, and both DeltaJournal corruption
seams, after it.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake import FakeCloudProvider as RefProvider, instance_types as ref_types
from karpenter_tpu.journal import JOURNAL as REF_JOURNAL
from karpenter_tpu.scheduler import build_scheduler as ref_build_scheduler
from karpenter_tpu.scheduler.scheduler import SchedulerOptions as RefOptions
from karpenter_tpu.solver import DenseSolver as RefDenseSolver
from karpenter_tpu.solver import faults as ref_faults
from karpenter_tpu.utils.clock import FakeClock as RefFakeClock
from karpenter_tpu_torch import flight, testing
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
from karpenter_tpu_torch.journal import JOURNAL, KIND_SOLVER
from karpenter_tpu_torch.ops import bucket_cost
from karpenter_tpu_torch.ops._cuda_build import KernelBuildError
from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_packed
from karpenter_tpu_torch.parallel.mesh import solver_mesh
from karpenter_tpu_torch.scheduler import build_scheduler
from karpenter_tpu_torch.scheduler.scheduler import SchedulerOptions
from karpenter_tpu_torch.solver import DenseSolver
from karpenter_tpu_torch.solver import faults
from karpenter_tpu_torch.solver.faults import (
    BREAKER,
    DEGRADED_SOLVES,
    FAULTS,
    KIND_COMPILE,
    KIND_DEVICE_LOST,
    KIND_HBM,
    KIND_KERNEL,
    KIND_UNCLASSIFIED,
    RUNG_CHUNKED,
    RUNG_HOST,
    SOLVER_FAULTS,
    STATE_CLOSED,
    STATE_HALF_OPEN,
    STATE_OPEN,
    FaultPlan,
    FaultSpec,
    SolverBreakerOpenError,
    SolverCompileError,
    SolverDeviceLostError,
    SolverFault,
    SolverHbmExhaustedError,
    SolverKernelError,
    classify,
)
from karpenter_tpu_torch.utils.clock import FakeClock
from tests import helpers
from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_scheduler_catalog import port_copy

_FAULTS = port_copy("test_solver_faults", extra=(("from karpenter_tpu import flight", "from karpenter_tpu_torch import flight"),))
TestClassify = _FAULTS.TestClassify
TestFaultPlan = _FAULTS.TestFaultPlan
TestCircuitBreaker = _FAULTS.TestCircuitBreaker


@pytest.fixture(autouse=True)
def _fault_domain_hygiene():
    """tests/test_solver_faults.py's hygiene on both packages: no plan, a
    closed breaker at threshold 3 / backoff 30 s, before and after."""
    for package in (ref_faults, faults):
        package.FAULTS.clear()
        package.BREAKER.reset()
        package.BREAKER.configure(threshold=3, backoff=30.0)
    yield
    for package in (ref_faults, faults):
        package.FAULTS.clear()
        package.FAULTS.set_simulation(False)
        package.BREAKER.reset()
        package.BREAKER.configure(threshold=3, backoff=30.0)


# -- one seeded batch through either package ---------------------------------------------


class Side:
    """One package's solve of tests/test_solver_faults.py's batch: `count`
    1-CPU pods (named by seed and index, on both sides alike) against the
    fake provider's first 30 types."""

    def __init__(self, side: str):
        self.side = side
        self.faults = ref_faults if side == "ref" else faults
        self.journal = REF_JOURNAL if side == "ref" else JOURNAL

    def solver(self, **kw):
        if self.side == "ref":
            return RefDenseSolver(min_batch=1, use_mesh=False, **kw)
        return DenseSolver(min_batch=1, device="cpu", **kw)

    def pods(self, count, tag):
        make = helpers.make_pod if self.side == "ref" else testing.make_pod
        return [make(name=f"{tag}-{i:03d}", requests={"cpu": 1, "memory": "1Gi"}) for i in range(count)]

    def provider(self):
        return RefProvider(ref_types(30)) if self.side == "ref" else FakeCloudProvider(instance_types(30))

    def solve(self, solver, count=40, tag="p", simulation=False, provider=None):
        """(placements by pod name, None) or (None, the exception)."""
        pods = self.pods(count, tag)
        if self.side == "ref":
            scheduler = ref_build_scheduler(
                [helpers.make_provisioner()], provider or self.provider(), pods, dense_solver=solver,
                opts=RefOptions(simulation_mode=simulation),
            )
        else:
            scheduler = build_scheduler(
                [testing.make_provisioner()], provider or self.provider(), pods, dense_solver=solver,
                opts=SchedulerOptions(simulation_mode=simulation),
            )
        try:
            results = scheduler.solve(pods)
        except Exception as exc:  # noqa: BLE001 - the port's held batch; the caller asserts on it
            return None, exc
        placed = {}
        for node in results.new_nodes:
            for pod in node.pods:
                placed[pod.metadata.name] = node.instance_type_options[0].name()
        return placed, None

    def install(self, specs, seed=0):
        self.faults.FAULTS.install(self.faults.FaultPlan([self.faults.FaultSpec(**s) for s in specs], seed=seed))

    def fault_count(self, kind):
        return self.faults.SOLVER_FAULTS.value(kind=kind)

    def journal_events(self, event):
        return [
            {"event": e["event"], **e.get("attrs", {})}
            for e in self.journal.events(limit=200)
            if e["kind"] == KIND_SOLVER and e["event"] == event
        ]


SIDES = (Side("ref"), Side("port"))


def _inject_both(specs, count=40):
    """The same plan and batch through both packages: per side, the
    solver, (placements, exception), the plan's history and the change of
    every fault counter."""
    out = {}
    for side in SIDES:
        before = {k: side.fault_count(k) for k in faults.KINDS}
        side.install(specs)
        solver = side.solver()
        placed, exc = side.solve(solver, count=count)
        out[side.side] = {
            "solver": solver,
            "placed": placed,
            "exc": exc,
            "history": side.faults.FAULTS.plan.history(),
            "counted": {k: side.fault_count(k) - before[k] for k in faults.KINDS if side.fault_count(k) != before[k]},
        }
        side.faults.FAULTS.clear()
    return out["ref"], out["port"]


# -- the classifier on the CUDA and torch surfaces ------------------------------------------


class TestClassifyCuda:
    @pytest.mark.parametrize("text", [
        "CUDA out of memory. Tried to allocate 2.00 GiB",
        "bucket_cost kernel launch failed: cudaErrorMemoryAllocation: out of memory (CUDA error 2)",
        "CUDA error: out of memory",
    ])
    def test_hbm(self, text):
        assert isinstance(classify(RuntimeError(text)), SolverHbmExhaustedError)

    def test_torch_out_of_memory_error_by_type(self):
        fault = classify(torch.cuda.OutOfMemoryError("allocator says no"))
        assert isinstance(fault, SolverHbmExhaustedError) and fault.kind == KIND_HBM

    @pytest.mark.parametrize("text", [
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: device-side assert triggered\nCUDA kernel errors might be asynchronously reported at some other API"
        " call\nCompile with `TORCH_USE_CUDA_DSA` to enable device-side assertions.",
        "CUDA error: unspecified launch failure",
        "CUDA error: misaligned address",
        "warm_fill round trip failed: cudaErrorLaunchFailure: unspecified launch failure (CUDA error 719)",
        "bucket_cost kernel launch failed: cudaErrorIllegalAddress: an illegal memory access was encountered (CUDA error 700)",
    ])
    def test_device_lost(self, text):
        assert isinstance(classify(RuntimeError(text)), SolverDeviceLostError), text

    def test_failed_build_is_compile_whatever_nvcc_printed(self):
        # nvcc's diagnostics are free text: words of other kinds must not win
        err = KernelBuildError("nvcc failed on bucket_cost.cu (1):\nerror: out of memory in an illegal memory access kernel")
        assert isinstance(classify(err), SolverCompileError)
        assert isinstance(classify(RuntimeError("ptxas fatal   : Unresolved extern function")), SolverCompileError)

    @pytest.mark.parametrize("text", [
        "bucket_cost kernel launch failed: cudaErrorInvalidValue: invalid argument (CUDA error 1)",
        "warm_fill kernel launch failed: cudaErrorInvalidConfiguration: invalid configuration argument (CUDA error 9)",
    ])
    def test_other_launch_errors_are_kernel(self, text):
        assert isinstance(classify(RuntimeError(text)), SolverKernelError)

    def test_the_wrappers_name_the_cuda_error(self, monkeypatch):
        """K1's and K2's exceptions carry the CUDA runtime's error name and
        text (read from the library's accessors), so they classify."""
        from karpenter_tpu_torch.ops import warmfill

        names = {1: ("cudaErrorInvalidValue", "invalid argument"), 700: ("cudaErrorIllegalAddress", "an illegal memory access was encountered")}
        for library in (bucket_cost.LIBRARY, warmfill.LIBRARY):
            monkeypatch.setattr(library, "describe", lambda err: f"{names[err][0]}: {names[err][1]} (CUDA error {err})")
        assert isinstance(classify(bucket_cost.launch_error(1)), SolverKernelError)
        assert "cudaErrorInvalidValue" in str(bucket_cost.launch_error(1))
        assert isinstance(classify(warmfill.launch_error(700, "round trip")), SolverDeviceLostError)

    def test_ordinary_bugs_stay_unclassified(self):
        assert classify(ValueError("shape mismatch: caps (30, 4)")) is None
        assert classify(IndexError("list index out of range")) is None

    def test_breaker_open_error_is_typed_and_never_counted(self):
        err = SolverBreakerOpenError("", "held")
        assert isinstance(err, SolverFault) and err.kind == KIND_DEVICE_LOST
        base = SOLVER_FAULTS.value(kind=KIND_DEVICE_LOST)
        faults.count_fault(err)
        assert SOLVER_FAULTS.value(kind=KIND_DEVICE_LOST) == base


# -- per-kind injection, end to end (tests/test_solver_faults.py:TestLadderRungs) ------------


class TestLadderRungs:
    """Each kind injected at a real dispatch seam of a real dense solve:
    the reference takes its rung and places the batch; the port raises the
    typed fault, counts it once, records it into the breaker and holds the
    batch (the scheduler returns no result)."""

    def _held(self, port, cls, kind):
        assert isinstance(port["exc"], cls) and port["exc"].kind == kind
        assert port["placed"] is None, "the batch is held, not placed elsewhere"
        assert port["counted"] == {kind: 1}
        assert port["solver"]._solve_faults == {kind: 1} and port["solver"]._solve_rungs == []

    def test_hbm_fault_takes_chunked_rung(self):
        """Port: no chunked re-dispatch from an `except`; an HBM fault counts
        into the breaker."""
        base = DEGRADED_SOLVES.value(rung=RUNG_CHUNKED)
        ref, port = _inject_both([{"kind": "hbm", "entry": "plain", "nth": 1}])
        assert ref["solver"]._solve_rungs == [ref_faults.RUNG_CHUNKED] and len(ref["placed"]) == 40
        self._held(port, SolverHbmExhaustedError, KIND_HBM)
        assert DEGRADED_SOLVES.value(rung=RUNG_CHUNKED) == base
        assert BREAKER.consecutive == 1 and BREAKER.last_fault_kind == KIND_HBM
        assert ref["history"] == port["history"] == [{"call": 1, "entry": "plain", "kind": KIND_HBM}]
        assert ref["counted"] == port["counted"]

    def test_device_lost_fault_takes_host_rung_and_counts_into_breaker(self):
        base = DEGRADED_SOLVES.value(rung=RUNG_HOST)
        ref, port = _inject_both([{"kind": "device-lost", "entry": "plain", "nth": 1}])
        assert ref["solver"]._solve_rungs == [ref_faults.RUNG_HOST] and len(ref["placed"]) == 40
        self._held(port, SolverDeviceLostError, KIND_DEVICE_LOST)
        assert DEGRADED_SOLVES.value(rung=RUNG_HOST) == base, "the port has no host rung"
        for breaker in (ref_faults.BREAKER, BREAKER):
            assert breaker.consecutive == 1 and breaker.last_fault_kind == KIND_DEVICE_LOST
        assert ref["history"] == port["history"] and ref["counted"] == port["counted"]

    def test_compile_fault_on_plain_takes_host_rung(self):
        ref, port = _inject_both([{"kind": "compile", "entry": "plain", "nth": 1}])
        assert ref["solver"]._solve_faults == {KIND_COMPILE: 1}
        self._held(port, SolverCompileError, KIND_COMPILE)
        assert ref["history"] == port["history"] and ref["counted"] == port["counted"]

    def test_kernel_fault_on_sharded_retires_the_flavor(self):
        """Port: no flavor to retire. A kernel fault at the 'sharded' seam of
        a port mesh (8 CPU blocks) is classified, counted and raised; the
        mesh stays, and the next solve dispatches on it and places the batch
        as the reference, which retired its mesh, did."""
        specs = [{"kind": "kernel", "entry": "sharded", "nth": 1}]
        ref_side, port_side = SIDES
        ref_side.install(specs)
        ref_solver = RefDenseSolver(min_batch=1)
        ref_placed, ref_exc = ref_side.solve(ref_solver, count=40)
        ref_history = ref_faults.FAULTS.plan.history()
        ref_faults.FAULTS.clear()
        assert ref_exc is None and len(ref_placed) == 40
        assert ref_solver._solve_rungs == [ref_faults.RUNG_FLAVOR] and ref_solver._mesh is None

        mesh = solver_mesh(8, types_parallel=2, devices=[torch.device("cpu")] * 8)
        port_side.install(specs)
        before = port_side.fault_count(KIND_KERNEL)
        solver = DenseSolver(min_batch=1, device="cpu", mesh=mesh)
        placed, exc = port_side.solve(solver, count=40)
        assert isinstance(exc, SolverKernelError) and exc.kind == KIND_KERNEL and placed is None
        assert port_side.fault_count(KIND_KERNEL) == before + 1
        assert solver._solve_faults == {KIND_KERNEL: 1} and solver._solve_rungs == []
        assert FAULTS.plan.history() == ref_history == [{"call": 1, "entry": "sharded", "kind": KIND_KERNEL}]
        assert solver._mesh is mesh and solver.stats.sharded_batches == 0
        assert BREAKER.consecutive == 1 and BREAKER.last_fault_kind == KIND_KERNEL
        placed, exc = port_side.solve(solver, count=40)
        assert exc is None and placed == ref_placed
        assert solver.stats.sharded_batches == 1 and solver.stats.batches == 2

    def test_kernel_fault_on_pallas_retires_the_kernel(self):
        """Port: K2's seam ('warmfill') raises a kernel fault on a warm
        solve; nothing retires, and the next solve fills through K2 (its
        plain version here) again."""
        states = testing.build_repack_state(40)
        FAULTS.install(FaultPlan([FaultSpec(kind="kernel", entry="warmfill", nth=1)]))
        pods = testing.build_workload(300, seed=3)
        solver = DenseSolver(min_batch=1, device="cpu")

        def solve():
            return build_scheduler([testing.make_provisioner()], FakeCloudProvider(instance_types(40)), pods, state_nodes=states, dense_solver=solver).solve(pods)

        with pytest.raises(SolverKernelError, match="warmfill"):
            solve()
        assert solver._solve_faults == {KIND_KERNEL: 1} and solver.stats.fills_vectorized == 0
        results = solve()
        assert solver.stats.fills_vectorized == 1
        assert sum(len(v.pods) for v in results.existing_nodes) + sum(len(n.pods) for n in results.new_nodes) == len(pods)

    def test_unclassified_exception_counts_distinctly_at_the_boundary(self):
        class NovelFailureSolver:
            def presolve(self, scheduler, pods):
                raise ValueError("a failure mode classify has no name for")

        for side in SIDES:
            base = side.fault_count(KIND_UNCLASSIFIED)
            placed, exc = side.solve(NovelFailureSolver(), count=10)
            if side.side == "ref":
                assert len(placed) == 10
            else:
                assert placed is None and isinstance(exc, ValueError), "an unclassified fault is raised, not hidden"
            assert side.fault_count(KIND_UNCLASSIFIED) == base + 1


# -- the breaker, end to end (tests/test_solver_faults.py:TestBreakerEndToEnd) ---------------


def _breaker_run(side, simulation_probe=False):
    """tests/test_solver_faults.py's breaker rounds on one package: two
    device-lost faults at threshold 2, a solve while open, the backoff, the
    recovery probe. Returns the breaker states after each solve, each
    solve's (placed count or exception type), the batches the open and the
    probe solves ran, and the plan's history."""
    clock = RefFakeClock() if side.side == "ref" else FakeClock()
    side.faults.BREAKER.configure(threshold=2, backoff=5.0, clock=clock)
    side.install([{"kind": "device-lost", "entry": "plain", "nth": 1, "count": 2}])
    provider = side.provider()
    states, outcomes, batches = [], [], []

    def solve(tag, simulation=False):
        solver = side.solver()
        placed, exc = side.solve(solver, count=20, tag=tag, simulation=simulation, provider=provider)
        outcomes.append(len(placed) if placed is not None else type(exc).__name__)
        states.append(side.faults.BREAKER.state)
        return solver

    solve("a")
    solve("b")
    batches.append(solve("c").stats.batches)  # open: no encode, no dispatch
    fired = side.faults.FAULTS.fired()
    clock.step(6.0)
    if simulation_probe:
        batches.append(solve("d", simulation=True).stats.batches)  # must not spend the probe
    batches.append(solve("e").stats.batches)  # the recovery probe
    assert side.faults.FAULTS.fired() == fired, "a held or probing solve consumed no trigger"
    return states, outcomes, batches, side.faults.FAULTS.plan.history()


class TestBreakerEndToEnd:
    def test_open_breaker_short_circuits_the_device_attempt(self):
        ref, port = (_breaker_run(side) for side in SIDES)
        assert ref[0] == port[0] == [STATE_CLOSED, STATE_OPEN, STATE_OPEN, STATE_CLOSED]
        assert ref[1] == [20, 20, 20, 20]
        assert port[1] == ["SolverDeviceLostError", "SolverDeviceLostError", "SolverBreakerOpenError", 20]
        assert ref[2] == port[2] == [0, 1], "open: no device attempt; the probe: one dense batch"
        assert ref[3] == port[3]

    def test_simulation_solve_never_spends_the_recovery_probe(self):
        ref, port = (_breaker_run(side, simulation_probe=True) for side in SIDES)
        assert ref[0] == port[0] == [STATE_CLOSED, STATE_OPEN, STATE_OPEN, STATE_OPEN, STATE_CLOSED]
        assert port[1][2:] == ["SolverBreakerOpenError", "SolverBreakerOpenError", 20]
        assert ref[2] == port[2] == [0, 0, 1]

    def test_held_solve_raises_the_last_faults_kind_and_voids_the_engine(self):
        from karpenter_tpu_torch.controllers.state.cluster import Cluster
        from karpenter_tpu_torch.kube.cluster import KubeCluster
        from karpenter_tpu_torch.solver.incremental import IncrementalEngine

        engine = IncrementalEngine(Cluster(KubeCluster(), None).delta_journal, device="cpu")
        solver = DenseSolver(min_batch=1, device="cpu", incremental=engine)
        BREAKER.configure(threshold=1)
        BREAKER.record_fault(KIND_HBM)
        placed, exc = SIDES[1].solve(solver, count=5)
        assert isinstance(exc, SolverBreakerOpenError) and exc.kind == KIND_HBM
        assert engine._pending_invalidate == "fault-breaker" and solver.stats.batches == 0
        assert BREAKER.retry_at() == pytest.approx(BREAKER.clock.now() + 30.0, abs=1.0)


# -- determinism (tests/test_solver_faults.py:TestFaultPlanDeterminismEndToEnd, plain) -------


class TestFaultPlanDeterminismEndToEnd:
    """Both dispatch flavors, as the reference's case: the single-device
    bucket choice ('plain' seam) and the 8-block CPU mesh ('sharded' seam,
    which a mesh consults in place of 'plain')."""

    SPECS = (
        {"kind": "hbm", "entry": "plain", "nth": 1},
        {"kind": "hbm", "entry": "sharded", "nth": 1},
        {"kind": "kernel", "entry": "warmfill", "nth": 1},
        {"kind": "device-lost", "entry": "*", "nth": 4},
    )

    def _run(self, use_mesh):
        FAULTS.clear()
        BREAKER.reset()
        FAULTS.install(FaultPlan.from_specs([dict(s) for s in self.SPECS], seed=11))
        side = SIDES[1]
        provider = side.provider()
        mesh = solver_mesh(8, types_parallel=2, devices=[torch.device("cpu")] * 8) if use_mesh else None
        solver = side.solver(mesh=mesh, use_mesh=use_mesh)
        kinds, tallies = [], []
        for i in range(5):
            placed, exc = side.solve(solver, count=25, tag=f"d{i}", provider=provider)
            kinds.append(exc.kind if exc is not None else len(placed))
            tallies.append(dict(solver._solve_faults))
        history = FAULTS.plan.history()
        sharded = solver.stats.sharded_batches
        FAULTS.clear()
        return history, kinds, tallies, BREAKER.snapshot()["consecutive_faults"], sharded

    @pytest.mark.parametrize("use_mesh", [False, True], ids=["plain", "sharded"])
    def test_two_runs_are_identical(self, use_mesh):
        first, second = self._run(use_mesh), self._run(use_mesh)
        assert first == second
        assert first[1] == [KIND_HBM, 25, 25, KIND_DEVICE_LOST, 25]
        assert first[0][0] == {"call": 1, "entry": "sharded" if use_mesh else "plain", "kind": KIND_HBM}
        assert all(h["kind"] in faults.KINDS for h in first[0])
        assert first[4] == (3 if use_mesh else 0)


# -- observability (tests/test_solver_faults.py:TestFaultObservability) ----------------------


class TestFaultObservability:
    def test_flight_record_carries_faults_rungs_and_breaker(self, monkeypatch):
        """A faulted solve's record is completed as the fault is raised; a
        budget split's record carries the chunked rung."""
        was_enabled = flight.FLIGHT.enabled
        flight.FLIGHT.enable()
        try:
            BREAKER.configure(threshold=1)
            FAULTS.install(FaultPlan([FaultSpec(kind="device-lost", entry="plain", nth=1)]))
            placed, exc = SIDES[1].solve(SIDES[1].solver(), count=25)
            assert isinstance(exc, SolverDeviceLostError)
            record = flight.FLIGHT.records()[-1]
            assert record.faults == {KIND_DEVICE_LOST: 1} and record.rungs == [] and record.breaker == STATE_OPEN
            assert record.to_dict()["faults"] == {KIND_DEVICE_LOST: 1} and record.summary()["breaker"] == STATE_OPEN
            FAULTS.clear()
            BREAKER.reset()
            monkeypatch.setattr(flight.FlightRecorder, "hbm_snapshot", staticmethod(lambda device=None: (1 << 40, 0)))
            placed, exc = SIDES[1].solve(SIDES[1].solver(hbm_budget_bytes=1 << 30), count=25)
            assert exc is None and len(placed) == 25
            record = flight.FLIGHT.records()[-1]
            assert record.faults == {} and record.rungs == [RUNG_CHUNKED] and record.breaker == STATE_CLOSED
        finally:
            if not was_enabled:
                flight.FLIGHT.disable()
            flight.FLIGHT.reset()

    def test_debug_solver_snapshot_has_the_fault_domain_block(self):
        from karpenter_tpu import flight as ref_flight

        block, ref_block = flight.FLIGHT.snapshot()["fault_domain"], ref_flight.FLIGHT.snapshot()["fault_domain"]
        assert block["breaker"] == ref_block["breaker"] and block["breaker"]["state"] == STATE_CLOSED
        assert isinstance(block["faults_total"], dict) and isinstance(block["degraded_solves_total"], dict)

    def test_journal_records_fault_degraded_and_breaker_events(self):
        events = {}
        for side in SIDES:
            side.journal.enable()
            try:
                side.journal.reset()
                side.faults.BREAKER.configure(threshold=1, backoff=30.0)
                side.install([{"kind": "device-lost", "entry": "plain", "nth": 1}])
                side.solve(side.solver(), count=20)
                side.solve(side.solver(), count=20, tag="q")  # the breaker is open now
                events[side.side] = {e: side.journal_events(e) for e in ("fault", "breaker-opened", "degraded")}
            finally:
                side.journal.disable()
                side.journal.reset()
        ref, port = events["ref"], events["port"]
        assert ref["fault"] == port["fault"] == [{"event": "fault", "kind": KIND_DEVICE_LOST, "entry": "device"}]
        assert len(ref["breaker-opened"]) == len(port["breaker-opened"]) == 1
        assert [e["rung"] for e in ref["degraded"]] == [RUNG_HOST, RUNG_HOST]
        assert port["degraded"] == [{"event": "degraded", "reason": "breaker-open", "kind": KIND_DEVICE_LOST}]

    def test_score_helpers_sum_across_labels(self):
        faults_base, degraded_base = faults.faults_total(), faults.degraded_total()
        SOLVER_FAULTS.inc(kind=KIND_HBM)
        SOLVER_FAULTS.inc(kind=KIND_KERNEL)
        DEGRADED_SOLVES.inc(rung=RUNG_CHUNKED)
        assert faults.faults_total() == faults_base + 2
        assert faults.degraded_total() == degraded_base + 1


# -- the budget split --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,B,T,R", [(0, 1, 7, 4), (1, 2, 30, 4), (2, 31, 500, 8), (3, 64, 13, 1), (4, 7, 33, 3)])
def test_split_launch_is_bit_equal_to_one(seed, B, T, R):
    """Each bucket's argmin is its own: the halves concatenated equal one
    launch on the whole bucket axis (K1's plain version on the CPU; on the
    card chip_smoke.py holds K1 the same way)."""
    arrays = testing.bucket_cost_problem(np.random.default_rng(seed), B, T, R, "random")
    stats, caps, prices, allowed = (torch.from_numpy(a) for a in arrays)
    solver = DenseSolver(min_batch=1, device="cpu")
    FAULTS.install(FaultPlan([FaultSpec(kind="kernel", entry="plain", nth=1)]))  # the split never consults 'plain'
    # each half's stats and mask are uploaded from the host arrays
    split = solver._split_dispatch(arrays[0], caps, prices, arrays[3])
    assert torch.equal(split, bucket_type_cost_packed(stats, caps, prices, allowed))
    assert FAULTS.plan.history() == []


def test_budget_split_solve_places_as_one_launch(monkeypatch):
    calls = []
    plain = bucket_cost.bucket_cost_packed

    def counted(stats, caps, prices, allowed):
        calls.append(int(stats.shape[1]))
        return plain(stats, caps, prices, allowed)

    from karpenter_tpu_torch.solver import dense as dense_module

    monkeypatch.setattr(dense_module, "bucket_cost_packed", counted)
    monkeypatch.setattr(flight.FlightRecorder, "hbm_snapshot", staticmethod(lambda device=None: (1 << 20, 0)))
    was_enabled = flight.FLIGHT.enabled
    flight.FLIGHT.enable()
    try:
        pods = testing.build_workload(600, seed=5)
        provider = FakeCloudProvider(instance_types(60))

        def solve(budget):
            solver = DenseSolver(min_batch=1, device="cpu", hbm_budget_bytes=budget)
            results = build_scheduler([testing.make_provisioner()], provider, pods, dense_solver=solver).solve(pods)
            return solver, sorted((n.instance_type_options[0].name(), tuple(sorted(p.metadata.name for p in n.pods))) for n in results.new_nodes)

        base = DEGRADED_SOLVES.value(rung=RUNG_CHUNKED)
        whole, whole_nodes = solve(0)
        assert len(calls) == 1
        B = calls[0]
        calls.clear()
        over, over_nodes = solve(1 << 19)  # the peak, 1 MiB, is over the budget
        assert calls == [-(-B // 2), B - -(-B // 2)], "two launches, one per half of the bucket axis"
        assert over_nodes == whole_nodes
        assert over._solve_rungs == [RUNG_CHUNKED] and DEGRADED_SOLVES.value(rung=RUNG_CHUNKED) == base + 1
        calls.clear()
        under, _ = solve(1 << 21)  # under the budget: one launch
        assert len(calls) == 1 and under._solve_rungs == []
    finally:
        if not was_enabled:
            flight.FLIGHT.disable()
        flight.FLIGHT.reset()


# -- the controllers hold the work --------------------------------------------------------------


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def test_provisioner_holds_the_batch_and_retries_on_the_device():
    """Two device-lost faults open the breaker (threshold 2); the pods stay
    Pending, the loop stays alive and re-arms for the reopen time (no pod
    event wakes it), and the recovery probe places every pod."""
    env = testing.Environment(dense_solver=DenseSolver(min_batch=1, device="cpu"))
    BREAKER.configure(threshold=2, backoff=5.0, clock=env.clock)
    FAULTS.install(FaultPlan([FaultSpec(kind="device-lost", entry="plain", nth=1, count=2)]))
    env.kube.create(testing.make_provisioner())
    controller = env.provisioner_controller
    controller.start()
    try:
        pods = [testing.make_pod(requests={"cpu": "1"}) for _ in range(6)]
        for pod in pods:
            env.kube.create(pod)
        assert _wait(lambda: BREAKER.state == STATE_OPEN and controller._fault_retry_at is not None)
        assert FAULTS.fired() == 2
        assert controller._fault_retry_at == pytest.approx(env.clock.now() + 5.0)
        assert controller.thread.is_alive() and controller.error is None
        assert env.kube.list_nodes() == [] and len(env.kube.pending_pods()) == 6, "every pod stays pending"
        env.clock.step(6.0)
        assert _wait(lambda: env.kube.list_nodes() and BREAKER.state == STATE_CLOSED)
        assert _wait(lambda: controller.last_results is not None and sum(len(n.pods) for n in controller.last_results.new_nodes) == 6)
        assert controller.error is None and controller.thread.is_alive()
    finally:
        controller.stop()


def test_provisioner_loop_ends_on_an_unclassified_exception(monkeypatch):
    from karpenter_tpu_torch.solver import dense as dense_module

    def novel(*args, **kwargs):
        raise ValueError("a failure classify has no name for")

    monkeypatch.setattr(dense_module, "bucket_cost_packed", novel)
    env = testing.Environment(dense_solver=DenseSolver(min_batch=1, device="cpu"))
    env.kube.create(testing.make_provisioner())
    controller = env.provisioner_controller
    controller.start()
    env.kube.create(testing.make_pod(requests={"cpu": "1"}))
    controller.thread.join(timeout=30)
    assert not controller.thread.is_alive() and isinstance(controller.error, ValueError)
    with pytest.raises(ValueError, match="no name for"):
        controller.stop()


def test_provisioner_loop_ends_on_a_device_lost_the_card_raised(monkeypatch):
    """Not a plan's: the CUDA context stays broken, so the loop ends (as on
    an unclassified exception) and the pod stays Pending for a restart."""
    from karpenter_tpu_torch.solver import dense as dense_module

    def asserting(*args, **kwargs):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(dense_module, "bucket_cost_packed", asserting)
    env = testing.Environment(dense_solver=DenseSolver(min_batch=1, device="cpu"))
    env.kube.create(testing.make_provisioner())
    controller = env.provisioner_controller
    controller.start()
    env.kube.create(testing.make_pod(requests={"cpu": "1"}))
    controller.thread.join(timeout=30)
    assert not controller.thread.is_alive() and isinstance(controller.error, SolverDeviceLostError)
    assert not controller.error.injected and BREAKER.consecutive == 1
    assert env.kube.list_nodes() == [] and len(env.kube.pending_pods()) == 1
    with pytest.raises(SolverDeviceLostError, match="device-side assert"):
        controller.stop()


@pytest.mark.parametrize("make,held", [
    (lambda: SolverKernelError("bucket_cost kernel launch failed: cudaErrorInvalidValue: invalid argument (CUDA error 1)"), True),
    (lambda: SolverHbmExhaustedError("CUDA out of memory"), True),
    (lambda: SolverBreakerOpenError(KIND_DEVICE_LOST, "open"), True),
    (lambda: _injected(KIND_DEVICE_LOST), True),
    (lambda: classify(RuntimeError("CUDA error: an illegal memory access was encountered")), False),
])
def test_ends_the_loop_only_on_a_device_lost_the_card_raised(make, held):
    fault = make()
    assert faults.ends_the_loop(fault) is not held


def _injected(kind):
    plan = FaultPlan([FaultSpec(kind=kind, entry="plain", nth=1)])
    with pytest.raises(SolverFault) as raised:
        plan.check("plain")
    assert raised.value.injected
    return raised.value


@pytest.mark.parametrize("make,held", [
    (lambda: SolverKernelError("bucket_cost kernel launch failed: cudaErrorLaunchOutOfResources"), True),
    (lambda: SolverBreakerOpenError(KIND_DEVICE_LOST, "open"), True),
    (lambda: _injected(KIND_DEVICE_LOST), True),
    (lambda: classify(RuntimeError("CUDA error: an illegal memory access was encountered")), False),
])
def test_slo_ideal_repack_holds_a_solver_fault(make, held):
    """The SLO scraper's ideal repack (--enable-slo): a held fault leaves the
    gauges and the epoch for the next scrape; a device-lost the card raised
    ends the metrics loop."""
    from karpenter_tpu_torch import slo
    from karpenter_tpu_torch.controllers.metrics.slo import SLOScraper
    from karpenter_tpu_torch.kube.cluster import KubeCluster

    fault = make()

    class Solving:
        calls = 0

        def schedule(self, *args, **kwargs):
            Solving.calls += 1
            raise fault

    kube = KubeCluster()
    kube.create(testing.make_pod(name="bound", requests={"cpu": "1"}, node_name="n-1", phase="Running", unschedulable=False))
    scraper = SLOScraper(kube, cluster=None, cloud_provider=None, provisioner_controller=Solving())
    ideal, drift = slo.IDEAL_COST.value(), slo.COST_DRIFT.value()
    if held:
        assert scraper.compute_drift(actual_cost=2.0) is None
        assert (slo.IDEAL_COST.value(), slo.COST_DRIFT.value()) == (ideal, drift)
    else:
        with pytest.raises(SolverDeviceLostError):
            scraper.compute_drift(actual_cost=2.0)
    assert Solving.calls == 1


@pytest.mark.parametrize("make,held", [
    (lambda: SolverKernelError("bucket_cost kernel launch failed: cudaErrorInvalidValue"), True),
    (lambda: SolverBreakerOpenError(KIND_DEVICE_LOST, "open"), True),
    (lambda: classify(RuntimeError("CUDA error: device-side assert triggered")), False),
])
def test_runtime_consolidation_pass_holds_a_solver_fault(make, held):
    """The Runtime's own consolidation pass (--disable-disruption): a held
    fault ends the pass with no action and forgets its epoch; a device-lost
    the card raised ends the loop."""
    from types import SimpleNamespace

    from karpenter_tpu_torch.runtime import Runtime

    fault, retried = make(), []

    def process_cluster():
        raise fault

    rt = SimpleNamespace(consolidation=SimpleNamespace(process_cluster=process_cluster, retry_next_pass=lambda: retried.append(1)))
    if held:
        assert Runtime._consolidate(rt) is None and retried == [1]
    else:
        with pytest.raises(SolverDeviceLostError):
            Runtime._consolidate(rt)
        assert retried == []


def test_orchestrator_holds_a_pass_while_the_breaker_is_open_then_consolidates():
    """An open breaker holds every what-if (simulation solves share the
    open answer): reconcile() ends the consolidation pass with no action;
    once the breaker closes the next pass consolidates."""
    from tests.test_torch_consolidation import DKit

    k = DKit("port", "dense")
    env = k.disrupt_env(provisioners=[k.consolidatable()], instance_types=k.big_small())
    pod = k.owned(requests={"cpu": "8"})
    env.launch_node_with_pods(pod)
    pod.spec.containers[0].resources.requests["cpu"] = 0.5
    env.kube.update(pod)
    env.clock.step(400)
    nodes = sorted(n.name for n in env.kube.list_nodes())
    BREAKER.configure(threshold=1)
    BREAKER.record_fault(KIND_DEVICE_LOST)
    env.disruption.reconcile()
    assert sorted(n.name for n in env.kube.list_nodes()) == nodes and not env.disruption._queue
    BREAKER.reset()
    env.disruption.reconcile()
    assert env.disruption._pending is not None or env.disruption.tracker.total_in_flight() == 1, "the next pass acted"
