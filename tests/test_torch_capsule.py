"""Incident capsules and their inspector on the port.

tests/test_capsule.py as written on the port (a port copy of the module
through `port_copy`), the breaker-open emit site and the capsule document's
`fault_domain` block (solver/faults.py) and `inspect --replay` through the
port's scenarios/replay.py included, less
test_steady_recompile_fires_only_on_within_run_retrace: it drives the JAX
package's per-entry jit cache polling (`register_jit_entry`), which the port
has no counterpart of (flight.py). Its port case, TestSteadyRecompile, seeds
kernel builds into the flight recorder's tally and reads the port's
committed contract (analysis/solver_contracts.json).
"""

from __future__ import annotations

from tests.test_torch_journal import recorder_copy
from tests.test_torch_tracing import without

_CAPSULE = recorder_copy("test_capsule")
_capsule_teardown = _CAPSULE._capsule_teardown
TestDisabledIsFree = _CAPSULE.TestDisabledIsFree
TestTriggerBus = _CAPSULE.TestTriggerBus
TestEmitSites = without(_CAPSULE.TestEmitSites, "test_steady_recompile_fires_only_on_within_run_retrace")
TestBurnRate = _CAPSULE.TestBurnRate
TestSpool = _CAPSULE.TestSpool
TestDebugRoute = _CAPSULE.TestDebugRoute
TestInspectCLI = _CAPSULE.TestInspectCLI


class TestSteadyRecompile:
    def test_steady_recompile_fires_only_on_a_build_after_the_first(self, monkeypatch):
        """The flight/contracts cross-check on the port: a kernel library
        built again after its first, on a shape change, is the incident (a
        library declares no varying axis in the committed contract). A
        cold start, a solve that builds nothing and a library's first build
        in the process (a path engaging mid-run) fire nothing."""
        from karpenter_tpu_torch import flight as flight_mod
        from karpenter_tpu_torch.capsule import CAPSULE, TRIGGER_STEADY_RECOMPILE

        contract = flight_mod._committed_contracts()
        assert contract is not None and set(contract["libraries"]) == {"bucket_cost", "warm_fill"}
        _CAPSULE._enable(CAPSULE)
        fresh = flight_mod.FlightRecorder()
        fresh.enable()
        # a tally of this test's own, so the process's real builds don't count
        monkeypatch.setattr(flight_mod, "_TALLY", flight_mod._CompileTally())

        def solve(signature, builds=()):
            token = fresh.begin_solve()
            for library in builds:
                flight_mod._TALLY.on_build(library, 0.5)
            fresh.complete_solve(
                token=token, signature=signature, dispatch=None, phases={}, fill_routing={},
                pods_committed=0, pods_to_host=0, duration=0.0,
            )

        solve({"pods": 10, "zones": 1}, ["bucket_cost"])  # cold start: K1's first build
        solve({"pods": 10, "zones": 1})  # steady: nothing built
        solve({"pods": 20, "zones": 1})  # a shape change that builds nothing
        solve({"pods": 30, "zones": 2}, ["warm_fill"])  # K2's first build, mid-run
        assert CAPSULE.poll() == 0
        solve({"pods": 40, "zones": 2}, ["bucket_cost"])  # K1 built again on a shape change
        assert CAPSULE.poll() == 1
        [row] = CAPSULE.index()
        assert row["trigger"] == TRIGGER_STEADY_RECOMPILE
        assert row["detail"] == {"attribution": ["pods"]}
