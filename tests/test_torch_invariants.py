"""The thread census, the invariant monitor and the coherence witness on the port.

- tests/test_invariants.py as written on the port (a port copy of the
  module through `port_copy`): the census, the monitor's leak, budget,
  memory-slope and double-launch witnesses, and /debug/invariants;
- tests/test_coherence.py as written on the port: the deep compare, the
  confirmed-divergence witness (watch gaps and a moving store skipped), the
  final check, /debug/coherence, and the Runtime's registration.
"""

from __future__ import annotations

from tests.test_torch_journal import recorder_copy

_INVARIANTS = recorder_copy("test_invariants")
_monitor_teardown = _INVARIANTS._monitor_teardown
TestThreadCensus = _INVARIANTS.TestThreadCensus
TestInvariantMonitor = _INVARIANTS.TestInvariantMonitor
TestInvariantsRoute = _INVARIANTS.TestInvariantsRoute

_COHERENCE = recorder_copy("test_coherence")
_isolated_witness = _COHERENCE._isolated_witness
TestCompare = _COHERENCE.TestCompare
TestWitness = _COHERENCE.TestWitness
TestRuntimeIntegration = _COHERENCE.TestRuntimeIntegration
