"""Incident capsules and their inspector on the port.

tests/test_capsule.py as written on the port (a port copy of the module
through `port_copy`), the breaker-open emit site and the capsule document's
`fault_domain` block (solver/faults.py) and `inspect --replay` through the
port's scenarios/replay.py included, less
test_steady_recompile_fires_only_on_within_run_retrace: it needs a committed
solver contract (ROADMAP A13) and the JAX package's per-entry jit cache
polling, which the port has no counterpart of (flight.py).
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
