"""The chaos orchestrator (scenarios/chaos_orchestrator.py) on the port.

tests/test_chaos_orchestrator.py as written on the port (a port copy of the
module through `port_copy`): the seed fan-out, the schedule's determinism,
the spec exports composing onto the solver and kube injectors, the diurnal
trace, the ddmin shrinker and the shrink document. One case counts the
solver specs a draw exports under the port's seams: one per draw for
"plain", "sharded" and "cuda" (K1's launch), where the JAX package exports
"plain", "sharded" and "pallas".
"""

from __future__ import annotations

from tests.test_torch_scheduler_catalog import port_copy

_ORCHESTRATOR = port_copy(
    "test_chaos_orchestrator",
    extra=(
        ('assert {s.entry for s in solver_plan.specs} == {"plain", "sharded", "pallas"}', 'assert {s.entry for s in solver_plan.specs} == {"plain", "sharded", "cuda"}'),
    ),
)
TestSeedFanout = _ORCHESTRATOR.TestSeedFanout
TestScheduleDeterminism = _ORCHESTRATOR.TestScheduleDeterminism
TestDiurnalTrace = _ORCHESTRATOR.TestDiurnalTrace
TestDdmin = _ORCHESTRATOR.TestDdmin
TestShrinkDoc = _ORCHESTRATOR.TestShrinkDoc
