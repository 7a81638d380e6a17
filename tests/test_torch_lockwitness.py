"""The lock-order witness on the port: tests/test_lockwitness.py, every
case, as written on the port (a port copy of the module through
`port_copy`), the Runtime integration case with the port's Runtime (the
JAX package's in-process LeaderElector, which the port does not have, is
not reset there). The port's tracer, decision log and witness are disabled
and emptied after every test (`port_telemetry`)."""

from __future__ import annotations

from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_scheduler_catalog import port_copy
from tests.test_torch_tracing import port_telemetry  # noqa: F401

_WITNESS = port_copy(
    "test_lockwitness",
    extra=(
        ("from karpenter_tpu_torch.runtime import LeaderElector, Runtime", "from karpenter_tpu_torch.runtime import Runtime"),
        ("                LeaderElector._leader = None\n", ""),
    ),
)
witness = _WITNESS.witness
TestDisabledIsPlain = _WITNESS.TestDisabledIsPlain
TestOrderingGraph = _WITNESS.TestOrderingGraph
TestReentrancy = _WITNESS.TestReentrancy
TestHoldAccounting = _WITNESS.TestHoldAccounting
TestLifecycleEdges = _WITNESS.TestLifecycleEdges
TestConditionSupport = _WITNESS.TestConditionSupport
TestSnapshot = _WITNESS.TestSnapshot
TestRuntimeIntegration = _WITNESS.TestRuntimeIntegration
