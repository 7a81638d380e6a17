"""Traces across controllers on the port, each reference case as written on
the port (port copies through `port_copy`):

- tests/test_disruption.py::TestTraceChain: a drift command's disrupt →
  validate → launch-replacement → drain-handoff is one trace;
- tests/test_capacity_resilience.py::TestFallbackResolve: the tracing
  Runtime's capacity-failure rounds, with the launch-failure counter and the
  escalated pod's decision record;
- tests/test_disruption_storm.py (marked slow, as the reference's is): the
  storm under the port's lock witness and informer-coherence witness, its
  teardown holding the acquisition graph acyclic and every informer cache
  equal to its store.

The port's tracer, decision log and witness are disabled and emptied after
every test (`port_telemetry`), the JAX package's singletons restored
(`reference_singletons`).
"""

from __future__ import annotations

import pytest

from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_scheduler_catalog import port_copy
from tests.test_torch_journal import coherence_witness  # noqa: F401  the port's witness, for the storm
from tests.test_torch_tracing import port_telemetry  # noqa: F401

_DISRUPTION = port_copy(
    "test_disruption",
    extra=(
        ("from karpenter_tpu import webhooks", "from karpenter_tpu_torch import webhooks"),
        ("from tests.env import Environment", "from karpenter_tpu_torch.testing import Environment"),
    ),
)
TestTraceChain = _DISRUPTION.TestTraceChain

_CAPACITY = port_copy("test_capacity_resilience")
TestFallbackResolve = _CAPACITY.TestFallbackResolve


@pytest.fixture
def port_lock_order_witness():
    """tests/conftest.py's lock_order_witness on the port's witness: every
    lock created during the test is witnessed, and the acquisition-order
    graph must stay acyclic."""
    from karpenter_tpu_torch.analysis.witness import WITNESS

    WITNESS.enable()
    try:
        yield WITNESS
        cycles = WITNESS.cycles()
    finally:
        WITNESS.disable()
        WITNESS.reset()
    assert cycles == [], f"lock-order cycles (potential deadlocks) detected: {cycles}"


_STORM = port_copy(
    "test_disruption_storm",
    extra=(
        ("from tests.test_disruption import DisruptionEnv", "DisruptionEnv = _DISRUPTION.DisruptionEnv"),
        ("def _lock_order_witness(lock_order_witness):", "def _lock_order_witness(port_lock_order_witness):"),
    ),
    inject={"_DISRUPTION": _DISRUPTION},
)
_lock_order_witness = _STORM._lock_order_witness
_coherence_witness = _STORM._coherence_witness
test_disruption_storm_budget_invariant = _STORM.test_disruption_storm_budget_invariant
