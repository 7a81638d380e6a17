"""Incident capsules and their inspector on the port.

tests/test_capsule.py as written on the port (a port copy of the module
through `port_copy`), the breaker-open emit site and the capsule document's
`fault_domain` block (solver/faults.py) included, less what waits for other
ROADMAP items:

- test_steady_recompile_fires_only_on_within_run_retrace needs a committed
  solver contract (A13) and the JAX package's per-entry jit cache polling,
  which the port has no counterpart of (flight.py);
- test_replay_round_trips_the_journal_slice needs scenarios/replay.py
  (A10): its port counterpart holds that `inspect --replay` exits 2 and
  names A10.
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


class TestInspectCLI(without(_CAPSULE.TestInspectCLI, "test_replay_round_trips_the_journal_slice")):
    def test_replay_waits_for_the_scenarios(self, tmp_path, capsys):
        from karpenter_tpu_torch.cmd import capsule as cmd_capsule

        path = self._spooled_capsule(tmp_path)
        assert cmd_capsule.main(["inspect", path, "--replay", "--compress", "2"]) == 2
        assert "ROADMAP A10" in capsys.readouterr().err
