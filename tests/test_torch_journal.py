"""The lifecycle journal and its JSONL schema on the port.

- tests/test_journal.py as written on the port (a port copy of the module
  through `port_copy`): recording, the bounds under load, disabled-is-free,
  the waterfall, the watch hooks, the routes, the schema, ReplayTrace, and
  the pod_burst scenario's journal captured by the campaign runner (its
  Runtime on the CPU) and replayed;
- tests/test_leader_flap.py::TestLeaderFlap::test_flap_counts_and_journals
  on both packages: a stolen Lease journals `lease-lost` and the
  re-acquisition `lease-acquired`.

This module also holds what the recorder suites' port copies share
(`RECORDER_SUBSTITUTIONS`, `recorder_copy`, and the port's
`lock_order_witness` and `coherence_witness`, the counterparts of
tests/conftest.py's fixtures of those names, which witness the JAX
package's singletons).
"""

from __future__ import annotations

import pytest

from tests.test_torch_runtime import RKit, _wait
from tests.test_torch_scheduler_catalog import port_copy

# what every recorder suite's port copy changes where its text occurs
RECORDER_SUBSTITUTIONS = (
    ("from karpenter_tpu import ", "from karpenter_tpu_torch import "),
    ("from tests.env import Environment", "from karpenter_tpu_torch.testing import Environment"),
    ("from karpenter_tpu_torch.runtime import LeaderElector, Runtime", "from karpenter_tpu_torch.runtime import Runtime"),
    ("                LeaderElector._leader = None\n", ""),
    ("            LeaderElector._leader = None\n", ""),
)


def recorder_copy(name: str, extra=()):
    """tests/<name>.py as written on the port, with RECORDER_SUBSTITUTIONS
    and the module's own `extra` pairs."""
    return port_copy(name, extra=extra, optional=RECORDER_SUBSTITUTIONS)


@pytest.fixture
def lock_order_witness():
    """tests/conftest.py's fixture of this name on the port's witness:
    every lock created during the test is witnessed, and the acquisition
    order must stay acyclic."""
    from karpenter_tpu_torch.analysis.witness import WITNESS

    WITNESS.enable()
    yield WITNESS
    cycles = WITNESS.cycles()
    WITNESS.disable()
    WITNESS.reset()
    assert cycles == [], f"lock-order cycles (potential deadlocks) detected: {cycles}"


@pytest.fixture
def coherence_witness():
    """tests/conftest.py's fixture of this name on the port's coherence
    witness: every cache still registered must match its store at teardown,
    and no confirmed divergence may be recorded during the test."""
    from karpenter_tpu_torch.kube.coherence import COHERENCE, divergences_total

    before = divergences_total()
    yield COHERENCE
    standing = COHERENCE.final_check(timeout=3.0)
    assert standing == [], f"informer caches diverged from the store at teardown: {standing}"
    recorded = divergences_total() - before
    assert recorded == 0, f"{recorded} confirmed informer divergence(s) recorded during the test"


# -- tests/test_journal.py --------------------------------------------------------

_JOURNAL = recorder_copy("test_journal", extra=(("CampaignRunner(", 'CampaignRunner(device="cpu", '),))
_lock_order_witness = _JOURNAL._lock_order_witness
journal = _JOURNAL.journal
TestRecording = _JOURNAL.TestRecording
TestBoundsUnderLoad = _JOURNAL.TestBoundsUnderLoad
TestDisabledIsFree = _JOURNAL.TestDisabledIsFree
TestWaterfall = _JOURNAL.TestWaterfall
TestWatchDriven = _JOURNAL.TestWatchDriven
TestRoutes = _JOURNAL.TestRoutes
TestJournalSchema = _JOURNAL.TestJournalSchema
TestReplayTrace = _JOURNAL.TestReplayTrace
test_pod_burst_journal_replays_exactly = _JOURNAL.test_pod_burst_journal_replays_exactly


# -- tests/test_leader_flap.py:111 ------------------------------------------------


@pytest.fixture
def flap_runtime(request):
    """(kit, kube, runtime) of the leader-flap stack on one package; the
    Runtime is stopped at the end."""
    kit = RKit(request.param)
    kube = kit.KubeCluster()
    _backend, provider = kit.simulated(kube)
    runtime = kit.build(
        kube, provider,
        leader_elect=True, lease_duration=1.0, lease_renew_period=0.05,
        batch_max_duration=0.2, batch_idle_duration=0.05, dense_solver_enabled=False,
        gc_interval=0.5, gc_registration_grace=2.0, coherence_interval=0.0,
    )
    yield kit, kube, runtime
    runtime.stop()
    if kit.side == "ref":
        from karpenter_tpu.runtime import LeaderElector

        LeaderElector._leader = None


@pytest.mark.parametrize("flap_runtime", ["ref", "port"], indirect=True)
def test_flap_counts_and_journals(flap_runtime):
    kit, kube, runtime = flap_runtime
    journal = __import__(f"{kit.root}.journal", fromlist=["JOURNAL"])
    JOURNAL = journal.JOURNAL
    LEADER_FLAPS = kit.leaderelection.LEADER_FLAPS
    JOURNAL.enable()
    JOURNAL.reset()
    try:
        runtime.start()
        before = LEADER_FLAPS.value()
        assert kit.leaderelection.steal_lease(kube, identity="thief")
        assert _wait(lambda: LEADER_FLAPS.value() == before + 1)
        assert _wait(lambda: runtime.elector.is_leader(), timeout=10.0)
        events = [(e["event"], e["entity"]) for e in JOURNAL.events(limit=50) if e["kind"] == "kube"]
        assert ("lease-lost", runtime.elector.identity) in events
        # re-acquisition journals a second lease-acquired for the same identity
        assert [e for e in events if e[0] == "lease-acquired"], events
    finally:
        JOURNAL.disable()
        JOURNAL.reset()
