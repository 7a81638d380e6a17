"""The soak tier and the crash storm on the port.

tests/test_chaos_soak.py and tests/test_crash_storm.py as written on the
port (port copies of the modules through `port_copy`, the campaign runner's
Runtimes on the CPU): the mini-soak on both cloud transports with every leak
witness at zero, the seeded negative control caught, the ddmin shrinker,
and the committed SHRINK_chaos_leak.json replayed on the port (read, never
written). The full chaos soak and the crash storm are marked slow, as the
JAX package's are. The suites' lock-order and informer-coherence witnesses
are the port's.
"""

from __future__ import annotations

from tests.test_torch_journal import coherence_witness, lock_order_witness  # noqa: F401
from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_scenarios import SCENARIO_SUBSTITUTIONS
from tests.test_torch_scheduler_catalog import port_copy

_SOAK = port_copy("test_chaos_soak", optional=SCENARIO_SUBSTITUTIONS)
_slo_teardown = _SOAK._slo_teardown
_lock_order_witness = _SOAK._lock_order_witness
_coherence_witness = _SOAK._coherence_witness
test_mini_soak_leaks_nothing_on_both_transports = _SOAK.test_mini_soak_leaks_nothing_on_both_transports
test_negative_control_leak_is_caught_and_fails_convergence = _SOAK.test_negative_control_leak_is_caught_and_fails_convergence
test_shrinker_reduces_the_failing_schedule_to_one_event = _SOAK.test_shrinker_reduces_the_failing_schedule_to_one_event
test_committed_shrink_reproducer_replays_deterministically = _SOAK.test_committed_shrink_reproducer_replays_deterministically
test_chaos_soak_acceptance_on_both_transports = _SOAK.test_chaos_soak_acceptance_on_both_transports

_CRASH = port_copy("test_crash_storm", optional=SCENARIO_SUBSTITUTIONS)
test_crash_storm_converges_leak_free = _CRASH.test_crash_storm_converges_leak_free
