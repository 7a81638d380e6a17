"""The solver flight recorder on the port, and the torch programs it names.

- tests/test_flight_recorder.py as written on the port (a port copy of the
  module through `port_copy`): the warm re-solve gate (zero kernel builds),
  the cold-start attribution, the record's shapes, phases and memory
  gauges, the device span's attributes, the bounded ring, disabled-is-free,
  /debug/solver and the /debug index, and a live controller process with
  --enable-solver-telemetry;
- its JAX-compile cases, which read jax.monitoring and the jit caches'
  `_cache_size()`, have port counterparts on the nvcc-build tally
  (ops/_cuda_build.py's BUILD_LISTENERS): a build inside a solve's window
  marks its record and is attributed to the dimension that changed; two
  enabled recorders install one listener; a build counts under its kernel
  library's name. `register_jit_entry` has no port counterpart (torch
  programs keep no executable cache), so its two cases are left out;
- `resource_fit` and `feasibility_mask` (ops/feasibility.py) against the
  JAX package's jitted programs on the same seeded inputs, exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_journal import recorder_copy
from tests.test_torch_provisioning import reference_singletons  # noqa: F401
from tests.test_torch_tracing import without

_FLIGHT = recorder_copy(
    "test_flight_recorder",
    extra=(('"-m", "karpenter_tpu.cmd.controller",', '"-m", "karpenter_tpu_torch.cmd.controller",'),),
)
recorder = _FLIGHT.recorder
_solve_once, _workload = _FLIGHT._solve_once, _FLIGHT._workload


class TestSteadyStateRecompileGate(
    without(_FLIGHT.TestSteadyStateRecompileGate, "test_shape_change_attributed_to_changed_dimension")
):
    def test_build_in_the_window_attributed_to_changed_dimension(self, recorder, monkeypatch, tmp_path):
        """The port's negative control: growing the type universe, with a
        kernel build landing inside that solve (a stand-in nvcc that writes
        its output), must count one build under the library's name, mark
        the record and name the changed dimension."""
        from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
        from karpenter_tpu_torch.ops import _cuda_build
        from karpenter_tpu_torch.solver import DenseSolver, dense

        library = _stand_in_library(monkeypatch, tmp_path, "bucket_cost")
        pods = _workload(300)
        solver = DenseSolver(min_batch=1, device="cpu")
        _solve_once(solver, FakeCloudProvider(instance_types(53)), pods)
        _solve_once(solver, FakeCloudProvider(instance_types(53)), pods)  # settle
        base = recorder.compilations_total()
        seam = dense.bucket_cost_packed

        def building(*args):
            library.build()
            return seam(*args)

        monkeypatch.setattr(dense, "bucket_cost_packed", building)
        _solve_once(solver, FakeCloudProvider(instance_types(59)), pods)
        assert recorder.compilations_total() - base == 1
        record = recorder.records()[-1]
        assert record.recompile is True
        assert record.compiled_fns == {"bucket_cost": 1}
        assert record.first_compiles == ["bucket_cost"]
        assert record.compile_seconds > 0
        assert "types" in record.recompile_attribution, record.recompile_attribution
        assert library.builds == 1 and _cuda_build.BUILD_LISTENERS


def _stand_in_library(monkeypatch, tmp_path, name: str):
    """A KernelLibrary named `name` whose build runs a stand-in for nvcc (a
    script that writes the output library), in a build directory of the
    test's own."""
    import stat
    import sys

    from karpenter_tpu_torch.ops import _cuda_build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys, time\ntime.sleep(0.01)\nopen(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    source = tmp_path / f"{name}.cu"
    source.write_text("// stand-in source\n")
    monkeypatch.setattr(_cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "_build")
    library = _cuda_build.KernelLibrary(name, lambda lib: None)
    library.source = source
    library.path = tmp_path / "_build" / f"lib{name}.so"
    return library


class TestRecordContents(
    without(
        _FLIGHT.TestRecordContents,
        "test_two_enabled_recorders_install_one_listener",
        "test_register_jit_entry_bounds_wrapper_generations",
        "test_register_jit_entry_dedupes_and_ignores_uncacheable",
    )
):
    def test_two_enabled_recorders_install_one_listener(self):
        """ops/_cuda_build.py keeps its listeners for the process: a second
        enabled recorder must reuse the process-wide tally's single
        listener, or every build would double into
        karpenter_jax_compile_seconds_total."""
        from karpenter_tpu_torch import flight
        from karpenter_tpu_torch.ops import _cuda_build

        a, b = flight.FlightRecorder(), flight.FlightRecorder()
        a.enable()
        b.enable()
        try:
            ours = [cb for cb in _cuda_build.BUILD_LISTENERS if getattr(cb, "__self__", None) is flight._TALLY]
            assert len(ours) == 1, f"{len(ours)} build listeners installed"
        finally:
            a.disable()
            b.disable()

    def test_builds_outside_a_window_count_but_mark_no_record(self, recorder, monkeypatch, tmp_path):
        """A build before a solve (a warm-up that loads the kernels) lands
        in the process tally and in the seconds family, not in the next
        solve's record."""
        from karpenter_tpu_torch import flight
        from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
        from karpenter_tpu_torch.solver import DenseSolver

        events, seconds = flight._TALLY.snapshot()
        seconds_family = flight.COMPILE_SECONDS.value()
        _stand_in_library(monkeypatch, tmp_path, "warm_fill").build()
        assert flight._TALLY.snapshot()[0] == events + 1
        assert flight.COMPILE_SECONDS.value() > seconds_family
        _solve_once(DenseSolver(min_batch=1, device="cpu"), FakeCloudProvider(instance_types(50)), _workload(300))
        record = recorder.records()[-1]
        assert record.recompile is False and record.compiled_fns == {}

    def test_cpu_solver_reports_no_device_memory(self, recorder):
        from karpenter_tpu_torch import flight

        assert flight.FlightRecorder.hbm_snapshot(torch.device("cpu")) == (0, 0)
        assert flight.FlightRecorder.hbm_snapshot() == (0, 0)

    def test_snapshot_has_no_fault_domain_block(self, recorder):
        """Named when solver/faults.py was not ported yet and the block was
        missing: the /debug/solver index's fault-domain block is now the
        reference's, key for key, with the breaker block equal on both
        packages after the same healthy solve."""
        from karpenter_tpu import flight as ref_flight
        from karpenter_tpu.solver.faults import BREAKER as REF_BREAKER
        from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
        from karpenter_tpu_torch.solver import DenseSolver
        from karpenter_tpu_torch.solver.faults import BREAKER, KINDS, RUNGS

        for breaker in (REF_BREAKER, BREAKER):
            breaker.reset()
            breaker.configure(threshold=3, backoff=30.0)
        _solve_once(DenseSolver(min_batch=1, device="cpu"), FakeCloudProvider(instance_types(50)), _workload(300))
        snapshot = recorder.snapshot()
        block, ref_block = snapshot["fault_domain"], ref_flight.FLIGHT.snapshot()["fault_domain"]
        assert list(block) == list(ref_block) == ["breaker", "faults_total", "degraded_solves_total"]
        assert block["breaker"] == ref_block["breaker"]
        assert block["breaker"]["state"] == "closed" and block["breaker"]["consecutive_faults"] == 0
        assert set(block["faults_total"]) <= set(KINDS) and set(block["degraded_solves_total"]) <= set(RUNGS)
        assert snapshot["records"][0]["dispatch"] == "plain"
        assert snapshot["records"][0]["faults"] == {} and snapshot["records"][0]["breaker"] == "closed"


TestDisabledIsFree = _FLIGHT.TestDisabledIsFree
TestSolverRoute = _FLIGHT.TestSolverRoute
TestDebugIndexRoute = _FLIGHT.TestDebugIndexRoute
test_live_process_serves_debug_and_solver_json = _FLIGHT.test_live_process_serves_debug_and_solver_json


# -- resource_fit and feasibility_mask against the JAX package's programs ----------

# (P, T, R, G): a one-pod batch, the fixture sizes of the reference's suite,
# and a ragged headline-sized slice
FIT_SHAPES = [(1, 1, 1, 1), (37, 13, 3, 4), (300, 50, 5, 9), (1024, 500, 8, 31)]


def _fit_inputs(seed: int, P: int, T: int, R: int, G: int):
    """Requests and capacities on a coarse grid, with exact ties and
    capacities 1e-6 short of a request (the tolerance's boundary) planted."""
    rng = np.random.default_rng(seed)
    caps = (rng.integers(0, 65, size=(T, R)) * 0.5).astype(np.float32)
    requests = (rng.integers(0, 40, size=(P, R)) * 0.5).astype(np.float32)
    ties = rng.random((P,)) < 0.2
    if T:
        pick = rng.integers(0, T, size=P)
        requests[ties] = caps[pick[ties]]
        near = rng.random((P,)) < 0.1
        requests[near] = caps[pick[near]] + np.float32(1e-6)
    compat = rng.random((G, T)) < 0.7
    group_ids = rng.integers(0, G, size=P).astype(np.int32)
    return requests, caps, compat, group_ids


@pytest.mark.parametrize("shape", FIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", range(3))
def test_resource_fit_and_feasibility_mask_match_the_jitted_programs(shape, seed):
    import jax.numpy as jnp

    from karpenter_tpu.ops import feasibility as ref
    from karpenter_tpu_torch.ops import feasibility as port

    requests, caps, compat, group_ids = _fit_inputs(seed, *shape)
    want_fit = np.asarray(ref.resource_fit(jnp.asarray(requests), jnp.asarray(caps)))
    want_mask = np.asarray(
        ref.feasibility_mask(jnp.asarray(requests), jnp.asarray(caps), jnp.asarray(compat), jnp.asarray(group_ids))
    )
    got_fit = port.resource_fit(torch.from_numpy(requests), torch.from_numpy(caps)).numpy()
    got_mask = port.feasibility_mask(
        torch.from_numpy(requests), torch.from_numpy(caps), torch.from_numpy(compat), torch.from_numpy(group_ids)
    ).numpy()
    assert got_fit.dtype == np.bool_ and got_mask.dtype == np.bool_
    assert got_fit.shape == want_fit.shape == (shape[0], shape[1])
    np.testing.assert_array_equal(got_fit, want_fit)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert 0 < want_fit.sum() < want_fit.size or shape[0] * shape[1] == 1
