"""The measured host/device crossover, held on both packages.

The cases of tests/test_crossover.py that time an injected dispatch run on
the JAX package's measure_dense_crossover and on the port's: the crossover
follows the round trip, clamps to the floor and the ceiling, and leaves the
warm-up call out. Where a measurement fails, the JAX package returns its
default and the port raises. The port's default dispatch (the bucket ->
type cost kernel's wrapper at the probe shape) runs here on the CPU, where
the wrapper takes its plain version; asked for the card without one, it
raises. The two Runtime cases of tests/test_crossover.py are held in
tests/test_torch_runtime.py.
"""

from __future__ import annotations

import time

import pytest
import torch

from karpenter_tpu.solver import dense as ref_dense
from karpenter_tpu_torch.solver import dense

SIDES = {"ref": ref_dense, "port": dense}


@pytest.mark.parametrize("side", sorted(SIDES))
class TestMeasuredCrossover:
    def test_constants_match_the_reference(self, side):
        mod = SIDES[side]
        assert (mod.HOST_SECONDS_PER_POD, mod.CROSSOVER_FLOOR, mod.CROSSOVER_CEILING) == (2.5e-4, 64, 2048)

    def test_constant_adapts_to_link_speed(self, side):
        mod = SIDES[side]
        fast = mod.measure_dense_crossover(trials=1, dispatch=lambda: time.sleep(0.02))
        slow = mod.measure_dense_crossover(trials=1, dispatch=lambda: time.sleep(0.12))
        assert fast < slow
        # proportional to the round trip within scheduling jitter
        for got, rt in ((fast, 0.02), (slow, 0.12)):
            assert abs(got - rt / mod.HOST_SECONDS_PER_POD) < 0.5 * (rt / mod.HOST_SECONDS_PER_POD)

    def test_instant_link_clamps_to_floor(self, side):
        mod = SIDES[side]
        assert mod.measure_dense_crossover(trials=1, dispatch=lambda: None) == mod.CROSSOVER_FLOOR

    def test_dead_slow_link_clamps_to_ceiling(self, side):
        mod = SIDES[side]
        got = mod.measure_dense_crossover(trials=1, dispatch=lambda: time.sleep(0.6), host_seconds_per_pod=1e-4)
        assert got == mod.CROSSOVER_CEILING

    def test_warmup_excluded_from_measurement(self, side):
        mod = SIDES[side]
        calls = {"n": 0}

        def dispatch():
            calls["n"] += 1
            time.sleep(0.3 if calls["n"] == 1 else 0.01)

        measured = mod.measure_dense_crossover(trials=2, dispatch=dispatch)
        assert calls["n"] == 3
        assert measured < 0.05 / mod.HOST_SECONDS_PER_POD, "the warm-up call leaked into the measurement"


def _broken():
    raise RuntimeError("no device")


def test_measurement_failure_reference_falls_back_to_default():
    assert ref_dense.measure_dense_crossover(dispatch=_broken) == ref_dense.MIN_BATCH_DEFAULT


def test_measurement_failure_port_raises():
    with pytest.raises(RuntimeError, match="no device"):
        dense.measure_dense_crossover(dispatch=_broken)


def test_port_default_dispatch_on_the_cpu():
    """The probe is K1's wrapper at the reference's probe shape; on the CPU
    it runs the plain version, well under a floor's worth of host time."""
    probe = dense.crossover_probe(device="cpu")
    out = probe()
    assert out.shape == (3, 8) and out.dtype.name == "int32"
    assert (out[2] == 1).all(), "every probe bucket fits a type"
    assert dense.measure_dense_crossover(trials=1, device="cpu", host_seconds_per_pod=10.0) == dense.CROSSOVER_FLOOR


def test_port_default_dispatch_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dense.measure_dense_crossover()
