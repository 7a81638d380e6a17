"""K1's keyed mode (ops/bucket_cost.py:bucket_cost_keyed) on the CPU.

The keyed launch returns K1's packed [3, B] and each bucket's winning key,
which a mesh combines across its type blocks (parallel/sharded.py). On the
CPU its wrapper takes the plain version, ops/feasibility.py:
bucket_type_cost_keyed. Held here, on tests/test_torch_bucket_cost.py's
shapes and seeds:

- its packed result equals the unkeyed plain version's, exactly;
- its key equals the minimum over types of the key computed in numpy f32 in
  the JAX package's order of operations, exactly (every step is one
  correctly rounded f32 operation on both sides), and is the key at t*;
- the key is inf exactly on the rows with no feasible type;
- the wrapper counts no launch for CPU tensors and refuses other devices.

The CUDA kernel runs only on the card: chip_smoke.py's solver_mesh phase
holds both of its outputs against this plain version bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.ops import bucket_cost
from karpenter_tpu_torch.ops.bucket_cost import bucket_cost_keyed
from karpenter_tpu_torch.ops.feasibility import bucket_type_cost_keyed, bucket_type_cost_packed
from tests.test_torch_bucket_cost import SHAPES, _cells, _problem


def _tensors(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_keyed_plain_version_matches_the_unkeyed_one_and_the_formula(seed, shape):
    arrays = _problem(seed, shape)
    packed, key = bucket_type_cost_keyed(*_tensors(arrays))
    np.testing.assert_array_equal(packed.numpy(), bucket_type_cost_packed(*_tensors(arrays)).numpy())
    assert key.dtype == torch.float32 and key.shape == (shape[0],)
    cells = _cells(*arrays)[0]
    np.testing.assert_array_equal(key.numpy(), cells.min(axis=1))
    tstar, feasible = packed[0].numpy(), packed[2].numpy().astype(bool)
    np.testing.assert_array_equal(key.numpy(), cells[np.arange(shape[0]), tstar])
    np.testing.assert_array_equal(np.isinf(key.numpy()), ~feasible)


def test_keyed_wrapper_takes_the_plain_version_on_the_cpu_without_counting():
    arrays = _problem(3, (16, 100, 4))
    before = bucket_cost.KEYED_LAUNCHES, bucket_cost.LAUNCHES
    packed, key = bucket_cost_keyed(*_tensors(arrays))
    want_packed, want_key = bucket_type_cost_keyed(*_tensors(arrays))
    assert torch.equal(packed, want_packed) and torch.equal(key, want_key)
    assert (bucket_cost.KEYED_LAUNCHES, bucket_cost.LAUNCHES) == before


def test_keyed_wrapper_refuses_non_cuda_devices():
    stats = torch.zeros((2, 4, 2), device="meta")
    caps = torch.zeros((5, 2), device="meta")
    prices = torch.zeros((5,), device="meta")
    allowed = torch.zeros((4, 5), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="want one CUDA device"):
        bucket_cost_keyed(stats, caps, prices, allowed)
