"""The port's warm-fill admission surface held against the JAX package.

The same seeded numpy inputs (tests/test_warm_fill_vectorized.py's
_random_surface generator) go through the reference's jnp path, its Pallas
kernel (interpret mode on the CPU, as the JAX package's own tests run it)
and the port's plain torch version on the CPU (through the kernel wrapper,
which takes the plain version for CPU tensors). The counts must be equal
exactly, and the port's surface must stay an upper bound on the exact f64
oracle, whose port copy must equal the reference's.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against this same plain version bit for bit. Its launch geometry (node
tiles by size-class chunks) is emulated here: every (s, v) is written
exactly once, with the value the plain version computes.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from karpenter_tpu.ops.warmfill import warm_fill_counts as ref_warm_fill_counts  # noqa: E402
from karpenter_tpu.ops.warmfill import warm_fill_counts_np as ref_warm_fill_counts_np  # noqa: E402
from karpenter_tpu.ops.warmfill import warm_fill_counts_pallas  # noqa: E402
from karpenter_tpu_torch import testing  # noqa: E402
from karpenter_tpu_torch.ops import warmfill  # noqa: E402
from karpenter_tpu_torch.ops.warmfill import warm_fill_counts, warm_fill_counts_device, warm_fill_counts_np  # noqa: E402

# the last two: S not a multiple of the kernel's size-class chunk, V not a
# multiple of its node tile, S in the hundreds
SHAPES = [(1, 1, 2), (5, 17, 3), (8, 128, 3), (32, 200, 4), (64, 512, 3), (7, 300, 8), (37, 300, 8), (300, 129, 3)]
SEEDS = range(6)
_CU_SOURCE = Path(warmfill.SOURCE).read_text()
TILE = int(re.search(r"constexpr int kTile = (\d+);", _CU_SOURCE).group(1))
MAX_CHUNK = int(re.search(r"constexpr int kMaxChunk = (\d+);", _CU_SOURCE).group(1))


def _port(sizes32, head32):
    return warm_fill_counts_device(torch.from_numpy(sizes32), torch.from_numpy(head32)).numpy()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jnp_and_pallas(seed, shape):
    S, V, R = shape
    rng = np.random.default_rng(seed * 101 + S)
    sizes, head = testing.warm_fill_surface(rng, S, V, R)
    sizes32, head32 = sizes.astype(np.float32), head.astype(np.float32)

    got = _port(sizes32, head32)
    assert got.dtype == np.int32 and got.shape == (S, V)
    np.testing.assert_array_equal(got, np.asarray(ref_warm_fill_counts(jnp.asarray(sizes32), jnp.asarray(head32))))
    np.testing.assert_array_equal(got, warm_fill_counts_pallas(sizes32, head32))

    # the upper-bound contract against the exact f64 closed form; both
    # saturate counts no positive resource bounds (exact at int32 max, the
    # surface at 2^30), so compare under the common ceiling
    exact = warm_fill_counts_np(sizes, head)
    np.testing.assert_array_equal(exact, ref_warm_fill_counts_np(sizes, head))
    assert (got >= np.minimum(exact, 1 << 30)).all(), "the surface under-counts the exact closed form"


def test_integer_boundaries_round_up():
    """Headroom that holds an exact multiple of the size: the slack keeps
    the f32 count at (or above) the exact f64 count, never one below."""
    sizes = np.array([[0.1, 0.25], [0.5, 0.0], [1.5, 3.0]], np.float64)
    head = np.array([[1.0, 2.5], [3.0, 6.0], [0.3, 0.75], [0.0, 0.0], [-1e-9, 5.0]], np.float64)
    sizes32, head32 = sizes.astype(np.float32), head.astype(np.float32)
    got = _port(sizes32, head32)
    np.testing.assert_array_equal(got, np.asarray(ref_warm_fill_counts(jnp.asarray(sizes32), jnp.asarray(head32))))
    assert (got >= np.minimum(warm_fill_counts_np(sizes, head), 1 << 30)).all()
    assert (got[:, 4] == 0).all()  # negative headroom on any axis takes nothing


@pytest.mark.parametrize("shape", [(0, 5, 3), (4, 0, 3), (0, 0, 2)])
def test_empty_surfaces_need_no_launch(shape):
    S, V, R = shape
    before = warmfill.LAUNCHES
    got = warm_fill_counts_device(torch.zeros((S, R)), torch.zeros((V, R)))
    assert tuple(got.shape) == (S, V) and got.dtype == torch.int32
    assert warmfill.LAUNCHES == before


def test_cpu_tensors_take_the_plain_version_without_counting_a_launch():
    rng = np.random.default_rng(3)
    sizes, head = testing.warm_fill_surface(rng, 9, 40, 3)
    before = warmfill.LAUNCHES
    _port(sizes.astype(np.float32), head.astype(np.float32))
    assert warmfill.LAUNCHES == before


def test_non_cuda_device_tensors_raise():
    with pytest.raises(ValueError, match="want one CUDA device"):
        warm_fill_counts_device(torch.zeros((3, 2), device="meta"), torch.zeros((5, 2), device="meta"))


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="want one CUDA device"):
        warm_fill_counts_device(torch.zeros((3, 2)), torch.zeros((5, 2), device="meta"))


def _emulate_kernel(sizes32, head32, tile, chunk):
    """The kernel's grid, block by block, in numpy f32: each thread of a
    block holds its node's head row and the chunk's size rows in registers,
    computes base_ok and slack_head once and writes its column of the chunk.
    Returns the counts and how often each cell was written."""
    S, R = sizes32.shape
    V = head32.shape[0]
    f = np.float32
    slack, big = f(4e-6), f(2**30)
    one_plus, one_minus = f(1) + slack, f(1) - slack
    out = np.zeros((S, V), np.int64)
    writes = np.zeros((S, V), np.int64)
    for by in range(-(-S // chunk)):
        s0 = by * chunk
        n = min(chunk, S - s0)
        rows = sizes32[s0 : s0 + n]
        positive = rows > 0
        safe = np.where(positive, rows, f(1)) * one_minus
        for bx in range(-(-V // tile)):
            v = np.arange(bx * tile, min((bx + 1) * tile, V))
            h = head32[v]
            base_ok = (h >= f(-1e-12)).all(axis=1)
            slack_head = h * one_plus + slack
            for i in range(n):
                with np.errstate(divide="ignore"):
                    ratio = np.where(positive[i], slack_head / safe[i], big)
                count = np.minimum(np.maximum(np.floor(np.minimum(big, ratio.min(axis=1))), f(0)), big)
                out[s0 + i, v] = np.where(base_ok, count, 0)
                writes[s0 + i, v] += 1
    return out, writes


# the default tile with each chunk the default may choose, and chip_sweep.py's extremes
@pytest.mark.parametrize("geometry", [(TILE, 1), (TILE, 2), (TILE, 4), (32, 1), (512, MAX_CHUNK)])
@pytest.mark.parametrize("shape", [(1, 1, 2), (4, 128, 3), (5, 129, 8), (37, 300, 8), (300, 129, 3), (30, 2400, 8)])
def test_kernel_geometry_writes_every_cell_once_with_the_plain_value(shape, geometry):
    S, V, R = shape
    sizes, head = testing.warm_fill_surface(np.random.default_rng(S * 7 + V), S, V, R)
    sizes32, head32 = sizes.astype(np.float32), head.astype(np.float32)
    got, writes = _emulate_kernel(sizes32, head32, *geometry)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, warm_fill_counts(torch.from_numpy(sizes32), torch.from_numpy(head32)).numpy())


def test_the_round_trip_surface_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        warmfill.AdmissionSurface("cpu")
