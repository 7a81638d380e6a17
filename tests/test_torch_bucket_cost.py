"""The port's bucket -> instance-type cost choice held against the JAX package.

The same seeded numpy inputs (tests/test_pallas.py's generator) go through
the reference's fused Pallas kernel (interpret mode on the CPU, as the
JAX package's own tests run it), the reference's jnp version, and the port's
plain torch version on the CPU (through the kernel wrapper, which takes the
plain version for CPU tensors). t*/feasible must agree exactly and bins
wherever feasible. The one allowance: where XLA's CPU code rounds a key by
one ulp differently, a different t* is accepted only if the two types' keys
lie within one ulp of each other (asserted per row, below).

The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against this same plain version bit for bit. Its reduction (per-thread
strided bests, a shuffle tree per warp, the warps' bests merged by one
warp) is emulated here in numpy for several block sizes and held against
the plain version's first-index argmin.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from karpenter_tpu.ops.feasibility import availability_counts as ref_availability_counts  # noqa: E402
from karpenter_tpu.ops.feasibility import bucket_type_cost_packed as ref_packed  # noqa: E402
from karpenter_tpu.ops.pallas_kernels import bucket_type_cost_pallas  # noqa: E402
from karpenter_tpu_torch import testing  # noqa: E402
from karpenter_tpu_torch.ops import bucket_cost  # noqa: E402
from karpenter_tpu_torch.ops.bucket_cost import bucket_cost_packed, load_catalog  # noqa: E402
from karpenter_tpu_torch.ops.feasibility import availability_counts  # noqa: E402

# (B, T, R) of tests/test_pallas.py, then the redesigned kernel's edges: T
# past one block and not a multiple of it, a tie-heavy catalog (price in
# proportion to capacity), buckets with no feasible type, and the headline's
# resource pattern (most sums zero, a path of its own in the kernel)
SHAPES = [
    (1, 1, 1),
    (3, 7, 2),
    (16, 100, 4),
    (53, 500, 8),
    (64, 512, 8),
    (8, 1025, 8),
    (16, 600, 4, "ties"),
    (12, 200, 3, "infeasible"),
    (16, 300, 8, "unrequested"),
]
_CU_SOURCE = Path(bucket_cost.SOURCE).read_text()
MAX_THREADS = int(re.search(r"constexpr int kMaxThreads = (\d+);", _CU_SOURCE).group(1))
MAX_TYPES_PER_THREAD = int(re.search(r"constexpr int kMaxTypesPerThread = (\d+);", _CU_SOURCE).group(1))
INT_MAX = 2**31 - 1


def _problem(seed, shape):
    B, T, R, *kind = shape
    return testing.bucket_cost_problem(np.random.default_rng(seed * 1000 + B), B, T, R, *kind)


def _cells(stats, caps, prices, allowed):
    """(key, bins, ok) [B, T] in numpy f32, in the reference's order of operations."""
    eps = np.float32(1e-9)
    sum_req, max_req = stats[0], stats[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = sum_req[:, None, :] / np.maximum(caps, eps)[None, :, :]
    impossible = (caps[None, :, :] <= eps) & (sum_req[:, None, :] > eps)
    frac = np.max(np.where(impossible, np.inf, ratio), axis=-1)
    bins = np.ceil(np.maximum(frac, eps))
    fits = np.all(max_req[:, None, :] <= caps[None, :, :] + np.float32(1e-6), axis=-1)
    ok = allowed & fits & np.isfinite(frac)
    key = frac * prices[None, :] + bins * np.float32(1e-4) + prices[None, :] * np.float32(1e-7)
    return np.where(ok, key, np.inf).astype(np.float32), bins, ok


def _port(stats, caps, prices, allowed):
    return bucket_cost_packed(
        torch.from_numpy(stats), torch.from_numpy(caps), torch.from_numpy(prices), torch.from_numpy(allowed)
    ).numpy()


def _assert_agrees(got, want, stats, caps, prices, allowed, what):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[2], want[2], err_msg=f"feasible mismatch vs {what}")
    feasible = want[2].astype(bool)
    differ = np.flatnonzero(feasible & (got[0] != want[0]))
    if differ.size:
        # sub-ulp argmin ties only: the two types' keys within one ulp
        key = _cells(stats, caps, prices, allowed)[0]
        for b in differ:
            k_got, k_want = key[b, got[0][b]], key[b, want[0][b]]
            assert abs(k_got - k_want) <= np.spacing(max(k_got, k_want)), f"tstar mismatch vs {what} at bucket {b}"
    same = feasible & (got[0] == want[0])
    np.testing.assert_array_equal(got[1][same], want[1][same], err_msg=f"bins mismatch vs {what}")


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_and_jnp(seed, shape):
    B = shape[0]
    stats, caps, prices, allowed = _problem(seed, shape)

    got = _port(stats, caps, prices, allowed)
    assert got.dtype == np.int32 and got.shape == (3, B)
    pallas = np.asarray(bucket_type_cost_pallas(stats, caps, prices, allowed))
    jnp_path = np.asarray(ref_packed(jnp.asarray(stats), jnp.asarray(caps), jnp.asarray(prices), jnp.asarray(allowed)))
    _assert_agrees(got, pallas, stats, caps, prices, allowed, "pallas")
    _assert_agrees(got, jnp_path, stats, caps, prices, allowed, "jnp")
    # infeasible rows: bins 0, as the Pallas kernel reports them, and t* 0,
    # the first index of an all-inf row
    assert (got[1][got[2] == 0] == 0).all()
    assert (got[0][got[2] == 0] == 0).all()
    if len(shape) > 3 and shape[3] == "infeasible":
        assert (got[2] == 0).any()


def _better(a, b):
    """The kernel's lexicographic (key, t) order: a before b."""
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


def _warp_merge(lanes):
    """__shfl_down_sync tree over 32 lanes' (key, t, bins): lane i takes
    lane i + offset's value (its own past the warp's end) when it is better."""
    lanes = list(lanes)
    offset = 16
    while offset:
        lanes = [
            lanes[i + offset] if i + offset < 32 and _better(lanes[i + offset], lanes[i]) else lanes[i]
            for i in range(32)
        ]
        offset //= 2
    return lanes[0]


def _emulate_kernel_row(key, bins, ok, block):
    """One bucket as the kernel reduces it with `block` threads: each thread
    folds its strided types (the ones held in registers, then the tail read
    from memory) into its best, each warp merges by shuffles, and warp 0
    merges the warps' bests from shared memory. Returns (t*, bins, any)."""
    T = key.shape[0]
    need = -(-T // block)
    per_thread = 1 if need <= 1 else 2 if need <= 2 else MAX_TYPES_PER_THREAD
    sentinel = (np.inf, INT_MAX, 0)
    threads = []
    for tid in range(block):
        best = sentinel
        owned = [tid + j * block for j in range(per_thread)] + list(range(tid + per_thread * block, T, block))
        for t in owned:
            if t < T:
                cell = (key[t], t, int(bins[t]) if ok[t] else 0)
                if _better(cell, best):
                    best = cell
        threads.append(best)
    warps = [_warp_merge(threads[w : w + 32]) for w in range(0, block, 32)]
    final = _warp_merge(warps + [sentinel] * (32 - len(warps)))
    return (0 if final[1] == INT_MAX else final[1]), final[2], int(ok.any())


@pytest.mark.parametrize("block", [32, 64, 96, 160, 256, MAX_THREADS])
@pytest.mark.parametrize("kind", ["ties", "infeasible"])
def test_block_reduction_is_the_first_index_argmin(kind, block):
    B, T, R = 8, 700, 4
    stats, caps, prices, allowed = testing.bucket_cost_problem(np.random.default_rng(block), B, T, R, kind)
    allowed[0] = False  # an all-inf row
    key, bins, ok = _cells(stats, caps, prices, allowed)
    want = _port(stats, caps, prices, allowed)
    got = np.array([_emulate_kernel_row(key[b], bins[b], ok[b], block) for b in range(B)], np.int64).T
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.argmin(key, axis=1))
    assert got[0][0] == 0 and got[2][0] == 0
    if kind == "ties":
        # the catalog does tie: some row's minimum key is held by several types
        assert any((key[b] == key[b].min()).sum() > 1 for b in range(B) if ok[b].any())


def test_price_ties_break_to_first_index():
    B, T, R = 4, 8, 2
    stats = np.stack([np.full((B, R), 2.0, np.float32), np.full((B, R), 1.0, np.float32)])
    caps = np.full((T, R), 4.0, np.float32)
    prices = np.full((T,), 1.0, np.float32)
    allowed = np.ones((B, T), bool)
    got = _port(stats, caps, prices, allowed)
    np.testing.assert_array_equal(got, np.asarray(bucket_type_cost_pallas(stats, caps, prices, allowed)))
    assert (got[0] == 0).all()


def test_infeasible_bucket_reported():
    B, T, R = 3, 4, 2
    sum_req = np.array([[100.0, 100.0], [1.0, 1.0], [1.0, 1.0]], np.float32)
    max_req = sum_req.copy()  # bucket 0's pod is too big for any type
    caps = np.full((T, R), 4.0, np.float32)
    prices = np.ones((T,), np.float32)
    allowed = np.ones((B, T), bool)
    allowed[2] = False  # bucket 2 may use no type at all
    stats = np.stack([sum_req, max_req])
    got = _port(stats, caps, prices, allowed)
    np.testing.assert_array_equal(got, np.asarray(bucket_type_cost_pallas(stats, caps, prices, allowed)))
    np.testing.assert_array_equal(got[:, 0], [0, 0, 0])
    np.testing.assert_array_equal(got[:, 1], [0, 1, 1])
    np.testing.assert_array_equal(got[:, 2], [0, 0, 0])


@pytest.mark.parametrize("seed", range(4))
def test_availability_mask_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, T, Z, C = 37, 120, 3, 2
    pair = (rng.random((B, Z * C)) > 0.5).astype(np.float32)
    cube = (rng.random((T, Z * C)) > 0.4).astype(np.float32)
    want = np.asarray(ref_availability_counts(jnp.asarray(pair), jnp.asarray(cube)))
    got = availability_counts(torch.from_numpy(pair), torch.from_numpy(cube)).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def test_load_catalog_from_reference_encoding():
    from karpenter_tpu.api.labels import LABEL_CAPACITY_TYPE, LABEL_TOPOLOGY_ZONE
    from karpenter_tpu.cloudprovider.fake import FakeCloudProvider as RefProvider
    from karpenter_tpu.cloudprovider.fake import instance_types as ref_instance_types
    from karpenter_tpu.ir.encode import encode_catalog as ref_encode_catalog
    from karpenter_tpu.ir.encode import encode_problem as ref_encode_problem
    from karpenter_tpu.scheduler import build_scheduler as ref_build_scheduler
    from karpenter_tpu_torch import testing
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.ir.encode import encode_catalog, encode_problem
    from karpenter_tpu_torch.scheduler import build_scheduler
    from tests.helpers import make_pod, make_provisioner

    def caps_eff_prices(build, provider, prov, pods, daemons, enc_catalog, enc_problem):
        s = build([prov], provider, pods, daemonset_pods=daemons)
        zones = s.topology.domains.get(LABEL_TOPOLOGY_ZONE, ())
        cts = s.topology.domains.get(LABEL_CAPACITY_TYPE, ())
        catalog = enc_catalog(s.node_templates, s.instance_types, zones, cts)
        problem = enc_problem(
            pods, s.node_templates, s.instance_types, daemon_overhead=s.daemon_overhead, zones=zones, capacity_types=cts, catalog=catalog
        )
        return np.maximum(problem.caps - problem.daemon_overhead, 0.0), problem.prices

    ref_caps, ref_prices = caps_eff_prices(
        ref_build_scheduler,
        RefProvider(ref_instance_types(50)),
        make_provisioner(),
        [make_pod(requests={"cpu": 1})],
        [make_pod(requests={"cpu": "100m", "memory": "64Mi"})],
        ref_encode_catalog,
        ref_encode_problem,
    )
    caps_t, prices_t = load_catalog(ref_caps, ref_prices, "cpu")
    assert caps_t.dtype == prices_t.dtype == torch.float32
    assert caps_t.is_contiguous() and prices_t.is_contiguous()
    np.testing.assert_array_equal(caps_t.numpy(), np.asarray(jnp.asarray(ref_caps, dtype=jnp.float32)))
    np.testing.assert_array_equal(prices_t.numpy(), np.asarray(jnp.asarray(ref_prices, dtype=jnp.float32)))
    # the port's own encoding of the same catalog is the same array
    port_caps, port_prices = caps_eff_prices(
        build_scheduler,
        FakeCloudProvider(instance_types(50)),
        testing.make_provisioner(),
        [testing.make_pod(requests={"cpu": 1})],
        [testing.make_pod(requests={"cpu": "100m", "memory": "64Mi"})],
        encode_catalog,
        encode_problem,
    )
    np.testing.assert_array_equal(port_caps, ref_caps)
    np.testing.assert_array_equal(port_prices, ref_prices)


def test_cpu_tensors_take_the_plain_version_without_counting_a_launch():
    stats, caps, prices, allowed = testing.bucket_cost_problem(np.random.default_rng(3), 8, 20, 4)
    before = bucket_cost.LAUNCHES
    _port(stats, caps, prices, allowed)
    assert bucket_cost.LAUNCHES == before


def test_non_cuda_device_tensors_raise():
    stats = torch.zeros((2, 4, 2), device="meta")
    caps = torch.zeros((5, 2), device="meta")
    prices = torch.zeros((5,), device="meta")
    allowed = torch.zeros((4, 5), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="want one CUDA device"):
        bucket_cost_packed(stats, caps, prices, allowed)
