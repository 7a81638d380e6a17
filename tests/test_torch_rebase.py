"""The port's rebase (karpenter_tpu_torch/ops/rebase.py) held against the
JAX package's jitted programs on the CPU and the numpy oracle.

Seeded shapes (row pads 128, 384 and 2432, up to 256 dirty rows, perm with
-1 slots) go through the port's `rebase_view_state` and `gather_rows` and
through karpenter_tpu's jitted `rebase_view_state` (its buffer donated, so
it gets a fresh copy) and `gather_rows`; every output must be byte-equal,
and equal to `rebase_view_state_np`. The JAX package is given its own
padded operands (`pack_rebase`: a pow2 dirty ladder whose pad slots its
scatter drops); the port is given the real dirty rows only, with perm
padded to the buffer's rows. The rebase writes into the buffer it is given
and allocates no other.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import rebase as ref_rebase
from karpenter_tpu_torch.ops.rebase import gather_rows, pad_views, rebase_view_state, rebase_view_state_np

# (views before, views after, dirty rows, R)
SHAPES = [(3, 5, 2, 2), (120, 128, 8, 8), (300, 310, 40, 8), (2400, 2410, 200, 8), (380, 360, 100, 3), (10, 2432, 0, 4)]


def _case(seed, v_old, v_new, d, R):
    """A buffer with -1.0 pad rows, the logical perm, the sorted dirty rows
    and their values."""
    rng = np.random.default_rng(900 + seed)
    vp = pad_views(max(v_old, v_new))
    buf = np.full((vp, R), -1.0, np.float32)
    buf[:v_old] = (rng.standard_normal((v_old, R)) * 16).astype(np.float32)
    perm = np.where(rng.random(v_new) < 0.8, rng.integers(0, v_old, v_new), -1).astype(np.int32)
    dirty = np.sort(rng.choice(v_new, size=min(d, v_new), replace=False)).astype(np.int32)
    rows = (rng.standard_normal((len(dirty), R)) * 16).astype(np.float32)
    return buf, perm, dirty, rows


def _port_rebase(buf, perm, dirty, rows, out=None):
    """The port's operands as the engine builds them: perm padded with -1 to
    the buffer's rows, the real dirty indices, int64."""
    vp = buf.shape[0]
    perm_p = np.full(vp, -1, np.int64)
    perm_p[: perm.shape[0]] = perm
    out = torch.empty((vp, buf.shape[1]), dtype=torch.float32) if out is None else out
    got = rebase_view_state(torch.from_numpy(buf), torch.from_numpy(perm_p), torch.from_numpy(rows), torch.from_numpy(dirty.astype(np.int64)), out=out)
    assert got.data_ptr() == out.data_ptr()
    return got.numpy()


def test_pad_ladders_equal_the_reference():
    for n in [0, 1, 7, 8, 9, 100, 127, 128, 129, 300, 2400, 2432, 5000]:
        assert pad_views(n) == ref_rebase.pad_views(n)
    assert pad_views(300) == 384 and pad_views(2400) == 2432


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rebase_equals_the_reference_and_the_oracle(shape, seed):
    import jax.numpy as jnp

    buf, perm, dirty, rows = _case(seed, *shape)
    perm_p, rows_p, idx_p = ref_rebase.pack_rebase(perm, rows, dirty, buf.shape[0])
    want = rebase_view_state_np(buf, perm_p, rows_p, idx_p)
    assert np.array_equal(want, ref_rebase.rebase_view_state_np(buf, perm_p, rows_p, idx_p))
    ref = np.asarray(ref_rebase.rebase_view_state(jnp.asarray(buf.copy()), jnp.asarray(perm_p), jnp.asarray(rows_p), jnp.asarray(idx_p)))
    got = _port_rebase(buf, perm, dirty, rows)
    assert got.dtype == np.float32 and got.shape == buf.shape
    assert np.array_equal(got, ref) and np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_gather_rows_equals_the_reference(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(950 + seed)
    for vp, n in ((128, 5), (384, 8), (2432, 300)):
        buf = rng.standard_normal((vp, 8)).astype(np.float32)
        idx = np.sort(rng.choice(vp - 4, size=n, replace=False)).astype(np.int32)
        # the JAX package gathers a padded index and slices; the port
        # gathers the sampled rows alone
        idx_p = ref_rebase.pack_gather(idx, pad=vp)
        ref = np.asarray(ref_rebase.gather_rows(jnp.asarray(buf), jnp.asarray(idx_p)))[:n]
        got = gather_rows(torch.from_numpy(buf), torch.from_numpy(idx.astype(np.int64))).numpy()
        assert np.array_equal(got, ref) and np.array_equal(got, buf[idx])


def test_the_reference_pad_slots_change_nothing_the_port_writes():
    """The JAX package's pad slots (at and past the buffer, anywhere in
    idx, or a dirty set of pads only) are dropped by its scatter and the
    oracle, never wrapped onto a real row: the port, which receives only
    the real rows, writes the same buffer."""
    vp = pad_views(4)
    buf = np.zeros((vp, 2), np.float32)
    perm = np.arange(vp, dtype=np.int32)
    dirty = np.asarray([1], np.int32)
    rows = np.full((1, 2), 7.0, np.float32)
    perm_p, rows_p, idx_p = ref_rebase.pack_rebase(perm, rows, dirty, vp)
    assert np.all(idx_p[1:] == vp), "the reference's pad slots target the dropped index"
    got = _port_rebase(buf, perm, dirty, rows)
    assert np.array_equal(got, rebase_view_state_np(buf, perm_p, rows_p, idx_p))
    assert np.all(got[1] == 7.0)
    assert np.all(got[2:] == 0.0) and np.all(got[0] == 0.0), "no pad row leaked into a real slot"
    idx_mixed = np.asarray([vp, 3, vp + 5, vp, 1], np.int32)
    rows_mixed = np.asarray([[-1, -1], [3, 3], [-1, -1], [-1, -1], [1, 1]], np.float32)
    real = idx_mixed < vp
    got = _port_rebase(buf, perm, idx_mixed[real], rows_mixed[real])
    assert np.array_equal(got, rebase_view_state_np(buf, perm_p, rows_mixed, idx_mixed))
    got = _port_rebase(buf, perm, np.zeros(0, np.int32), np.zeros((0, 2), np.float32))
    assert np.array_equal(got, rebase_view_state_np(buf, perm_p, np.full((8, 2), -1.0, np.float32), np.full(8, vp, np.int32)))
    assert np.array_equal(got, buf)


def test_the_rebase_allocates_no_buffer():
    buf, perm, dirty, rows = _case(0, 300, 310, 40, 8)
    vp = buf.shape[0]
    perm_p = np.full(vp, -1, np.int64)
    perm_p[: perm.shape[0]] = perm
    operands = torch.from_numpy(perm_p), torch.from_numpy(rows), torch.from_numpy(dirty.astype(np.int64))
    live = torch.from_numpy(buf)
    spare = torch.empty_like(live)
    ptrs = {live.data_ptr(), spare.data_ptr()}
    for _ in range(3):
        out = rebase_view_state(live, *operands, out=spare)
        assert out is spare and {out.data_ptr(), live.data_ptr()} == ptrs
        live, spare = spare, live
    with pytest.raises(ValueError, match="another buffer"):
        rebase_view_state(live, *operands, out=live)
