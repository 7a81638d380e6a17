"""Rebase of the resident view surface: delta application in PyTorch.

The incremental engine (solver/incremental.py) keeps the warm-view headroom
matrix `head0` resident on the device across provision passes, as an f32
`[Vp, R]` buffer. Between passes the cluster shifts under it: nodes appear
and vanish (rows come and go) and pods bind and unbind (surviving rows
change values). `rebase_view_state` moves the prior pass's buffer into the
current pass's layout:

    out[v] = rows[j]            if v is dirty (idx[j] == v)
    out[v] = buf[perm[v]]       if v survived (perm[v] is its old row)
    out[v] = -1.0               if v is new-but-clean padding (perm[v] < 0)

The JAX package (karpenter_tpu/ops/rebase.py) writes this as one jitted
program whose input buffer is donated, so XLA reuses its storage. A gather
cannot run in place over its own input, so here the engine owns two
resident buffers: the rebase gathers the survivors from the live buffer
into the spare (`out`), scatters the dirty rows into it, and the engine
swaps the two. The operands move per pass; the buffers never do.

The view axis keeps the JAX package's pad to the lane multiple (128): the
resident buffers are that size, and outgrowing them is the engine's 'grow'
pass. The JAX package also pads the dirty axis on a pow2 ladder and drops
pad slots in the scatter, so its jitted program never retraces; eager
PyTorch has no trace to reuse, so here the rebase takes the real dirty rows
only. It is a torch program, not a hand kernel: the TPU side is an XLA
program too.

f32 only: this is the surface the warm-fill kernel (ops/warmfill.py)
consumes, whose upper-bound slack already absorbs f32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

_LANE = 128


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_views(n: int) -> int:
    """View-axis pad: lane multiple, minimum one lane."""
    return _ceil_to(max(n, 1), _LANE)


def rebase_view_state(buf: torch.Tensor, perm: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Gather by perm + scatter of the dirty rows, written into `out`.

    buf:  [Vp, R] f32  prior resident surface (read only)
    perm: [Vp]    i64  old row index per new row, -1 = no prior row
    rows: [D, R]  f32  recomputed values for the dirty rows
    idx:  [D]     i64  destination row per dirty entry, each < Vp
    out:  [Vp, R] f32  the spare resident buffer, not `buf`; returned."""
    if out.data_ptr() == buf.data_ptr():
        raise ValueError("rebase_view_state gathers from buf: out must be another buffer")
    torch.index_select(buf, 0, perm.clamp(min=0), out=out)
    out.masked_fill_((perm < 0).unsqueeze(1), -1.0)
    return out.index_copy_(0, idx, rows)


def gather_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sampled-row readback for the residency auditor: the `idx` rows of the
    resident buffer in one gather. `buf` is only read."""
    return buf.index_select(0, idx)


def rebase_view_state_np(buf: np.ndarray, perm: np.ndarray, rows: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Exact host reference for the parity tests and chip_smoke.py. As in
    the JAX package, idx slots at or past the buffer's rows are dropped."""
    out = np.where((perm >= 0)[:, None], buf[np.clip(perm, 0, None)], np.float32(-1.0))
    keep = idx < out.shape[0]
    out[idx[keep]] = rows[keep]
    return out.astype(np.float32)
