"""Counts-based bin packing over deduplicated pod sizes.

Why not a per-pod scan on device: a lax.scan pays ~10us/step of loop overhead
on TPU, so a 10k-pod sequential pack costs ~100ms before doing any work —
sequential control flow is the one thing the hardware punishes. Instead we
exploit that bins within a pack bucket are *identical* (same chosen instance
type) and pod sizes are heavily repeated (requests come from discrete
cpu/memory menus): dedupe pods to U distinct request vectors with counts,
fill one bin greedily largest-first (exact multi-resource check), then emit
that bin pattern as many times as the remaining counts allow. Rounds are
bounded by ~U (each round exhausts at least one size class), so packing cost
is U-scale regardless of P — and the quality matches bin-by-bin greedy FFD,
the same family as the reference's algorithm (scheduler.go:189-232).

The P-scale work — feasibility masks and layout verification — stays on
device (ops/feasibility.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import native


def pack_and_assign(unique: np.ndarray, counts: np.ndarray, inverse: np.ndarray, cap: np.ndarray) -> Tuple[np.ndarray, int]:
    """Pack deduplicated sizes and expand to per-item bin ids in one call.

    Uses the native C++ core (native/) when available; the pure
    numpy path below is the always-available fallback with identical
    semantics (held together by tests/test_native.py).

    Returns (bin_of_item [P] int64 with -1 unplaced, number of bins).
    """
    result = native.pack_assign(unique, counts, inverse, cap, 0)
    if result is not None:
        bin_of_item, next_bin, _unplaced = result
        return bin_of_item, next_bin
    patterns, unplaced = pack_counts(unique, counts, cap)
    return assign_bins(inverse, patterns, unplaced, 0)


def pack_dedicated(requests: np.ndarray, cap: np.ndarray) -> Tuple[np.ndarray, int]:
    """One item per bin when it fits an empty bin; -1 otherwise."""
    result = native.pack_dedicated(requests, cap, 0)
    if result is not None:
        return result
    from ..utils.resources import tolerance

    fits = np.all(requests <= cap[None, :] + tolerance(cap)[None, :], axis=1)
    ids = np.where(fits, np.cumsum(fits) - 1, -1)
    return ids, int(fits.sum())


def dedupe_sizes(requests: np.ndarray, quantum: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group identical request vectors.

    Returns (unique [U, R] same dtype as the input, counts [U] int64,
    inverse [P] int64), with unique sorted descending by the first resource
    column, later columns as tiebreaks — FFD order. An optional
    per-resource quantum rounds requests *up* to bound U for continuous size
    distributions (feasible by construction: we only over-estimate).
    """
    reqs = requests
    if quantum is not None:
        q = np.maximum(quantum, 1e-12)
        reqs = np.ceil(requests / q) * q
    unique, inverse, counts = np.unique(reqs, axis=0, return_inverse=True, return_counts=True)
    # descending by first column, later columns as tiebreaks (FFD order)
    order = np.lexsort(tuple(-unique[:, c] for c in range(unique.shape[1] - 1, -1, -1)))
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return unique[order], counts[order], rank[inverse]


def pack_counts(unique: np.ndarray, counts: np.ndarray, cap: np.ndarray) -> Tuple[List[Tuple[np.ndarray, int]], np.ndarray]:
    """Pack `counts[u]` items of size `unique[u]` into identical bins `cap`.

    Returns (bins, unplaced):
      bins: list of (pattern [U] int64, repeat int) — `repeat` identical bins
            each holding pattern[u] items of size u.
      unplaced: [U] int64 counts of items that don't fit an empty bin.
    """
    from ..utils.resources import tolerance

    U, R = unique.shape
    tol = tolerance(cap)
    remaining = counts.astype(np.int64).copy()
    # items that can never fit (single item exceeds empty-bin capacity)
    impossible = ~np.all(unique <= cap[None, :] + tol[None, :], axis=1)
    unplaced = np.where(impossible, remaining, 0)
    remaining[impossible] = 0

    bins: List[Tuple[np.ndarray, int]] = []
    guard = 0
    while remaining.sum() > 0:
        guard += 1
        if guard > 4 * U + 64:  # safety net; should be unreachable
            unplaced += remaining
            break
        pattern = np.zeros((U,), np.int64)
        free = cap.astype(np.float64).copy()
        for u in range(U):
            if remaining[u] - pattern[u] <= 0:
                continue
            size = unique[u]
            # how many of size u fit in the remaining free capacity
            with np.errstate(divide="ignore", invalid="ignore"):
                per_r = np.where(size > 1e-9, np.floor((free + tol) / np.maximum(size, 1e-9)), np.inf)
            k = int(min(per_r.min(), remaining[u]))
            if k > 0:
                pattern[u] = k
                free -= size * k
        if pattern.sum() == 0:
            unplaced += remaining
            break
        with np.errstate(divide="ignore"):
            repeats = np.where(pattern > 0, remaining // np.maximum(pattern, 1), np.iinfo(np.int64).max)
        repeat = max(1, int(repeats.min()))
        bins.append((pattern, repeat))
        remaining -= pattern * repeat
    return bins, unplaced


def assign_bins(
    inverse: np.ndarray, bins: List[Tuple[np.ndarray, int]], unplaced: np.ndarray, first_bin_id: int
) -> Tuple[np.ndarray, int]:
    """Expand bin patterns into a per-item bin id (-1 for unplaced).

    Items of each size class are assigned to bins in class order; which item
    of a class lands in which identical bin is arbitrary (they're
    interchangeable).
    """
    U = len(unplaced)
    P = len(inverse)
    bin_of_item = np.full((P,), -1, np.int64)
    # rows per size class, in original order
    class_rows: List[List[int]] = [[] for _ in range(U)]
    for row, u in enumerate(inverse):
        class_rows[u].append(row)
    cursors = np.zeros((U,), np.int64)
    bin_id = first_bin_id
    for pattern, repeat in bins:
        for _ in range(repeat):
            for u in np.nonzero(pattern)[0]:
                take = int(pattern[u])
                rows = class_rows[u][int(cursors[u]) : int(cursors[u]) + take]
                cursors[u] += take
                for r in rows:
                    bin_of_item[r] = bin_id
            bin_id += 1
    return bin_of_item, bin_id
