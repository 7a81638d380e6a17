"""Cluster delta grammar: the epoch/journal feed for the incremental engine.

The dense pipeline's steady-state cost through round 5 was dominated by
re-encoding the ENTIRE cluster every provision pass — `encode_warm_views`
walks every existing view even when the pass only bound three pods.  The
incremental engine (solver/incremental.py) keeps the prior pass's encoding
resident and rebases only the rows that changed; this module is the feed
that tells it WHICH rows those are.

Grammar.  Every cluster mutation collapses to one of four delta kinds
against the view axis (a view == one existing node's schedulable surface):

  NODE_ADDED    a node appeared (launched, or first seen by the informer)
  NODE_REMOVED  a node vanished (terminated, deleted, cordoned away)
  POD_BOUND     a pod landed on a node → that node's residual headroom shrank
  POD_REMOVED   a pod left a node → headroom grew (includes rebinds: the old
                node gets POD_REMOVED, the new one POD_BOUND)

All four are recorded against a NODE name — the engine's unit of dirtiness
is the view row, so a pod event just dirties its node.  Catalog/provisioner
version bumps are NOT journal events: the engine compares `catalog_key`
directly each pass and a mismatch forces a full re-encode (attributed as
`invalidate.catalog`), because a catalog change can re-shape every row.

Epochs and gaps.  The journal is a bounded ring keyed by a monotonically
increasing epoch.  `dirty_since(epoch)` returns the set of node names
touched after `epoch`, or None when the window has been overwritten (the
reader fell too far behind) — None means "I cannot enumerate your delta",
and the engine must full re-encode (attributed as `invalidate.gap`).
`mark_gap()` forces the same outcome explicitly; the informer's resync path
uses it because a re-list may reflect mutations the watch never delivered.

Locking.  The journal has its own leaf lock and takes no others, so it is
safe to call `record()` while holding the cluster state lock (cluster.py's
mutators do exactly that).  Readers (`dirty_since`) only copy.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import FrozenSet, List, Optional, Tuple

NODE_ADDED = "node-added"
NODE_REMOVED = "node-removed"
POD_BOUND = "pod-bound"
POD_REMOVED = "pod-removed"

DELTA_KINDS = (NODE_ADDED, NODE_REMOVED, POD_BOUND, POD_REMOVED)

# seeded corruption seam (solver/faults.py): when armed, record() consults
# this hook and — if it answers True — SUPPRESSES the delta (no epoch bump,
# no ring entry), modeling a missed journal event for the residency
# auditor's detection proofs (solver/audit.py). FAULTS.install arms it for a
# plan with suppress-delta specs and FAULTS.clear disarms it. This module is
# an import leaf, so the injector reaches in through a module global instead
# of an import; None (the production state) keeps record() at one global read.
_corrupt_consult = None


def set_corrupt_seam(consult) -> None:
    """Arm (callable `(node, kind) -> bool`, True suppresses the record) or
    disarm (None) the journal's corruption seam. The hook sees the delta
    before deciding so injectors can target a kind family — suppressing a
    pod-level record is the detectable missed-delta shape; node add/remove
    suppressions are invisible (the engine diffs the row set directly)."""
    global _corrupt_consult
    _corrupt_consult = consult

# default ring capacity: sized for a large cluster's worst-case burst
# between two provision passes (a reclaim wave touching every node once is
# ~cluster-size events; 4096 covers the 16k-view bench's per-pass churn
# with a wide margin while keeping the ring a few hundred KB)
DEFAULT_CAPACITY = 4096


@dataclass(frozen=True)
class Delta:
    """One journal entry: at `epoch`, node `node` changed per `kind`."""

    epoch: int
    node: str
    kind: str


class DeltaJournal:
    """Bounded ring of cluster deltas with monotone epochs.

    Writers call `record(node, kind)` under any outer lock they like (the
    journal lock is a leaf).  Readers call `current_epoch()` to checkpoint
    and later `dirty_since(checkpoint)` to enumerate what changed — or
    learn (None) that the window is gone and they must resync from scratch.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError("journal capacity must be >= 1")
        self._lock = threading.Lock()
        self._capacity = int(capacity)
        self._ring: List[Delta] = []
        self._head = 0  # next write slot when the ring is full
        self._epoch = 0
        # epoch of the oldest entry still in the ring; entries at or below
        # this bound may have been overwritten → readers behind it get None
        self._floor = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    def current_epoch(self) -> int:
        """The epoch of the newest recorded delta (0 when empty)."""
        with self._lock:
            return self._epoch

    def record(self, node: str, kind: str) -> int:
        """Append one delta; returns its epoch. Thread-safe, leaf-locked."""
        if kind not in DELTA_KINDS:
            raise ValueError(f"unknown delta kind: {kind!r}")
        consult = _corrupt_consult
        if consult is not None and consult(node, kind):
            # seeded suppression: the mutation happened but the journal
            # never hears of it — the missed-delta shape the auditor hunts.
            # The current epoch is returned so callers see a valid handle.
            with self._lock:
                return self._epoch
        with self._lock:
            self._epoch += 1
            entry = Delta(self._epoch, node, kind)
            if len(self._ring) < self._capacity:
                self._ring.append(entry)
            else:
                evicted = self._ring[self._head]
                self._floor = evicted.epoch
                self._ring[self._head] = entry
                self._head = (self._head + 1) % self._capacity
            return self._epoch

    def mark_gap(self) -> None:
        """Invalidate every outstanding checkpoint: readers at any epoch
        before NOW get None from dirty_since. The informer resync path calls
        this because a re-list may fold in mutations the watch dropped."""
        with self._lock:
            self._epoch += 1
            self._floor = self._epoch
            self._ring.clear()
            self._head = 0

    def dirty_since(self, epoch: int) -> Optional[FrozenSet[str]]:
        """Node names touched strictly after `epoch`, or None when the ring
        no longer covers that span (overwritten, or a declared gap)."""
        with self._lock:
            if epoch < self._floor:
                return None
            if epoch >= self._epoch:
                return frozenset()
            return frozenset(d.node for d in self._ring if d.epoch > epoch)

    def deltas_since(self, epoch: int) -> Optional[Tuple[Delta, ...]]:
        """The raw entries after `epoch` in epoch order, or None on a gap —
        for tests and attribution, not the hot path."""
        with self._lock:
            if epoch < self._floor:
                return None
            out = sorted((d for d in self._ring if d.epoch > epoch), key=lambda d: d.epoch)
            return tuple(out)
