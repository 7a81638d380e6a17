"""The port's DeltaJournal (karpenter_tpu_torch/ir/delta.py) held against the
JAX package's.

The six TestDeltaJournal cases of tests/test_incremental_engine.py run on
the port's journal, and one seeded record sequence (with ring eviction and a
gap) is fed to both packages' journals: every checkpoint must answer the
same `dirty_since` and `deltas_since`.
"""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_tpu.ir import delta as ref_delta
from karpenter_tpu_torch.ir import delta
from karpenter_tpu_torch.ir.delta import (
    DELTA_KINDS,
    NODE_ADDED,
    NODE_REMOVED,
    POD_BOUND,
    POD_REMOVED,
    DeltaJournal,
)


class TestDeltaJournal:
    def test_epochs_are_monotone_and_checkpointable(self):
        j = DeltaJournal()
        assert j.current_epoch() == 0
        e1 = j.record("n1", NODE_ADDED)
        e2 = j.record("n2", POD_BOUND)
        assert 0 < e1 < e2 == j.current_epoch()

    def test_dirty_since_is_strictly_after(self):
        j = DeltaJournal()
        j.record("a", NODE_ADDED)
        mark = j.current_epoch()
        j.record("b", POD_BOUND)
        j.record("c", POD_REMOVED)
        assert j.dirty_since(mark) == frozenset({"b", "c"})
        assert j.dirty_since(j.current_epoch()) == frozenset()

    def test_all_kinds_accepted_and_unknown_rejected(self):
        j = DeltaJournal()
        for kind in DELTA_KINDS:
            j.record("n", kind)
        with pytest.raises(ValueError):
            j.record("n", "node-exploded")

    def test_ring_eviction_moves_the_floor(self):
        j = DeltaJournal(capacity=4)
        j.record("a", NODE_ADDED)
        mark = j.current_epoch()
        for i in range(4):  # fill past capacity: 'a' is evicted
            j.record(f"x{i}", POD_BOUND)
        assert j.dirty_since(0) is None, "a reader from before the window must resync"
        assert j.dirty_since(mark) == frozenset({"x0", "x1", "x2", "x3"})

    def test_mark_gap_voids_every_checkpoint(self):
        j = DeltaJournal()
        j.record("a", NODE_ADDED)
        mark = j.current_epoch()
        j.mark_gap()
        assert j.dirty_since(mark) is None
        # but a checkpoint taken AFTER the gap works again
        mark = j.current_epoch()
        j.record("b", NODE_REMOVED)
        assert j.dirty_since(mark) == frozenset({"b"})

    def test_deltas_since_orders_by_epoch(self):
        j = DeltaJournal()
        j.record("a", NODE_ADDED)
        mark = j.current_epoch()
        j.record("b", POD_BOUND)
        j.record("b", POD_REMOVED)
        out = j.deltas_since(mark)
        assert [(d.node, d.kind) for d in out] == [("b", POD_BOUND), ("b", POD_REMOVED)]


def _answers(journal, epochs):
    out = []
    for e in epochs:
        deltas = journal.deltas_since(e)
        dirty = journal.dirty_since(e)
        out.append(
            (
                e,
                None if dirty is None else sorted(dirty),
                None if deltas is None else [(d.epoch, d.node, d.kind) for d in deltas],
            )
        )
    return out


@pytest.mark.parametrize("seed", range(3))
def test_one_record_sequence_gives_the_same_answers_in_both_packages(seed):
    rng = np.random.default_rng(300 + seed)
    port, ref = DeltaJournal(capacity=16), ref_delta.DeltaJournal(capacity=16)
    assert port.capacity == ref.capacity == 16
    for step in range(60):
        if step == 37:
            port.mark_gap()
            ref.mark_gap()
            continue
        node = f"n{int(rng.integers(12))}"
        kind = DELTA_KINDS[int(rng.integers(len(DELTA_KINDS)))]
        assert port.record(node, kind) == ref.record(node, kind)
        assert port.current_epoch() == ref.current_epoch()
    epochs = range(0, port.current_epoch() + 2)
    assert _answers(port, epochs) == _answers(ref, epochs)


def test_the_corrupt_seam_suppresses_a_record():
    j = DeltaJournal()
    e1 = j.record("n-a", NODE_ADDED)
    delta.set_corrupt_seam(lambda node, kind: kind == POD_BOUND)
    try:
        assert j.record("n-a", POD_BOUND) == e1, "a suppressed record moves no epoch"
        assert j.record("n-b", POD_REMOVED) == e1 + 1
    finally:
        delta.set_corrupt_seam(None)
    assert j.dirty_since(e1) == frozenset({"n-b"})
    assert j.record("n-c", POD_BOUND) == e1 + 2
