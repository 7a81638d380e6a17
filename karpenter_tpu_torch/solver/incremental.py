"""Incremental solve engine: resident cluster state, O(delta) passes.

The port of karpenter_tpu/solver/incremental.py. A provision pass without
it re-encodes EVERY existing node (`encode_warm_views` walks every view even
when the pass only bound three pods) and, on the card, stages and uploads
the whole [V, R] headroom for the warm-fill kernel. The engine keeps three
things alive across passes instead:

  * a host mirror of the last pass's `WarmViewEncoding` plus the node-name →
    row map that gives its rows identity across passes;
  * the f32 headroom surface `head0` on the solver's device, padded to the
    lane multiple: two resident [Vp, R] buffers, the live one and a spare.
    Each delta pass rebases the live buffer into the spare in one torch
    program (ops/rebase.py) and swaps them, so steady state costs two
    buffers and no host→device upload of the unchanged rows, and the
    warm-fill kernel reads its head in place (ops/warmfill.py:
    AdmissionSurface.counts_resident);
  * its checkpoint into the cluster `DeltaJournal` (ir/delta.py), the feed
    that names the dirty rows. The checkpoint is the epoch of the snapshot
    the pass was handed (Cluster.nodes_snapshot reads the nodes and the
    journal's epoch under one lock), never an epoch read later.

Each `advance()` classifies the pass:

  delta   the journal covers the span since the checkpoint and the dirty
          set is small: re-encode ONLY the dirty views (encode_warm_views
          is row-independent, so the spliced mirror is byte-identical to a
          fresh full encode), realign survivors by permutation, rebase the
          device buffer.
  full    anything that voids row identity or the journal window: cold
          start, catalog-key change ('catalog': a catalog bump can re-shape
          every row), journal gap/overflow ('gap'), view-pad regrowth
          ('grow'), a residency-auditor heal ('audit', solver/audit.py), or a
          dirty set so large the delta machinery would cost more than the
          full encode ('bulk').
  bypass  there is nothing to manage (no views), or the views are not the
          cluster's snapshot (no epoch: a re-solve on views with the round's
          nominated pods counted on them). The caller runs the fresh path,
          and the resident state is neither read nor written.

Correctness posture: the engine NEVER trusts resident values for a row the
journal (or the previous pass — see below) named dirty; those rows are
recomputed from the CURRENT views with the same f64 expressions as the
fresh path, so the mirror is byte-equal by determinism. Every pass, full or
delta, stores the snapshot's epoch as its checkpoint, so the resident state
describes exactly the snapshot it served: a mutation that lands after the
snapshot (while the round lists its pods, say) is in the next pass's
journal window whatever kind this pass was, and its row is recomputed
then. The window of a delta pass reaches to the journal's newest record, so
it may also name rows that moved after the snapshot; they are recomputed
from the snapshot now (over-dirtying, which is safe) and again next pass.
The DOUBLE-WINDOW rule (every pass re-dirties the names the JOURNAL
reported on the previous pass) is kept, though the snapshot epoch already
covers what it was for. Rows re-encoded purely for healing leave the window
immediately: the steady-state dirty set is bounded by two passes of churn.

Residency is not optional here: a failed upload or rebase raises out of the
solve; nothing quietly continues on the host. A classified device fault at
the rebase (solver/faults.py) is counted and voids residency ('fault-device':
the next pass is a clean full re-encode) before it is raised typed.

The fault injector's state seams live here too: 'resident-row' (a flipped
value in the host mirror, after every pass) and 'rebase' (one element of the
rebased head perturbed on the device), for the residency auditor to find.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ir.delta import DeltaJournal
from ..ir.encode import WarmViewEncoding, encode_warm_views
from ..metrics import REGISTRY
from ..ops.rebase import pad_views, rebase_view_state
from .faults import FAULTS, KIND_CORRUPT_DEVICE, KIND_CORRUPT_ROW, classify, count_fault

log = logging.getLogger("karpenter_tpu_torch.solver.incremental")

# above this fraction of dirty rows the delta path costs more than it saves
# (the splice is O(dirty) numpy + one rebase; the full encode is one O(V)
# vectorized pass) — and a half-churned cluster has no stable steady state
# to protect anyway
MAX_DIRTY_FRACTION = 0.5

PASS_FULL = "full"
PASS_DELTA = "delta"
PASS_BYPASS = "bypass"

INCREMENTAL_PASSES = REGISTRY.counter(
    "karpenter_solver_incremental_passes_total",
    "Incremental-engine provision passes by kind: 'delta' (resident state"
    " rebased in place, encode skipped), 'full' (resident state rebuilt —"
    " cold start, catalog change, journal gap, fault invalidation, or bulk"
    " churn), 'bypass' (nothing to manage; fresh path untouched).",
    ("kind",),
)
INCREMENTAL_INVALIDATIONS = REGISTRY.counter(
    "karpenter_solver_incremental_invalidations_total",
    "Resident-state invalidations forcing a full re-encode, by reason:"
    " 'cold', 'catalog', 'gap', 'grow', 'bulk', a fault seam"
    " ('fault-breaker', 'fault-flavor', 'fault-chunked', 'fault-host',"
    " 'fault-device'), or 'audit' (the residency auditor found divergence"
    " and healed by forcing the fresh full re-encode path).",
    ("reason",),
)


@dataclass
class _Resident:
    """What survives between passes."""

    epoch: int
    ckey: tuple
    enc: WarmViewEncoding
    names: List[str]
    row_of: Dict[str, int]
    head_dev: torch.Tensor  # [Vp, R] f32 on the engine's device: the live buffer
    vp: int
    prev_dirty: FrozenSet[str] = frozenset()


@dataclass
class AdvanceResult:
    """One pass's outcome: the encoding (byte-equal to a fresh
    encode_warm_views over the same views), its attribution, the time the
    engine spent producing it (charged to delta_apply or full_encode by the
    caller), and the host time of the rebase call inside it (0 on a full
    pass)."""

    enc: Optional[WarmViewEncoding]
    kind: str  # PASS_DELTA | PASS_FULL | PASS_BYPASS
    reason: str  # "" for delta; invalidation reason for full
    seconds: float
    dirty_rows: int
    rebase_seconds: float = 0.0


class IncrementalEngine:
    """Per-solver resident-state manager. Not thread-safe: it lives inside
    DenseSolver.presolve's single-threaded provisioning loop (the journal
    it reads IS thread-safe — that is the concurrent edge).

    `device` is where the resident headroom lives, the solver's device:
    "cuda" by default, "cpu" only on request (the tests)."""

    def __init__(self, journal: DeltaJournal, device="cuda"):
        self.journal = journal
        self.device = resolve_device(device)
        self._resident: Optional[_Resident] = None
        self._pending_invalidate: Optional[str] = None
        # the two resident [Vp, R] buffers: the live one (head_dev) and the
        # spare a rebase writes into; reallocated only when Vp or R changes
        self.buffers: tuple = ()
        # one engine's history, by pass kind and by full-pass reason
        self.passes: Dict[str, int] = {PASS_FULL: 0, PASS_DELTA: 0, PASS_BYPASS: 0}
        self.invalidations: Dict[str, int] = {}

    # -- invalidation ------------------------------------------------------

    def invalidate(self, reason: str) -> None:
        """Void the resident state: the next pass is a clean full re-encode
        attributed to `reason`. The residency auditor calls this to heal."""
        self._pending_invalidate = reason
        self._resident = None

    # -- the per-pass entry point -----------------------------------------

    def advance(self, views: Sequence, ckey: tuple, epoch: Optional[int]) -> AdvanceResult:
        """Produce this pass's WarmViewEncoding from the resident state plus
        the journal's delta, or rebuild it. `views` is the caller's
        scheduler.existing_nodes, built from a cluster snapshot; `ckey` the
        catalog key of this solve; `epoch` the journal's epoch at that
        snapshot (Scheduler.snapshot_epoch), which this pass stores as its
        checkpoint, full or delta. With `epoch` None the views are not the
        cluster's snapshot: the pass is a bypass that leaves the resident
        state as it was."""
        t0 = time.perf_counter()
        if epoch is None:
            self._note(PASS_BYPASS)
            return AdvanceResult(None, PASS_BYPASS, "", time.perf_counter() - t0, 0)
        if not views:
            # nothing resident to protect; drop state so a later non-empty
            # pass starts clean rather than diffing against a stale map
            self._resident = None
            self._note(PASS_BYPASS)
            return AdvanceResult(None, PASS_BYPASS, "", time.perf_counter() - t0, 0)

        names = [v.node.name for v in views]

        reason = self._full_reason(names, ckey, epoch)
        if reason is not None:
            enc = self._rebuild(views, names, ckey, epoch, reason)
            self._note(PASS_FULL)
            self.invalidations[reason] = self.invalidations.get(reason, 0) + 1
            INCREMENTAL_INVALIDATIONS.inc(reason=reason)
            self._maybe_corrupt_row()
            return AdvanceResult(enc, PASS_FULL, reason, time.perf_counter() - t0, len(views))

        res = self._resident
        assert res is not None
        dirty_names = self._dirty_names  # set by _full_reason's probe
        dirty_idx = [i for i, n in enumerate(names) if n in dirty_names or n not in res.row_of]
        enc, rebase_seconds = self._apply_delta(views, names, dirty_idx, epoch, ckey)
        self._note(PASS_DELTA)
        self._maybe_corrupt_row()
        return AdvanceResult(enc, PASS_DELTA, "", time.perf_counter() - t0, len(dirty_idx), rebase_seconds)

    def _note(self, kind: str) -> None:
        self.passes[kind] += 1
        INCREMENTAL_PASSES.inc(kind=kind)

    def _maybe_corrupt_row(self) -> None:
        """Seeded resident-row corruption seam (solver/faults.py): when the
        installed plan fires 'corrupt-row' at 'resident-row', flip one value
        in the HOST mirror — not head_dev, so the device check cannot
        double-count the same injection — modeling a splice/aliasing bug the
        residency auditor must detect as row-drift."""
        res = self._resident
        if res is None:
            return
        if FAULTS.corrupt("resident-row") == KIND_CORRUPT_ROW:
            res.enc.avail_tol[0] += 1.0
            log.warning("injected resident-row corruption: host mirror row 0 avail_tol flipped")

    # -- classification ----------------------------------------------------

    def _full_reason(self, names: List[str], ckey: tuple, epoch: int) -> Optional[str]:
        self._dirty_names: FrozenSet[str] = frozenset()
        self._journal_dirty: FrozenSet[str] = frozenset()
        if self._pending_invalidate is not None:
            reason, self._pending_invalidate = self._pending_invalidate, None
            return reason
        res = self._resident
        if res is None:
            return "cold"
        if res.ckey != ckey:
            return "catalog"
        dirty = self.journal.dirty_since(res.epoch)
        if dirty is None:
            return "gap"
        if pad_views(len(names)) != res.vp:
            return "grow"
        dirty_all = dirty | res.prev_dirty
        known = set(res.row_of)
        touched = sum(1 for n in names if n in dirty_all or n not in known)
        if touched > MAX_DIRTY_FRACTION * len(names):
            return "bulk"
        self._dirty_names = frozenset(dirty_all)
        self._journal_dirty = frozenset(dirty)
        return None

    # -- full rebuild ------------------------------------------------------

    def _rebuild(self, views: Sequence, names: List[str], ckey: tuple, epoch: int, reason: str) -> WarmViewEncoding:
        enc = encode_warm_views(views)
        head_dev, vp = self._upload(enc.head0)
        self._resident = _Resident(
            epoch=epoch,
            ckey=ckey,
            enc=enc,
            names=names,
            row_of={n: i for i, n in enumerate(names)},
            head_dev=head_dev,
            vp=vp,
            prev_dirty=frozenset(),
        )
        self._attach(enc)
        if reason != "cold":
            log.info("incremental resident state invalidated (%s): full re-encode of %d views", reason, len(views))
        return enc

    def _upload(self, head0: np.ndarray):
        """Fresh device residency: [V, R] f64 → padded [Vp, R] f32 in the
        live buffer, -1.0 pad rows (the dead-row sentinel the rebase keeps).
        The two buffers are reused while Vp and R stay."""
        V, R = head0.shape
        vp = pad_views(V)
        padded = np.full((vp, R), -1.0, np.float32)
        padded[:V] = head0.astype(np.float32)
        if not self.buffers or tuple(self.buffers[0].shape) != (vp, R):
            self.buffers = tuple(torch.empty((vp, R), dtype=torch.float32, device=self.device) for _ in range(2))
        live = self.buffers[0]
        live.copy_(torch.from_numpy(padded))
        return live, vp

    # -- delta application -------------------------------------------------

    def _apply_delta(self, views: Sequence, names: List[str], dirty_idx: List[int], epoch: int, ckey: tuple):
        res = self._resident
        assert res is not None
        old = res.enc
        V = len(views)

        # survivor permutation: new row i ← old row perm[i] (or -1)
        perm = np.fromiter((res.row_of.get(n, -1) for n in names), dtype=np.int32, count=V)
        take = np.clip(perm, 0, None)
        alive = perm >= 0

        usable = old.usable[take] & alive
        avail_tol = np.where(alive[:, None], old.avail_tol[take], 0.0)
        requests0 = np.where(alive[:, None], old.requests0[take], 0.0)
        head0 = np.where(alive[:, None], old.head0[take], -1.0)
        zone = [old.zone[p] if p >= 0 else None for p in perm]
        ct = [old.ct[p] if p >= 0 else None for p in perm]
        hostname = [old.hostname[p] if p >= 0 else "" for p in perm]
        taint_sig = [old.taint_sig[p] if p >= 0 else () for p in perm]

        # dirty rows: recomputed from the CURRENT views with the exact fresh
        # expressions (encode_warm_views is row-independent → byte-equal)
        sub = encode_warm_views([views[i] for i in dirty_idx])
        for j, i in enumerate(dirty_idx):
            usable[i] = sub.usable[j]
            avail_tol[i] = sub.avail_tol[j]
            requests0[i] = sub.requests0[j]
            head0[i] = sub.head0[j]
            zone[i] = sub.zone[j]
            ct[i] = sub.ct[j]
            hostname[i] = sub.hostname[j]
            taint_sig[i] = sub.taint_sig[j]

        enc = WarmViewEncoding(
            usable=usable,
            avail_tol=avail_tol,
            requests0=requests0,
            head0=head0,
            zone=zone,
            ct=ct,
            hostname=hostname,
            taint_sig=taint_sig,
        )

        # device rebase: survivors gathered by permutation and the dirty rows
        # scattered into the spare buffer, which becomes the live one. A
        # failure here propagates out of the solve; a classified one first
        # voids residency, since the buffers' state is unknown after it.
        t_rebase = time.perf_counter()
        vp = res.vp
        try:
            FAULTS.check("rebase")
            # perm padded to the buffer's rows (-1: pad rows stay dead), then
            # the dirty rows' indices: one int64 upload
            ix = np.full(vp + len(dirty_idx), -1, np.int64)
            ix[:V] = perm
            ix[vp:] = dirty_idx
            ix_dev = torch.from_numpy(ix).to(self.device)
            rows = sub.head0.astype(np.float32) if dirty_idx else np.zeros((0, head0.shape[1]), np.float32)
            spare = self.buffers[1] if res.head_dev is self.buffers[0] else self.buffers[0]
            head_dev = rebase_view_state(res.head_dev, ix_dev[:vp], torch.from_numpy(rows).to(self.device), ix_dev[vp:], out=spare)
        except Exception as exc:
            fault = classify(exc)
            if fault is None:
                raise
            count_fault(fault)
            self.invalidate("fault-device")
            log.warning("device fault at the rebase (%s): residency voided, next pass full re-encode: %s", fault.kind, exc)
            if fault is exc:
                raise
            raise fault from exc
        if FAULTS.corrupt("rebase") == KIND_CORRUPT_DEVICE:
            # seeded device-buffer corruption: one element of the rebased
            # buffer perturbed on the device AFTER the rebase — the host
            # mirror stays byte-exact, so only the auditor's device check
            # (the resident rows against f32(head0)) can see it
            head_dev[0, 0] += 1.0
            log.warning("injected device-buffer corruption: resident head_dev[0, 0] perturbed")
        rebase_seconds = time.perf_counter() - t_rebase

        # next pass's double window: the rows the journal named this pass
        # (plus rows new to the map). A mutation after the snapshot is in the
        # next window through the snapshot's epoch already; the rule stays
        # as a second guard. Rows re-encoded merely
        # because they sat in the previous window are healed and must leave
        # it — carrying all of dirty_idx would make the window transitively
        # cumulative, growing every pass until it trips 'bulk'
        prev = frozenset(
            names[i]
            for i in dirty_idx
            if names[i] in self._journal_dirty or names[i] not in res.row_of
        )
        self._resident = _Resident(
            epoch=epoch,
            ckey=ckey,
            enc=enc,
            names=names,
            row_of={n: i for i, n in enumerate(names)},
            head_dev=head_dev,
            vp=res.vp,
            prev_dirty=prev,
        )
        self._attach(enc)
        return enc, rebase_seconds

    def _attach(self, enc: WarmViewEncoding) -> None:
        """Carry the resident device buffer on the encoding so the warm-fill
        admission surface (solver/warmfill.py:_device_counts) reads it in
        place, with no fresh host→device transfer."""
        res = self._resident
        enc.head_dev = res.head_dev
        enc.head_vp = res.vp
